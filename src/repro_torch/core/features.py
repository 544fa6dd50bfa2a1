"""Columnar feature schema and TSV codec for shared runtime data (paper §VI-A).

The runtime-data plane is a struct-of-arrays: machine codes (int32 indices
into a small machine vocabulary), scale-outs, context features, and runtimes
each live in their own contiguous array.  Row layout of the *assembled*
feature matrix follows the paper: column 0 of ``X`` is ALWAYS the scale-out
(models such as the optimistic SSM depend on that convention); the machine
type is a partition key, not a model feature (paper §VI-C: models only train
on data from the target machine type).

Columnar storage is growable: ``append`` writes contributions into spare
tail capacity (amortized doubling) instead of re-copying the whole store,
and per-machine index views plus assembled-``X`` caches are carried forward
incrementally so ``predictor_for`` -> engine dispatch re-uses one assembled
batch per (machine, data version) without re-filtering.  TSV remains
strictly an import/export format at the edges — the codec is vectorized
(``np.loadtxt`` / ``np.char``) and never materializes Python row objects.
"""
from __future__ import annotations

import io
from dataclasses import dataclass

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# Instrumentation for the incremental view plane (read by tests and the
# replay harness): full (re)builds should happen once per cold store, while
# steady-state ingestion only ever extends cached state by the delta.
VIEW_STATS: Dict[str, int] = {
    "machine_view_builds": 0,     # machine_view assembled via full subset scan
    "machine_view_extends": 0,    # cached view carried forward with the delta
    "x_builds": 0,                # assembled-X buffer allocated from scratch
    "x_extends": 0,               # assembled-X extended in place by new rows
}

#: default contributor identity for rows whose provenance is unrecorded —
#: every pre-provenance store decodes to this (the TSV format without a
#: contributor column is the canonical encoding for such data, so legacy
#: files keep their fingerprints byte-for-byte)
UNKNOWN_CONTRIBUTOR = "unknown"


def view_stats_reset() -> None:
    for k in VIEW_STATS:
        VIEW_STATS[k] = 0


@dataclass(frozen=True)
class JobSchema:
    job: str
    context_features: Tuple[str, ...]        # job-specific columns
    base_features: Tuple[str, ...] = ("scale_out", "data_size_gb")

    @property
    def feature_names(self) -> Tuple[str, ...]:
        return self.base_features + self.context_features

    @property
    def n_features(self) -> int:
        return len(self.feature_names)

    @property
    def columns(self) -> Tuple[str, ...]:
        return ("machine_type",) + self.feature_names + ("runtime_s",)

    @property
    def columns_with_provenance(self) -> Tuple[str, ...]:
        """TSV header once any row carries a known contributor: the
        contributor column rides at the end so numeric parsing of the
        legacy prefix is unchanged."""
        return self.columns + ("contributor",)


class _Columns:
    """Growable column buffers shared by ``RuntimeData`` frontier views.

    ``used`` is the number of globally valid rows; each ``RuntimeData`` view
    covers a prefix ``[:n]`` with ``n <= used``.  Rows are append-only —
    existing rows are never mutated in place — so prefix views (and any
    numpy slices handed out from them) stay valid across later appends and
    buffer growth.
    """

    __slots__ = ("codes", "scale_out", "context", "runtime", "ccodes",
                 "used", "xbuf", "xrows")

    def __init__(self, codes, scale_out, context, runtime, ccodes=None):
        self.codes = np.ascontiguousarray(codes, np.int32)
        self.scale_out = np.ascontiguousarray(scale_out, np.float64)
        self.context = np.ascontiguousarray(context, np.float64)
        self.runtime = np.ascontiguousarray(runtime, np.float64)
        self.ccodes = (np.zeros(len(self.codes), np.int32) if ccodes is None
                       else np.ascontiguousarray(ccodes, np.int32))
        self.used = len(self.codes)
        self.xbuf = None          # [capacity, 1+k] assembled-X mirror (lazy)
        self.xrows = 0            # valid assembled rows (<= used)

    @property
    def capacity(self) -> int:
        return len(self.codes)

    def grow(self, need: int) -> None:
        """Reallocate to >= ``need`` rows (amortized doubling); valid rows
        are copied, so views over the OLD buffers keep their contents."""
        cap = max(8, 2 * self.capacity)
        while cap < need:
            cap *= 2
        for name in ("codes", "scale_out", "runtime", "ccodes"):
            old = getattr(self, name)
            new = np.empty(cap, old.dtype)
            new[:self.used] = old[:self.used]
            setattr(self, name, new)
        old = self.context
        new = np.empty((cap, old.shape[1]), old.dtype)
        new[:self.used] = old[:self.used]
        self.context = new
        if self.xbuf is not None:
            newx = np.empty((cap, self.xbuf.shape[1]), np.float64)
            newx[:self.xrows] = self.xbuf[:self.xrows]
            self.xbuf = newx

    def x_view(self, n: int) -> np.ndarray:
        """Assembled [n, 1+k] feature matrix over the first ``n`` rows.

        The buffer mirrors (scale_out | context) at column-buffer capacity
        and is extended IN PLACE as views grow past previously assembled
        rows: after an append of ``m`` rows the next ``X`` access assembles
        only those ``m`` — refit preparation is O(delta), not O(n).  Rows
        are append-only, so slices handed out earlier stay valid."""
        if self.xbuf is None:
            self.xbuf = np.empty((self.capacity, self.context.shape[1] + 1),
                                 np.float64)
            self.xrows = 0
            VIEW_STATS["x_builds"] += 1
        if self.xrows < n:
            lo = self.xrows
            self.xbuf[lo:n, 0] = self.scale_out[lo:n]
            self.xbuf[lo:n, 1:] = self.context[lo:n]
            if lo:
                VIEW_STATS["x_extends"] += 1
            self.xrows = n
        return self.xbuf[:n]


def check_tsv_field(value: str, what: str = "field") -> str:
    """A string destined for a TSV column must survive the codec round
    trip byte-for-byte: no tab (the delimiter), no line-breaking
    character (``splitlines`` splits on \\v, \\f, \\x1c-\\x1e, \\x85,
    U+2028/U+2029 too, shearing the persisted store), and no leading or
    trailing whitespace (the parser strips it, silently changing the
    value — and therefore the fingerprint — on reload); not empty (a
    trailing empty field is dropped on reload, shifting every column)."""
    value = str(value)
    if (not value or "\t" in value or len(value.splitlines()) > 1
            or value != value.strip()):
        raise ValueError(
            f"{what} {value!r} would not survive the TSV codec "
            "(empty, tab, line-breaking character, or leading/trailing "
            "whitespace): it would corrupt the store's canonical "
            "encoding")
    return value


def check_contributor_id(name: str) -> str:
    """Contributor ids live in a TSV column; reject at the door anything
    the codec cannot round-trip."""
    return check_tsv_field(name, "contributor id")


def _contributor_columns(contributor, n: int):
    """(vocabulary, int32 codes) for a per-row/scalar/absent contributor."""
    if contributor is None:
        return (UNKNOWN_CONTRIBUTOR,), np.zeros(n, np.int32)
    if isinstance(contributor, str):
        return (check_contributor_id(contributor),), np.zeros(n, np.int32)
    names = np.asarray(contributor)
    if not len(names):
        return (UNKNOWN_CONTRIBUTOR,), np.empty(0, np.int32)
    vocab, ccodes = np.unique(names, return_inverse=True)
    return (tuple(check_contributor_id(c) for c in vocab),
            ccodes.astype(np.int32))


class RuntimeData:
    """Columnar runtime data for one job (struct-of-arrays).

    Columns (all length ``n``):
      ``codes``      int32 indices into the ``machines`` vocabulary
      ``scale_out``  float64 number of nodes
      ``context``    float64 [n, d-1] remaining features (data size + job
                     context), in ``schema.feature_names[1:]`` order
      ``runtime``    float64 measured runtime in seconds
      ``ccodes``     int32 indices into the ``contributors`` vocabulary
                     (provenance: which collaborator measured the row)

    ``machine_type`` / ``X`` / ``y`` are assembled-on-demand compatibility
    views (cached); hot paths should consume the columns directly or go
    through ``machine_view`` for the cached per-machine batch.  Provenance
    is metadata, never a model feature: predictors and validation ignore
    the contributor column entirely.
    """

    def __init__(self, schema: JobSchema, machine_type, X, y,
                 contributor=None):
        """Row-oriented compatibility constructor (decodes to columns).

        ``contributor`` may be a per-row array of contributor ids or a
        single id for every row; omitted means provenance unrecorded
        (``UNKNOWN_CONTRIBUTOR``)."""
        X = np.asarray(X, np.float64)
        if X.ndim != 2:
            X = X.reshape(-1, schema.n_features)
        mt = np.asarray(machine_type)
        if len(mt):
            machines, codes = np.unique(mt, return_inverse=True)
            machines = tuple(str(m) for m in machines)
        else:
            machines, codes = (), np.empty(0, np.int32)
        contributors, ccodes = _contributor_columns(contributor, len(codes))
        self._init(schema, machines,
                   _Columns(codes, X[:, 0], X[:, 1:],
                            np.asarray(y, np.float64), ccodes),
                   len(codes), contributors)

    def _init(self, schema, machines, cols, n,
              contributors=(UNKNOWN_CONTRIBUTOR,)):
        self.schema = schema
        self.machines = tuple(machines)
        self.contributors = tuple(contributors)
        self._cols = cols
        self._n = int(n)
        self._mindex = {}            # machine -> row-index array (cached)
        self._mview = {}             # machine -> RuntimeData (cached)
        self._X = None               # assembled [n, d] cache
        self._has_prov = None        # lazy has_provenance (append-carried)

    @classmethod
    def from_columns(cls, schema: JobSchema, machines: Sequence[str],
                     codes, scale_out, context, runtime, *,
                     contributors: Sequence[str] = (UNKNOWN_CONTRIBUTOR,),
                     ccodes=None) -> "RuntimeData":
        """Zero-copy columnar constructor (arrays are adopted, not copied,
        when already contiguous with the right dtype)."""
        self = cls.__new__(cls)
        context = np.asarray(context, np.float64)
        if context.ndim != 2:
            context = context.reshape(len(np.atleast_1d(scale_out)), -1)
        cols = _Columns(codes, scale_out, context, runtime, ccodes)
        self._init(schema, machines, cols, cols.used, contributors)
        return self

    @classmethod
    def empty(cls, schema: JobSchema) -> "RuntimeData":
        k = schema.n_features - 1
        return cls.from_columns(schema, (), np.empty(0, np.int32),
                                np.empty(0), np.empty((0, k)), np.empty(0))

    # ---------------- columns (views over the shared buffers) --------------
    @property
    def codes(self) -> np.ndarray:
        return self._cols.codes[:self._n]

    @property
    def scale_out(self) -> np.ndarray:
        return self._cols.scale_out[:self._n]

    @property
    def context(self) -> np.ndarray:
        return self._cols.context[:self._n]

    @property
    def runtime(self) -> np.ndarray:
        return self._cols.runtime[:self._n]

    @property
    def ccodes(self) -> np.ndarray:
        return self._cols.ccodes[:self._n]

    def __len__(self) -> int:
        return self._n

    # ---------------- contributor provenance -------------------------------
    @property
    def contributor(self) -> np.ndarray:
        """[n] contributor-id strings (decoded from codes on demand).

        A store assembled before provenance existed can carry an EMPTY
        contributor vocabulary (``from_columns(..., contributors=())``);
        its rows are provenance-unrecorded, which decodes to
        ``UNKNOWN_CONTRIBUTOR`` — not to empty strings, which would
        corrupt a TSV encoding and mislead provenance stats."""
        if not self.contributors:
            return np.full(self._n, UNKNOWN_CONTRIBUTOR)
        return np.asarray(self.contributors)[self.ccodes]

    @property
    def has_provenance(self) -> bool:
        """True when any row carries a KNOWN contributor.  Decides the TSV
        encoding: provenance-free data keeps the legacy column set, so
        pre-provenance files round-trip byte-identically (same
        fingerprint); once a known contributor appears the canonical
        encoding gains the trailing ``contributor`` column.

        Computed at most once per object — the full-column scan only runs
        when the vocabulary is ambiguous — and carried forward by
        ``append`` (rows are append-only, so ``merged = self or delta``),
        keeping ``contribute`` O(delta) on provenance-format stores."""
        if self._has_prov is None:
            if self._n == 0 or all(c == UNKNOWN_CONTRIBUTOR
                                   for c in self.contributors):
                self._has_prov = False
            else:
                used = np.unique(self.ccodes)
                self._has_prov = any(
                    self.contributors[c] != UNKNOWN_CONTRIBUTOR
                    for c in used)
        return self._has_prov

    def with_contributor(self, contributor_id: str) -> "RuntimeData":
        """Same rows stamped with one contributor identity (shares every
        non-provenance column buffer; used by ``RuntimeDataStore.contribute``
        to thread the gateway's ``contributor_id`` into the store)."""
        return RuntimeData.from_columns(
            self.schema, self.machines, self.codes, self.scale_out,
            self.context, self.runtime,
            contributors=(check_contributor_id(contributor_id),),
            ccodes=np.zeros(self._n, np.int32))

    def contributor_counts(self) -> Dict[str, int]:
        """Rows per contributor id (provenance stats for the gateway).

        Codes outside the vocabulary — a store that predates provenance
        entirely (empty vocabulary) or was assembled from raw columns with
        dangling codes — aggregate under ``UNKNOWN_CONTRIBUTOR`` instead
        of raising: the gateway's ``contributor_stats`` must answer with a
        well-formed table for every store it can serve."""
        used, counts = np.unique(self.ccodes, return_counts=True)
        out: Dict[str, int] = {}
        for c, k in zip(used, counts):
            name = (self.contributors[c]
                    if 0 <= c < len(self.contributors)
                    else UNKNOWN_CONTRIBUTOR)
            out[name] = out.get(name, 0) + int(k)
        return out

    # ---------------- assembled compatibility views ------------------------
    @property
    def machine_type(self) -> np.ndarray:
        """[n] machine-name strings (decoded from codes on demand)."""
        if not self.machines:
            return np.empty(self._n, dtype="<U1")
        return np.asarray(self.machines)[self.codes]

    @property
    def X(self) -> np.ndarray:
        """[n, d] float64 feature matrix, scale-out first.  Backed by the
        shared assembled-X buffer in ``_Columns``: built once per buffer,
        then extended in place by exactly the delta rows as the data grows
        (views are append-safe, see ``_Columns``)."""
        if self._X is None or len(self._X) != self._n:
            self._X = self._cols.x_view(self._n)
        return self._X

    @property
    def y(self) -> np.ndarray:
        return self.runtime

    @y.setter
    def y(self, value) -> None:
        """Replace runtimes (tests perturb contributions this way).  The
        view detaches onto private buffers first so sibling views sharing
        the columns are never mutated."""
        self._detach()
        self._cols.runtime = np.ascontiguousarray(value, np.float64)
        assert len(self._cols.runtime) == self._n
        self._mview = {}

    def _detach(self) -> None:
        if self._cols.used != self._n or self._cols.capacity != self._n:
            self._cols = _Columns(self.codes.copy(), self.scale_out.copy(),
                                  self.context.copy(), self.runtime.copy(),
                                  self.ccodes.copy())
        else:
            self._cols = _Columns(self._cols.codes, self._cols.scale_out,
                                  self._cols.context, self._cols.runtime,
                                  self._cols.ccodes)

    # ---------------- per-machine index views ------------------------------
    def machine_code(self, machine: str) -> int:
        """Vocabulary index of ``machine`` (-1 when absent)."""
        try:
            return self.machines.index(machine)
        except ValueError:
            return -1

    def present_machines(self) -> Tuple[str, ...]:
        """Machine names present in the data, first-appearance order."""
        codes, first = np.unique(self.codes, return_index=True)
        order = np.argsort(first)
        return tuple(self.machines[c] for c in codes[order])

    def machine_indices(self, machine: str) -> np.ndarray:
        """Row indices for one machine type (computed once, then carried
        forward incrementally across ``append``)."""
        idx = self._mindex.get(machine)
        if idx is None:
            code = self.machine_code(machine)
            idx = np.nonzero(self.codes == code)[0] if code >= 0 \
                else np.empty(0, np.int64)
            self._mindex[machine] = idx
        return idx

    def machine_view(self, machine: str) -> "RuntimeData":
        """Cached columnar batch for one machine type: repeated calls (the
        ``predictor_for`` hot path) return the SAME object, so its assembled
        ``X`` is built at most once per (machine, data version).  ``append``
        carries cached views forward by appending only the delta rows, so
        after an accepted contribution refit preparation never re-scans the
        full store (see ``VIEW_STATS``)."""
        view = self._mview.get(machine)
        if view is None:
            VIEW_STATS["machine_view_builds"] += 1
            view = self.subset(self.machine_indices(machine))
            self._mview[machine] = view
        return view

    def _light_clone(self) -> "RuntimeData":
        """Distinct object over the same columns (and shared ``X`` cache).
        Mutating the clone's ``y`` detaches it onto private buffers, so the
        original — e.g. the cached ``machine_view`` — is untouched."""
        out = RuntimeData.__new__(RuntimeData)
        out._init(self.schema, self.machines, self._cols, self._n,
                  self.contributors)
        out._X = self._X
        out._mindex = dict(self._mindex)
        out._has_prov = self._has_prov
        return out

    def filter_machine(self, machine: str) -> "RuntimeData":
        """Per-machine rows, sharing storage with the cached view but safe
        to perturb (the pre-refactor contract returned an independent copy;
        callers may legitimately edit the result's runtimes)."""
        return self.machine_view(machine)._light_clone()

    # ---------------- subset / append --------------------------------------
    def subset(self, idx) -> "RuntimeData":
        idx = np.asarray(idx)
        return RuntimeData.from_columns(
            self.schema, self.machines, self.codes[idx], self.scale_out[idx],
            self.context[idx], self.runtime[idx],
            contributors=self.contributors, ccodes=self.ccodes[idx])

    @staticmethod
    def _merge_names(ours: Sequence[str], theirs: Sequence[str],
                     their_codes: np.ndarray):
        """(merged vocabulary, their codes remapped into it)."""
        merged = list(ours)
        lut = {m: i for i, m in enumerate(merged)}
        remap = np.empty(max(len(theirs), 1), np.int32)
        for j, m in enumerate(theirs):
            if m not in lut:
                lut[m] = len(merged)
                merged.append(m)
            remap[j] = lut[m]
        out = remap[their_codes] if len(their_codes) else their_codes
        return tuple(merged), out

    def _merged_vocab(self, other: "RuntimeData"):
        """(merged machine vocabulary, other's codes remapped into it)."""
        return self._merge_names(self.machines, other.machines, other.codes)

    def append(self, other: "RuntimeData") -> "RuntimeData":
        """Columnar append in amortized O(len(other)).

        When ``self`` is the frontier view of its buffers (nothing appended
        past it yet), the delta is written into spare tail capacity and the
        returned view shares storage; otherwise a compact copy is made.
        ``self`` remains a valid, unchanged view either way.  Cached
        per-machine indices are extended incrementally, not recomputed.
        """
        assert self.schema.job == other.schema.job
        if len(other) == 0:
            return self
        machines, ocodes = self._merged_vocab(other)
        contributors, occodes = self._merge_names(
            self.contributors, other.contributors, other.ccodes)
        m = len(other)
        n = self._n
        cols = self._cols
        if cols.used != n or cols.context.shape[1] != other.context.shape[1]:
            cols = _Columns(self.codes.copy(), self.scale_out.copy(),
                            self.context.copy(), self.runtime.copy(),
                            self.ccodes.copy())
        if n + m > cols.capacity:
            cols.grow(n + m)
        cols.codes[n:n + m] = ocodes
        cols.scale_out[n:n + m] = other.scale_out
        cols.context[n:n + m] = other.context
        cols.runtime[n:n + m] = other.runtime
        cols.ccodes[n:n + m] = occodes
        cols.used = n + m
        out = RuntimeData.__new__(RuntimeData)
        out._init(self.schema, machines, cols, n + m, contributors)
        # rows are append-only, so the provenance flag composes: one O(N)
        # evaluation at the head of an append chain, O(delta) after
        out._has_prov = self.has_provenance or other.has_provenance
        # carry cached per-machine indices forward with just the delta rows
        for machine, pidx in self._mindex.items():
            code = machines.index(machine) if machine in machines else -1
            didx = np.nonzero(ocodes == code)[0] + n
            out._mindex[machine] = (np.concatenate([pidx, didx])
                                    if len(didx) else pidx)
        # carry cached per-machine VIEWS forward too: extend each cached
        # view with only its delta rows (columnar tail append), so refit
        # preparation after an accepted contribution is O(delta) — the
        # per-machine matrices are never rebuilt from a full-store scan
        for machine, view in self._mview.items():
            code = machines.index(machine) if machine in machines else -1
            didx = np.nonzero(ocodes == code)[0]
            if len(didx):
                VIEW_STATS["machine_view_extends"] += 1
                delta = RuntimeData.from_columns(
                    other.schema, machines, ocodes[didx],
                    other.scale_out[didx], other.context[didx],
                    other.runtime[didx],
                    contributors=contributors, ccodes=occodes[didx])
                out._mview[machine] = view.append(delta)
            else:
                out._mview[machine] = view
        return out

    def concat(self, other: "RuntimeData") -> "RuntimeData":
        return self.append(other)

    # ---------------- TSV (the sharing format, paper §VI-A) ----------------
    def tsv_lines(self, with_contributor: Optional[bool] = None) -> np.ndarray:
        """Canonical per-row TSV lines (no header, no newlines) as a string
        array — the unit of the datastore's chained fingerprint.

        ``with_contributor`` selects the encoding; None means "whatever is
        canonical for this data" (``has_provenance``).  Callers advancing a
        fingerprint chain pass the STORE's format explicitly so delta bytes
        match the full encoding even when the delta itself is provenance-
        free."""
        if self._n == 0:
            return np.empty(0, dtype=object)
        if with_contributor is None:
            with_contributor = self.has_provenance
        out = self.machine_type.astype(object)
        X = self.X
        for j in range(X.shape[1]):
            out = out + "\t" + np.char.mod("%.6g", X[:, j]).astype(object)
        out = out + "\t" + np.char.mod("%.4f", self.runtime).astype(object)
        if with_contributor:
            out = out + "\t" + self.contributor.astype(object)
        return out

    def tsv_delta_bytes(self, with_contributor: Optional[bool] = None
                        ) -> bytes:
        """This view's rows in canonical TSV byte form (one trailing newline
        per row) — what an append contributes to the fingerprint chain."""
        lines = self.tsv_lines(with_contributor)
        if not len(lines):
            return b""
        return ("\n".join(lines) + "\n").encode()

    def to_tsv(self) -> str:
        prov = self.has_provenance
        header = "\t".join(self.schema.columns_with_provenance if prov
                           else self.schema.columns) + "\n"
        return header + self.tsv_delta_bytes(prov).decode()

    @classmethod
    def from_tsv(cls, text: str, schema: JobSchema) -> "RuntimeData":
        lines = text.strip().splitlines()
        header = tuple(lines[0].split("\t")) if lines else ()
        prov = header == schema.columns_with_provenance
        assert prov or header == schema.columns, \
            f"schema mismatch: {header} vs {schema.columns}"
        body = [ln for ln in lines[1:] if ln]
        if not body:
            return cls.empty(schema)
        arr = np.loadtxt(io.StringIO("\n".join(body)), dtype=str,
                         delimiter="\t", ndmin=2, comments=None)
        stop = -1 if prov else arr.shape[1]
        nums = arr[:, 1:stop].astype(np.float64)
        machines, codes = np.unique(arr[:, 0], return_inverse=True)
        if prov:
            contributors, ccodes = _contributor_columns(arr[:, -1], len(arr))
        else:
            contributors, ccodes = _contributor_columns(None, len(arr))
        return cls.from_columns(schema, tuple(str(m) for m in machines),
                                codes, nums[:, 0], nums[:, 1:-1],
                                nums[:, -1], contributors=contributors,
                                ccodes=ccodes)


def assemble_X(scale_out: np.ndarray, context: np.ndarray,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """Assemble the [n, d] model feature matrix from columns (scale-out
    first) — the one place the columnar plane flattens for the engine."""
    scale_out = np.asarray(scale_out, np.float64)
    context = np.atleast_2d(np.asarray(context, np.float64))
    n, k = context.shape
    if out is None:
        out = np.empty((n, k + 1), np.float64)
    out[:, 0] = scale_out
    out[:, 1:] = context
    return out
