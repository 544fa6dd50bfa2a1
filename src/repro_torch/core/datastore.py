"""Collaborative runtime-data store with contribution validation (paper §III-C).

Runtime data lives as TSV alongside the job (one store per job repo), but
in memory the store is columnar (``repro_torch.core.features.RuntimeData``) and
ingestion is incremental:

  * accepted contributions are *appended* into spare column capacity
    (amortized O(delta), no full-store copy);
  * the content fingerprint is a streaming SHA-256 over the canonical TSV
    byte stream, advanced per accepted delta — byte-for-byte identical to
    hashing the full TSV export, with no O(N) re-encode per contribution;
  * validation (§III-C.b) routes through the prediction engine
    (``engine.holdout_mape``) on the store's ``device`` instead of
    constructing a fresh CV predictor per machine group.

``contribute`` implements §III-C.b: retrain the model pool with the
candidate rows included and evaluate on a held-out test set of *previously
existing* points; reject the contribution if the error increases
significantly (corrupted or fabricated data would poison every
collaborator's models).
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.features import (UNKNOWN_CONTRIBUTOR, JobSchema, RuntimeData)
from repro_torch.core.trust import ReputationLedger


@dataclass
class ValidationReport:
    accepted: bool
    baseline_mape: float
    candidate_mape: float
    reason: str = ""


#: machine-readable compaction outcome codes (`CompactionReport.code`,
#: carried verbatim on the gateway's `CompactResult` envelope)
COMPACTED = "compacted"
COMPACTION_REJECTED = "compaction_rejected"


@dataclass
class CompactionReport:
    """Outcome of one ``RuntimeDataStore.compact`` attempt.

    A rejected attempt is a strict no-op: no rows move, no version bump,
    no fingerprint reseed — ``code`` says which, ``reason`` says why."""
    accepted: bool
    code: str                         # COMPACTED | COMPACTION_REJECTED
    reason: str
    rows_before: int
    rows_after: int
    epoch: int                        # store epoch AFTER the attempt
    cells: int = 0                    # occupied (machine, cell, scale) cells
    baseline_mape: float = float("nan")
    candidate_mape: float = float("nan")

    @property
    def retained_ratio(self) -> float:
        return self.rows_after / max(self.rows_before, 1)


def _gap_bins(col: np.ndarray, rel_width: float) -> np.ndarray:
    """Cluster one context feature by relative gaps between sorted values.

    Consecutive unique values split into separate cells where their gap
    exceeds ``rel_width`` RELATIVE to the larger magnitude — collaborators
    jitter the same canonical context cell multiplicatively, so their
    values never coincide exactly but sit within a narrow relative band
    that this clustering collapses into one shared coverage cell.

    Compaction stays idempotent under it: removing rows only widens the
    remaining consecutive gaps, and for ``rel_width <= 1`` a widened pair
    spanning an old split still satisfies the split criterion — cells can
    only ever SUBDIVIDE after a compaction, never merge, so every new cell
    is a subset of an old (already capped) one."""
    u, inv = np.unique(col, return_inverse=True)
    if len(u) <= 1:
        return np.zeros(len(col), np.int64)
    a, b = u[:-1], u[1:]
    split = (b - a) > rel_width * np.maximum(np.abs(a), np.abs(b))
    return np.concatenate(([0], np.cumsum(split)))[inv.reshape(-1)]


def _waterfill(parts: Sequence[np.ndarray], cap: int) -> np.ndarray:
    """Concatenate prefix samples of ``parts`` under a total row cap.

    Water-filling allocation: groups are visited smallest-first and each
    receives ``min(len(group), remaining_cap // remaining_groups)`` rows, so
    small (rare-machine) groups keep ALL their rows while large groups share
    whatever budget is left.  Each part is pre-permuted by the caller, so a
    prefix is a uniform subsample of that group."""
    out = []
    cap = int(cap)
    for i, p in enumerate(sorted(parts, key=len)):
        take = min(len(p), cap // (len(parts) - i))
        out.append(p[:take])
        cap -= take
    return (np.concatenate(out) if out
            else np.empty(0, np.int64))


class RuntimeDataStore:
    """One shared store per (job, repository)."""

    def __init__(self, data: RuntimeData, *, reject_ratio: float = 1.5,
                 reject_slack: float = 0.02, seed: int = 0,
                 model_names: Optional[Sequence[str]] = None,
                 max_validation_rows: int = 1024,
                 trust: Optional[ReputationLedger] = None,
                 device="cuda"):
        self.reject_ratio = reject_ratio
        self.reject_slack = reject_slack
        self.seed = seed
        self.model_names = model_names
        # optional reputation ledger (repro_torch.core.trust): when present,
        # every judged contribution records an outcome against its
        # contributor, acceptance thresholds adapt to reputation, and
        # row_weights() derives per-row fit weights from it.  None (the
        # default) keeps the §III-C.b scheme byte-identical to the
        # trust-free store.
        self.trust = trust
        # validation retrains/tests on at most this many existing rows per
        # side: keeps the per-contribution cost flat as the collaborative
        # store grows (the optimistic models' group aux is O(n^2), so
        # unbounded validation would dominate ingestion at hub scale)
        self.max_validation_rows = max_validation_rows
        # where validation fits run; "cpu" must be asked for
        self.device = device
        self._version = 0
        # epoch lifecycle: contributions append WITHIN the current epoch
        # (O(delta) fingerprint chain); compact() transitions to the next
        # epoch, re-seeding the chain once.  Pre-epoch TSV stores load as
        # epoch 0 with byte-identical fingerprints (nothing here touches
        # the on-disk format).
        self._epoch = 0
        self._compactions = 0
        self._rows_contributed = len(data)
        self.last_compaction: Optional[CompactionReport] = None
        self.data = data          # property setter seeds the fingerprint

    @property
    def data(self) -> RuntimeData:
        return self._data

    @data.setter
    def data(self, value: RuntimeData) -> None:
        """Replacing the data wholesale re-seeds the streaming fingerprint
        from the new content (O(N), correct for arbitrary edits); the
        ``contribute`` fast path bypasses this and advances the existing
        chain with just its delta."""
        self._data = value
        self._hasher = hashlib.sha256(value.to_tsv().encode())

    def __len__(self):
        return len(self.data)

    @property
    def version(self) -> int:
        """Monotonic data version: bumps only when a contribution is
        accepted, so downstream fit caches (JobRepo.predictor_for) refit
        exactly when the data actually changed."""
        return self._version

    @property
    def fingerprint(self) -> str:
        """Content hash of the TSV encoding.  Unlike ``version`` (an
        in-process counter that restarts at 0), the fingerprint survives
        save/load round-trips, so persisted fit caches key on it to decide
        whether saved params still match the data on disk.

        Maintained as a chained digest: the hasher consumed the initial
        store's canonical TSV bytes once at construction and each accepted
        contribution's delta rows since.  Because SHA-256 is a stream hash,
        the chained value equals ``sha256(data.to_tsv())`` at every point —
        contribution boundaries leave no trace — while ``contribute`` pays
        O(delta), not O(N), to advance it."""
        return self._hasher.hexdigest()

    # ----------------------- epoch lifecycle ------------------------------
    @property
    def epoch(self) -> int:
        """Compaction epoch: 0 for a freshly constructed/loaded store,
        +1 per accepted ``compact`` transition.  Appends never change it —
        the (version, epoch) pair distinguishes an epoch transition (both
        moved) from a plain append (version only)."""
        return self._epoch

    @property
    def compactions(self) -> int:
        """Accepted compactions over this store's in-process lifetime."""
        return self._compactions

    @property
    def rows_contributed(self) -> int:
        """Lifetime ingest counter: seed rows plus every accepted
        contribution's rows.  Compaction does NOT decrease it — the
        retained/contributed ratio is the compaction frontier's x-axis."""
        return self._rows_contributed

    def restore_epoch(self, epoch: int, compactions: int = 0) -> None:
        """Fast-forward epoch metadata recorded out-of-process (the fits
        sidecar stamps it next to the fingerprint): a reloaded store starts
        at epoch 0, and a sidecar whose fingerprint matched proves the TSV
        on disk IS that later epoch's content.  Only ever moves forward."""
        if epoch > self._epoch:
            self._epoch = int(epoch)
            self._compactions = max(self._compactions, int(compactions))

    # ----------------------- trust plane ----------------------------------
    @property
    def trust_version(self) -> int:
        """Ledger version for downstream cache keys (-1 = no ledger).

        A REJECTED contribution never bumps ``version`` (no data changed)
        but does change its contributor's reputation — and therefore the
        reputation-derived row weights of rows ALREADY in the store at the
        next fit.  Fit/service caches must key on this alongside the data
        version."""
        return -1 if self.trust is None else self.trust.version

    def row_weights(self, view: RuntimeData) -> Optional[np.ndarray]:
        """Reputation-derived per-row fit weights for ``view`` (typically
        a cached ``machine_view`` of this store's data), or None when
        every row is at full weight — the None fast path keeps trust-free
        (and all-neutral) fits on the exact unweighted engine path."""
        if self.trust is None or len(view) == 0:
            return None
        vocab = view.contributors or (UNKNOWN_CONTRIBUTOR,)
        per = np.asarray([self.trust.row_weight(c) for c in vocab],
                         np.float64)
        if np.all(per >= 1.0 - 1e-12):
            return None
        if not view.contributors:        # pre-provenance store: all rows
            return np.full(len(view), per[0])
        return per[view.ccodes]

    def _reject_limit(self, baseline_mape: float,
                      threshold_scale: float = 1.0) -> float:
        """The §III-C.b acceptance limit, scaled by the contributor's
        reputation-derived strictness (scale < 1 = stricter)."""
        return (baseline_mape * self.reject_ratio + self.reject_slack) \
            * threshold_scale

    # ----------------------- persistence ---------------------------------
    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.data.to_tsv())
        os.replace(tmp, path)            # atomic, like checkpoints

    @classmethod
    def load(cls, path: str, schema: JobSchema, **kw) -> "RuntimeDataStore":
        with open(path) as f:
            return cls(RuntimeData.from_tsv(f.read(), schema), **kw)

    @staticmethod
    def _accountable_contributor(contribution: RuntimeData) -> str:
        """The identity a contribution's validation outcome is recorded
        against: its single contributor when provenance is unambiguous,
        else ``UNKNOWN_CONTRIBUTOR`` (mixed-provenance batches cannot pin
        blame on one collaborator; anonymous ones pool under the unknown
        identity, which down-weights unattributed data collectively if
        anonymous contributions keep failing)."""
        ids = sorted(contribution.contributor_counts())
        return ids[0] if len(ids) == 1 else UNKNOWN_CONTRIBUTOR

    # ----------------------- validation (§III-C.b) ------------------------
    def _model_specs(self):
        from repro_torch.core.models.api import get_model
        from repro_torch.core.predictor import DEFAULT_MODELS
        names = self.model_names or DEFAULT_MODELS
        return [get_model(n) for n in names]

    def _mape(self, train: RuntimeData, test: RuntimeData,
              machine: str) -> float:
        """Held-out MAPE of the best model in the pool for one machine type.

        All models fit through the engine (one dispatch each, single
        host pull) — no throwaway CV predictor is constructed per
        validation call.

        With a trust ledger the fit is REPUTATION-WEIGHTED (same weights
        the serving fits use): previously ingested suspect rows cannot
        balloon the baseline error — and with it the §III-C.b reject
        limit — so one accepted poison batch does not hold the door open
        for the next.  Validation measures the marginal damage a
        contribution would do under the weighting it would actually enter
        the store with."""
        from repro_torch.core import engine
        tr = train.machine_view(machine)
        te = test.machine_view(machine)
        if len(tr) < 5 or len(te) < 2:
            return np.nan
        return engine.holdout_mape(self._model_specs(), tr.X, tr.y,
                                   te.X, te.y,
                                   row_weight=self.row_weights(tr),
                                   device=self.device)

    def _stratified_split(self, rng) -> tuple:
        """Stratified-by-machine (holdout, train) index split.

        Each machine-type group is permuted independently and split 20/80,
        then each side is capped at ``max_validation_rows`` by water-filling
        (see ``_waterfill``): rare machine types keep all of their rows
        while frequent ones share the remaining budget.  A uniform
        permutation of the whole store (the previous scheme) could starve a
        rare machine below the 2-holdout/5-train minimum ``_mape`` needs,
        silently waving its contributions through unvalidated."""
        data = self.data
        holds, trains = [], []
        for m in data.present_machines():
            g = data.machine_indices(m)
            g = g[rng.permutation(len(g))]
            k = min(max(2, len(g) // 5), len(g))
            holds.append(g[:k])
            trains.append(g[k:])
        return (_waterfill(holds, self.max_validation_rows),
                _waterfill(trains, self.max_validation_rows))

    def validate(self, contribution: RuntimeData,
                 machine: Optional[str] = None,
                 threshold_scale: float = 1.0) -> ValidationReport:
        """Validate EVERY machine type present in the contribution.

        A mixed contribution used to be judged only against its first row's
        machine type, so poisoned rows for any other machine type entered
        the store unvalidated.  Now each machine-type group must pass on its
        own partition of the held-out set; one failing group rejects the
        whole contribution.  Groups the store holds too little data to
        judge are accepted (the paper's scheme needs existing points to
        validate against — that is how a new machine type bootstraps) but
        named in the report reason so the bypass is visible.  ``machine``
        restricts validation to one explicit machine type (legacy
        single-machine call sites).  ``threshold_scale`` scales the reject
        limit (< 1 = stricter; the trust plane passes the contributor's
        reputation-derived strictness)."""
        if len(contribution) == 0:
            return ValidationReport(
                False, np.nan, np.nan,
                "empty contribution: no rows to validate or ingest")
        rng = np.random.default_rng(self.seed)
        machines = ([machine] if machine is not None
                    else list(contribution.present_machines()))
        hold, rest = self._stratified_split(rng)
        test = self.data.subset(hold)
        train = self.data.subset(rest)
        # the candidate set keeps the FULL contribution on top of the capped
        # train subset — poisoned rows must never be sampled away
        cand_data = train.append(contribution)
        worst: Optional[ValidationReport] = None
        unjudged = []
        for m in machines:
            base = self._mape(train, test, m)
            cand = self._mape(cand_data, test, m)
            if np.isnan(base) or np.isnan(cand):
                unjudged.append(str(m))  # too little data to judge this group
                continue
            limit = self._reject_limit(base, threshold_scale)
            if cand > limit:
                return ValidationReport(
                    False, base, cand,
                    f"machine {m}: error {cand:.3f} exceeds {limit:.3f} "
                    f"(baseline {base:.3f}) — contribution rejected")
            if worst is None or cand - base > \
                    worst.candidate_mape - worst.baseline_mape:
                worst = ValidationReport(True, base, cand, "accepted")
        note = (f"; unvalidated (insufficient data): {', '.join(unjudged)}"
                if unjudged else "")
        if worst is None:
            return ValidationReport(True, np.nan, np.nan,
                                    "insufficient data for validation")
        return ValidationReport(True, worst.baseline_mape,
                                worst.candidate_mape, worst.reason + note)

    def contribute(self, contribution: RuntimeData,
                   contributor: Optional[str] = None) -> ValidationReport:
        """Validate and (if accepted) ingest incrementally: columnar append
        into tail capacity plus an O(delta) fingerprint-chain advance — the
        stored rows are never re-encoded or re-hashed.

        ``contributor`` stamps every contributed row with one collaborator
        identity (gateway provenance); rows already carrying per-row
        provenance are ingested as-is when it is None.  The first known
        contributor transitions the store's canonical TSV encoding to the
        provenance format, which re-seeds the fingerprint chain from the
        full re-encoded content once (O(N)); before and after the
        transition the chain advances per delta as usual, so the
        fingerprint always equals ``sha256(data.to_tsv())`` — and a store
        that never sees provenance keeps byte-identical legacy
        fingerprints."""
        from repro_torch.core.features import check_tsv_field
        # every ingest path (gateway, JobRepo, replay) funnels here: a
        # machine name or contributor id the TSV codec cannot round-trip
        # must never reach the persisted store — including per-row
        # provenance carried by the contribution itself (which bypasses
        # the constructors' own validation via from_columns)
        for m in contribution.machines:
            check_tsv_field(m, "machine type")
        for c in contribution.contributors:
            check_tsv_field(c, "contributor id")
        if contributor is not None:
            contribution = contribution.with_contributor(contributor)
        cid = self._accountable_contributor(contribution)
        scale = (1.0 if self.trust is None
                 else self.trust.threshold_scale(cid))
        report = self.validate(contribution, threshold_scale=scale)
        graced = False
        if (not report.accepted and self.trust is not None
                and len(contribution)
                and np.isfinite(report.baseline_mape)
                and np.isfinite(report.candidate_mape)
                and self.trust.allows_grace(cid)):
            # graceful degradation for contributors in high standing: a
            # near-miss is ingested anyway (their history says the data is
            # probably fine and the emulated validation split noisy) — but
            # only within GRACE_RATIO of the limit, and the zero-quality
            # outcome recorded below drains the reputation that earned the
            # grace, so repeated failures revert to hard rejection AND
            # down-weight the rows this grace let in
            limit = self._reject_limit(report.baseline_mape, scale)
            if report.candidate_mape <= limit * self.trust.GRACE_RATIO:
                graced = True
                report = ValidationReport(
                    True, report.baseline_mape, report.candidate_mape,
                    "accepted via graceful degradation (reputation "
                    f"{self.trust.reputation(cid):.2f}): {report.reason}")
        if (self.trust is not None and np.isfinite(report.baseline_mape)
                and np.isfinite(report.candidate_mape)):
            # judged contributions record an outcome (unjudged ones —
            # empty stores, bootstrap machine types — carry no evidence
            # about the contributor either way)
            quality = 0.0 if (graced or not report.accepted) else \
                self.trust.quality_of(
                    report.baseline_mape, report.candidate_mape,
                    self._reject_limit(report.baseline_mape, scale))
            self.trust.record_outcome(cid, report.accepted, quality)
        if report.accepted:
            was_provenance = self._data.has_provenance
            # bypass the data setter: the append only adds the delta rows,
            # so the chained hash advances in O(delta), not O(N)
            self._data = self._data.append(contribution)
            if not was_provenance and self._data.has_provenance:
                # encoding transition: every stored row gained the
                # contributor column, so the old chain's bytes no longer
                # prefix the canonical encoding — re-seed once
                self._hasher = hashlib.sha256(self._data.to_tsv().encode())
            else:
                # delta bytes in the STORE's format: a provenance-format
                # store encodes even an unknown-contributor delta with the
                # contributor column
                self._hasher.update(
                    contribution.tsv_delta_bytes(was_provenance))
            self._version += 1
            self._rows_contributed += len(contribution)
        return report

    # ----------------------- compaction (epoch transition) ----------------
    def _compaction_grid(self, cell_rel_width: float,
                         data: Optional[RuntimeData] = None) -> tuple:
        """Per-row (cell id, group id) over the coverage grid.

        A CELL is one (machine, context-cell, scale-out) triple — the unit
        the per-cell row cap applies to; a GROUP is its (machine,
        context-cell) projection across scale-outs — the unit the support
        floor protects.  Context cells come from ``_gap_bins`` so rows from
        different contributors collapse into shared coverage units."""
        data = self.data if data is None else data
        ctx = data.context
        parts = [data.codes.astype(np.float64)]
        parts += [_gap_bins(ctx[:, j], cell_rel_width).astype(np.float64)
                  for j in range(ctx.shape[1])]
        gkey = np.column_stack(parts)
        ckey = np.column_stack(parts + [data.scale_out.astype(np.float64)])
        _, grp = np.unique(gkey, axis=0, return_inverse=True)
        _, cell = np.unique(ckey, axis=0, return_inverse=True)
        return cell.reshape(-1), grp.reshape(-1)

    def _select_retained(self, cell: np.ndarray, grp: np.ndarray,
                         max_rows_per_cell: int, support_floor: int,
                         data: Optional[RuntimeData] = None) -> np.ndarray:
        """Boolean keep-mask: per-cell cap, reputation-first, spread-aware.

        Within each over-full cell, rows whose reputation row weight is
        strictly above the cell's k-th largest always stay; the remaining
        slots are filled from the weight-tied rows by greedy farthest-point
        (k-center) selection over the cell-normalized (context, runtime)
        space — a cell that swallowed a range of context values keeps rows
        covering ALL of its varying dimensions (and, for exact-duplicate
        configs, a spread of measured runtimes), not an arbitrary corner.
        A lone slot takes the cell medoid.  Fully deterministic: distance
        ties break on the lowest original row position (argmin/argmax).
        After capping, any (machine, context-cell) group below ``min(group
        size, support_floor)`` is topped back up with its best dropped
        rows."""
        data = self.data if data is None else data
        n = len(cell)
        w = self.row_weights(data)
        w = np.ones(n) if w is None else np.round(
            np.asarray(w, np.float64), 9)
        feats = np.column_stack([data.context, data.runtime])
        order = np.argsort(cell, kind="stable")
        cs = cell[order]
        bounds = np.r_[np.flatnonzero(np.r_[True, cs[1:] != cs[:-1]]), n]
        k = max_rows_per_cell
        keep = np.zeros(n, bool)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            rows = order[lo:hi]
            if hi - lo <= k:
                keep[rows] = True
                continue
            wc = w[rows]
            thr = np.partition(wc, hi - lo - k)[hi - lo - k]  # k-th largest
            above = wc > thr
            keep[rows[above]] = True
            need = k - int(above.sum())
            if need == 0:
                continue
            tied = rows[wc == thr]
            # per-cell min-max normalization; constant dims drop out
            f = feats[tied]
            span = f.max(axis=0) - f.min(axis=0)
            f = (f - f.min(axis=0)) / np.where(span > 0, span, 1.0)
            d = np.linalg.norm(f - f.mean(axis=0), axis=1)
            if need == 1:
                # medoid-like: the row closest to the cell centroid
                keep[tied[int(np.argmin(d))]] = True
                continue
            # seed with the row farthest off-center, then repeatedly add
            # the row farthest from everything chosen so far
            pick = int(np.argmax(d))
            keep[tied[pick]] = True
            dist = np.linalg.norm(f - f[pick], axis=1)
            for _ in range(need - 1):
                pick = int(np.argmax(dist))
                keep[tied[pick]] = True
                dist = np.minimum(dist,
                                  np.linalg.norm(f - f[pick], axis=1))
        # support floor: top up shorted groups with their best dropped rows
        n_grp = int(grp.max()) + 1
        deficit = np.maximum(
            support_floor - np.bincount(grp[keep], minlength=n_grp), 0)
        if deficit.any():
            prio = np.lexsort((np.arange(n), -w))
            ordpos = np.empty(n, np.int64)
            ordpos[prio] = np.arange(n)
            drop = np.where(~keep)[0]
            o3 = drop[np.lexsort((ordpos[drop], grp[drop]))]
            gstarts = np.searchsorted(grp[o3], np.arange(n_grp))
            grank = np.arange(len(o3)) - gstarts[grp[o3]]
            keep[o3[grank < deficit[grp[o3]]]] = True
        return keep

    def _compaction_gate(self, keep: np.ndarray, retained: np.ndarray,
                         accuracy_budget: float, rng,
                         max_rows_per_cell: int, support_floor: int,
                         cell_rel_width: float) -> tuple:
        """Engine-backed "accuracy holds" check for a compaction candidate.

        Collaborative stores are judged the way they are USED: leave one
        contributor out (up to three, drawn without replacement under the
        compaction seed), rerun the REDUCTION POLICY on the remaining
        rows, refit on them twice — full vs policy-reduced — and compare
        bucketed holdout MAPE per machine type on the held-out
        contributor's measurements, averaged across held contributors.
        Rerunning the selection per split matters: subtracting the held
        contributor from the full-store selection would strip exactly the
        coverage rows chosen near their contexts and misread coverage loss
        as policy damage.  A stratified row split would err the other way,
        testing same-context in-fill where losing near-duplicate
        neighbours reads as damage even when cross-contributor
        generalization — the serving task — is unharmed.  Provenance-free
        stores (no known contributors) fall back to testing on the DROPPED
        stratified-holdout rows, unseen by either side.

        Returns ``(reason, baseline_mape, candidate_mape)``; ``reason`` is
        ``None`` when every judged machine holds the budget, else the
        typed rollback message.  The reported pair is the judged machine
        with the worst degradation."""
        data = self.data

        def capped(idx: np.ndarray) -> np.ndarray:
            if len(idx) <= self.max_validation_rows:
                return idx
            codes = data.codes[idx]
            parts = [idx[codes == c][rng.permutation(
                int(np.sum(codes == c)))] for c in np.unique(codes)]
            return np.asarray(_waterfill(parts, self.max_validation_rows))

        def judge(splits) -> dict:
            per: dict = {}
            for test_idx, base_idx, cand_idx in splits:
                test = data.subset(np.sort(test_idx))
                base_d = data.subset(np.sort(capped(base_idx)))
                cand_d = data.subset(np.sort(capped(cand_idx)))
                for m in test.present_machines():
                    b = self._mape(base_d, test, m)
                    c = self._mape(cand_d, test, m)
                    if np.isnan(b) or np.isnan(c):
                        continue      # too little data to judge this group
                    per.setdefault(m, []).append((b, c))
            return {m: (float(np.mean([p[0] for p in v])),
                        float(np.mean([p[1] for p in v])))
                    for m, v in per.items()}

        splits = []
        ids = data.contributor
        uniq = np.unique(ids[ids != UNKNOWN_CONTRIBUTOR])
        if len(uniq) >= 3:            # leave-one-contributor-out gate
            held = rng.choice(uniq, size=min(3, len(uniq)), replace=False)
            for h in held:
                mask = ids == h
                test_idx = np.where(mask)[0]
                base_idx = np.where(~mask)[0]
                if not len(test_idx) or not len(base_idx):
                    continue
                view = data.subset(base_idx)
                vcell, vgrp = self._compaction_grid(cell_rel_width, view)
                vkeep = self._select_retained(vcell, vgrp, max_rows_per_cell,
                                              support_floor, view)
                splits.append((test_idx, base_idx, base_idx[vkeep]))
        per = judge(splits) if splits else {}
        if not per:                   # provenance-free (or unjudgeable)
            hold, rest = self._stratified_split(rng)
            hold_eff = hold[~keep[hold]]
            if len(hold_eff):
                per = judge([(hold_eff, np.asarray(rest), retained)])
        worst = (float("nan"), float("nan"))
        for m in sorted(per):
            b, c = per[m]
            if c > b + accuracy_budget:
                return (f"accuracy budget exceeded on machine {m}: "
                        f"candidate MAPE {c:.4f} > baseline {b:.4f} + "
                        f"budget {accuracy_budget:g} — rolled back", b, c)
            if np.isnan(worst[0]) or c - b > worst[1] - worst[0]:
                worst = (b, c)
        return None, worst[0], worst[1]

    def compact(self, *, max_rows_per_cell: int = 4, support_floor: int = 2,
                cell_rel_width: float = 0.15, accuracy_budget: float = 0.01,
                min_store_rows: int = 64,
                seed: Optional[int] = None) -> CompactionReport:
        """Epoch transition via coverage-aware training-data reduction.

        Downsamples the store over the (machine x context-cell x scale-out)
        grid: each occupied cell keeps at most ``max_rows_per_cell`` rows
        (highest reputation first), each (machine, context-cell) group
        keeps at least ``min(group size, support_floor)``.  The transition
        is gated on an engine-backed accuracy check: the candidate reduced
        training set must hold bucketed holdout MAPE within
        ``accuracy_budget`` (additive, percentage points as a fraction) of
        the pre-compaction baseline per machine type, else the attempt
        rolls back untouched.  ``accuracy_budget=inf`` skips the gate.

        Accepting re-seeds the fingerprint chain from the retained rows'
        canonical TSV once (the data-setter path, like the provenance
        transition) and bumps version AND epoch; a rejected attempt is a
        strict no-op with a typed ``compaction_rejected`` code."""
        if max_rows_per_cell < 1:
            raise ValueError("max_rows_per_cell must be >= 1")
        if support_floor < 0:
            raise ValueError("support_floor must be >= 0")
        if not 0 < cell_rel_width <= 1:
            # > 1 would let row removal erase a cell split (see _gap_bins),
            # breaking compaction idempotence
            raise ValueError("cell_rel_width must be in (0, 1]")
        n = len(self.data)

        def rejected(reason: str, b: float = float("nan"),
                     c: float = float("nan"),
                     cells: int = 0) -> CompactionReport:
            report = CompactionReport(False, COMPACTION_REJECTED, reason,
                                      n, n, self._epoch, cells=cells,
                                      baseline_mape=float(b),
                                      candidate_mape=float(c))
            self.last_compaction = report
            return report

        if n < max(min_store_rows, 1):
            return rejected(
                f"store too small to compact: {n} rows < "
                f"min_store_rows={max(min_store_rows, 1)}")
        cell, grp = self._compaction_grid(cell_rel_width)
        n_cells = int(cell.max()) + 1
        if support_floor > 0:
            counts = np.bincount(grp)
            short = int(np.sum(counts < support_floor))
            if short:
                return rejected(
                    f"{short} (machine, context-cell) group(s) hold fewer "
                    f"than support_floor={support_floor} rows: compacting "
                    "would drop them below the floor")
        rng = np.random.default_rng(self.seed if seed is None else seed)
        keep = self._select_retained(cell, grp, max_rows_per_cell,
                                     support_floor)
        rows_after = int(keep.sum())
        if rows_after >= n:
            return rejected(
                f"already compact at this resolution: every occupied cell "
                f"holds <= {max_rows_per_cell} row(s), nothing to remove")
        retained = np.where(keep)[0]      # ascending: original row order
        base_mape = cand_mape = np.nan
        if np.isfinite(accuracy_budget):
            reason, base_mape, cand_mape = self._compaction_gate(
                keep, retained, accuracy_budget, rng, max_rows_per_cell,
                support_floor, cell_rel_width)
            if reason is not None:
                return rejected(reason, base_mape, cand_mape, n_cells)
        self.data = self.data.subset(retained)   # setter re-seeds the chain
        self._version += 1
        self._epoch += 1
        self._compactions += 1
        report = CompactionReport(
            True, COMPACTED,
            f"compacted {n} -> {rows_after} rows over {n_cells} cells",
            n, rows_after, self._epoch, cells=n_cells,
            baseline_mape=float(base_mape), candidate_mape=float(cand_mape))
        self.last_compaction = report
        return report
