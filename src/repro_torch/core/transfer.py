"""Cross-job cold-start transfer: Flora-style job similarity (PAPERS.md,
arxiv 2502.21046).

C3O's runtime models need per-job history, so a real hub is permanently
in cold-start for some jobs.  Flora's answer is classification: relate a
NEW job to jobs that already have history and reuse their resource
knowledge.  This module implements the data side of that idea over the
columnar store:

  * ``job_signature`` compresses one job's shared runtime data into a
    fixed-size, schema-agnostic :class:`JobSignature` — per-machine
    log-runtime quantile sketches plus a (scale-out x data-size)
    occupancy histogram — computed vectorized over the columns (no
    per-row Python loops);
  * ``similarity`` scores two signatures in ``[0, 1]``: symmetric,
    invariant under row/contribution order (quantiles and histograms are
    permutation-free), and maximal for a signature against itself
    (``tests/test_torch_transfer.py`` checks all three);
  * ``TransferIndex`` is the hub-side nearest-job lookup.  Signatures
    and pairwise similarities are cached keyed on each store's
    ``(version, epoch)``, so repeated lookups are dictionary hits until
    a contribution or compaction actually changes the data.

The gateway uses ``TransferIndex.nearest`` to serve ``predict``/``choose``
for unknown or under-supported jobs from the nearest donor's fitted
models, answering envelopes stamped with ``transfer_source`` and a
discounted ``transfer_confidence`` instead of an ``unknown_job`` error.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.features import RuntimeData

#: interior deciles of the per-machine log-runtime distribution — enough
#: to separate the emulated job families, small enough that a signature
#: is a few hundred bytes
_QUANTILES = np.linspace(0.1, 0.9, 9)

#: fixed occupancy grid: scale-out in log2 bins (1..2048 nodes), data
#: size in sixth-decade log10 bins (1e-2..1e4 GB — fine enough that
#: e.g. 10/20/30 GB working sets land in distinct bins).  Fixed global
#: bins — not per-job adaptive ones — so occupancy vectors of different
#: jobs are directly comparable
_SCALE_BINS = 12
_SIZE_BINS = 36


@dataclass(frozen=True)
class TransferPolicy:
    """Knobs of the cold-start fallback.

    ``min_rows`` splits the world: jobs with at least this many stored
    rows are donors and serve themselves; jobs below it (including
    unpublished ones) borrow.  ``discount`` converts a similarity into
    the envelope's ``transfer_confidence`` — borrowed answers are never
    reported at full confidence.  ``min_similarity`` refuses donors that
    match the probe no better than noise; ``unknown_prior`` is the
    (pre-discount) confidence basis when the job has NO rows at all and
    the lookup can only fall back to the best-supported
    schema-compatible donor."""
    min_rows: int = 24
    discount: float = 0.8
    min_similarity: float = 0.05
    unknown_prior: float = 0.25


@dataclass(frozen=True)
class JobSignature:
    """Fixed-size sketch of one job's runtime data (see module docstring).

    ``machines`` is SORTED (not first-appearance order) so signatures are
    invariant under row permutation; ``runtime_q`` holds one tuple of
    log-runtime quantiles per machine, aligned with ``machines``."""
    job: str
    n_features: int
    rows: int
    machines: Tuple[str, ...]
    runtime_q: Tuple[Tuple[float, ...], ...]
    counts: Tuple[int, ...]
    occupancy: Tuple[float, ...]
    #: one log10-quantile sketch per context feature BEYOND data size
    #: (empty for context-free jobs like sort) — k-means' k in 3..9 and
    #: SGD's iterations in 10..100 occupy visibly different ranges, which
    #: is what separates families whose runtimes overlap
    context_q: Tuple[Tuple[float, ...], ...] = ()


@dataclass(frozen=True)
class TransferMatch:
    """One nearest-job lookup answer: borrow ``source``'s fitted models.

    ``similarity`` is the raw signature score (0.0 when the borrowing job
    had no rows to sketch); ``confidence`` is what the gateway stamps on
    envelopes — similarity (or the unknown-job prior) times the policy
    discount."""
    source: str
    similarity: float
    confidence: float


def job_signature(data: RuntimeData, job: Optional[str] = None
                  ) -> JobSignature:
    """Sketch ``data`` into a :class:`JobSignature`, vectorized.

    Works on any non-empty ``RuntimeData`` — donors' full stores and
    a new job's few probe rows go through the same code path."""
    if len(data) == 0:
        raise ValueError("cannot sketch a job with no runtime data")
    machines = tuple(sorted(data.present_machines()))
    runtime_q = []
    counts = []
    for m in machines:
        view = data.machine_view(m)
        q = np.quantile(np.log(np.maximum(view.runtime, 1e-9)), _QUANTILES)
        runtime_q.append(tuple(float(v) for v in q))
        counts.append(len(view))
    sbin = np.clip(np.floor(np.log2(np.maximum(data.scale_out, 1.0))),
                   0, _SCALE_BINS - 1).astype(np.int64)
    size = np.maximum(data.context[:, 0], 1e-9)
    zbin = np.clip(np.floor(6.0 * np.log10(size)) + 12,
                   0, _SIZE_BINS - 1).astype(np.int64)
    hist = np.bincount(sbin * _SIZE_BINS + zbin,
                       minlength=_SCALE_BINS * _SIZE_BINS)
    occ = hist.astype(np.float64) / len(data)
    ctx = np.log10(np.maximum(np.abs(data.context[:, 1:]), 1e-9))
    context_q = tuple(
        tuple(float(v) for v in np.quantile(ctx[:, j], _QUANTILES))
        for j in range(ctx.shape[1]))
    return JobSignature(
        job if job is not None else data.schema.job,
        data.schema.n_features, len(data), machines,
        tuple(runtime_q), tuple(counts), tuple(float(v) for v in occ),
        context_q)


def similarity(a: JobSignature, b: JobSignature) -> float:
    """Signature similarity in ``[0, 1]``: symmetric in (a, b), and 1.0
    for a signature against itself.

    Three components: histogram intersection of the (scale-out x data
    size) occupancy grids (which execution regimes the jobs visit),
    ``exp(-d)`` of the mean L1 distance between log-runtime quantile
    sketches over the machines BOTH jobs have run on (how the jobs
    behave where they are comparable), and ``exp(-d)`` over the context
    quantile sketches (whether the jobs' parameter spaces coincide —
    context-free pairs score 1.0 there, incompatible widths 0.0).  No
    shared machine zeroes the runtime component — occupancy and context
    alone can still rank donors."""
    occ = float(np.minimum(np.asarray(a.occupancy),
                           np.asarray(b.occupancy)).sum())
    shared = sorted(set(a.machines) & set(b.machines))
    if shared:
        qa = np.asarray([a.runtime_q[a.machines.index(m)] for m in shared])
        qb = np.asarray([b.runtime_q[b.machines.index(m)] for m in shared])
        run = float(np.exp(-np.mean(np.abs(qa - qb))))
    else:
        run = 0.0
    if len(a.context_q) != len(b.context_q):
        ctx = 0.0
    elif not a.context_q:
        ctx = 1.0
    else:
        ctx = float(np.exp(-np.mean(np.abs(
            np.asarray(a.context_q) - np.asarray(b.context_q)))))
    return 0.4 * run + 0.3 * occ + 0.3 * ctx


class TransferIndex:
    """Hub-side nearest-job lookup with store-version-keyed caching.

    Signatures are cached per job keyed on the store's
    ``(version, epoch)`` — an accepted contribution or an epoch
    transition invalidates exactly that job's entry.  Pairwise
    similarities are cached keyed on BOTH jobs' cache keys, so a lookup
    against unchanged stores is pure dictionary traffic
    (``stats["signature_builds"]`` / ``stats["pair_evals"]`` stay flat;
    ``tests/test_torch_transfer.py`` checks it)."""

    def __init__(self, hub, policy: Optional[TransferPolicy] = None):
        self.hub = hub
        self.policy = policy if policy is not None else TransferPolicy()
        # job -> ((version, epoch), JobSignature)
        self._sigs: Dict[str, tuple] = {}
        # (job_a, key_a, job_b, key_b) normalized a<b -> similarity
        self._pairs: Dict[tuple, float] = {}
        self.stats: Dict[str, int] = {
            "lookups": 0, "signature_builds": 0, "pair_evals": 0}

    # ------------------------- cached primitives --------------------------
    def _key(self, job: str) -> tuple:
        store = self.hub.get(job).store
        return (store.version, store.epoch)

    def signature(self, job: str) -> Optional[JobSignature]:
        """Cached signature of a published job; None while it has no rows."""
        repo = self.hub.get(job)
        if len(repo.store) == 0:
            return None
        key = (repo.store.version, repo.store.epoch)
        entry = self._sigs.get(job)
        if entry is None or entry[0] != key:
            self.stats["signature_builds"] += 1
            entry = (key, job_signature(repo.store.data, job))
            self._sigs[job] = entry
            # drop pair entries computed against the superseded signature
            for k in [k for k in self._pairs
                      if (k[0] == job and k[1] != key)
                      or (k[2] == job and k[3] != key)]:
                del self._pairs[k]
        return entry[1]

    def _pair(self, a: str, b: str) -> float:
        """Cached ``similarity(signature(a), signature(b))``; symmetric."""
        if a > b:
            a, b = b, a
        key = (a, self._key(a), b, self._key(b))
        sim = self._pairs.get(key)
        if sim is None:
            self.stats["pair_evals"] += 1
            sim = similarity(self.signature(a), self.signature(b))
            self._pairs[key] = sim
        return sim

    # ------------------------- lookup -------------------------------------
    def donors(self, n_features: Optional[int] = None,
               exclude: str = "") -> List[str]:
        """Jobs with enough history to lend models, sorted by name."""
        out = []
        for job in self.hub.jobs():
            if job == exclude:
                continue
            repo = self.hub.get(job)
            if len(repo.store) < self.policy.min_rows:
                continue
            if n_features is not None \
                    and repo.schema.n_features != n_features:
                continue
            out.append(job)
        return out

    def nearest(self, job: str, n_features: Optional[int] = None
                ) -> Optional[TransferMatch]:
        """Best donor for ``job``, or None when transfer cannot help.

        A job published with SOME rows (even a handful of probe
        measurements, too few to fit) is ranked by signature similarity;
        a job with no rows at all falls back to the best-supported
        schema-compatible donor at the low ``unknown_prior`` confidence.
        Ties break deterministically on (similarity, donor name)."""
        self.stats["lookups"] += 1
        pool = self.donors(n_features, exclude=job)
        if not pool:
            return None
        try:
            probe = self.signature(job)
        except KeyError:
            probe = None
        if probe is None:
            source = max(pool, key=lambda j: (len(self.hub.get(j).store), j))
            return TransferMatch(
                source, 0.0,
                self.policy.unknown_prior * self.policy.discount)
        scored = sorted(((self._pair(job, d), d) for d in pool),
                        key=lambda t: (-t[0], t[1]))
        sim, source = scored[0]
        if sim < self.policy.min_similarity:
            return None
        return TransferMatch(source, sim, sim * self.policy.discount)
