"""Calibrated emulators of the paper's five Spark jobs (Table I).

The paper's AWS/EMR runtime dataset (dos-group/c3o-experiments) is not
available offline; this module regenerates a dataset with the *same
structure* — 126 Sort / 162 Grep / 180 SGD / 180 K-Means / 282 PageRank
unique configurations, the same feature counts (3+0 … 3+2) and parameter
ranges — from first-principles runtime laws:

  parallel read/scan  ~ size / (io * scale_out)
  shuffle             ~ size / scale_out^0.85         (network overhead)
  per-iteration sync  ~ log(scale_out)                (barriers)
  startup             ~ a + b * scale_out             (provisioning)
  memory cliff: iterative jobs that do not fit in cluster memory re-read
  from disk every iteration (paper §IV-B) -> large discontinuous penalty.

Each unique configuration is "run" five times with log-normal noise plus
occasional stragglers, and the median is kept (paper §VI-B).
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.features import JobSchema, RuntimeData


@dataclass(frozen=True)
class Machine:
    name: str
    cpu: float          # relative compute throughput
    mem_gb: float       # memory per node usable for caching
    io: float           # relative disk/network throughput
    price: float        # $ per node-hour


MACHINES: Dict[str, Machine] = {
    "m5.xlarge": Machine("m5.xlarge", 1.0, 16.0, 1.0, 0.192),
    "c5.xlarge": Machine("c5.xlarge", 1.45, 8.0, 1.0, 0.170),
    "r5.xlarge": Machine("r5.xlarge", 1.0, 32.0, 0.95, 0.252),
}

SCHEMAS: Dict[str, JobSchema] = {
    "sort": JobSchema("sort", ()),
    "grep": JobSchema("grep", ("kw_hit_ratio",)),
    "sgd": JobSchema("sgd", ("iterations", "n_features")),
    "kmeans": JobSchema("kmeans", ("k", "dim")),
    "pagerank": JobSchema("pagerank", ("convergence", "unique_pages")),
}


# ---------------------------------------------------------------------------
# deterministic runtime laws (seconds)
# ---------------------------------------------------------------------------

def _startup(s: float) -> float:
    return 12.0 + 0.45 * s


def _mem_cliff(data_mem_gb: float, m: Machine, s: float) -> float:
    """>1 multiplier on per-iteration work when the dataset misses memory."""
    fit = data_mem_gb / (0.80 * m.mem_gb * s)
    return 1.0 if fit <= 1.0 else 2.1 + 0.5 * min(fit - 1.0, 2.0)


def sort_time(m: Machine, s: float, z: float) -> float:
    read = 9.0 * z / (m.io * s)
    cpu = 1.3 * z * math.log2(z * 64.0) / (m.cpu * s)
    shuffle = 2.4 * z / s ** 0.85
    write = 6.0 * z / (m.io * s)
    return read + cpu + shuffle + write + _startup(s)


def grep_time(m: Machine, s: float, z: float, kw: float) -> float:
    read = 9.0 * z / (m.io * s)
    scan = 3.1 * z / (m.cpu * s)
    # matches are written back (and shuffled for dedup): dominant when the
    # keyword is frequent — the context feature Ernest cannot see
    write = 420.0 * z * kw / (m.io * s) + 95.0 * z * kw / s ** 0.8
    return read + scan + write + _startup(s)


def sgd_time(m: Machine, s: float, z: float, iters: float,
             n_features: float) -> float:
    read = 9.0 * z / (m.io * s)
    cliff = _mem_cliff(1.15 * z, m, s)
    per_iter = (0.30 * z * (n_features / 50.0) / (m.cpu * s)) * cliff \
        + 0.22 * math.log2(s + 1)
    return read + iters * per_iter + _startup(s)


def kmeans_time(m: Machine, s: float, z: float, k: float, dim: float) -> float:
    read = 9.0 * z / (m.io * s)
    iters = (2.0 + 0.9 * k) * (1.0 + 0.15 * dim / 10.0)
    cliff = _mem_cliff(1.0 * z, m, s)
    per_iter = (0.16 * z * k * (dim / 10.0) / (m.cpu * s)) * cliff \
        + 0.05 * k * math.log2(s + 1)
    return read + iters * per_iter + _startup(s)


def pagerank_time(m: Machine, s: float, z: float, conv: float,
                  pages: float) -> float:
    links = z * 42e6          # edges per GB of edge-list text
    iters = math.ceil(math.log10(1.0 / conv)) + 3
    graph_mem = pages * 1.3e-7 + z * 2.0
    cliff = _mem_cliff(graph_mem, m, s)
    per_iter = ((links * 1.3e-8 + pages * 2.2e-7) / (m.cpu * s)) * cliff \
        + 0.35 * math.log2(s + 1)
    return 9.0 * z / (m.io * s) + iters * per_iter + _startup(s)


TIME_FNS: Dict[str, Callable] = {
    "sort": sort_time, "grep": grep_time, "sgd": sgd_time,
    "kmeans": kmeans_time, "pagerank": pagerank_time,
}


def true_runtime(job: str, machine: str, s: float, features: Tuple) -> float:
    """Noise-free ground truth (configurator oracles in tests)."""
    return TIME_FNS[job](MACHINES[machine], s, *features)


def derived_rng(*key) -> np.random.Generator:
    """Deterministic generator seeded from SHA-256 of a structured identity
    key (independent of PYTHONHASHSEED).  The SINGLE definition of the
    hash-to-seed mapping: measurement noise streams, user designs, and the
    eval replay plane all derive their RNGs here, so the byte layout of the
    seed can never drift between modules (which would silently change every
    fingerprint the harness reports)."""
    digest = hashlib.sha256("|".join(map(str, key)).encode()).digest()[:8]
    return np.random.default_rng(int.from_bytes(digest, "little"))


# ---------------------------------------------------------------------------
# noisy measurement: 5 repetitions, median (paper §VI-B)
# ---------------------------------------------------------------------------

def _measure(job: str, machine: str, s: float, features: Tuple,
             seed: int, noise: float = 0.02, reps: int = 5) -> float:
    rng = derived_rng(job, machine, s, features, seed)
    base = true_runtime(job, machine, s, features)
    runs = base * rng.lognormal(0.0, noise, size=reps)
    straggler = rng.random(reps) < 0.04
    runs = np.where(straggler, runs * rng.uniform(1.25, 2.2, size=reps), runs)
    return float(np.median(runs))


# ---------------------------------------------------------------------------
# dataset generation (Table I layout)
# ---------------------------------------------------------------------------

_SCALEOUTS7 = [2, 3, 4, 6, 8, 12, 16]
_SCALEOUTS6 = [2, 3, 4, 6, 8, 12]


def _pick(grid: List[Tuple], k: int, seed: int) -> List[Tuple]:
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(grid), size=k, replace=False)
    return [grid[i] for i in sorted(idx)]


def _job_cells(job: str) -> Tuple[List[Tuple], List[int]]:
    """Canonical ((size, ctx...) cells, scale-out grid) for one job."""
    if job == "sort":
        sizes = [10, 12, 14, 16, 18, 20]
        return [(z,) for z in sizes], _SCALEOUTS7
    if job == "grep":
        return [(z, kw) for z in [10, 15, 20]
                for kw in [0.002, 0.02, 0.08]], _SCALEOUTS6
    if job == "sgd":
        # 5 contexts x 2 sizes: every context group spans sizes AND
        # scale-outs (the optimistic SSM needs same-context groups)
        ctxs = [(10, 50), (25, 100), (40, 50), (70, 100), (100, 50)]
        return [(z, it, f) for (it, f) in ctxs for z in [10, 30]], _SCALEOUTS6
    if job == "kmeans":
        ctxs = [(3, 10), (5, 30), (6, 10), (8, 30), (9, 10)]
        return [(z, k, d) for (k, d) in ctxs for z in [10, 20]], _SCALEOUTS6
    if job == "pagerank":
        ctxs = [(0.01, 2e5), (0.001, 1e6), (0.001, 5e6), (0.0001, 5e6),
                (0.0001, 2e7), (0.01, 1e6), (0.001, 2e7), (0.0001, 1e6)]
        return [(z, c, u) for (c, u) in ctxs
                for z in [0.13, 0.44]], _SCALEOUTS6
    raise ValueError(job)


def job_design(job: str, seed: int = 7) -> List[Tuple[str, float, Tuple]]:
    """Unique (machine, scale_out, (size, ctx...)) configurations."""
    machines = list(MACHINES)
    cells, scale = _job_cells(job)
    design = [(m, float(s), tuple(map(float, cell)))
              for m in machines for s in scale for cell in cells]
    if job == "pagerank":        # 3*6*16=288 -> drop 6 cells (Table I: 282)
        rng = np.random.default_rng(seed + 3)
        drop = set(rng.choice(len(design), 6, replace=False).tolist())
        design = [d for i, d in enumerate(design) if i not in drop]
    return design


# Which cell components a user's execution context may perturb smoothly:
# the PHYSICALLY continuous ones — dataset size (component 0 everywhere),
# grep's keyword-hit ratio, pagerank's page count.  Integer job parameters
# (k, iterations, n_features, dim) stay on the canonical grid: a user runs
# k-means with k=3, not k=3.07.  Jittering them would also make every
# user's context block a unique fingerprint perfectly confounded with that
# user's data size — greedy tree splits then separate users on meaningless
# epsilon differences in k and inherit the wrong user's size regime, an
# artifact of the emulation rather than the paper's setting.  pagerank's
# convergence threshold also stays fixed: the iteration count is a ceil()
# of it, so an epsilon perturbation across the 10^-k boundary jumps the
# true runtime discontinuously.
_JITTERABLE: Dict[str, Tuple[int, ...]] = {
    "sort": (0,), "grep": (0, 1), "sgd": (0,), "kmeans": (0,),
    "pagerank": (0, 2),
}


def _user_rng(job: str, user: int, seed: int) -> np.random.Generator:
    return derived_rng("user", job, user, seed)


def user_design(job: str, user: int, seed: int = 0, n_cells: int = 4,
                n_scale: int = 5,
                jitter: float = 0.10) -> List[Tuple[str, float, Tuple]]:
    """One collaborating user's execution context (paper §VI-C "global").

    Users share the job but not the exact context: each draws its own
    subset of context cells and scale-outs from the canonical grids, then
    perturbs the continuous cell components (dataset size, keyword ratio,
    iterations, ...) multiplicatively by up to ``jitter``.  Perturbation is
    applied once per cell — within a user every context group still spans
    all of its scale-outs (the optimistic SSM needs same-context groups) —
    while across users contexts never coincide, which is exactly the
    heterogeneity the leave-one-user-out replay measures generalization
    over.  The row count is a user-independent constant
    (machines x n_scale x n_cells) so replayed store sizes are identical
    across held-out users and the engine's shape-bucketed executables are
    shared."""
    rng = _user_rng(job, user, seed)
    cells, scale = _job_cells(job)
    pick_c = sorted(rng.choice(len(cells), size=min(n_cells, len(cells)),
                               replace=False).tolist())
    pick_s = sorted(rng.choice(len(scale), size=min(n_scale, len(scale)),
                               replace=False).tolist())
    jitterable = _JITTERABLE[job]
    ucells = []
    for ci in pick_c:
        cell = [float(v) for v in cells[ci]]
        for j in jitterable:
            cell[j] *= float(rng.uniform(1.0 - jitter, 1.0 + jitter))
        ucells.append(tuple(cell))
    return [(m, float(scale[si]), cell)
            for m in MACHINES for si in pick_s for cell in ucells]


def _measure_design(job: str, design: List[Tuple[str, float, Tuple]],
                    seed: int, schema: JobSchema = None,
                    runtime_scale: float = 1.0) -> RuntimeData:
    """Emulated dataset for one design, assembled straight into the
    columnar layout.

    The measurement loop is inherently per-configuration (each cell's noise
    stream is seeded from its identity hash), but the columns are written
    into preallocated arrays and adopted zero-copy by ``from_columns`` —
    no intermediate Python row lists.  ``schema`` defaults to the canonical
    one for ``job``; cold-job emulation passes its renamed schema and a
    per-job efficiency ``runtime_scale``."""
    if schema is None:
        schema = SCHEMAS[job]
    machines = tuple(MACHINES)
    code_of = {m: i for i, m in enumerate(machines)}
    n = len(design)
    codes = np.empty(n, np.int32)
    scale_out = np.empty(n, np.float64)
    context = np.empty((n, schema.n_features - 1), np.float64)
    runtime = np.empty(n, np.float64)
    for i, (machine, s, cell) in enumerate(design):
        codes[i] = code_of[machine]
        scale_out[i] = s
        context[i] = cell
        runtime[i] = _measure(job, machine, s, cell, seed) * runtime_scale
    return RuntimeData.from_columns(schema, machines, codes, scale_out,
                                    context, runtime)


def generate_job_data(job: str, seed: int = 0) -> RuntimeData:
    """The paper's Table I dataset layout (one pooled global dataset)."""
    return _measure_design(job, job_design(job), seed)


def generate_user_data(job: str, user: int, seed: int = 0,
                       **design_kw) -> RuntimeData:
    """One user's contribution-ready runtime data: their perturbed design
    (``user_design``) measured with a user-specific noise stream."""
    design = user_design(job, user, seed, **design_kw)
    return _measure_design(job, design, seed * 10007 + user + 1)


# ---------------------------------------------------------------------------
# adversarial user emulation (trust-plane evaluation)
# ---------------------------------------------------------------------------

#: attack repertoire for emulated poisoners.  Each corrupts an honest
#: user's dataset a different way; all are deliberately MODERATE —
#: egregious corruption is caught by plain §III-C.b validation, so the
#: interesting adversary is the one whose data partially slips through
#: and must be handled by reputation weighting:
#:   scale  — systematic runtime inflation (a mis-calibrated or lying
#:            harness reporting ~1.3x the true runtimes)
#:   noise  — high-variance measurements (no medians, single flaky runs)
#:   shift  — column shift: under-reports the dataset size feature, so
#:            runtimes attach to the wrong inputs
#:   spam   — high-volume near-duplicates of a few measurements (one real
#:            run uploaded many times with cosmetic jitter)
ADVERSARY_KINDS = ("scale", "noise", "shift", "spam")


def adversarial_user_data(job: str, user: int, seed: int, kind: str,
                          **design_kw) -> RuntimeData:
    """A poisoner's contribution-ready dataset: the honest measurements
    this user WOULD have produced (``generate_user_data``), corrupted by
    attack ``kind``.  Deterministic in (kind, job, user, seed) via
    ``derived_rng``, like everything the replay planes consume."""
    if kind not in ADVERSARY_KINDS:
        raise ValueError(f"unknown adversary kind {kind!r} "
                         f"(known: {', '.join(ADVERSARY_KINDS)})")
    data = generate_user_data(job, user, seed, **design_kw)
    rng = derived_rng("adversary", kind, job, user, seed)
    X = np.array(data.X, np.float64)
    y = np.array(data.y, np.float64)
    machines = np.asarray(data.machine_type)
    if kind == "scale":
        y = y * rng.uniform(1.25, 1.45, size=len(y))
    elif kind == "noise":
        y = y * rng.lognormal(0.0, 0.4, size=len(y))
    elif kind == "shift":
        # context column 0 (feature column 1: scale-out rides first) is
        # the dataset size in every job schema
        X[:, 1] = X[:, 1] * rng.uniform(0.55, 0.75, size=len(y))
    elif kind == "spam":
        take = rng.choice(len(y), size=max(1, len(y) // 4), replace=False)
        reps = 3 * (len(y) // max(1, len(take)))
        idx = np.sort(np.tile(np.sort(take), reps))
        X = X[idx]
        machines = machines[idx]
        y = y[idx] * rng.lognormal(0.0, 0.05, size=len(idx))
    return RuntimeData(data.schema, machines, X, y)


# ---------------------------------------------------------------------------
# cold-job emulation (zero-history cross-job transfer evaluation)
# ---------------------------------------------------------------------------

def cold_job_name(job: str) -> str:
    """Name of the held-out zero-history twin of a canonical job family."""
    return f"{job}-cold"


def cold_schema(job: str) -> JobSchema:
    """Schema of the cold twin: same feature layout, different job name —
    the hub treats it as a completely separate job with no history."""
    base = SCHEMAS[job]
    return JobSchema(cold_job_name(job), base.context_features,
                     base.base_features)


def cold_efficiency(job: str, seed: int = 0) -> float:
    """Systematic runtime offset of the cold twin vs its family (a
    different input dataset / code version running the same algorithm)."""
    return float(derived_rng("cold-eff", job, seed).uniform(0.92, 1.08))


def cold_design(job: str, seed: int = 0,
                jitter: float = 0.15) -> List[Tuple[str, float, Tuple]]:
    """The cold twin's execution context: every canonical cell with its
    continuous components perturbed by up to ``jitter``, over the full
    machine x scale-out grid.  Same jitter discipline as ``user_design``
    (integer parameters stay on the canonical grid)."""
    rng = derived_rng("cold", job, seed)
    cells, scale = _job_cells(job)
    jitterable = _JITTERABLE[job]
    ccells = []
    for cell in cells:
        cell = [float(v) for v in cell]
        for j in jitterable:
            cell[j] *= float(rng.uniform(1.0 - jitter, 1.0 + jitter))
        ccells.append(tuple(cell))
    return [(m, float(s), cell)
            for m in MACHINES for s in scale for cell in ccells]


def cold_true_runtime(job: str, machine: str, s: float, features: Tuple,
                      seed: int = 0) -> float:
    """Noise-free ground truth for the cold twin (family law x efficiency)."""
    return true_runtime(job, machine, s, features) * cold_efficiency(job, seed)


def generate_cold_job_data(job: str, seed: int = 0) -> RuntimeData:
    """The cold twin's full emulated dataset (evaluation ground truth —
    a real hub never has this; replay holds it out as the test set)."""
    return _measure_design(job, cold_design(job, seed), seed * 7919 + 13,
                           schema=cold_schema(job),
                           runtime_scale=cold_efficiency(job, seed))


def cold_probe(job: str, seed: int = 0,
               rows_per_machine: int = 3) -> RuntimeData:
    """The few measurements a new job's owner has actually run: a small
    deterministic slice of the cold design (``rows_per_machine`` per
    machine type) — enough to sketch a transfer signature, far too few to
    fit models."""
    design = cold_design(job, seed)
    rng = derived_rng("cold-probe", job, seed)
    by_machine: Dict[str, List[Tuple[str, float, Tuple]]] = {}
    for d in design:
        by_machine.setdefault(d[0], []).append(d)
    probe = []
    for m in sorted(by_machine):
        rows = by_machine[m]
        idx = sorted(rng.choice(len(rows),
                                size=min(rows_per_machine, len(rows)),
                                replace=False).tolist())
        probe.extend(rows[i] for i in idx)
    return _measure_design(job, probe, seed * 7919 + 13,
                           schema=cold_schema(job),
                           runtime_scale=cold_efficiency(job, seed))


def generate_all(seed: int = 0) -> Dict[str, RuntimeData]:
    return {job: generate_job_data(job, seed) for job in SCHEMAS}


def context_groups(data: RuntimeData) -> List[np.ndarray]:
    """Index sets sharing all context features (the paper's 'local' sets).

    Operates on the context column block directly (column 0 of ``context``
    is the dataset size — a base feature, not a grouping key)."""
    ctx = data.context[:, 1:]
    if ctx.shape[1] == 0:
        return [np.arange(len(data))]
    _, gid = np.unique(np.round(ctx, 9), axis=0, return_inverse=True)
    return [np.where(gid == g)[0] for g in range(gid.max() + 1)]


# ---------------------------------------------------------------------------
# spot-market emulation (cloud market plane evaluation)
# ---------------------------------------------------------------------------

#: emulated availability zones with (spot discount vs on-demand,
#: (lo, hi) hourly interruption-rate band).  The ordering is the market's
#: core trade-off: the deeper the discount, the flakier the capacity —
#: az-1c lists the lowest spot price AND interrupts so often that long
#: jobs placed there pay for the discount several times over in restarts.
SPOT_ZONES: Tuple[str, ...] = ("az-1a", "az-1b", "az-1c")
_ZONE_MARKET: Dict[str, Tuple[float, Tuple[float, float]]] = {
    "az-1a": (0.72, (0.2, 0.5)),
    "az-1b": (0.50, (1.5, 2.5)),
    # az-1c's compressed-time volatility is deliberately extreme: the
    # emulated jobs run seconds-to-minutes (not hours), so the rate that
    # makes "cheapest listed price" a trap at THIS time scale is ~30/h
    "az-1c": (0.34, (25.0, 40.0)),
}

#: fixed restart overhead (seconds) an interrupted attempt pays before
#: retrying from scratch in the emulated market
SPOT_RESTART_OVERHEAD_S = 180.0


def spot_interruption_rate(zone: str, seed: int = 0) -> float:
    """Seeded hourly interruption rate for one zone's spot capacity,
    drawn once per (zone, seed) from the zone's band."""
    lo, hi = _ZONE_MARKET[zone][1]
    return float(derived_rng("spot-rate", zone, seed).uniform(lo, hi))


def spot_price_series(machine: str, zone: str, seed: int = 0,
                      n_ticks: int = 64) -> np.ndarray:
    """Seeded time-varying spot price vector for one (machine, zone).

    A mean-reverting multiplicative walk around the zone's discount
    level, clipped to (0.12, 0.97) x on-demand — spot never beats free
    and never exceeds the listed rate."""
    base = MACHINES[machine].price
    disc = _ZONE_MARKET[zone][0]
    rng = derived_rng("spot-price", machine, zone, seed)
    x, out = 0.0, np.empty(n_ticks, np.float64)
    for t in range(n_ticks):
        x = 0.88 * x + float(rng.normal(0.0, 0.06))
        out[t] = base * float(np.clip(disc * math.exp(x), 0.12, 0.97))
    return out


def generate_price_book(seed: int = 0, n_ticks: int = 64,
                        zones: Tuple[str, ...] = SPOT_ZONES,
                        machines: Optional[Tuple[str, ...]] = None,
                        restart_overhead_s: float = SPOT_RESTART_OVERHEAD_S):
    """Seeded multi-AZ spot/on-demand ``PriceBook`` over the emulated
    machine catalog: per-zone on-demand price spread (capacity pricing
    differs a little per AZ), seeded spot price series, and
    discount-correlated interruption rates."""
    from repro_torch.core.market import ON_DEMAND, SPOT, PriceBook
    machines = tuple(MACHINES) if machines is None else tuple(machines)
    prices: Dict[Tuple[str, str, str], np.ndarray] = {}
    rates: Dict[Tuple[str, str], float] = {}
    for z in zones:
        od_spread = float(derived_rng("od-spread", z, seed).uniform(0.985,
                                                                    1.015))
        rates[(z, ON_DEMAND)] = 0.0
        rates[(z, SPOT)] = spot_interruption_rate(z, seed)
        for m in machines:
            prices[(m, z, ON_DEMAND)] = np.full(
                n_ticks, MACHINES[m].price * od_spread)
            prices[(m, z, SPOT)] = spot_price_series(m, z, seed, n_ticks)
    return PriceBook(prices, rates, restart_overhead_s=restart_overhead_s)
