#!/usr/bin/env python3
"""The paper's Table II, Fig. 5 and the configurator's deadline study on
the PyTorch port, printed as ``name,us_per_call,derived`` rows.

    python3 scripts/paper_figures.py [--device cpu] [--only table2]
        [--splits 60]

``--only`` takes table2, fig5 or configurator (all three without it).
Every model fit, LOO-CV selection and prediction runs on ``--device``
("cuda" unless "cpu" is asked for; without a card it refuses to start),
through ``repro_torch.core.predictor.evaluate_split``, ``C3OPredictor``
and ``Configurator``.  The protocol (scenarios, splits, seeds, the
paper's Table II values beside each row) is the paper-reproduction
benchmarks' own, kept here as a copy so that this script loads nothing
of the JAX package.  ``us_per_call`` is host wall time a split (a
context for the configurator), ending in a pull of the results.
"""
import argparse
import os
import sys
import time
from typing import Dict, List

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

# -------------------------------------------------- the protocol (§VI-C)
# local:  the single-user situation: training data from ONE context group
#         (all context features fixed; scale-out and dataset size vary);
#         splits sample the valid local datasets uniformly.
# global: collaboratively shared data: every context of the target machine
#         type mixed together.
# Each split trains on a fraction of the scenario's data and scores MAPE on
# the held-out rows; the c3o row runs LOO-CV model selection first.

JOBS = ("sort", "grep", "sgd", "kmeans", "pagerank")
MODELS = ("ernest", "gbm", "bom", "ogb")
TARGET_MACHINE = "m5.xlarge"

# Paper Table II (local, global); Sort has a single column.
PAPER_TABLE2 = {
    "sort": {"ernest": (.0582, .0582), "gbm": (.0443, .0443),
             "bom": (.0639, .0639), "ogb": (.0261, .0261),
             "c3o": (.0261, .0261)},
    "grep": {"ernest": (.0753, .3938), "gbm": (.0554, .0274),
             "bom": (.0645, .1295), "ogb": (.0447, .0935),
             "c3o": (.0505, .0274)},
    "sgd": {"ernest": (.1000, .2185), "gbm": (.0689, .0225),
            "bom": (.0604, .1266), "ogb": (.0654, .0779),
            "c3o": (.0622, .0225)},
    "kmeans": {"ernest": (.1404, .1531), "gbm": (.0860, .0217),
               "bom": (.0551, .0574), "ogb": (.0570, .0550),
               "c3o": (.0522, .0217)},
    "pagerank": {"ernest": (.1093, .3485), "gbm": (.0525, .0271),
                 "bom": (.0399, .1508), "ogb": (.0405, .0317),
                 "c3o": (.0429, .0277)},
}

SCALEOUTS = (2, 3, 4, 6, 8, 12, 16)
FIG5_SIZES = (3, 6, 9, 12, 15, 18, 21, 24, 27, 30)
CONFIGURATOR_CONTEXTS = 60


def _row(name: str, us: float, derived: str) -> None:
    print(f"{name},{us:.1f},{derived}", flush=True)


def scenario_splits(data, scenario: str, n_splits: int, seed: int,
                    train_frac: float = 0.7):
    """Yields (X_tr, y_tr, X_te, y_te) per split."""
    from repro_torch.workloads import spark_emul as W
    rng = np.random.default_rng(seed)
    d = data.filter_machine(TARGET_MACHINE)
    groups = W.context_groups(d)
    for i in range(n_splits):
        if scenario == "local":
            g = groups[rng.integers(len(groups))]
            idx = rng.permutation(g)
        else:
            idx = rng.permutation(len(d))
        k = max(int(len(idx) * train_frac), 3)
        tr, te = idx[:k], idx[k:]
        if len(te) == 0:
            tr, te = idx[:-2], idx[-2:]
        yield d.X[tr], d.y[tr], d.X[te], d.y[te]


def run_scenario(job: str, scenario: str, n_splits: int = 100,
                 seed: int = 0, max_cv_folds: int = 20,
                 device: str = "cuda") -> Dict[str, float]:
    """Mean MAPE per model (and c3o) over ``n_splits`` splits."""
    from repro_torch.core.predictor import evaluate_split
    from repro_torch.workloads import spark_emul as W
    data = W.generate_job_data(job)
    errs: Dict[str, List[float]] = {}
    for i, (Xtr, ytr, Xte, yte) in enumerate(
            scenario_splits(data, scenario, n_splits, seed)):
        r = evaluate_split(MODELS, Xtr, ytr, Xte, yte,
                           max_cv_folds=max_cv_folds, seed=seed + i,
                           device=device)
        for k, v in r.items():
            if k != "c3o_selected":
                errs.setdefault(k, []).append(v)
    return {k: float(np.mean(v)) for k, v in errs.items()}


def table2(splits: int, device: str) -> None:
    """Table II: MAPE per job, scenario and model beside the paper's."""
    for job in JOBS:
        for scenario in (("local", "global") if job != "sort"
                         else ("global",)):
            t0 = time.time()
            r = run_scenario(job, scenario, n_splits=splits, device=device)
            dt = (time.time() - t0) * 1e6 / splits
            for model in MODELS + ("c3o",):
                paper = PAPER_TABLE2[job][model][scenario != "local"]
                _row(f"table2.{job}.{scenario}.{model}", dt,
                     f"mape={r[model]:.4f} paper={paper:.4f}")


def fig5(splits: int, device: str) -> None:
    """Fig. 5: MAPE against training-set size (errors capped at 10), for
    a representative pair of panels."""
    from repro_torch.core.predictor import evaluate_split
    from repro_torch.workloads import spark_emul as W
    n_splits = max(splits // 4, 10)
    for job in ("grep", "kmeans"):
        data = W.generate_job_data(job).filter_machine(TARGET_MACHINE)
        rng = np.random.default_rng(1)
        for n in FIG5_SIZES:
            t0 = time.time()
            errs: Dict[str, List[float]] = {}
            for i in range(n_splits):
                idx = rng.permutation(len(data))
                tr, te = idx[:n], idx[n:]
                r = evaluate_split(MODELS, data.X[tr], data.y[tr],
                                   data.X[te], data.y[te],
                                   max_cv_folds=min(n, 10), seed=i,
                                   device=device)
                for k, v in r.items():
                    if k != "c3o_selected":
                        errs.setdefault(k, []).append(v)
            dt = (time.time() - t0) * 1e6 / n_splits
            summary = " ".join(
                f"{m}={np.mean(np.minimum(errs[m], 10.0)):.3f}"
                for m in MODELS + ("c3o",))
            _row(f"fig5.{job}.n{n}", dt, summary)


def configurator_choices(job: str, rng: np.random.Generator,
                         n_contexts: int, device: str):
    """The deadline study for ``job``: ``n_contexts`` contexts drawn from
    ``rng`` (one stream across the jobs, as the benchmark draws them), each
    with a deadline and the scale-out the port's Configurator picks.
    Returns (a list of (context, t_max, scale_out, true runtimes at every
    scale-out), seconds spent choosing)."""
    from repro_torch.core.configurator import Configurator
    from repro_torch.core.predictor import C3OPredictor
    from repro_torch.workloads import spark_emul as W
    prices = {m.name: m.price for m in W.MACHINES.values()}
    ctx_fn = {"grep": lambda: (rng.uniform(10, 20),
                               rng.choice([.002, .02, .08])),
              "sgd": lambda: (rng.uniform(10, 30),
                              rng.choice([5, 20, 40, 70, 100]),
                              rng.choice([50, 100]))}[job]
    d = W.generate_job_data(job).filter_machine(TARGET_MACHINE)
    pred = C3OPredictor(max_cv_folds=25, device=device).fit(d.X, d.y)
    conf = Configurator(pred, TARGET_MACHINE, prices, list(SCALEOUTS),
                        confidence=0.95)
    out = []
    t0 = time.time()
    for _ in range(n_contexts):
        ctx = np.asarray(ctx_fn(), dtype=float)
        feasible_t = [W.true_runtime(job, TARGET_MACHINE, s, tuple(ctx))
                      for s in SCALEOUTS]
        t_max = float(rng.uniform(1.15, 2.0) * min(feasible_t))
        ch = conf.choose_scaleout(ctx, t_max=t_max)
        out.append((ctx, t_max, ch.scale_out, feasible_t))
    return out, time.time() - t0


def configurator(device: str, n_contexts: int = CONFIGURATOR_CONTEXTS
                 ) -> None:
    """Deadline hit rate and cost against over-provisioning, grep and sgd."""
    from repro_torch.workloads import spark_emul as W
    price = W.MACHINES[TARGET_MACHINE].price
    rng = np.random.default_rng(0)
    for job in ("grep", "sgd"):
        picks, seconds = configurator_choices(job, rng, n_contexts, device)
        hits = sum(f[SCALEOUTS.index(s)] <= t for _, t, s, f in picks)
        cost_c3o = sum(price * f[SCALEOUTS.index(s)] / 3600 * s
                       for _, _, s, f in picks)
        cost_max = sum(price * f[-1] / 3600 * SCALEOUTS[-1]
                       for _, _, _, f in picks)
        _row(f"configurator.{job}", seconds * 1e6 / n_contexts,
             f"deadline_hit={hits / n_contexts:.3f} (target>=0.95) "
             f"cost_vs_overprovision={cost_c3o / cost_max:.3f}")


FIGURES = {"table2": lambda a: table2(a.splits, a.device),
           "fig5": lambda a: fig5(a.splits, a.device),
           "configurator": lambda a: configurator(a.device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="the paper's Table II, Fig. 5 and configurator study "
                    "on the PyTorch port")
    ap.add_argument("--splits", type=int, default=60)
    ap.add_argument("--only", choices=sorted(FIGURES), default=None)
    ap.add_argument("--device", default="cuda",
                    help='where predictors fit and predict ("cpu" must be '
                         "asked for; there is no fallback)")
    args = ap.parse_args(argv)
    if args.splits < 1:
        ap.error("--splits must be >= 1")
    from repro_torch.eval.replay import require_device
    require_device(args.device)
    print("name,us_per_call,derived", flush=True)
    for name, fn in FIGURES.items():
        if args.only in (None, name):
            fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
