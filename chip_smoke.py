#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: builds the port's CUDA kernels from this checkout, holds each against
its plain PyTorch version, drives the paper's loop end to end on the card,
and prints one JSON line per phase.

    python3 chip_smoke.py

Phases:
  device   card name and power limit, torch version, kernel build time
  kernel   GBM-ensemble kernel vs its plain version at the serving shape,
           edge cases and n = 2**20; CUDA-event times and the bound
  fit      all five Table I jobs published on a hub, 15 predictors fitted
           on the card; a 10,000-row grep store and its 3 predictors
  serve    per job, 4096 seeded contexts in one choose_cluster_batch (plus
           one market-mode batch); the kernel must have been launched
  loop     the quickstart: choose for grep, check the emulator, contribute
  parity   sort and grep fitted on the CPU, carried to the card, predictions
           compared
  profile  device busy time and launches of one fit and one choose
           (torch.profiler, profiler on: wall times are inflated)

The phases fit, serve and loop are the main path: the kernels' launch
counts are set to 0 before it and read after it.  Before the last line it
prints the ``kernels`` line and the nvidia-smi line; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero.  Without a
CUDA card, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

SCALEOUTS = (2, 3, 4, 6, 8, 12)
N_CONTEXTS = 4096
JOBS = ("sort", "grep", "sgd", "kmeans", "pagerank")


def emit(phase, t0, **kw):
    print(json.dumps({"phase": phase,
                      "seconds": time.perf_counter() - t0, **kw}),
          flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def sync():
    import torch
    torch.cuda.synchronize()


# ------------------------------------------------------------------ kernel

def ensemble(seed, n, d, T, depth, device, inf_frac=0.2, nonfinite=False):
    """Seeded random ensemble and rows, as tensors on ``device``."""
    import torch
    rng = np.random.default_rng(seed)
    n_int = 2 ** depth - 1
    X = rng.uniform(0, 10, (n, d)).astype(np.float32)
    if nonfinite:
        m = rng.random(X.shape)
        X[m < 0.05] = np.inf
        X[(m >= 0.05) & (m < 0.1)] = -np.inf
        X[(m >= 0.1) & (m < 0.15)] = np.nan
    feat = rng.integers(0, d, (T, n_int)).astype(np.int32)
    thr = rng.uniform(0, 10, (T, n_int)).astype(np.float32)
    thr[rng.random((T, n_int)) < inf_frac] = np.inf
    leaf = rng.normal(0, 0.1, (T, n_int + 1)).astype(np.float32)
    return [torch.as_tensor(a, device=device) for a in (X, feat, thr, leaf)]


def bound_ms(n, d, T, depth):
    """Least time for one call: each input read once and the output written
    once at the HBM rate, against the fp32 comparisons and adds (depth
    compares and one add per row and tree) at the fp32 peak."""
    n_int = 2 ** depth - 1
    nbytes = 4 * (n * d + T * (3 * n_int + 1) + 2 + n)
    ops = n * T * (depth + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def smem_bound_ms(n, T, depth):
    """Least time for the kernel's shared-memory loads: each row loads a
    feature id and a threshold per level and one leaf per tree, and an SM
    serves 32 four-byte loads per clock, at the card's maximum SM clock."""
    import torch
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n * T * (2 * depth + 1) / (sms * 32 * mhz * 1e6) * 1e3


def cuda_ms(fn, reps, warm=3):
    """Mean device time of one call, by CUDA events over ``reps`` calls."""
    import torch
    for _ in range(warm):
        fn()
    sync()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def kernel_phase(dev):
    import torch
    from repro_torch.kernels import gbm_predict as K
    t0 = time.perf_counter()
    serve_n = N_CONTEXTS * len(SCALEOUTS)
    cases = []            # (label, n, d, T, depth, y_scale, nonfinite)
    for d in (2, 3, 4):
        for ys in (0.0, 250.0):
            cases.append((f"serve d={d} y_scale={ys}", serve_n, d, 200, 3,
                          ys, False))
    cases += [("thr=inf and +-inf/NaN features", 5000, 3, 200, 3, 0.0, True),
              ("n=1", 1, 3, 200, 3, 0.0, False),
              ("ragged n=1000", 1000, 4, 200, 3, 0.0, True),
              ("T=1", 777, 3, 1, 3, 1.0, False),
              ("D=1", 513, 2, 50, 1, 0.0, True),
              ("D=4", 2049, 4, 100, 4, 0.0, True),
              ("d=1", 300, 1, 200, 3, 0.0, True),
              ("d=16", 4099, 16, 64, 3, 0.0, True),
              ("n=2^20", 2 ** 20, 3, 200, 3, 0.0, False)]
    max_abs, worst, checked = 0.0, 0.0, []
    for i, (label, n, d, T, depth, ys, nonfinite) in enumerate(cases):
        X, feat, thr, leaf = ensemble(i, n, d, T, depth, dev,
                                      nonfinite=nonfinite)
        if nonfinite and depth >= 1:
            X[0, :] = float("inf")       # R2: +inf at thr = inf goes left
        f0 = 0.3
        got = K.gbm_predict(X, feat, thr, leaf, f0, ys)
        want = K.gbm_predict_plain(X, feat, thr, leaf, f0, ys)
        sync()
        g, w = got.cpu().numpy(), want.cpu().numpy()
        assert g.shape == w.shape == (n,), label
        inf = np.isinf(w)
        assert np.array_equal(np.isnan(g), np.isnan(w)) and \
            np.array_equal(g[inf], w[inf]), \
            f"kernel vs plain: non-finite outputs differ ({label})"
        fin = np.isfinite(w)
        diff = np.abs(g[fin] - w[fin])
        excess = float(np.max(diff - 1e-6 * np.abs(w[fin]), initial=0.0))
        assert excess <= 1e-6, f"kernel vs plain beyond rtol/atol 1e-6 " \
            f"({label}): {excess}"
        max_abs = max(max_abs, float(np.max(diff, initial=0.0)))
        worst = max(worst, excess)
        checked.append(label)

    def timed(n, d, reps, plain_reps):
        X, feat, thr, leaf = ensemble(99, n, d, 200, 3, dev)
        f0 = torch.tensor([0.3], device=dev)
        ys = torch.tensor([0.0], device=dev)
        k = cuda_ms(lambda: K.gbm_predict(X, feat, thr, leaf, f0, ys), reps)
        p = cuda_ms(lambda: K.gbm_predict_plain(X, feat, thr, leaf, f0, ys),
                    plain_reps, warm=1)
        b, by = bound_ms(n, d, 200, 3)
        return k, p, b, by, smem_bound_ms(n, 200, 3)

    times = {}
    for d in (2, 3, 4):
        times[f"serve_d{d}"] = timed(serve_n, d, 200, 20)
    times["n2p20_d3"] = timed(2 ** 20, 3, 50, 3)
    emit("kernel", t0, kernel="gbm_predict", cases=checked,
         max_abs_err=max_abs, worst_excess_over_tol=worst,
         times={k: {"ms": v[0], "plain_ms": v[1], "bound_ms": v[2],
                    "bound_by": v[3], "smem_load_bound_ms": v[4]}
                for k, v in times.items()})
    return max_abs, times


# ------------------------------------------------------------- main path

def make_hub(device):
    from repro_torch.core import Hub, JobRepo, RuntimeDataStore
    from repro_torch.workloads import spark_emul as W
    hub = Hub()
    for job in JOBS:
        data = W.generate_job_data(job)
        hub.publish(JobRepo(job, f"apache spark {job}", data.schema,
                            RuntimeDataStore(data, device=device),
                            predictor_kw={"device": device}))
    return hub


def grep_10k(device):
    """The 10,000-row grep store of the ingest benchmark
    (benchmarks/run.py), seeded the same way."""
    from repro_torch.core import RuntimeDataStore
    from repro_torch.core.features import RuntimeData
    from repro_torch.workloads import spark_emul as W
    base = W.generate_job_data("grep")
    rng = np.random.default_rng(0)
    n_store = 10_000
    idx = np.tile(np.arange(len(base)), -(-n_store // len(base)))[:n_store]
    data = RuntimeData.from_columns(
        base.schema, base.machines, base.codes[idx], base.scale_out[idx],
        base.context[idx],
        base.runtime[idx] * rng.lognormal(0.0, 0.01, n_store))
    return RuntimeDataStore(data, seed=0, device=device)


def fit_phase(hub, device, big_store=True):
    import torch
    from repro_torch.core import JobRepo
    t0 = time.perf_counter()
    rows = []
    for job in JOBS:
        repo = hub.get(job)
        for m in repo.store.data.present_machines():
            t1 = time.perf_counter()
            p = repo.predictor_for(m)
            sync()
            dt = time.perf_counter() - t1
            rows.append({"job": job, "machine": m, "selected": p.selected,
                         "cv_mape": p.cv_mape[p.selected], "fit_s": dt,
                         "n": len(repo.store.data.machine_view(m)),
                         "cv_mapes": dict(p.cv_mape)})
    bad = [r for r in rows if not r["cv_mape"] < 0.10]
    assert not bad, f"selected CV MAPE >= 0.10: {bad}"
    big = {}
    if big_store:
        store = grep_10k(device)
        repo = JobRepo("grep10k", "spark grep", store.data.schema, store,
                       predictor_kw={"device": device})
        torch.cuda.reset_peak_memory_stats()
        for m in store.data.present_machines():
            t1 = time.perf_counter()
            p = repo.predictor_for(m)
            sync()
            big[m] = {"fit_s": time.perf_counter() - t1,
                      "selected": p.selected,
                      "cv_mape": p.cv_mape[p.selected],
                      "n": len(store.data.machine_view(m))}
        big["peak_bytes"] = torch.cuda.max_memory_allocated()
    emit("fit", t0, predictors=rows, n_gbm_selected=sum(
        r["selected"] == "gbm" for r in rows), grep_10k=big)
    return rows


def contexts(repo, n, seed):
    rng = np.random.default_rng(seed)
    ctx = repo.store.data.X[:, 1:]
    c = rng.uniform(ctx.min(0), ctx.max(0), (n, ctx.shape[1]))
    t = rng.uniform(0.5, 3.0, n) * float(np.median(repo.store.data.y))
    t[rng.random(n) < 0.25] = np.nan
    return c, t


def serve_phase(hub, n_contexts=N_CONTEXTS):
    from repro_torch.core import ConfigurationService
    from repro_torch.kernels import gbm_predict as K
    from repro_torch.workloads import spark_emul as W
    t0 = time.perf_counter()
    before = K.LAUNCHES
    prices = {m.name: m.price for m in W.MACHINES.values()}
    book = W.generate_price_book(seed=0)
    out = {}
    for i, job in enumerate(JOBS):
        repo = hub.get(job)
        ctx, t_max = contexts(repo, n_contexts, seed=i)
        svc = ConfigurationService.from_repo(repo, None, prices, SCALEOUTS)
        msvc = ConfigurationService.from_repo(repo, None, prices, SCALEOUTS,
                                              market=book)
        svc.choose_cluster_batch(ctx[:8], t_max[:8])          # warm-up
        sync()
        full_gcs = gc.get_stats()[2]["collections"]
        t1 = time.perf_counter()
        choices = svc.choose_cluster_batch(ctx, t_max)
        sync()
        plain_s = time.perf_counter() - t1
        full_gcs = gc.get_stats()[2]["collections"] - full_gcs
        t1 = time.perf_counter()
        mchoices = msvc.choose_cluster_batch(ctx, t_max)
        sync()
        market_s = time.perf_counter() - t1
        assert len(choices) == len(mchoices) == n_contexts
        for c in (*choices, *mchoices):
            assert c.scale_out in SCALEOUTS and np.isfinite(c.cost_usd)
            assert np.isfinite(c.runtime_bound_s) and c.predicted_runtime_s >= 0
        out[job] = {"choose_s": plain_s, "market_choose_s": market_s,
                    "full_gcs_in_choose": full_gcs, "contexts": n_contexts,
                    "machines": sorted({c.machine_type for c in choices})}
    launched = K.LAUNCHES - before
    assert launched > 0, "the GBM kernel was not launched while serving"
    emit("serve", t0, jobs=out, gbm_kernel_launches=launched)


def loop_phase(hub):
    from repro_torch.core.features import RuntimeData
    from repro_torch.workloads import spark_emul as W
    t0 = time.perf_counter()
    prices = {m.name: m.price for m in W.MACHINES.values()}
    repo = hub.search("grep")[0]
    conf = repo.configurator("m5.xlarge", prices, list(SCALEOUTS))
    ctx = np.asarray([18.0, 0.02])
    choice = conf.choose_scaleout(ctx, t_max=420.0)
    assert choice.runtime_bound_s <= 420.0, choice
    truth = W.true_runtime("grep", "m5.xlarge", choice.scale_out,
                           (18.0, 0.02))
    assert truth <= 420.0 * 1.05, (truth, choice)
    measured = W._measure("grep", "m5.xlarge", choice.scale_out,
                          (18.0, 0.02), seed=123)
    new = RuntimeData(repo.schema, np.asarray(["m5.xlarge"]),
                      np.asarray([[choice.scale_out, 18.0, 0.02]]),
                      np.asarray([measured]))
    rep = repo.contribute(new, contributor="chip-smoke")
    assert rep.accepted, rep.reason
    emit("loop", t0, scale_out=choice.scale_out,
         bound_s=choice.runtime_bound_s, true_runtime_s=truth,
         measured_s=measured, accepted=rep.accepted,
         baseline_mape=rep.baseline_mape, candidate_mape=rep.candidate_mape)


def parity_phase(card_rows):
    """``card_rows``: the fit phase's results, taken before the loop phase
    contributed a row to the grep store."""
    from repro_torch.core import engine
    from repro_torch.core.predictor import C3OPredictor
    t0 = time.perf_counter()
    cpu_hub = make_hub("cpu")
    card = {(r["job"], r["machine"]): r for r in card_rows}
    worst, differ, total, cv_gap = 0.0, [], 0, 0.0
    for job in ("sort", "grep"):
        repo = cpu_hub.get(job)
        ctx, _ = contexts(repo, 256, seed=7)
        rows = engine.grid_rows(SCALEOUTS, ctx)
        for m in repo.store.data.present_machines():
            cpu_pred = repo.predictor_for(m)
            carried = C3OPredictor.from_state(
                cpu_pred.export_state(), repo.store.data.machine_view(m).X,
                device="cuda")
            a, b = cpu_pred.predict(rows), carried.predict(rows)
            rel = np.max(np.abs(b - a) / np.maximum(np.abs(a), 1e-12))
            assert rel <= 1e-5, f"{job}/{m}: card vs CPU rel err {rel}"
            worst = max(worst, float(rel))
            total += 1
            c = card[job, m]
            cv_gap = max(cv_gap, max(abs(c["cv_mapes"][k] - v)
                                     for k, v in cpu_pred.cv_mape.items()))
            if c["selected"] != cpu_pred.selected:
                differ.append({"job": job, "machine": m,
                               "card": c["cv_mapes"],
                               "cpu": cpu_pred.cv_mape})
    emit("parity", t0, max_rel_err=worst,
         card_selections_matching_cpu=f"{total - len(differ)}/{total}",
         max_cv_mape_gap=cv_gap, differing=differ)


def profile_phase(hub):
    """Device busy time against host wall time for one predictor fit
    (grep on c5.xlarge, 4 models x 30 folds) and one 4096-context choose,
    from a torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import ConfigurationService
    from repro_torch.core.predictor import C3OPredictor
    from repro_torch.workloads import spark_emul as W
    t0 = time.perf_counter()
    v = hub.get("grep").store.data.machine_view("c5.xlarge")
    prices = {m.name: m.price for m in W.MACHINES.values()}
    svc = ConfigurationService.from_repo(hub.get("grep"), None, prices,
                                         SCALEOUTS)
    ctx, t_max = contexts(hub.get("grep"), N_CONTEXTS, seed=1)
    out = {}
    for name, fn in (
            ("fit", lambda: C3OPredictor(device="cuda").fit(v.X, v.y)),
            ("choose", lambda: svc.choose_cluster_batch(ctx, t_max))):
        fn()                                  # warm
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            fn()
            sync()
            wall = time.perf_counter() - t1
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        out[name] = {"wall_s": wall, "device_busy_s": busy_us * 1e-6,
                     "idle_share": 1.0 - busy_us * 1e-6 / wall,
                     "kernel_launches": len(kernels),
                     "top_kernels_us": top}
    assert out["fit"]["kernel_launches"] > 0, "profiler saw no device work"
    emit("profile", t0, **out)


# ------------------------------------------------------------------ main

def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import gbm_predict as K
    from repro_torch.core import engine  # noqa: F401  (sets TF32 off)
    assert not torch.backends.cuda.matmul.allow_tf32
    dev = torch.device("cuda")
    smi = nvidia_smi()

    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [ln for ln in build.BUILD_INFO["gbm_predict"]["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit("device", t0, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         build_s=build_s, ptxas=ptxas)

    max_abs, times = kernel_phase(dev)

    # ---- main path: counts from 0 before it, read after it
    K.LAUNCHES = 0
    hub = make_hub("cuda")
    fit_rows = fit_phase(hub, "cuda")
    serve_phase(hub)
    loop_phase(hub)
    launches = K.LAUNCHES
    assert launches > 0, "main path never launched the GBM kernel"

    parity_phase(fit_rows)
    profile_phase(hub)

    serve, big = times["serve_d3"], times["n2p20_d3"]
    print(json.dumps({"kernels": [{
        "name": "gbm_predict", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gbm_predict.cu",
        "replaces": "src/repro/kernels/gbm_predict.py:58",
        "launches": launches, "max_abs_err": max_abs,
        "ms": serve[0], "plain_ms": serve[1], "bound_ms": serve[2],
        "bound_by": serve[3], "library_ms": None,
        "shape": f"n={N_CONTEXTS * len(SCALEOUTS)} d=3 T=200 D=3",
        "ms_n2p20": big[0], "plain_ms_n2p20": big[1],
        "bound_ms_n2p20": big[2]}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
