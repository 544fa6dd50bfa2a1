#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: builds the port's CUDA kernels from this checkout, holds each against
its plain PyTorch version, drives the paper's loop end to end on the card,
and prints one JSON line per phase.

    python3 chip_smoke.py

Phases:
  device   card name and power limit, torch version, kernel build time
  flash_build  per instantiation of the flash-attention kernels: ptxas's
               registers and spills, dynamic shared memory, and the HGMMA
               and UTMALDG instructions in the library's SASS
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
  lm_kernel   flash-attention and flash-decode kernels vs their plain
              versions in bfloat16 (flash: the wgmma/TMA kernel) and
              float32 (the SIMT kernel) (gemma3-1b's serving shapes,
              softcap, non-causal, ragged S, S = 1 and 129, a window
              across a kv tile, hd 64/128, ring slot maps, pos = 0,
              G = 1/2/4/8); CUDA-event and profiler device times, achieved
              TFLOP/s (flash), bounds and the scaled_dot_product_attention
              yardstick at the serving shapes
  lm_serve    gemma3-1b at full width through repro_torch.launch.serve.run:
              batch 8, prompt 2048, 64 new tokens; prefill ms, decode
              ms/token, tokens/s, peak memory, the runtime-log line
  lm_parity   one full-width period of gemma3-1b (6 layers), prompt 1024,
              8 decode steps: card (bfloat16, kernels) vs CPU (float32,
              plain) logits and greedy tokens
  lm_profile  device busy time and top kernels of one full-width prefill
              and 8 decode steps (torch.profiler)
  rwkv_kernel   WKV6 kernel vs its chunked plain version at rwkv6-3b's
                serving shape (B 8, S 2048, H 40, hd 64, float32), and vs
                both plain versions on edge cases (given s0, two chunks,
                B 1 H 1, hd 32, log w down to -12, u = 0, s0 = None, a
                sequence split across two calls); device times
                (torch.profiler) and the bound
  rwkv_profile  device busy time and top kernels of one full-width rwkv6-3b
                prefill and 8 decode steps (torch.profiler)
  rwkv_serve    rwkv6-3b at full width and depth through
                repro_torch.launch.serve.run: batch 8, prompt 2048, 64 new
                tokens; prefill ms, decode ms/token, tokens/s, peak memory,
                the runtime-log line; wkv6 launches = 32 (prefill only)
  rwkv_parity   rwkv6-3b at full width cut to 4 layers, prompt 512, 8
                decode steps: card (bfloat16, kernel) vs CPU (float32,
                plain) logits, greedy tokens and the bf16 state's drift
  jamba_kernel  selective-scan kernel vs its plain version at
                jamba-1.5-large's serving shape (B 8, S 2048, D 16,384,
                N 16, float32, given h0) and on edge cases (h0 = None,
                N 8 and 4, B 1 with ragged D and S, bf16 u, dt*A down to
                -50, a sequence split across two calls); CUDA-event times
                and the bound
  jamba_profile device busy time and top kernels of one prefill and 8
                decode steps of jamba-1.5-large at full width cut to 4
                layers (torch.profiler); the scan kernel in prefill only
  jamba_serve   the same model through repro_torch.launch.serve.run:
                batch 8, prompt 2048, 64 new tokens; init s, prefill ms,
                decode ms/token, peak memory, MoE drop share; scan
                launches = 3 (prefill only), flash 1, decode 63
  jamba_parity  the same 4 layers with d_ff and moe_d_ff cut to 2,048,
                prompt 256, 8 decode steps: card in float32 and in bf16
                vs CPU (float32, plain) logits, greedy tokens and MoE
                routing

Four main paths: the phases fit, serve and loop (the paper's loop,
through the GBM kernel), lm_serve (gemma3-1b serving, through the two
attention kernels), rwkv_serve (rwkv6-3b serving, through the WKV6
kernel) and jamba_serve (jamba-1.5-large serving, through the scan and
the attention kernels).  Each path's kernel launch counts are set to 0
just before it and read just after it.  Before the last line it prints the ``kernels``
line and the nvidia-smi line; the last line is ``{"ok": true, "device":
{...}}``.  Any failure exits non-zero.  Without a
CUDA card, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""
import gc
import json
import os
import re
import shutil
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n * T * (2 * depth + 1) / (sms * 32 * max_sm_clock_mhz() * 1e6) \
        * 1e3


def max_sm_clock_mhz():
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])


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


# --------------------------------------------------------------- LM slice

# bfloat16 dense tensor-core peak of one H100 SXM (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12
# tests/test_kernels.py's tolerances: atol, with rtol ten times that
LM_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# A tighter check of the bf16 flash route beside LM_TOL, whose atol is as
# large as a typical output at S 2048: ||got - want|| / ||want|| over the
# whole output.  The kernel rounds P and the output to bf16 (8 significant
# bits); the replay of its arithmetic gives about 2e-3 on the CPU.  P
# rounded to fp8 e4m3 (4 significant bits) or a scale off by 10% gives
# 1.7e-2 and 8e-2 or more, and each case's controls must exceed the limit.
# PERF.md gives the card's readings this limit was set from.
FLASH_BF16_REL = 5e-3
# where the LM phases run: the card (a rehearsal on the CPU may change it)
LM_DEVICE = "cuda"
# gemma3-1b's serving shape (launch/serve.py: batch 8, prompt 2048, 64 new)
SERVE_B, SERVE_PROMPT, SERVE_NEW = 8, 2048, 64
SERVE_L = SERVE_PROMPT + SERVE_NEW + 8       # the global layers' cache
# lm_parity: last-position logits of the card (bfloat16, kernels) against
# the CPU (float32, plain versions) on the same weights.  bfloat16 keeps 8
# significant bits, so each rounding of an activation is off by up to
# 2**-9 (0.2%) relative; one period of 6 layers rounds the residual stream
# some 30 times, which adds up like a random walk to about 1%.  5e-2
# leaves room for that; a wrong mask, ring slot or rope offset gives
# errors of order 1.
PARITY_REL_TOL = 5e-2


def _tdtype(name):
    import torch
    return getattr(torch, name)


def kept_pairs(S, causal, window):
    """(query, key) pairs the masks keep in one [S, S] attention."""
    q = np.arange(S)
    hi = q if causal else np.full(S, S - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(S, int)
    return int(np.sum(hi - lo + 1))


def attn_bound_ms(nbytes, flops, dtype):
    """Least time for the work: bytes at the HBM rate against the products'
    operations at the tensor-core peak of bfloat16 (or the float32 peak
    outside the tensor cores for float32 inputs)."""
    peak = BF16_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bound_ms(B, S, H, KV, hd, causal, window, dtype):
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * B * S * hd * (2 * H + 2 * KV)      # q, k, v in; o out
    flops = 4 * B * H * hd * kept_pairs(S, causal, window)
    return attn_bound_ms(nbytes, flops, dtype)


def decode_bound_ms(B, H, KV, hd, n_kept, n_slots_map, dtype):
    """Only the slots the mask keeps need reading (this run's data), plus q,
    the output and the slot map."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * (2 * B * H * hd + 2 * B * KV * hd * n_kept) \
        + 4 * n_slots_map
    return attn_bound_ms(nbytes, 4 * B * H * hd * n_kept, dtype)


def _qkv(seed, B, S, H, KV, hd, dtype, L=None):
    import torch
    g = torch.Generator(device=LM_DEVICE).manual_seed(seed)
    L = S if L is None else L
    return [torch.randn(s, generator=g, device=LM_DEVICE).to(_tdtype(dtype))
            for s in ((B, S, H, hd), (B, L, KV, hd), (B, L, KV, hd))]


def _excess(got, want, dtype):
    """Largest |got - want| beyond atol + rtol |want|, and the largest
    |got - want|."""
    g, w = got.float(), want.float()
    assert g.shape == w.shape and bool(g.isfinite().all())
    d = (g - w).abs()
    tol = LM_TOL[dtype]
    return float((d - tol - 10 * tol * w.abs()).max()), float(d.max())


def _rel_err(got, want):
    """||got - want|| / ||want||, in float64."""
    g, w = got.double(), want.double()
    return float((g - w).norm() / w.norm().clamp_min(1e-300))


def _coarse_p_attention(q, k, v, causal, window, cap, p_type):
    """A control for the bf16 check: attention with the kernel's
    unnormalised P = exp(s - rowmax) rounded to ``p_type`` before P.V, the
    row sums taken before the rounding.  One batch row at a time, to keep
    the score matrix small at jamba's shape."""
    import torch
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    ok = kp <= qp if causal else torch.ones(S, S, dtype=torch.bool,
                                             device=q.device)
    if window:
        ok = ok & (kp > qp - window)
    out = []
    for b in range(B):
        qg = q[b].float().reshape(S, KV, G, hd) * hd ** -0.5
        s = torch.einsum("qkgh,skh->kgqs", qg, k[b].float())
        if cap:
            s = cap * torch.tanh(s / cap)
        s = torch.where(ok, s, torch.tensor(-2.0e38, device=q.device))
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = torch.einsum("kgqs,skh->kgqh", p.to(p_type).float(), v[b].float())
        o = o / p.sum(-1, keepdim=True)
        out.append(o.permute(2, 0, 1, 3).reshape(S, H, hd))
    return torch.stack(out).to(q.dtype)


def sdpa_has_gqa():
    """``scaled_dot_product_attention`` takes ``enable_gqa`` from torch
    2.5 on."""
    import torch
    major, minor = (int(x) for x in torch.__version__.split(".")[:2])
    return (major, minor) >= (2, 5)


def sdpa_flash(q, k, v, causal, window):
    """One ``scaled_dot_product_attention`` call computing the same
    function (no softcap), on [B, H, S, hd] copies made outside the call.
    Returns the call, or None where this torch has no ``enable_gqa``."""
    import torch
    import torch.nn.functional as F
    if not sdpa_has_gqa():
        return None
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    S = q.shape[1]
    mask = None
    if window:
        i = torch.arange(S, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)


def sdpa_decode(q, kc, vc, ok):
    import torch.nn.functional as F
    if not sdpa_has_gqa():
        return None
    qt = q[:, :, None].contiguous()                     # [B, H, 1, hd]
    kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
    mask = ok[None, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def lm_time(fn, reps, kernels_per_call=1):
    """Time of one call, two ways: CUDA events around ``reps`` back-to-back
    calls (``events_ms``; when the host launches slower than the card runs,
    as for a decode step's small launches, this is the host's time), and
    the device time of the kernels and copies a torch.profiler trace
    records over ``reps`` calls (``device_ms``).  The trace may drop events
    (it kept 7 of 20 launches of 23 ms, and some of SDPA's): the device
    time of a call is, over the kernel names, the mean recorded duration
    times the launches a call makes, ceil(recorded / reps);
    ``trace_complete`` says whether every name was recorded a whole number
    of times per call.  ``ms`` is the device time when the trace recorded
    at least ``kernels_per_call`` device events per call, else the events
    time (``ms_from`` says which).  ``kernel_names`` are the device
    events' names."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    events_ms = cuda_ms(fn, reps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    per_call = len(dev) / reps
    by_name = {}
    for e in dev:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    device_ms = sum(sum(d) / len(d) * -(-len(d) // reps)
                    for d in by_name.values()) / 1e3 if dev else None
    seen = per_call >= kernels_per_call
    return {"ms": device_ms if seen else events_ms, "events_ms": events_ms,
            "device_ms": device_ms, "device_events_per_call": per_call,
            "ms_from": "profiler device time" if seen else "cuda events",
            "trace_complete": all(len(d) % reps == 0
                                  for d in by_name.values()),
            "kernel_names": sorted({n[:80] for n in by_name})}


def flash_times(seed, B, S, H, KV, hd, window):
    """Kernel, plain and SDPA times of one causal bf16 flash_attention call
    at [B, S, H over KV, hd], and its bound.  The times are CUDA events,
    the kernel's and SDPA's over the same 20 calls; beside them the
    profiler's device times, and for each reading of the kernel and SDPA
    its achieved TFLOP/s (the operations of ``flash_bound_ms`` over the
    time).  Fails on a reading above the bf16 peak, and unless the trace
    shows the tensor-core kernel."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _qkv(seed, B, S, H, KV, hd, "bfloat16")
    kern = lm_time(lambda: FA.flash_attention(q, k, v, window=window), 20)
    assert any("flash_fwd_wgmma" in n for n in kern["kernel_names"]), \
        kern["kernel_names"]
    plain = lm_time(lambda: FA.flash_attention_plain(q, k, v,
                                                     window=window), 5)
    lib = sdpa_flash(q, k, v, True, window)
    lib_t = lm_time(lib, 20) if lib else None
    lib_err = None if lib is None else float(
        (lib().transpose(1, 2).float()
         - FA.flash_attention_plain(q, k, v, window=window).float())
        .abs().max())
    bnd, by = flash_bound_ms(B, S, H, KV, hd, True, window, "bfloat16")
    flops = 4 * B * H * hd * kept_pairs(S, True, window)
    tflops = {f"{who}_{how}": flops / t[f"{how}_ms"] * 1e-9
              for who, t in (("kernel", kern), ("library", lib_t))
              if t is not None for how in ("events", "device")
              if t[f"{how}_ms"]}
    over = {n: x for n, x in tflops.items() if x > BF16_OPS_PER_S * 1e-12}
    assert not over, f"flash readings above the bf16 peak: {over}"
    return {"ms": kern["events_ms"], "plain_ms": plain["events_ms"],
            "bound_ms": bnd, "bound_by": by,
            "library_ms": lib_t and lib_t["events_ms"],
            "ms_from": "cuda events", "tflops": tflops,
            "library_max_abs_err_vs_plain": lib_err,
            "timings": {"kernel": kern, "plain": plain, "library": lib_t}}


def decode_times(seed, B, Lc, H, KV, hd, pos, window, ring):
    """Kernel (split + combine), plain and SDPA times of one bf16
    decode_attention call over a [B, Lc, KV, hd] cache at ``pos`` (a ring
    cache through its slot map when ``ring``), and its bound."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.modeling.attention import ring_positions
    q, kc, vc = _qkv(seed, B, 1, H, KV, hd, "bfloat16", L=Lc)
    q = q[:, 0].contiguous()
    k_pos = ring_positions(Lc, pos, LM_DEVICE) if ring else None
    kern = lm_time(lambda: DA.decode_attention(
        q, kc, vc, pos, window=window, k_pos=k_pos), 200,
        kernels_per_call=2)
    plain = lm_time(lambda: DA.decode_attention_plain(
        q, kc, vc, pos, window=window, k_pos=k_pos), 50)
    ok = DA._mask(k_pos, Lc, pos, window, q.device)
    lib = sdpa_decode(q, kc, vc, ok)
    lib_t = lm_time(lib, 200) if lib else None
    n_kept = int(ok.sum())
    bnd, by = decode_bound_ms(B, H, KV, hd, n_kept, Lc if ring else 0,
                              "bfloat16")
    return {"ms": kern["ms"], "plain_ms": plain["ms"], "bound_ms": bnd,
            "bound_by": by, "library_ms": lib_t and lib_t["ms"],
            "pos": pos, "slots_kept": n_kept,
            "timings": {"kernel": kern, "plain": plain, "library": lib_t}}


def check_flash_bf16_rel(label, q, k, v, causal, window, cap, got, want):
    """The tighter bf16 check of one flash case: the kernel's relative error
    within FLASH_BF16_REL, and, where a row sees more than one key, each
    control (P rounded to fp8, the scale off by 10%) beyond it.  Returns
    the readings."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    hd = q.shape[-1]
    r = {"kernel": _rel_err(got, want)}
    assert r["kernel"] <= FLASH_BF16_REL, \
        f"flash_attention {label} bfloat16: relative error {r['kernel']} " \
        f"beyond {FLASH_BF16_REL}"
    r["control_p_fp8"] = _rel_err(_coarse_p_attention(
        q, k, v, causal, window, cap, torch.float8_e4m3fn), want)
    r["control_scale_1.1"] = _rel_err(FA.flash_attention_plain(
        q, k, v, causal=causal, window=window, softcap=cap,
        scale=1.1 * hd ** -0.5), want)
    if q.shape[1] > 1 and window != 1:
        for name in ("control_p_fp8", "control_scale_1.1"):
            assert r[name] > FLASH_BF16_REL, \
                f"flash_attention {label}: the bf16 check passes its " \
                f"{name} ({r[name]})"
    return r


def check_attention(flash_cases, decode_cases, seed=0):
    """Each case of both attention kernels against its plain version on
    the card, in bfloat16 and float32, within LM_TOL, and bf16 flash within
    FLASH_BF16_REL (``check_flash_bf16_rel``): the largest abs error by
    kernel and type, the cases checked, and the relative errors of bf16
    flash and its controls by case."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.modeling.attention import ring_positions
    worst = {"flash_attention": {}, "decode_attention": {}}
    checked = {"flash_attention": [], "decode_attention": []}
    rel = {}
    for i, (label, b, S, H, KV, hd, causal, window, cap) in \
            enumerate(flash_cases):
        for dt in ("bfloat16", "float32"):
            q, k, v = _qkv(seed + i, b, S, H, KV, hd, dt)
            got = FA.flash_attention(q, k, v, causal=causal, window=window,
                                     softcap=cap)
            want = FA.flash_attention_plain(q, k, v, causal=causal,
                                            window=window, softcap=cap)
            sync()
            excess, err = _excess(got, want, dt)
            assert excess <= 0, f"flash_attention {label} {dt}: " \
                f"{excess} beyond tolerance"
            if dt == "bfloat16":
                rel[label] = check_flash_bf16_rel(
                    label, q, k, v, causal, window, cap, got, want)
            w = worst["flash_attention"]
            w[dt] = max(w.get(dt, 0.0), err)
            checked["flash_attention"].append(f"{label} {dt}")
    for i, (label, b, Lc, H, KV, hd, pos, window, cap, ring) in \
            enumerate(decode_cases):
        for dt in ("bfloat16", "float32"):
            q, kc, vc = _qkv(seed + 100 + i, b, 1, H, KV, hd, dt, L=Lc)
            q = q[:, 0].contiguous()
            k_pos = ring_positions(Lc, pos, LM_DEVICE) if ring else None
            got = DA.decode_attention(q, kc, vc, pos, window=window,
                                      softcap=cap, k_pos=k_pos)
            want = DA.decode_attention_plain(q, kc, vc, pos, window=window,
                                             softcap=cap, k_pos=k_pos)
            sync()
            excess, err = _excess(got, want, dt)
            assert excess <= 0, f"decode_attention {label} {dt}: " \
                f"{excess} beyond tolerance"
            w = worst["decode_attention"]
            w[dt] = max(w.get(dt, 0.0), err)
            checked["decode_attention"].append(f"{label} {dt}")
    return worst, checked, rel


def _flash_instance(mangled):
    """The label of a mangled kernel name of flash_attention.cu, such as
    'bf16 wgmma hd 128', or None for another function."""
    m = re.search(r"flash_fwd_wgmma_kernelILi(\d+)E", mangled)
    if m:
        return f"bf16 wgmma hd {m.group(1)}"
    m = re.search(r"flash_fwd_kernelIfLi(\d+)E", mangled)
    return f"float32 simt hd {m.group(1)}" if m else None


def flash_build_phase(build, so_path):
    """What the compiler made of flash_attention.cu, per instantiation:
    ptxas's registers, static shared memory and spills (from
    ``build.BUILD_INFO``), the dynamic shared memory of a bf16 block
    (``tc::Cfg``'s SMEM, through ``tile_config``), and the counts of
    tensor-core (HGMMA) and TMA-load (UTMALDG) instructions in
    ``cuobjdump --dump-sass`` of the built library.  Fails unless every
    bf16 instantiation holds both and spills nothing."""
    from repro_torch.kernels import flash_attention as FA
    t0 = time.perf_counter()
    per = {}
    cur = None
    for ln in build.BUILD_INFO["flash_attention"]["log"].splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = _flash_instance(m.group(1))
            if cur:
                per[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            per[cur]["spill_stores"] = int(m.group(1))
            per[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            per[cur]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            per[cur]["static_smem_bytes"] = int(m.group(1))
    for name, info in per.items():
        if name.startswith("bf16"):
            cfg = FA.tile_config(int(name.split()[-1]))
            info.update(BK=cfg["BK"], stages=cfg["NS"],
                        dynamic_smem_bytes=cfg["SMEM"])
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(so_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    for part in sass.split("Function : ")[1:]:
        name = _flash_instance(part.split()[0])
        if name in per:
            per[name]["HGMMA"] = part.count("HGMMA")
            per[name]["UTMALDG"] = part.count("UTMALDG")
    for name, info in per.items():
        assert info.get("spill_stores", 1) == 0, (name, info)
        if name.startswith("bf16"):
            assert info.get("HGMMA", 0) > 0 and info.get("UTMALDG", 0) > 0, \
                (name, info)
    assert sum(n.startswith("bf16") for n in per) == 3, per
    emit("flash_build", t0, instances=per,
         sass_total={"HGMMA": sass.count("HGMMA"),
                     "UTMALDG": sass.count("UTMALDG")})


def lm_kernel_phase():
    """Both attention kernels against their plain versions on the card, in
    bfloat16 and float32, then times at the serving shapes."""
    t0 = time.perf_counter()
    B, Sv, L = SERVE_B, SERVE_PROMPT, SERVE_L
    flash_cases = [   # label, B, S, H, KV, hd, causal, window, cap
        ("serve global", B, Sv, 4, 1, 256, True, 0, 0.0),
        ("serve local window 512", B, Sv, 4, 1, 256, True, 512, 0.0),
        ("softcap 50 H8 KV4", 2, 1024, 8, 4, 256, True, 0, 50.0),
        ("non-causal", 2, 512, 4, 2, 128, False, 0, 0.0),
        ("ragged S=1000 window 512", 2, 1000, 4, 1, 256, True, 512, 0.0),
        ("S=1", 4, 1, 4, 1, 256, True, 0, 0.0),
        ("hd=64 window 128", 2, 512, 8, 2, 64, True, 128, 0.0),
        ("hd=128 softcap 30", 2, 512, 4, 4, 128, True, 0, 30.0),
        ("S=129 hd=128", 2, 129, 4, 1, 128, True, 0, 0.0),
        ("window 16 across a kv tile, first tile fully masked", 1, 384, 2,
         1, 64, True, 16, 0.0),
        ("G=8 hd=128 non-causal", 1, 512, 16, 2, 128, False, 0, 0.0)]
    decode_cases = [  # label, B, L, H, KV, hd, pos, window, cap, ring
        ("serve global pos 2100", B, L, 4, 1, 256, 2100, 0, 0.0, False),
        ("global mid-cache pos 1000", B, L, 4, 1, 256, 1000, 0, 0.0, False),
        ("pos=0", B, L, 4, 1, 256, 0, 0, 0.0, False),
        ("serve local ring pos 2100", B, 512, 4, 1, 256, 2100, 512, 0.0,
         True),
        ("ring first turn, empty slots", B, 512, 4, 1, 256, 300, 512, 0.0,
         True),
        ("softcap 50 H8 KV4", 2, L, 8, 4, 256, 1500, 0, 50.0, False),
        ("G=1 hd=128", 2, L, 4, 4, 128, 700, 0, 0.0, False),
        ("G=8 hd=64 window 256", 2, 1000, 8, 1, 64, 999, 256, 0.0, False)]
    worst, checked, rel = check_attention(flash_cases, decode_cases)

    times = {}
    for name, window in (("global", 0), ("local", 512)):
        times[f"flash_{name}"] = flash_times(7, B, Sv, 4, 1, 256, window)
    for name, Lc, window, ring in (("global", L, 0, False),
                                   ("local", 512, 512, True)):
        times[f"decode_{name}"] = decode_times(
            8, B, Lc, 4, 1, 256, SERVE_PROMPT + SERVE_NEW // 2, window, ring)
    emit("lm_kernel", t0, cases=checked, max_abs_err=worst,
         tolerances=LM_TOL, flash_bf16_rel_err=rel,
         flash_bf16_rel_limit=FLASH_BF16_REL, times=times)
    return worst, times, rel


def lm_serve_phase():
    """gemma3-1b at full width through ``repro_torch.launch.serve.run``:
    batch 8, prompt 2048 (past the 512 window), 64 new tokens.  A short
    warm-up run first; the counts are set to 0 just before the measured
    run and read just after it."""
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    cfg = get_config("gemma3-1b")
    serve.run("gemma3-1b", SERVE_B, SERVE_PROMPT, 4, smoke=False,
              seed=0, device=LM_DEVICE)                     # warm-up
    sync()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        log = os.path.join(tmp, "runtime.jsonl")
        torch.cuda.reset_peak_memory_stats()
        FA.LAUNCHES = DA.LAUNCHES = DA.COMBINE_LAUNCHES = 0
        t1 = time.perf_counter()
        toks = serve.run("gemma3-1b", SERVE_B, SERVE_PROMPT, SERVE_NEW,
                         smoke=False, runtime_log=log, seed=0,
                         device=LM_DEVICE)
        sync()
        wall = time.perf_counter() - t1
        launches = {"flash_attention": FA.LAUNCHES,
                    "decode_attention": DA.LAUNCHES,
                    "decode_attention_combine": DA.COMBINE_LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        with open(log) as f:
            rec = json.loads(f.read().splitlines()[-1])
    assert rec["arch"] == "gemma3-1b" and rec["batch"] == SERVE_B
    assert rec["prompt_len"] == SERVE_PROMPT
    assert rec["prefill_s"] > 0 and rec["decode_median_s"] > 0
    assert tuple(toks.shape) == (SERVE_B, SERVE_NEW)
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    assert launches["flash_attention"] == cfg.n_layers, launches
    steps = SERVE_NEW - 1
    assert launches["decode_attention"] == steps * cfg.n_layers, launches
    assert launches["decode_attention_combine"] == steps * cfg.n_layers
    emit("lm_serve", t0, arch="gemma3-1b", batch=SERVE_B,
         prompt_len=SERVE_PROMPT, max_new=SERVE_NEW,
         prefill_ms=rec["prefill_s"] * 1e3,
         prefill_tokens_per_s=SERVE_B * SERVE_PROMPT / rec["prefill_s"],
         decode_median_ms_per_token=rec["decode_median_s"] * 1e3,
         decode_tokens_per_s=SERVE_B / rec["decode_median_s"],
         run_wall_s=wall, peak_device_bytes=peak, launches=launches,
         runtime_log_line=rec)
    return launches


def _map_tree(fn, tree):
    """``fn`` applied to every tensor of a parameter tree."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def _cpu_f32(tree):
    """A parameter tree as float32 tensors on the CPU."""
    return _map_tree(lambda t: t.float().cpu(), tree)


def lm_parity_phase():
    """One period of gemma3-1b at full width (5 local + 1 global layer),
    batch 1, prompt 1024 (past the window), 8 greedy decode steps: the card
    (bfloat16, kernels) against the CPU (float32, plain versions) on the
    same weights.  The card's decode steps take the CPU's tokens, so every
    step compares the same inputs."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.modeling.model import Model, init_params
    t0 = time.perf_counter()
    cfg = get_config("gemma3-1b", n_layers=6)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params = init_params(cfg, 1, LM_DEVICE)
    card, cpu = Model(cfg, params), Model(cfg32, _cpu_f32(params))
    S, steps, max_seq = 1024, 8, 1024 + 16
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, S)))
    rel, agree, decided, margins = [], 0, 0, []
    with torch.inference_mode():
        c_cpu, c_card = cpu.init_cache(1, max_seq), card.init_cache(1, max_seq)
        want, _ = cpu(prompt, mode="prefill", cache=c_cpu)
        got, _ = card(prompt.to(LM_DEVICE), mode="prefill", cache=c_card)
        for step in range(steps + 1):
            w, g = want[0, -1].double(), got[0, -1].double().cpu()
            err = (g - w).abs().max().item()
            rel.append(((g - w).norm() / w.norm()).item())
            top2 = torch.topk(w, 2).values
            margin = (top2[0] - top2[1]).item()
            margins.append(margin)
            same = int(g.argmax()) == int(w.argmax())
            agree += same
            if margin > 2 * err:          # the card's error cannot flip it
                decided += 1
                assert same, f"step {step}: greedy token differs"
            if step == steps:
                break
            tok = w.argmax().reshape(1, 1)
            pos = S + step
            want, _ = cpu(tok, mode="decode", pos0=pos, cache=c_cpu)
            got, _ = card(tok.to(LM_DEVICE), mode="decode", pos0=pos,
                          cache=c_card)
    assert max(rel) <= PARITY_REL_TOL, rel
    emit("lm_parity", t0, layers=6, prompt_len=S, decode_steps=steps,
         logits_rel_err=rel, max_logits_rel_err=max(rel),
         tolerance=PARITY_REL_TOL,
         greedy_tokens_agree=f"{agree}/{steps + 1}",
         steps_where_margin_exceeds_twice_error=decided,
         top2_margins=margins)
    return max(rel)


def profile_serving(arch, kernel_marks):
    """Device busy time and top device kernels of one full-width prefill
    of ``arch`` (batch 8, prompt 2048; depth cut as ``launch.serve`` cuts
    it, weights drawn on the card) and of 8 decode steps after it, from a
    torch.profiler trace (profiler on: wall times are inflated).  A device
    kernel whose name holds one of ``kernel_marks`` counts as one of the
    port's hand-written kernels; ``launches_by_mark`` counts each mark and
    ``device_s_by_mark`` sums its device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import card_config
    from repro_torch.modeling.model import Model
    from repro_torch.serve.serve_step import make_decode_step, \
        make_prefill_step
    cfg = card_config(arch)
    model = Model.from_seed(cfg, 0, LM_DEVICE, gen_device=LM_DEVICE)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT),
                           generator=torch.Generator().manual_seed(3))
    prompt = prompt.to(LM_DEVICE)
    out = {}
    with torch.inference_mode():
        def run_prefill():
            cache = model.init_cache(SERVE_B, SERVE_L)
            logits, cache = prefill(prompt, cache)
            return logits.argmax(-1), cache

        tok, cache = run_prefill()                       # warm
        sync()

        def run_decode():
            t = tok
            for pos in range(SERVE_PROMPT, SERVE_PROMPT + 8):
                logits, _ = decode(t, pos, cache)
                t = logits.argmax(-1)
            return t

        run_decode()
        sync()
        for name, fn in (("prefill", run_prefill),
                         ("decode_8_steps", run_decode)):
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
                by_name[e.name] = by_name.get(e.name, 0) + \
                    e.time_range.elapsed_us()
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
            ours = [e for e in kernels
                    if any(m in e.name for m in kernel_marks)]
            out[name] = {"wall_s": wall, "device_busy_s": busy_us * 1e-6,
                         "idle_share": 1.0 - busy_us * 1e-6 / wall,
                         "kernel_launches": len(kernels),
                         "hand_written_kernels_seen": len(ours),
                         "launches_by_mark": {
                             m: sum(m in e.name for e in kernels)
                             for m in kernel_marks},
                         "device_s_by_mark": {
                             m: sum(e.time_range.elapsed_us()
                                    for e in kernels if m in e.name) * 1e-6
                             for m in kernel_marks},
                         "hand_written_device_s": sum(
                             e.time_range.elapsed_us() for e in ours) * 1e-6,
                         "top_kernels_us": top}
    return out


def lm_profile_phase():
    """profile_serving for gemma3-1b: the flash and decode kernels."""
    t0 = time.perf_counter()
    emit("lm_profile", t0, **profile_serving("gemma3-1b",
                                             ("flash_fwd", "decode_")))


# -------------------------------------------------------------- RWKV slice

RWKV_ARCH = "rwkv6-3b"
# rwkv6-3b's serving shape inside the kernel: 40 heads of 64
RWKV_H, RWKV_HD = 40, 64
# tests/test_kernels.py's wkv6 tolerance: atol 2e-4, rtol 1e-3 (float32
# sums in another order, chunk-local exponents up to 72)
WKV_ATOL, WKV_RTOL = 2e-4, 1e-3


def wkv6_bound_ms(B, S, H, hd):
    """Least time for one call: r, k, v, w read once, y written once, u,
    s0 read and s_end written, float32, at the HBM rate; against the
    products' float32 operations per (b, h, chunk of 16): scores and their
    product with v (16 x 16 x hd each), the carried-state term and the
    state update (16 x hd x hd each), two operations per multiply-add."""
    nbytes = 4 * (5 * B * S * H * hd + H * hd + 2 * B * H * hd * hd)
    flops = 2 * (2 * 16 * 16 * hd + 2 * 16 * hd * hd) * B * H * (S // 16)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _wkv_inputs(seed, B, S, H, hd, s0=True, log_w_min=None, zero_u=False):
    """Seeded float32 inputs on the card: r, k, v ~ N(0, 0.5^2), decays in
    RWKV6's domain w = exp(-exp(x)), x = clip(N(0, 1), -8, 2), or log w
    uniform in [log_w_min, -0.01]; u ~ N(0, 0.3^2), s0 ~ N(0, 0.5^2)."""
    import torch
    g = torch.Generator(device=LM_DEVICE).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=LM_DEVICE)
    r, k, v = (0.5 * randn(B, S, H, hd) for _ in range(3))
    if log_w_min is None:
        w = torch.exp(-torch.exp(randn(B, S, H, hd).clamp(-8.0, 2.0)))
    else:
        w = torch.exp(log_w_min + (-0.01 - log_w_min) * torch.rand(
            B, S, H, hd, generator=g, device=LM_DEVICE))
    u = torch.zeros(H, hd, device=LM_DEVICE) if zero_u else 0.3 * randn(H, hd)
    return r, k, v, w, u, (0.5 * randn(B, H, hd, hd) if s0 else None)


def _wkv_excess(got, want):
    """Largest |got - want| beyond atol + rtol |want|, and the largest
    |got - want|, over y and the state."""
    ex, err = -float("inf"), 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(g.isfinite().all())
        d = (g - w).abs()
        ex = max(ex, float((d - WKV_ATOL - WKV_RTOL * w.abs()).max()))
        err = max(err, float(d.max()))
    return ex, err


def rwkv_kernel_phase():
    """The WKV6 kernel against its chunked plain version at rwkv6-3b's
    serving shape, and against both plain versions on the edge cases; then
    device times at the serving shape and the bound."""
    import torch
    from repro_torch.kernels import wkv6 as WK
    t0 = time.perf_counter()
    B, S, H, hd = SERVE_B, SERVE_PROMPT, RWKV_H, RWKV_HD
    checked, worst = [], {"vs_chunked_plain": 0.0, "vs_sequential_plain": 0.0}

    def check(label, got, want, which):
        excess, err = _wkv_excess(got, want)
        assert excess <= 0, f"wkv6 {label} vs {which}: {excess} beyond " \
            "tolerance"
        worst[which] = max(worst[which], err)
        checked.append(f"{label} {which}")

    serve_in = _wkv_inputs(0, B, S, H, hd)
    got = WK.wkv6(*serve_in)
    check(f"serve B{B} S{S} H{H} hd{hd}", got, WK.wkv6_plain(*serve_in),
          "vs_chunked_plain")
    cases = [   # label, B, S, H, hd, s0, log w down to, u = 0
        ("given s0", 2, 64, 4, 64, True, None, False),
        ("S=32 two chunks", 2, 32, 4, 64, True, None, False),
        ("B=1 H=1", 1, 64, 1, 64, True, None, False),
        ("hd=32", 2, 64, 4, 32, True, None, False),
        ("log w down to -12", 2, 64, 4, 64, True, -12.0, False),
        ("u=0", 2, 64, 4, 64, True, None, True),
        ("s0=None", 2, 64, 4, 64, False, None, False)]
    w_min = float(np.exp(WK.LOG_W_MIN))
    for i, (label, b, s, h, d, s0, lw_min, zero_u) in enumerate(cases):
        r, k, v, w, u, st = _wkv_inputs(10 + i, b, s, h, d, s0, lw_min,
                                        zero_u)
        got = WK.wkv6(r, k, v, w, u, st)
        check(label, got, WK.wkv6_plain(r, k, v, w, u, st),
              "vs_chunked_plain")
        # the exact recurrence on the clamped decays (log w >= -9)
        check(label, got, WK.wkv6_sequential_plain(
            r, k, v, w.clamp(min=w_min), u, st), "vs_sequential_plain")
    r, k, v, w, u, st = _wkv_inputs(30, 2, 128, 4, 64)
    y, s_end = WK.wkv6(r, k, v, w, u, st)
    y1, s1 = WK.wkv6(*(t[:, :64].contiguous() for t in (r, k, v, w)), u, st)
    y2, s2 = WK.wkv6(*(t[:, 64:].contiguous() for t in (r, k, v, w)), u, s1)
    check("split across two calls", (torch.cat([y1, y2], 1), s2),
          (y, s_end), "vs_chunked_plain")
    sync()

    kern = lm_time(lambda: WK.wkv6(*serve_in), 20)
    plain = lm_time(lambda: WK.wkv6_plain(*serve_in), 3)
    bnd, by = wkv6_bound_ms(B, S, H, hd)
    times = {"ms": kern["ms"], "plain_ms": plain["ms"], "bound_ms": bnd,
             "bound_by": by, "library_ms": None,
             "timings": {"kernel": kern, "plain": plain}}
    emit("rwkv_kernel", t0, cases=checked, max_abs_err=worst,
         tolerance={"atol": WKV_ATOL, "rtol": WKV_RTOL}, times=times,
         library="none: no one PyTorch call computes WKV6")
    return max(worst.values()), times


def rwkv_profile_phase():
    """profile_serving for rwkv6-3b: the WKV6 kernel, seen in the prefill
    only.  It runs before rwkv_serve and leaves the card warm for it."""
    t0 = time.perf_counter()
    out = profile_serving(RWKV_ARCH, ("wkv6_kernel",))
    assert out["prefill"]["hand_written_kernels_seen"] > 0
    assert out["decode_8_steps"]["hand_written_kernels_seen"] == 0
    emit("rwkv_profile", t0, **out)


def rwkv_serve_phase():
    """rwkv6-3b at full width and depth through
    ``repro_torch.launch.serve.run``: batch 8, prompt 2048 (128 chunks of
    16), 64 new tokens.  rwkv_profile ran the same shapes before it, so
    the card is warm.  The count is set to 0 just before the run and read
    just after it: the prefill launches the kernel once per layer, and no
    decode step launches it (S = 1 takes the sequential branch)."""
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import wkv6 as WK
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    cfg = get_config(RWKV_ARCH)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        log = os.path.join(tmp, "runtime.jsonl")
        torch.cuda.reset_peak_memory_stats()
        WK.LAUNCHES = 0
        t1 = time.perf_counter()
        toks = serve.run(RWKV_ARCH, SERVE_B, SERVE_PROMPT, SERVE_NEW,
                         smoke=False, runtime_log=log, seed=0,
                         device=LM_DEVICE)
        sync()
        wall = time.perf_counter() - t1
        launches = WK.LAUNCHES
        peak = torch.cuda.max_memory_allocated()
        with open(log) as f:
            rec = json.loads(f.read().splitlines()[-1])
    assert rec["arch"] == RWKV_ARCH and rec["batch"] == SERVE_B
    assert rec["prompt_len"] == SERVE_PROMPT
    assert rec["prefill_s"] > 0 and rec["decode_median_s"] > 0
    assert tuple(toks.shape) == (SERVE_B, SERVE_NEW)
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    assert launches == cfg.n_layers, launches
    emit("rwkv_serve", t0, arch=RWKV_ARCH, layers=cfg.n_layers,
         d_model=cfg.d_model, params=cfg.param_counts()["total"],
         batch=SERVE_B, prompt_len=SERVE_PROMPT, max_new=SERVE_NEW,
         prefill_ms=rec["prefill_s"] * 1e3,
         prefill_tokens_per_s=SERVE_B * SERVE_PROMPT / rec["prefill_s"],
         decode_median_ms_per_token=rec["decode_median_s"] * 1e3,
         decode_tokens_per_s=SERVE_B / rec["decode_median_s"],
         run_wall_s=wall, peak_device_bytes=peak,
         launches={"wkv6": launches}, runtime_log_line=rec)
    return launches


def rwkv_parity_phase():
    """rwkv6-3b at full width with depth cut to 4 layers, batch 1, prompt
    512 (32 chunks), 8 decode steps: the card (bfloat16 activations and
    state, the kernel) against the CPU (float32, plain versions) on the
    same weights.  The card's decode steps take the CPU's tokens, so every
    step compares the same inputs.  The state round-trips through bf16
    after the prefill and every step, as in the reference; the per-step
    errors and the states' relative errors show how far that drifts."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.modeling.model import Model, init_params
    t0 = time.perf_counter()
    cfg = get_config(RWKV_ARCH, n_layers=4)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params = init_params(cfg, 1, LM_DEVICE)
    card, cpu = Model(cfg, params), Model(cfg32, _cpu_f32(params))
    S, steps = 512, 8
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, S)))
    rel, agree, decided, margins, state_rel = [], 0, 0, [], []
    with torch.inference_mode():
        c_cpu, c_card = cpu.init_cache(1, S), card.init_cache(1, S)
        want, _ = cpu(prompt, mode="prefill", cache=c_cpu)
        got, _ = card(prompt.to(LM_DEVICE), mode="prefill", cache=c_card)
        for step in range(steps + 1):
            w, g = want[0, -1].double(), got[0, -1].double().cpu()
            err = (g - w).abs().max().item()
            rel.append(((g - w).norm() / w.norm()).item())
            state_rel.append(max(
                ((a["s"].double().cpu() - b["s"].double()).norm()
                 / b["s"].double().norm()).item()
                for a, b in zip(c_card, c_cpu)))
            top2 = torch.topk(w, 2).values
            margin = (top2[0] - top2[1]).item()
            margins.append(margin)
            same = int(g.argmax()) == int(w.argmax())
            agree += same
            if margin > 2 * err:          # the card's error cannot flip it
                decided += 1
                assert same, f"step {step}: greedy token differs"
            if step == steps:
                break
            tok = w.argmax().reshape(1, 1)
            pos = S + step
            want, _ = cpu(tok, mode="decode", pos0=pos, cache=c_cpu)
            got, _ = card(tok.to(LM_DEVICE), mode="decode", pos0=pos,
                          cache=c_card)
    assert max(rel) <= PARITY_REL_TOL, rel
    emit("rwkv_parity", t0, layers=4, prompt_len=S, decode_steps=steps,
         logits_rel_err=rel, max_logits_rel_err=max(rel),
         tolerance=PARITY_REL_TOL, state_rel_err_max_over_layers=state_rel,
         greedy_tokens_agree=f"{agree}/{steps + 1}",
         steps_where_margin_exceeds_twice_error=decided,
         top2_margins=margins)
    return max(rel)


# ------------------------------------------------------------- jamba slice

JAMBA_ARCH = "jamba-1.5-large-398b"
# the mamba layers' scan at jamba-1.5-large's serving shape: d_inner 16,384,
# d_state 16
JAMBA_D, JAMBA_N = 16384, 16
# its attention layer: 64 query heads over 8 KV heads of 128
JAMBA_H, JAMBA_KV, JAMBA_HD = 64, 8, 128
# mamba_scan against its plain version: float32 exponentials (the kernel's
# ex2.approx is ~1e-6 relative from torch.exp) and products in another
# order, over up to 2,048 steps whose decays keep the state O(1)
SCAN_ATOL, SCAN_RTOL = 1e-4, 1e-3
# bf16 y: both sides round float32 values ~1e-6 apart to bf16, which may
# land one bf16 step apart (2**-8 relative, 2**-7 at most)
SCAN_BF16_RTOL = 2.0 ** -7
# special-function unit rate of one Hopper SM: 16 exponentials per
# clock (CUDA C++ programming guide, arithmetic instruction throughput,
# compute capability 9.0)
SFU_PER_SM_CLOCK = 16
# float32-pipe instructions of one exponential computed without the
# special-function unit: range reduction (round, subtract), a degree-5
# polynomial (5 FMAs) and the exponent insert
EXP_EMULATION_FMAS = 8
# jamba_parity, float32 on both sides (the card's kernels, TF32 off,
# against the CPU's plain versions): float32 sums in another order through
# 4 layers move logits of magnitude ~1 by ~1e-5; 1e-3 relative leaves room
# and a wrong layout, cast or routing gives errors of order 1
JAMBA_F32_TOL = 1e-3


def scan_bound_ms(B, S, D, N, u_item):
    """Least time for one mamba_scan call: u read and y written in u's
    type, dt read in float32, A, B_in, C_in, h0 read and h_end written, at
    the HBM rate; against the operations: the float32 products (dt*A,
    h*dA, du*B, the add, h*C and its sum for every (b, t, d, n), dt*u for
    every (b, t, d)) at the float32 peak, and the B*S*D*N exponentials
    split between the special-function units (their rate at the card's
    maximum SM clock) and a polynomial on the float32 pipes
    (EXP_EMULATION_FMAS FMAs each, 2 operations an FMA) in the share that
    finishes both at once."""
    import torch
    nbytes = 2 * u_item * B * S * D + 4 * B * S * D + 4 * (
        D * N + 2 * B * S * N + 2 * B * D * N)
    flops = 6 * B * S * D * N + B * S * D
    n_exp = B * S * D * N
    mhz = max_sm_clock_mhz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_fp32 = flops / FP32_OPS_PER_S * 1e3
    t_sfu = n_exp / (sms * SFU_PER_SM_CLOCK * mhz * 1e6) * 1e3
    t_emul = 2 * EXP_EMULATION_FMAS * n_exp / FP32_OPS_PER_S * 1e3
    # share f emulated: t_fp32 + f * t_emul = (1 - f) * t_sfu
    f = min(max((t_sfu - t_fp32) / (t_emul + t_sfu), 0.0), 1.0)
    t_ops = max(t_fp32 + f * t_emul, (1 - f) * t_sfu)
    parts = {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "fp32_ops_ms": t_fp32, "exp_sfu_only_ms": t_sfu,
             "exp_emulated_share": f, "operations_ms": t_ops,
             "max_sm_clock_mhz": mhz, "sms": sms}
    if parts["bytes_ms"] >= t_ops:
        return parts["bytes_ms"], "bytes", parts
    return t_ops, "operations", parts


def serve_bounds_ms(cfg, B, S):
    """Least times of one serving prefill and one decode step of ``cfg``
    at batch B and prompt S: the prefill's bf16 products (projections,
    FFNs, the MoE router and its experts over all E*C capacity slots, the
    causal attention scores, the last position's head) at the bf16 peak;
    a decode step's read of every weight once at the HBM rate."""
    from repro_torch.modeling import moe
    T, d, hd = B * S, cfg.d_model, cfg.resolved_head_dim
    din, n, dtr = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.resolved_dt_rank
    macs = B * d * cfg.padded_vocab_size                  # the head
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) == "mamba":
            macs += T * (d * 2 * din + din * (dtr + 2 * n) + dtr * din
                         + din * d)
        else:
            macs += T * d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
            macs += 2 * B * cfg.n_heads * hd * kept_pairs(S, True, 0)
        if cfg.is_moe_layer(i):
            macs += T * d * cfg.n_experts + cfg.n_experts * moe.capacity(
                cfg, T) * 3 * d * cfg.moe_d_ff
        else:
            macs += T * 3 * d * cfg.d_ff
    weight_bytes = 2 * cfg.param_counts()["total"]
    return {"prefill_products_ms": 2 * macs / BF16_OPS_PER_S * 1e3,
            "prefill_tflop": 2 * macs / 1e12,
            "decode_weight_read_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
            "weight_bytes": weight_bytes}


def _scan_inputs(seed, B, S, D, N, h0=True, dt_max=None, u_bf16=False):
    """Seeded inputs on the card: u ~ N(0, 0.5^2), dt = softplus(N(0,
    0.3^2)) (or uniform in [0, dt_max]), A = -exp(N(0, 0.3^2)) random in
    every entry (a transposed A would show), B_in, C_in ~ N(0, 0.5^2),
    h0 ~ N(0, 0.5^2)."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device=LM_DEVICE).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=LM_DEVICE)
    u = 0.5 * randn(B, S, D)
    if u_bf16:
        u = u.bfloat16()
    if dt_max is None:
        dt = F.softplus(0.3 * randn(B, S, D))
    else:
        dt = dt_max * torch.rand(B, S, D, generator=g, device=LM_DEVICE)
    A = -torch.exp(0.3 * randn(D, N))
    return [u, dt, A, 0.5 * randn(B, S, N), 0.5 * randn(B, S, N),
            0.5 * randn(B, D, N) if h0 else None]


def _scan_excess(got, want):
    """Largest |got - want| beyond the tolerance, and the largest
    |got - want|, over y and h_end (y in bf16 gets one bf16 step)."""
    ex, err = -float("inf"), 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert bool(g.isfinite().all())
        rtol = SCAN_BF16_RTOL if g.dtype == _tdtype("bfloat16") else \
            SCAN_RTOL
        g, w = g.float(), w.float()
        d = (g - w).abs()
        ex = max(ex, float((d - SCAN_ATOL - rtol * w.abs()).max()))
        err = max(err, float(d.max()))
    return ex, err


def jamba_kernel_phase():
    """The selective-scan kernel against its plain version on the card: the
    serving shape with a given h0, then h0 = None, a sequence split across
    two calls (carrying h) against one call, B 1 with a small ragged D,
    bf16 u, and dt * A down to about -50 (exponentials that underflow);
    N 16, 8 and 4.  Then CUDA-event times at the serving shape and the
    bound.  Last, the attention layer's kernels at the shapes jamba's path
    gives them (flash over the 8 x 2048 prompt, 64 heads over 8 KV heads of
    128; decode over the 2,120-slot cache), against their plain versions
    in bf16 and float32 within LM_TOL, and their times, bounds and SDPA
    times in bf16."""
    import torch
    from repro_torch.kernels import mamba_scan as MS
    t0 = time.perf_counter()
    B, S, D, N = SERVE_B, SERVE_PROMPT, JAMBA_D, JAMBA_N
    checked, worst = [], {}

    def check(label, got, want):
        excess, err = _scan_excess(got, want)
        assert excess <= 0, f"mamba_scan {label}: {excess} beyond tolerance"
        dt = str(got[0].dtype).split(".")[-1]     # y's type, u's type
        worst[dt] = max(worst.get(dt, 0.0), err)
        checked.append(label)

    serve_in = _scan_inputs(0, B, S, D, N)
    check(f"serve B{B} S{S} D{D} N{N} given h0", MS.mamba_scan(*serve_in),
          MS.mamba_scan_plain(*serve_in))
    cases = [   # label, B, S, D, N, h0, dt_max, bf16 u
        ("h0=None N8", 2, 256, 2048, 8, False, None, False),
        ("B=1 D=100 S=77 N4", 1, 77, 100, 4, True, None, False),
        ("bf16 u", 2, 256, 2048, 16, True, None, True),
        ("dt*A down to -50", 2, 256, 2048, 16, True, 20.0, False)]
    min_dta = 0.0
    for i, (label, b, s, d, n, h0, dt_max, bf) in enumerate(cases):
        ins = _scan_inputs(10 + i, b, s, d, n, h0, dt_max, bf)
        if dt_max is not None:
            dt_max_d = ins[1].amax(dim=(0, 1))
            min_dta = float((dt_max_d[:, None] * ins[2]).min())
        check(label, MS.mamba_scan(*ins), MS.mamba_scan_plain(*ins))
    u, dt, A, Bi, Ci, h0 = _scan_inputs(30, 2, 500, 2048, 16)
    y, h = MS.mamba_scan(u, dt, A, Bi, Ci, h0)
    cut = 197                  # off the 64-step tiles and 8-step groups
    y1, h1 = MS.mamba_scan(*(t[:, :cut].contiguous() for t in (u, dt)), A,
                           *(t[:, :cut].contiguous() for t in (Bi, Ci)), h0)
    y2, h2 = MS.mamba_scan(*(t[:, cut:].contiguous() for t in (u, dt)), A,
                           *(t[:, cut:].contiguous() for t in (Bi, Ci)), h1)
    check("split across two calls", (torch.cat([y1, y2], 1), h2), (y, h))
    sync()
    assert min_dta < -45.0, min_dta

    kern_ms = cuda_ms(lambda: MS.mamba_scan(*serve_in), 10)
    plain = lm_time(lambda: MS.mamba_scan_plain(*serve_in), 2)
    bnd, by, parts = scan_bound_ms(B, S, D, N, 4)
    times = {"ms": kern_ms, "plain_ms": plain["events_ms"], "bound_ms": bnd,
             "bound_by": by, "library_ms": None, "bound_parts": parts,
             "ms_from": "cuda events", "plain_timings": plain}
    del serve_in
    _free_card()

    H, KV, hd = JAMBA_H, JAMBA_KV, JAMBA_HD
    attn_worst, attn_checked, attn_rel = check_attention(
        [("jamba attention layer", B, S, H, KV, hd, True, 0, 0.0)],
        [("jamba decode pos 2100", B, SERVE_L, H, KV, hd, 2100, 0, 0.0,
          False)], seed=200)
    attn_times = {
        "flash_attention": flash_times(207, B, S, H, KV, hd, 0),
        "decode_attention": decode_times(
            208, B, SERVE_L, H, KV, hd, SERVE_PROMPT + SERVE_NEW // 2, 0,
            False)}
    attn = {"max_abs_err": attn_worst, "flash_bf16_rel_err": attn_rel,
            "times": attn_times}
    _free_card()
    emit("jamba_kernel", t0, cases=checked, max_abs_err_by_dtype=worst,
         tolerance={"atol": SCAN_ATOL, "rtol": SCAN_RTOL,
                    "rtol_bf16_y": SCAN_BF16_RTOL},
         min_dt_times_A=min_dta, times=times,
         library="none: no one PyTorch call computes a selective scan",
         attention_cases=attn_checked, attention_tolerances=LM_TOL,
         flash_bf16_rel_limit=FLASH_BF16_REL, attention=attn)
    return worst, times, attn


def _free_card():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def jamba_profile_phase():
    """profile_serving for jamba-1.5-large cut to 4 layers: the scan kernel
    (seen in the prefill only), flash attention and the decode kernels.
    It runs before jamba_serve and leaves the card warm for it."""
    t0 = time.perf_counter()
    _free_card()
    marks = ("mamba_scan_kernel", "flash_fwd", "decode_split",
             "decode_combine")
    out = profile_serving(JAMBA_ARCH, marks)
    _free_card()
    assert out["prefill"]["launches_by_mark"]["mamba_scan_kernel"] == 3
    decode = out["decode_8_steps"]["launches_by_mark"]
    assert decode["mamba_scan_kernel"] == 0
    emit("jamba_profile", t0, **out)


def jamba_serve_phase():
    """jamba-1.5-large at full width, cut to its first 4 layers (mamba +
    FFN, mamba + MoE, mamba + FFN, attention + MoE), through
    ``repro_torch.launch.serve.run``: batch 8, prompt 2048, 64 new tokens,
    weights drawn on the card.  The counts are set to 0 just before the
    run and read just after it: the prefill launches the scan kernel once
    per mamba layer and flash attention once; each of the 63 decode steps
    launches the decode kernels once and the scan kernel never.  A forward
    pre-hook keeps a reference to each MoE input (no device work, no
    synchronisation; it holds one 268 MB prefill input a little longer),
    from which the share of dropped (token, k) assignments is recomputed
    after the run."""
    import contextlib
    import io
    import tempfile
    import torch
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.launch import serve
    from repro_torch.modeling import moe
    t0 = time.perf_counter()
    cfg = serve.card_config(JAMBA_ARCH)
    seen = []

    def keep_input(module, args):
        if isinstance(module, moe.MoE):
            seen.append((module.p["router"], args[0]))

    _free_card()
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        keep_input)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            log = os.path.join(tmp, "runtime.jsonl")
            torch.cuda.reset_peak_memory_stats()
            out = io.StringIO()
            MS.LAUNCHES = FA.LAUNCHES = DA.LAUNCHES = DA.COMBINE_LAUNCHES = 0
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                toks = serve.run(JAMBA_ARCH, SERVE_B, SERVE_PROMPT,
                                 SERVE_NEW, smoke=False, runtime_log=log,
                                 seed=0, device=LM_DEVICE)
            sync()
            wall = time.perf_counter() - t1
            launches = {"mamba_scan": MS.LAUNCHES,
                        "flash_attention": FA.LAUNCHES,
                        "decode_attention": DA.LAUNCHES,
                        "decode_attention_combine": DA.COMBINE_LAUNCHES}
            peak = torch.cuda.max_memory_allocated()
            with open(log) as f:
                rec = json.loads(f.read().splitlines()[-1])
    finally:
        hook.remove()
    line = out.getvalue().strip()
    print(line, file=sys.stderr, flush=True)
    init_s = float(line.split("init ")[1].split("s;")[0])
    drops = {"prefill": [0, 0], "decode": [0, 0]}
    with torch.inference_mode():
        for router, x in seen:
            xt = x.reshape(-1, cfg.d_model)
            ids = moe.route(cfg, router, xt)[0]
            pos = moe.queue_positions(ids, cfg.n_experts)
            d = drops["prefill" if xt.shape[0] > SERVE_B else "decode"]
            d[0] += int((pos >= moe.capacity(cfg, xt.shape[0])).sum())
            d[1] += ids.numel()
    seen.clear()
    _free_card()
    n_mamba = sum(cfg.layer_kind(i) == "mamba" for i in range(cfg.n_layers))
    steps = SERVE_NEW - 1
    assert rec["arch"] == JAMBA_ARCH and rec["batch"] == SERVE_B
    assert rec["prompt_len"] == SERVE_PROMPT
    assert rec["n_layers"] == cfg.n_layers == 4, rec
    assert rec["prefill_s"] > 0 and rec["decode_median_s"] > 0
    assert tuple(toks.shape) == (SERVE_B, SERVE_NEW)
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    assert n_mamba == 3 and launches["mamba_scan"] == n_mamba, launches
    assert launches["flash_attention"] == 1, launches
    assert launches["decode_attention"] == steps, launches
    assert launches["decode_attention_combine"] == steps, launches
    emit("jamba_serve", t0, arch=JAMBA_ARCH, layers=cfg.n_layers,
         d_model=cfg.d_model, params=cfg.param_counts()["total"],
         batch=SERVE_B, prompt_len=SERVE_PROMPT, max_new=SERVE_NEW,
         init_s=init_s, prefill_ms=rec["prefill_s"] * 1e3,
         prefill_tokens_per_s=SERVE_B * SERVE_PROMPT / rec["prefill_s"],
         decode_median_ms_per_token=rec["decode_median_s"] * 1e3,
         decode_tokens_per_s=SERVE_B / rec["decode_median_s"],
         run_wall_s=wall, peak_device_bytes=peak, launches=launches,
         bounds=serve_bounds_ms(cfg, SERVE_B, SERVE_PROMPT),
         moe_dropped_share={k: v[0] / v[1] for k, v in drops.items()},
         moe_assignments=drops, runtime_log_line=rec)
    return launches


def _moe_inputs(model):
    """Forward pre-hooks that record each MoE layer's input: returns the
    list they append (layer index, input) to, and the hook handles."""
    seen, handles = [], []
    for i, layer in enumerate(model.layers):
        if layer.moe is not None:
            handles.append(layer.moe.register_forward_pre_hook(
                lambda mod, args, i=i: seen.append((i, args[0]))))
    return seen, handles


def _routing(model, seen):
    """Per recorded MoE input: the expert ids [T, K] its router gives."""
    from repro_torch.modeling import moe
    cfg = model.cfg
    return [moe.route(cfg, model.layers[i].moe.p["router"],
                      x.reshape(-1, cfg.d_model))[0].cpu()
            for i, x in seen]


def _routing_diff(got, want):
    """(token, k) assignments of ``got`` whose expert is not among the
    token's experts in ``want``: over all tokens, and at the last one."""
    total = last = 0
    for g, w in zip(got, want):
        miss = ~(g[:, :, None] == w[:, None, :]).any(-1)
        total += int(miss.sum())
        last += int(miss[-1].sum())
    return total, last


def jamba_parity_phase():
    """jamba-1.5-large's first 4 layers at full width with d_ff and
    moe_d_ff cut from 24,576 to 2,048 (3.66 B parameters, 14.6 GB in
    float32), batch 1, prompt 256, 8 decode steps.  One set of float32
    weights drawn on the card; the CPU (float32, plain versions) runs
    first, and the card's decode steps take the CPU's greedy tokens.  The
    card in float32 (kernels, TF32 off) is held to JAMBA_F32_TOL relative
    on the last-position logits and to the CPU's greedy tokens.  The card
    in bf16 (the same weights rounded) is reported per step, with the MoE
    routing recomputed from each MoE layer's recorded input on both sides;
    its logits are held to PARITY_REL_TOL only at steps where the last
    position's routing agrees with the CPU's in every MoE layer."""
    import dataclasses
    import torch
    from repro_torch.launch.serve import card_config
    from repro_torch.modeling.model import Model, init_params
    t0 = time.perf_counter()
    _free_card()
    cfg = card_config(JAMBA_ARCH, d_ff=2048, moe_d_ff=2048)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params = init_params(cfg32, 1, LM_DEVICE, gen_device=LM_DEVICE)
    cpu = Model(cfg32, _cpu_f32(params))
    S, steps = 256, 8
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, S)))

    def drive(model, toks=None):
        """Prefill, then ``steps`` decode steps on ``toks`` (or greedy):
        per step the last-position logits (float64, CPU) and the routing
        of every MoE input."""
        seen, handles = _moe_inputs(model)
        dev = model.device
        logits, routes, fed = [], [], []
        with torch.inference_mode():
            cache = model.init_cache(1, S + steps)
            out, _ = model(prompt.to(dev), mode="prefill", cache=cache)
            for step in range(steps + 1):
                logits.append(out[0, -1].double().cpu())
                routes.append(_routing(model, seen))
                seen.clear()
                if step == steps:
                    break
                tok = (logits[-1].argmax() if toks is None
                       else toks[step]).reshape(1, 1)
                fed.append(tok)
                out, _ = model(tok.to(dev), mode="decode", pos0=S + step,
                               cache=cache)
        for h in handles:
            h.remove()
        return logits, routes, fed

    want, want_routes, toks = drive(cpu)
    del cpu
    gc.collect()
    report = {}
    makers = {"float32": lambda: Model(cfg32, params),
              "bfloat16": lambda: Model(cfg, _map_tree(
                  lambda t: t.to(_tdtype("bfloat16")), params))}
    for name, make in makers.items():
        model = make()
        got, routes, _ = drive(model, toks)
        del model
        _free_card()
        rel, agree, diff_all, diff_last = [], 0, [], []
        for step, (g, w) in enumerate(zip(got, want)):
            rel.append(((g - w).norm() / w.norm()).item())
            agree += int(g.argmax()) == int(w.argmax())
            a, last = _routing_diff(routes[step], want_routes[step])
            diff_all.append(a)
            diff_last.append(last)
        report[name] = {"logits_rel_err": rel,
                        "max_logits_rel_err": max(rel),
                        "greedy_tokens_agree": f"{agree}/{steps + 1}",
                        "routing_assignments_differing": diff_all,
                        "routing_differs_at_last_position": diff_last}
        if name == "float32":
            assert max(rel) <= JAMBA_F32_TOL, rel
            assert agree == steps + 1, "float32 greedy tokens differ"
        else:
            held = [r for r, d in zip(rel, diff_last) if d == 0]
            assert held and max(held) <= PARITY_REL_TOL, (rel, diff_last)
            report[name]["steps_held"] = len(held)
    del params
    _free_card()
    emit("jamba_parity", t0, layers=cfg.n_layers, d_ff=cfg.d_ff,
         moe_d_ff=cfg.moe_d_ff,
         params=cfg.param_counts()["total"], prompt_len=S,
         decode_steps=steps,
         cuts="depth 72 -> 4 layers; d_ff and moe_d_ff 24,576 -> 2,048; "
              "batch 1, prompt 256",
         tolerance={"float32": JAMBA_F32_TOL, "bfloat16": PARITY_REL_TOL},
         moe_tokens_prefill=S, **report)
    return report["float32"]["max_logits_rel_err"]


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
    built = build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {n: [ln for ln in info["log"].splitlines()
                 if "registers" in ln or "Compiling entry" in ln
                 or "spill" in ln]
             for n, info in build.BUILD_INFO.items()}
    emit("device", t0, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         build_s=build_s, nvcc_s={n: i["seconds"]
                                  for n, i in build.BUILD_INFO.items()},
         ptxas=ptxas)

    flash_build_phase(build, built["flash_attention"])
    max_abs, times = kernel_phase(dev)
    lm_worst, lm_times, lm_rel = lm_kernel_phase()

    # ---- main path of slice 1: counts from 0 before it, read after it
    K.LAUNCHES = 0
    hub = make_hub("cuda")
    fit_rows = fit_phase(hub, "cuda")
    serve_phase(hub)
    loop_phase(hub)
    launches = K.LAUNCHES
    assert launches > 0, "main path never launched the GBM kernel"

    parity_phase(fit_rows)
    profile_phase(hub)

    # ---- main path of slice 2 (lm_serve sets its counts to 0 itself)
    lm_launches = lm_serve_phase()
    lm_parity_phase()
    lm_profile_phase()

    # ---- main path of slice 3 (rwkv_serve sets its count to 0 itself)
    wkv_err, wkv_times = rwkv_kernel_phase()
    rwkv_profile_phase()
    wkv_launches = rwkv_serve_phase()
    rwkv_parity_phase()

    # ---- main path of slice 4 (jamba_serve sets its counts to 0 itself)
    scan_err, scan_times, jamba_attn = jamba_kernel_phase()
    jamba_profile_phase()
    jamba_launches = jamba_serve_phase()
    jamba_parity_phase()

    serve, big = times["serve_d3"], times["n2p20_d3"]
    fg, fl = lm_times["flash_global"], lm_times["flash_local"]
    dg, dl = lm_times["decode_global"], lm_times["decode_local"]
    fj, dj = (jamba_attn["times"][k]
              for k in ("flash_attention", "decode_attention"))
    errs = {k: {dt: max(lm_worst[k][dt], jamba_attn["max_abs_err"][k][dt])
                for dt in lm_worst[k]} for k in lm_worst}
    rels = list(lm_rel.values()) + list(jamba_attn["flash_bf16_rel_err"]
                                        .values())
    print(json.dumps({"kernels": [{
        "name": "gbm_predict", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gbm_predict.cu",
        "replaces": "src/repro/kernels/gbm_predict.py:58",
        "launches": launches, "max_abs_err": max_abs,
        "ms": serve[0], "plain_ms": serve[1], "bound_ms": serve[2],
        "bound_by": serve[3], "library_ms": None,
        "shape": f"n={N_CONTEXTS * len(SCALEOUTS)} d=3 T=200 D=3",
        "ms_n2p20": big[0], "plain_ms_n2p20": big[1],
        "bound_ms_n2p20": big[2]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:72",
        "launches": lm_launches["flash_attention"],
        "max_abs_err": max(errs["flash_attention"].values()),
        "max_abs_err_by_dtype": errs["flash_attention"],
        "rel_err_bf16": max(r["kernel"] for r in rels),
        "rel_err_bf16_limit": FLASH_BF16_REL,
        "rel_err_bf16_least_control": min(
            min(r["control_p_fp8"], r["control_scale_1.1"])
            for r in rels if r["control_p_fp8"] > 0),
        "ms": fg["ms"], "plain_ms": fg["plain_ms"],
        "bound_ms": fg["bound_ms"], "bound_by": fg["bound_by"],
        "library_ms": fg["library_ms"], "ms_from": "cuda events",
        "tflops": fg["tflops"],
        "shape": f"global layer B={SERVE_B} S={SERVE_PROMPT} H=4 KV=1 "
                 "hd=256 causal bf16",
        "ms_local": fl["ms"], "plain_ms_local": fl["plain_ms"],
        "bound_ms_local": fl["bound_ms"],
        "library_ms_local": fl["library_ms"], "tflops_local": fl["tflops"],
        "launches_jamba": jamba_launches["flash_attention"],
        "shape_jamba": f"attention layer B={SERVE_B} S={SERVE_PROMPT} "
                       f"H={JAMBA_H} KV={JAMBA_KV} hd={JAMBA_HD} causal bf16",
        "ms_jamba": fj["ms"], "plain_ms_jamba": fj["plain_ms"],
        "bound_ms_jamba": fj["bound_ms"], "bound_by_jamba": fj["bound_by"],
        "library_ms_jamba": fj["library_ms"],
        "tflops_jamba": fj["tflops"]}, {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:62",
        "launches": lm_launches["decode_attention"],
        "combine_launches": lm_launches["decode_attention_combine"],
        "max_abs_err": max(errs["decode_attention"].values()),
        "max_abs_err_by_dtype": errs["decode_attention"],
        "ms": dg["ms"], "plain_ms": dg["plain_ms"],
        "bound_ms": dg["bound_ms"], "bound_by": dg["bound_by"],
        "library_ms": dg["library_ms"],
        "shape": f"global layer B={SERVE_B} L={SERVE_L} H=4 KV=1 hd=256 "
                 f"pos={dg['pos']} bf16, split + combine",
        "ms_local": dl["ms"], "plain_ms_local": dl["plain_ms"],
        "bound_ms_local": dl["bound_ms"],
        "library_ms_local": dl["library_ms"],
        "launches_jamba": jamba_launches["decode_attention"],
        "combine_launches_jamba": jamba_launches["decode_attention_combine"],
        "shape_jamba": f"attention layer B={SERVE_B} L={SERVE_L} "
                       f"H={JAMBA_H} KV={JAMBA_KV} hd={JAMBA_HD} "
                       f"pos={dj['pos']} bf16, split + combine",
        "ms_jamba": dj["ms"], "plain_ms_jamba": dj["plain_ms"],
        "bound_ms_jamba": dj["bound_ms"], "bound_by_jamba": dj["bound_by"],
        "library_ms_jamba": dj["library_ms"]}, {
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6.py:66",
        "launches": wkv_launches, "max_abs_err": wkv_err,
        "ms": wkv_times["ms"], "plain_ms": wkv_times["plain_ms"],
        "bound_ms": wkv_times["bound_ms"],
        "bound_by": wkv_times["bound_by"], "library_ms": None,
        "shape": f"B={SERVE_B} S={SERVE_PROMPT} H={RWKV_H} hd={RWKV_HD} "
                 "float32, given s0"}, {
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:51",
        "launches": jamba_launches["mamba_scan"],
        "max_abs_err": max(scan_err.values()),
        "max_abs_err_by_dtype": scan_err,
        "ms": scan_times["ms"], "plain_ms": scan_times["plain_ms"],
        "bound_ms": scan_times["bound_ms"],
        "bound_by": scan_times["bound_by"], "library_ms": None,
        "shape": f"B={SERVE_B} S={SERVE_PROMPT} D={JAMBA_D} N={JAMBA_N} "
                 "float32, given h0"}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
