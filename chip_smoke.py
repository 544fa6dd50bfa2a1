#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: builds the port's CUDA kernels from this checkout, holds each against
its plain PyTorch version, drives the paper's loop end to end on the card,
and prints one JSON line per phase.

    python3 chip_smoke.py

Phases:
  device   card name and power limit, torch version, kernel build time
  flash_build  per instantiation of the flash-attention kernels: ptxas's
               registers and spills (and any wgmma serialisation it
               reports), dynamic shared memory, and the HGMMA and UTMALDG
               instructions in the library's SASS; for MLA's (96, 64)
               kernel its item rows, warpgroups and register split
  kernel_build per instantiation of the decode, WKV6 (serving and
               training), GBM, RWKV / Mamba backward and MLA decode
               kernels: ptxas's registers, spills, stack and shared
               memory; the MLA decode's tiling, largest cluster, HGMMA
               and UTMALDG; the loops of the GBM instance at d 3, depth 3
               in its SASS
  kernel   GBM-ensemble kernel vs its plain version (bit for bit at
           y_scale != 0) at the serving shape, edge cases (non-finite
           inputs, n = 1, ragged n, T = 1, 203 and 2000, depth 1, 4 and
           10, d = 1 and 16) and n = 2**20; CUDA-event times (queued behind
           a sleeping kernel, and back to back) and the bound
  fit      all five Table I jobs published on a hub, 15 predictors fitted
           on the card; a 10,000-row grep store and its 3 predictors
  serve    per job, 4096 seeded contexts in one choose_cluster_batch (plus
           one market-mode batch); the kernel must have been launched
  loop     the quickstart: choose for grep, check the emulator, contribute
  parity   sort and grep fitted on the CPU, carried to the card, predictions
           compared
  edge     slice 8's main path: the edge's demo gateway (grep and
           sort, fitted on the card before any timed window) served by
           serve_edge on a localhost socket; the seeded 1024-request
           workload played by run_loadgen at 64 connections in the
           edge's own event loop, as the JAX package's edge bench plays
           it, in 7 interleaved triples of a socket pass, a bare-TCP pass
           (the same request and response bytes over the same loop and
           connections, nothing else: the host's TCP cost) and an
           in-process pass, each timed pass on a fully collected heap;
           requests/s of each, the three times a request, client
           p50/p95/p99 ms, each lane's mean batch, gbm_predict launches
           (in all, and per inline choose and predict); fails unless
           errors are 0, every HTTP body is the in-process envelope's
           bytes, the predict-lane mean batch is > 1 and the GBM kernel
           was launched, and (at the end of the run, after the later
           phases) unless t_socket - t_tcp <= 2 t_inproc in the median
           triple and a control (the socket pass through an edge that
           busy-waits 2 t_inproc a request) fails that gate
  sidecar  save_fits of the edge hub's card fits, load_fits into fresh
           repos on cuda: no refit, predictions bit for bit
  profile  device busy time and launches, in one torch.profiler session
           split by record_function ranges, of one fit, one choose, the
           edge gateway's chooses through its lanes and one edge pass
           over the socket (profiler on: wall times are inflated)
  transfer a cold job (grep's twin, a handful of probe rows) served
           through its donor's predictors on the card, transfer_source
           stamped
  lm_kernel   flash-attention and flash-decode kernels vs their plain
              versions in bfloat16 (tensor cores; also held to a relative
              bound, with two controls that must exceed it) and float32
              (SIMT) (gemma3-1b's serving shapes, softcap, non-causal,
              ragged S, S = 1 and 129, a window across a kv tile, ring
              slot maps, pos = 0, decode runs that end inside a tile and
              warps whose slots are all masked, G = 1/2/4/8 at hd
              64/128/256); CUDA-event and profiler device times, achieved
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
                sequence split across two calls); CUDA-event times (the
                profiler's device time beside them) and the bound
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
  mla_kernel    minicpm3-4b's two kernels vs their plain versions in
                bfloat16 (also held to a relative bound, with two controls
                that must exceed it) and float32, every call repeated bit
                for bit: flash attention at q/k head 96 and v head 64 (40
                heads; B 8 x S 2048, S = 1, S = 129, ragged S, a window
                with a softcap over 8 kv heads) and the MLA decode over
                the latent caches (B 8, L 2,120 at pos 0, 191, 192, 1100
                and 2080; B 1; B 16); CUDA-event (flash) and profiler
                device (decode) times, the decode's walk and in-launch
                merge apart, bounds and SDPA's times
  mla_serve     minicpm3-4b at full width and depth (62 layers, d 2560)
                through repro_torch.launch.serve.run: batch 8, prompt
                2048, 64 new tokens; init s, prefill ms, decode ms/token,
                tokens/s, peak memory, the runtime-log line; launches:
                flash 62 (prefill only), MLA decode 62 x 63, dense decode 0
  mla_profile   device busy time and top kernels of one full-width
                minicpm3-4b prefill and 8 decode steps (torch.profiler)
  mla_parity    the same model cut to 4 layers, prompt 512, 8 decode
                steps: card in float32 and in bf16 vs CPU (float32,
                plain) logits and greedy tokens
  train_kernel  the flash-attention backward (flash_bwd_delta, _dkdv,
                _dkdv_sum, _dq; bf16 on the wgmma/TMA kernels, float32 on
                SIMT) vs flash_attention_bwd_plain on the forward kernel's
                o and lse, and vs autograd of flash_attention_plain, in
                bfloat16 (held to a relative bound with two controls that
                must exceed it: delta set to 0, dS rounded to fp8; the
                dkdv partials vs their plain version and their head sum
                bit for bit) and float32, each repeated bit for bit; the
                forward's bytes with and without its lse output;
                gemma3-1b's training microbatch (B 2, S 4096, H 4 over 1,
                hd 256; global and window 512), jamba's attention layer
                at its microbatch (B 1, S 4096, 64 heads over 8 of 128)
                and edge cases (softcap,
                G 1/2/4/8, non-causal, ragged S, S = 1, hd 64 and 128);
                MLA's (96, 64) instances at minicpm3-4b's microbatch (B 1,
                S 4096, 40 heads over 40) and at G 4, softcap 30, a window
                of 100 across tiles, ragged S 1000 and S = 1, with their
                times there beside SDPA's backward and its backend;
                ptxas per instantiation (no spills), the wgmma instances'
                shared memory and HGMMA/UTMALDG counts; CUDA-event times,
                bounds and SDPA's backward; the kernels profiled calls
                run, traced in a process of their own (the route's dkdv
                and dq kernels, none of the other route's)
  train    gemma3-1b at full width and depth through
           repro_torch.launch.train.run: 4 steps of batch 8 x 4096 (remat
           full, AdamW, 4 microbatches); step s, tokens/s, MFU, peak
           memory, losses (finite, the last below the first), launches a
           step (208 flash forwards, 104 of each backward launch: delta,
           dkdv, dkdv sum, dq), the
           runtime-log line, read back into launch.autoconfig beside
           simulated H100 records, and the analytic step time for the job
  train_parity  one full-width period of gemma3-1b (6 layers), batch 2 x
                1024, one AdamW step from the same float32 weights: card
                float32 and bf16 vs CPU float32 (loss, grad norm, every
                gradient leaf, parameters after the step, those also split
                by the clipped |g| against AdamW's eps), a control with
                the backward's delta set to 0; crash-restart at full width
                with 2 layers, the final loss against the uninterrupted
                run's at rtol 1e-4
  mla_train     minicpm3-4b at full width (62 layers unless
                launch.train.TRAIN_DEPTH cuts them) through
                repro_torch.launch.train.run: 4 steps of batch 8 x 4096
                (remat full, AdamW, 8 microbatches); step s, tokens/s, MFU
                (MLA's attention at q/k 96 and v 64), peak memory, losses
                (finite, the last below the first), launches a step (flash
                forward 2 x, delta, dkdv and dq 1 x microbatches x layers;
                no dkdv sum)
  mla_train_parity  the same model cut to 4 layers, batch 2 x 512, one
                AdamW step: card float32 and bf16 vs CPU float32, with
                train_parity's limits and its delta-0 control
  ssm_train_kernel  wkv6_bwd and mamba_scan_bwd (the backward kernels of
                WKV6 and the selective scan) vs their plain versions and
                autograd of the plain forwards (also through the WKV6 and
                MambaScan autograd Functions): the training microbatch
                (B 1, S 4096; 40 heads of 64, 16,384 channels of 16), the
                serving shapes (B 8, S 2048), given s0 / h0 and ds_end /
                dh_end, decays on all sides of the clamp with ties at -9,
                exp(dt A) that underflows, hd 16 and 32, N 4 with ragged S
                and D, chunks that wkv6_bwd's segments do not divide and
                one segment, D off the scan's 128-, 256- and 512-channel
                blocks at N 16, 8 and 4 (D % 4 != 0 too); every call
                repeated bit for bit, each check with a control that must
                exceed it (the u diagonal's gradient dropped; the
                checkpoints zeroed); CUDA-event times at the training
                shape beside the plain versions' and the bounds, each
                launch on its own (wkv6_bwd's fold, carry scan, walk and
                du sum; the scan's walk and sums) with its blocks, blocks
                resident an SM and waves; ptxas per instance
  rwkv_train    rwkv6-3b at full width and depth (32 layers, d 2560, vocab
                65,536) through repro_torch.launch.train.run: 4 steps of
                8 x 4096 (remat full, AdamW, grad_accum 8); step s,
                tokens/s, MFU, peak memory, the analytic step, launches a
                step (512 wkv6, 256 wkv6_bwd)
  jamba_train   jamba-1.5-large at launch.train's cut (4 layers, d_ff and
                moe_d_ff 2,048: 3.66 B) the same way (Adafactor, bf16
                accumulation, the MoE aux loss); launches a step 48
                mamba_scan, 24 mamba_scan_bwd, 16 flash forwards and 8 of
                each backward launch
  ssm_train_parity  rwkv6 at rwkv_parity's cut and jamba at jamba_parity's,
                batch 1 x 128, one float32 step: card vs CPU (loss, grad
                norm, every gradient leaf, the parameters after AdamW's
                first step, split by |g| against eps)
  eval     the evaluation plane on the card: run_replay at the golden's
           config cut to its grep job (2 users, 3 contributions each), the
           final MAPE per model held to tests/goldens/replay_mini.json
           (linear models 1e-5 relative, models with trees 2e-3), run again
           byte for byte; run_spot_market (grep, sort, 8 queries: adjusted
           beats naive) and run_cold_start (grep, sort, 2 users: borrowed
           beats the global mean, transfer_source stamped); wall time,
           gbm_predict launches and engine fits per checkpoint and part

Ten main paths: the phases fit, serve and loop (the paper's loop,
through the GBM kernel), edge (the hub's public surface over a socket,
through the GBM kernel), eval (the evaluation plane, through the GBM
kernel), lm_serve (gemma3-1b serving, through the two attention
kernels), rwkv_serve (rwkv6-3b serving, through the WKV6 kernel),
jamba_serve (jamba-1.5-large serving, through the scan and the attention
kernels), mla_serve (minicpm3-4b serving, through the flash kernel's
(96, 64) instance and the MLA decode kernel), train (gemma3-1b training,
through the flash forward and the four backward launches), rwkv_train
(through the WKV6 kernel and wkv6_bwd) and jamba_train (through the scan
kernel, mamba_scan_bwd and the flash kernels).  Each path's kernel
launch counts are set to 0
just before it and read just after it.  Before the last line it prints the ``kernels``
line and the nvidia-smi line; the last line is ``{"ok": true, "device":
{...}}``.  Any failure exits non-zero.  Without a
CUDA card, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""
import asyncio
import gc
import hashlib
import json
import math
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
    """Least time for the shared-memory loads of the kernel's first
    design: each row loads a feature id and a threshold per level and one
    leaf per tree, and an SM serves 32 four-byte loads per clock, at the
    card's maximum SM clock.  The current design loads one node a level,
    the last with both leaves, so this counts loads it no longer makes and
    bounds nothing of its work."""
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


def check_gbm(label, got, want, y_scale):
    """The kernel's output against the plain version's: bit for bit (NaN
    where NaN) when y_scale != 0, where both compute the same float32 sum
    in the same order and one multiply; within rtol = atol = 1e-6 when
    y_scale == 0, where expf and torch.exp may differ by an ulp.  Returns
    the largest absolute difference."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    assert g.shape == w.shape, label
    nan = np.isnan(w)
    assert np.array_equal(np.isnan(g), nan), \
        f"kernel vs plain: NaN outputs differ ({label})"
    if y_scale != 0.0:
        bad = int(np.sum(g[~nan].view(np.int32) != w[~nan].view(np.int32)))
        assert bad == 0, f"kernel vs plain: {bad} outputs differ in bits " \
            f"({label})"
        return 0.0
    inf = np.isinf(w)
    assert np.array_equal(g[inf], w[inf]), \
        f"kernel vs plain: infinite outputs differ ({label})"
    fin = np.isfinite(w)
    diff = np.abs(g[fin] - w[fin])
    excess = float(np.max(diff - 1e-6 * np.abs(w[fin]), initial=0.0))
    assert excess <= 1e-6, f"kernel vs plain beyond rtol/atol 1e-6 " \
        f"({label}): {excess}"
    return float(np.max(diff, initial=0.0))


def queued_ms(fn, reps, warm=3):
    """Mean device time of one call, by CUDA events over ``reps`` calls
    queued behind a sleeping kernel: the host enqueues them all while the
    card sleeps, so the reading is the card's time for back-to-back
    launches even where the host takes longer to enqueue a call than the
    card takes to run it (where ``cuda_ms`` reads the host's rate)."""
    import torch
    for _ in range(warm):
        fn()
    sync()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    fn()
    sync()
    host_s = time.perf_counter() - t0        # one call's enqueue, at most
    torch.cuda._sleep(int((reps * host_s + 2e-3) * max_sm_clock_mhz() * 2e6))
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = []            # (label, n, d, T, depth, nonfinite)
    for d in (2, 3, 4):
        cases.append((f"serve d={d}", serve_n, d, 200, 3, False))
    cases += [("thr=inf and +-inf/NaN features", 5000, 3, 200, 3, True),
              ("n=1", 1, 3, 200, 3, False),
              ("ragged n=1000", 1000, 4, 200, 3, True),
              ("T=1", 777, 3, 1, 3, False),
              ("D=1", 513, 2, 50, 1, True),
              ("D=4", 2049, 4, 100, 4, True),
              ("d=1", 300, 1, 200, 3, True),
              ("d=16", 4099, 16, 64, 3, True),
              ("T=2000: tiles over 48 KB", serve_n, 3, 2000, 3, True),
              ("D=10", serve_n, 5, 100, 10, True),
              ("T=203: not a multiple of slices or chains", serve_n, 3,
               203, 3, True),
              ("n=2^20", 2 ** 20, 3, 200, 3, False),
              ("n=2^20 d=16", 2 ** 20, 16, 200, 3, True)]
    max_abs, checked = 0.0, {}
    for i, (label, n, d, T, depth, nonfinite) in enumerate(cases):
        X, feat, thr, leaf = ensemble(i, n, d, T, depth, dev,
                                      nonfinite=nonfinite)
        if nonfinite:
            X[0, :] = float("inf")       # R2: +inf at thr = inf goes left
        for ys in (0.0, 250.0):
            got = K.gbm_predict(X, feat, thr, leaf, 0.3, ys)
            want = K.gbm_predict_plain(X, feat, thr, leaf, 0.3, ys)
            sync()
            max_abs = max(max_abs, check_gbm(f"{label} y_scale={ys}", got,
                                             want, ys))
        p = K.plan(n, d, T, depth, sms)
        checked[label] = {k: p[k] for k in ("rows", "slices", "tiles",
                                            "smem_bytes", "blocks")}

    def timed(n, d, reps, plain_reps):
        X, feat, thr, leaf = ensemble(99, n, d, 200, 3, dev)
        f0 = torch.tensor([0.3], device=dev)
        ys = torch.tensor([0.0], device=dev)

        def call():
            K.gbm_predict(X, feat, thr, leaf, f0, ys)
        b, by = bound_ms(n, d, 200, 3)
        return {"ms": queued_ms(call, reps),
                "ms_back_to_back": cuda_ms(call, reps),
                "plain_ms": cuda_ms(
                    lambda: K.gbm_predict_plain(X, feat, thr, leaf, f0, ys),
                    plain_reps, warm=1),
                "bound_ms": b, "bound_by": by,
                "first_design_smem_load_ms": smem_bound_ms(n, 200, 3)}

    times = {}
    for d in (2, 3, 4):
        times[f"serve_d{d}"] = timed(serve_n, d, 500, 20)
    times["n2p20_d3"] = timed(2 ** 20, 3, 50, 3)
    emit("kernel", t0, kernel="gbm_predict", cases=checked,
         bit_exact_at_y_scale_nonzero=True, max_abs_err_y_scale_0=max_abs,
         times=times)
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


def _device_events_by_range(prof, ranges):
    """Device events of one torch.profiler session split by the
    ``record_function`` ranges named in ``ranges``: an event belongs to
    the range whose window holds its start.  A range's window is its span
    on the device timeline (the profiler's annotation of the range there,
    on the kernels' own clock) where the profiler records one, else its
    host window (each range ends in a synchronisation).  Host windows
    alone misfiled kernels near a boundary: the device clock, mapped to
    the host's, can lag it, and one run read the fit's last kernels in
    the choose window and another the choose's GBM kernels outside it.
    Returns the events by range and the windows with their clock."""
    import torch
    events = list(prof.events())
    host, device = {}, {}
    for e in events:
        if e.name not in ranges:
            continue
        spans = host if e.device_type == torch.autograd.DeviceType.CPU \
            else device
        a, b = e.time_range.start, e.time_range.end
        if e.name in spans:
            a, b = min(a, spans[e.name][0]), max(b, spans[e.name][1])
        spans[e.name] = (a, b)
    missing = set(ranges) - set(host)
    assert not missing, f"profiler recorded no range {sorted(missing)}"
    windows = {r: device.get(r, host[r]) for r in ranges}
    out = {r: [] for r in ranges}
    for e in events:
        # the ranges themselves show up on the device timeline too (as
        # annotations spanning their kernels): not device work
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.name in ranges:
            continue
        for r, (a, b) in windows.items():
            if a <= e.time_range.start <= b:
                out[r].append(e)
                break
    return out, {r: "device" if r in device else "host" for r in ranges}


def profile_phase(hub, gw):
    """Device busy time against host wall time, in ONE torch.profiler
    session split by record_function ranges: one predictor fit (grep on
    c5.xlarge, 4 models x 30 folds), one 4096-context choose, the edge
    demo gateway's chooses of the seeded workload through its lanes
    (in process, 64 at once), and one whole edge pass over the socket.
    (A second profiler session in one process saw no device work: an
    earlier version of this phase read 0 launches in the choose window
    that way.)"""
    import asyncio

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.api import AsyncHubGateway, ChooseRequest
    from repro_torch.core import ConfigurationService
    from repro_torch.core.predictor import C3OPredictor
    from repro_torch.workloads import spark_emul as W
    t0 = time.perf_counter()
    v = hub.get("grep").store.data.machine_view("c5.xlarge")
    prices = {m.name: m.price for m in W.MACHINES.values()}
    svc = ConfigurationService.from_repo(hub.get("grep"), None, prices,
                                         SCALEOUTS)
    ctx, t_max = contexts(hub.get("grep"), N_CONTEXTS, seed=1)
    chooses = [q for q in edge_requests() if isinstance(q, ChooseRequest)]

    async def gateway_chooses():
        sem = asyncio.Semaphore(EDGE_CONNECTIONS)

        async def one(agw, q):
            async with sem:
                return await agw.handle_async(q)

        async with AsyncHubGateway(gw, tick_s=EDGE_TICK_S) as agw:
            out = await asyncio.gather(*[one(agw, q) for q in chooses])
        assert all(r.ok for r in out)

    work = (
        ("fit", lambda: C3OPredictor(device="cuda").fit(v.X, v.y)),
        ("choose", lambda: svc.choose_cluster_batch(ctx, t_max)),
        ("edge_choose", lambda: asyncio.run(gateway_chooses())),
        ("edge_pass", lambda: asyncio.run(edge_socket_pass(gw))))
    for _, fn in work:
        fn()                                  # warm
    sync()
    walls = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, fn in work:
            with record_function(name):
                t1 = time.perf_counter()
                fn()
                sync()
                walls[name] = time.perf_counter() - t1
    by_range, clocks = _device_events_by_range(prof, [n for n, _ in work])
    out = {}
    for name, kernels in by_range.items():
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        out[name] = {"wall_s": walls[name], "device_busy_s": busy_us * 1e-6,
                     "idle_share": 1.0 - busy_us * 1e-6 / walls[name],
                     "kernel_launches": len(kernels),
                     "gbm_predict_launches": sum(
                         "gbm_kernel" in e.name for e in kernels),
                     "window_clock": clocks[name],
                     "top_kernels_us": top}
    for name in ("fit", "choose", "edge_choose", "edge_pass"):
        assert out[name]["kernel_launches"] > 0, \
            f"profiler saw no device work in the {name} window"
    for name in ("choose", "edge_choose"):
        assert out[name]["gbm_predict_launches"] > 0, \
            f"profiler saw no gbm_predict kernel in the {name} window"
    emit("profile", t0, chooses_in_edge_choose=len(chooses), **out)


# ------------------------------------------------- the hub's public surface

EDGE_JOBS = ("grep", "sort")
EDGE_REQUESTS = 1024
EDGE_CONNECTIONS = 64
EDGE_TICK_S = 0.004           # the edge bench's tick (benchmarks/run.py)
# the gate reads the median of this many triples: on the card's host a
# socket pass now and then runs far slower than its neighbours with the
# same code and data (scripts/edge_spread.py), and with three triples two
# such passes decided the run
EDGE_TRIPLES = 7
# the HTTP layer's budget: over the socket, a request may take at most
# this many in-process request times more than the host's bare TCP
# exchange of the same bytes takes (the edge bench's 0.5x bound where a
# TCP exchange costs nothing)
EDGE_BUDGET = 2.0


def edge_requests():
    """The seeded edge workload (1024 requests: predicts, chooses and
    searches over grep and sort) as request objects."""
    from repro_torch.api import decode
    from repro_torch.serve.loadgen import build_workload
    return [decode(body.decode("ascii")) for _, body in
            build_workload(EDGE_REQUESTS, jobs=EDGE_JOBS, seed=0)]


def edge_gateway():
    """The edge's demo gateway on the card, every (job, machine)
    predictor fitted before any timed window; (gateway, predictors,
    seconds)."""
    from repro_torch.serve.edge import _demo_gateway, warm
    t0 = time.perf_counter()
    gw = _demo_gateway(EDGE_JOBS, device="cuda")
    n = warm(gw)
    sync()
    return gw, n, time.perf_counter() - t0


async def edge_inproc_pass(gw, reqs):
    """The workload through AsyncHubGateway in process, at the socket
    path's concurrency (a semaphore plays the connections); (responses,
    seconds)."""
    import asyncio
    from repro_torch.api import AsyncHubGateway
    sem = asyncio.Semaphore(EDGE_CONNECTIONS)

    async def one(agw, q):
        async with sem:
            return await agw.handle_async(q)

    async with AsyncHubGateway(gw, max_batch=256, tick_s=EDGE_TICK_S) as agw:
        t0 = time.monotonic()
        out = await asyncio.gather(*[one(agw, q) for q in reqs])
        dt = time.monotonic() - t0
        sync()
        return out, dt, dict(agw.lane_stats)


async def edge_socket_pass(gw):
    """The workload closed-loop over a localhost socket (64 keep-alive
    connections) through a fresh edge on the same warm gateway, with the
    load generator in the edge's own event loop, as the JAX package's
    edge bench runs it; its LoadReport."""
    from repro_torch.serve.edge import serve_edge
    from repro_torch.serve.loadgen import build_workload, run_loadgen
    workload = build_workload(EDGE_REQUESTS, jobs=EDGE_JOBS, seed=0)
    app, server = await serve_edge(gw, tick_s=EDGE_TICK_S)
    try:
        return await run_loadgen(server.host, server.port,
                                 connections=EDGE_CONNECTIONS,
                                 workload=workload)
    finally:
        await server.stop()


async def edge_capture(gw, connections=8):
    """Every HTTP response's status and body of the workload, by index."""
    import asyncio
    from repro_torch.serve.edge import serve_edge
    from repro_torch.serve.loadgen import _request, build_workload
    workload = build_workload(EDGE_REQUESTS, jobs=EDGE_JOBS, seed=0)
    out = [(0, b"")] * len(workload)
    app, server = await serve_edge(gw, tick_s=EDGE_TICK_S)

    async def worker(c):
        reader, writer = await asyncio.open_connection(server.host,
                                                       server.port)
        try:
            for k in range(c, len(workload), connections):
                path, body = workload[k]
                out[k] = await _request(reader, writer, "POST", path, body)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    try:
        await asyncio.gather(*(worker(c) for c in range(connections)))
    finally:
        await server.stop()
    return out


class _Answers(asyncio.Protocol):
    """The bare-TCP pass's server connection: each request's bytes, once
    all have arrived, are answered with the edge's response bytes for
    them, looked up whole (no HTTP parsing, codec, gateway or lanes)."""

    def __init__(self, table):
        self.table = table
        self.buf = b""
        self.transport = None

    def connection_made(self, transport):
        self.transport = transport

    def data_received(self, data):
        self.buf = self.buf + data if self.buf else data
        out = self.table.get(self.buf)
        if out is not None:
            self.buf = b""
            self.transport.write(out)

    def connection_lost(self, exc):
        self.transport = None


class _Replay(asyncio.BufferedProtocol):
    """The bare-TCP pass's client connection: writes a request's bytes,
    reads until its response's length in bytes has arrived, then writes
    the next (closed loop, as the load generator plays it, reading into
    one buffer shared by the connections as the load generator does)."""

    def __init__(self, items, done, rbuf):
        self.items, self.done, self.rbuf = items, done, rbuf
        self.k = self.got = 0
        self.transport = None

    def connection_made(self, transport):
        self.transport = transport
        transport.write(self.items[0][0])

    def get_buffer(self, sizehint):
        return self.rbuf

    def buffer_updated(self, nbytes):
        self.got += nbytes
        if self.got < self.items[self.k][1]:
            return
        self.got = 0
        self.k += 1
        if self.k == len(self.items):
            self.transport.close()
        else:
            self.transport.write(self.items[self.k][0])

    def connection_lost(self, exc):
        if self.done.done():
            return
        if self.k == len(self.items):
            self.done.set_result(None)
        else:
            self.done.set_exception(exc or ConnectionResetError(
                f"bare TCP: closed after {self.k} of {len(self.items)}"))


async def edge_tcp_pass(wire, table):
    """The workload's bytes exchanged over the host's TCP loopback alone:
    ``wire`` holds (request bytes as the load generator sends them,
    response bytes as the edge answers them) by workload index, played
    closed-loop on EDGE_CONNECTIONS keep-alive connections in this event
    loop as the load generator shares them out; ``table`` maps request
    to response bytes.  Returns the window in seconds."""
    loop = asyncio.get_running_loop()
    server = await loop.create_server(lambda: _Answers(table),
                                      "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    shares = [[(q, len(r)) for q, r in wire[c::EDGE_CONNECTIONS]]
              for c in range(EDGE_CONNECTIONS)]
    rbuf = memoryview(bytearray(1 << 16))

    async def worker(items):
        done = loop.create_future()
        transport, _ = await loop.create_connection(
            lambda: _Replay(items, done, rbuf), "127.0.0.1", port)
        try:
            await done
        finally:
            transport.close()

    try:
        t0 = time.monotonic()
        await asyncio.gather(*(worker(s) for s in shares if s))
        return time.monotonic() - t0
    finally:
        server.close()
        await server.wait_closed()


async def edge_busy_socket_pass(gw, busy_s):
    """The gate's control: the socket pass through an edge whose app
    busy-waits ``busy_s`` on the loop thread before answering each
    request (an HTTP layer that costs that much more a request); its
    LoadReport."""
    from repro_torch.api import AsyncHubGateway
    from repro_torch.serve.edge import EdgeServer, HubEdgeApp
    from repro_torch.serve.loadgen import build_workload, run_loadgen

    class BusyApp(HubEdgeApp):
        async def respond(self, method, path, read_body):
            end = time.perf_counter() + busy_s
            while time.perf_counter() < end:
                pass
            return await super().respond(method, path, read_body)

    workload = build_workload(EDGE_REQUESTS, jobs=EDGE_JOBS, seed=0)
    app = BusyApp(AsyncHubGateway(gw, max_batch=256, tick_s=EDGE_TICK_S))
    server = await EdgeServer(app).start()
    try:
        return await run_loadgen(server.host, server.port,
                                 connections=EDGE_CONNECTIONS,
                                 workload=workload)
    finally:
        await server.stop()


def edge_launches_per_request(gw):
    """gbm_predict launches of one choose and one single-row predict per
    job, served inline (one dispatch each): what a lane's dispatch
    launches, whatever its batch."""
    from repro_torch.api import ChooseRequest, PredictRequest
    from repro_torch.kernels import gbm_predict as K
    out = {}
    for job in EDGE_JOBS:
        data = gw.hub.get(job).store.data
        row = tuple(float(x) for x in data.X[0])
        for op, req in (
                ("choose", ChooseRequest(job, row[1:], t_max=math.nan)),
                ("predict", PredictRequest(job, str(data.machine_type[0]),
                                           (row,)))):
            before = K.LAUNCHES
            assert gw.handle(req).ok
            sync()
            out[f"{job}_{op}"] = K.LAUNCHES - before
    return out


async def after_full_collection(pass_fn):
    """One timed pass started on a fully collected heap: (its result, the
    full collections that ran inside it).  A full collection of this
    process's heap takes about 0.1 s on the card's host, and one landing
    inside a pass of 0.2 s halves that pass's requests/s."""
    gc.collect()
    full = gc.get_stats()[2]["collections"]
    out = await pass_fn()
    return out, gc.get_stats()[2]["collections"] - full


def edge_phase(gw, warm_s, n_predictors):
    """This slice's main path: the seeded workload played over a
    localhost socket through serve_edge (HubEdgeApp, AsyncHubGateway's
    lanes, HubGateway, ConfigurationService / C3OPredictor, the engine,
    the GBM kernel) by run_loadgen in the edge's own event loop, as the
    JAX package's edge bench plays it: one warm pass of each path, every
    response's bytes recorded, then EDGE_TRIPLES interleaved triples of
    a socket pass, a bare-TCP pass (the same request and response bytes
    exchanged on the same loop and connections, nothing else) and an
    in-process pass, each timed pass on a fully collected heap; last a
    control, the socket pass through an edge that busy-waits
    EDGE_BUDGET in-process request times a request.  Asserts no errors,
    every HTTP body the in-process envelope's bytes, predict-lane mean
    batch > 1 in every socket pass and gbm_predict launched during the
    passes.  Per-request times t (a pass's window over its requests):
    the gate, t_socket - t_tcp <= EDGE_BUDGET * t_inproc in the median
    triple, and that the control fails it, are returned as ``gate_ok``
    and ``control_fails`` for main to fail the run on after the later
    phases.  Returns the launch counts too."""
    from repro_torch.api import encode
    from repro_torch.kernels import gbm_predict as K
    from repro_torch.serve.edge import http_response
    from repro_torch.serve.loadgen import _head, build_workload
    t0 = time.perf_counter()
    reqs = edge_requests()
    n = len(reqs)
    workload = build_workload(EDGE_REQUESTS, jobs=EDGE_JOBS, seed=0)

    async def run():
        await edge_inproc_pass(gw, reqs)              # warm both paths
        await edge_socket_pass(gw)
        http = await edge_capture(gw)
        wire = [(_head("POST", path, len(body)) + body,
                 http_response(status, payload, True))
                for (path, body), (status, payload) in zip(workload, http)]
        table = {}
        for q, r in wire:
            assert table.setdefault(q, r) == r, \
                "edge: one request's bytes drew two different answers"
        triples = []
        for _ in range(EDGE_TRIPLES):
            before = K.LAUNCHES
            rep, full_s = await after_full_collection(
                lambda: edge_socket_pass(gw))
            sync()
            launched = K.LAUNCHES - before
            tcp_s, full_t = await after_full_collection(
                lambda: edge_tcp_pass(wire, table))
            (out, dt, lanes), full_i = await after_full_collection(
                lambda: edge_inproc_pass(gw, reqs))
            t_s, t_t, t_i = rep.wall_s / n, tcp_s / n, dt / n
            triples.append({"rep": rep, "out": out, "dt": dt, "lanes": lanes,
                            "t": (t_s, t_t, t_i),
                            "over_budget": (t_s - t_t) / t_i,
                            "socket_launches": launched,
                            "full_collections": [full_s, full_t, full_i]})
        med = sorted(triples, key=lambda p: p["over_budget"])[len(triples) // 2]
        busy_s = EDGE_BUDGET * med["t"][2]
        control, full_c = await after_full_collection(
            lambda: edge_busy_socket_pass(gw, busy_s))
        return triples, med, http, busy_s, control, full_c

    K.LAUNCHES = 0
    triples, med, http, busy_s, control, full_c = asyncio.run(run())
    sync()
    launches = K.LAUNCHES
    per_request = edge_launches_per_request(gw)
    rep = med["rep"]
    t_s, t_t, t_i = med["t"]
    t_c = control.wall_s / n
    control_reading = (t_c - t_t) / t_i
    gate_ok = med["over_budget"] <= EDGE_BUDGET
    control_fails = control_reading > EDGE_BUDGET
    expected = [encode(r).encode("ascii") for r in med["out"]]
    identical = sum(a == b for (_, a), b in zip(http, expected))
    batches = [p["rep"].predict_mean_batch() for p in triples]
    errors = sum(p["rep"].errors for p in triples) + control.errors
    us = 1e6
    emit("edge", t0, jobs=list(EDGE_JOBS), requests=n,
         connections=EDGE_CONNECTIONS, tick_s=EDGE_TICK_S,
         warm_s=warm_s, predictors_warmed=n_predictors,
         load_generator="run_loadgen in the edge's event loop",
         triples=[{"socket_rps": p["rep"].rps, "inproc_rps": n / p["dt"],
                   "tcp_rps": 1.0 / p["t"][1],
                   "t_socket_us": p["t"][0] * us, "t_tcp_us": p["t"][1] * us,
                   "t_inproc_us": p["t"][2] * us,
                   "socket_minus_tcp_over_inproc": p["over_budget"],
                   "socket_vs_inproc": p["t"][2] / p["t"][0],
                   "socket_launches": p["socket_launches"],
                   "full_collections_socket_tcp_inproc":
                       p["full_collections"]}
                  for p in triples],
         t_socket_us=t_s * us, t_tcp_us=t_t * us, t_inproc_us=t_i * us,
         gate="t_socket - t_tcp <= %g * t_inproc, median triple"
              % EDGE_BUDGET,
         socket_minus_tcp_over_inproc=med["over_budget"],
         gate_result="pass" if gate_ok else "FAIL",
         control={"busy_us_per_request": busy_s * us,
                  "t_socket_us": t_c * us, "socket_rps": control.rps,
                  "socket_minus_tcp_over_inproc": control_reading,
                  "full_collections": full_c,
                  "result": "fails the gate (as it must)" if control_fails
                  else "PASSES the gate: the gate is void"},
         socket_rps=rep.rps, inproc_rps=n / med["dt"],
         socket_vs_inproc=t_i / t_s,
         socket_vs_inproc_triples=[p["t"][2] / p["t"][0] for p in triples],
         p50_ms=rep.p50_ms, p95_ms=rep.p95_ms, p99_ms=rep.p99_ms,
         errors=errors, op_counts=rep.op_counts,
         predict_mean_batch=batches,
         identical=f"{identical}/{n}",
         socket_lanes={ln.lane: {"requests": ln.requests,
                                 "batches": ln.batches,
                                 "mean_batch": ln.mean_batch}
                       for ln in rep.server.lanes},
         inproc_lanes={k: {"requests": s.requests, "batches": s.batches,
                           "mean_batch": s.requests / max(s.batches, 1)}
                       for k, s in med["lanes"].items()},
         gbm_predict_launches=launches,
         gbm_predict_launches_per_inline_request=per_request)
    assert errors == 0, f"edge: {errors} error envelopes"
    assert identical == n, \
        f"edge: {n - identical} HTTP bodies differ from in process"
    assert all(st == 200 for st, _ in http), "edge: a non-200 answer"
    assert min(batches) > 1.0, f"edge: predict-lane mean batch {batches}"
    assert launches > 0, "edge: the GBM kernel was not launched"
    return {"launches": launches, "per_request": per_request,
            "over_budget": med["over_budget"], "gate_ok": gate_ok,
            "control": control_reading, "control_fails": control_fails}


def transfer_check(gw):
    """Cold-start transfer on the card: grep's cold twin, published with
    its handful of probe rows, is served through its donor's predictors
    (the GBM kernel) with transfer_source stamped."""
    from repro_torch.api import (ChooseRequest, HubGateway, PredictRequest,
                                 TransferPolicy, encode)
    from repro_torch.core import JobRepo, RuntimeDataStore
    from repro_torch.kernels import gbm_predict as K
    from repro_torch.workloads import spark_emul as W
    t0 = time.perf_counter()
    probe = W.cold_probe("grep", 0)
    hub = gw.hub                  # the last phase to use this hub
    hub.publish(JobRepo("grep-cold", "grep (cold twin)", W.cold_schema("grep"),
                        RuntimeDataStore(probe, seed=0, device="cuda"),
                        predictor_kw=dict(pad_rows=True, max_cv_folds=15,
                                          device="cuda")))
    pol = TransferPolicy()
    tgw = HubGateway(hub, gw.prices, gw.scaleouts, transfer=pol)
    row = tuple(float(x) for x in probe.X[0])
    machine = str(probe.machine_type[0])
    before = K.LAUNCHES
    resp = tgw.predict(PredictRequest("grep-cold", machine, (row,)))
    choice = tgw.choose(ChooseRequest("grep-cold", row[1:], t_max=400.0))
    sync()
    launched = K.LAUNCHES - before
    donor = tgw.predict(PredictRequest("grep", machine, (row,)))
    dchoice = tgw.choose(ChooseRequest("grep", row[1:], t_max=400.0))
    match = hub.nearest_job("grep-cold", policy=pol)
    emit("transfer", t0, probe_rows=len(probe), source=resp.result.transfer_source,
         similarity=match.similarity,
         confidence=resp.result.transfer_confidence,
         runtime_s=resp.result.runtimes_s[0],
         donor_runtime_s=donor.result.runtimes_s[0],
         choice=[choice.result.machine_type, choice.result.scale_out],
         gbm_predict_launches=launched)
    assert resp.ok and choice.ok, (encode(resp), encode(choice))
    assert resp.result.transfer_source == "grep"
    assert choice.result.transfer_source == "grep"
    assert '"transfer_source":"grep"' in encode(resp)
    assert resp.result.runtimes_s == donor.result.runtimes_s
    assert (choice.result.machine_type, choice.result.scale_out) == \
        (dchoice.result.machine_type, dchoice.result.scale_out)
    assert launched > 0, "transfer: the donor's GBM kernel was not launched"


def sidecar_phase(gw):
    """save_fits of the edge hub's card fits, load_fits into fresh repos
    on cuda: zero refits (engine.cache_stats) and predictions with the
    fitted ones' bits."""
    import tempfile
    from repro_torch.core import JobRepo, RuntimeDataStore, engine
    t0 = time.perf_counter()
    out = {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for job in EDGE_JOBS:
            repo = gw.hub.get(job)
            path = repo.fits_path(os.path.join(tmp, f"{job}.tsv"))
            saved = repo.save_fits(path)
            fresh = JobRepo(job, job, repo.schema,
                            RuntimeDataStore(repo.store.data, seed=0,
                                             device="cuda"),
                            predictor_kw=dict(repo.predictor_kw))
            engine.cache_clear()
            loaded = fresh.load_fits(path)
            stats = engine.cache_stats()
            rows = repo.store.data.X
            same = 0
            for m in repo.store.data.present_machines():
                a = fresh.predictor_for(m).predict(rows).astype(np.float32)
                b = repo.predictor_for(m).predict(rows).astype(np.float32)
                same += int(np.array_equal(a.view(np.int32),
                                           b.view(np.int32)))
            refits = engine.cache_stats()
            out[job] = {"saved": saved, "loaded": loaded,
                        "bytes": os.path.getsize(path),
                        "fits": refits["fit"], "cv": refits["cv"],
                        "bit_equal": f"{same}/{saved}",
                        "load_stats": stats}
            assert saved == loaded == len(repo.store.data.present_machines())
            assert refits["fit"] == 0 and refits["cv"] == 0, refits
            assert same == saved, f"sidecar: {job} predictions differ"
    emit("sidecar", t0, **out)


# -------------------------------------------------------- the eval plane

# tests/test_eval_replay.py's MINI_CFG, the config that
# tests/goldens/replay_mini.json pins (the JAX package's final MAPE per job
# and model, 6 significant digits), cut to its grep job: a run of both
# jobs took 142 s on the H100 (11.8 s a checkpoint, launch-bound fits),
# and the phase runs it twice.  A job's records depend on that job alone.
EVAL_REPLAY = {"jobs": ("grep",), "n_users": 2, "seed": 0,
               "chunks_per_user": 3}
EVAL_GOLDEN = os.path.join(ROOT, "tests", "goldens", "replay_mini.json")
# relative tolerances against the golden: the linear models to float32
# rounding; models with trees to 2e-3 (GBM fits may part at a late near-tie
# split between frameworks and devices: ROADMAP.md, R3)
EVAL_EXACT_REL = 1e-5
EVAL_TREE_REL = 2e-3
EVAL_TREES = ("gbm", "ogb", "bom")
EVAL_SPOT = {"jobs": ("grep", "sort"), "n_queries": 8}
EVAL_COLD = {"jobs": ("grep", "sort"), "n_users": 2}


def eval_tolerance(model, selected_counts):
    """The golden's tolerance for one model's final MAPE (c3o takes the
    trees' where a final checkpoint selected a tree model)."""
    if model in EVAL_TREES or (model == "c3o" and any(
            m in EVAL_TREES for m in selected_counts)):
        return EVAL_TREE_REL
    return EVAL_EXACT_REL


def eval_phase():
    """Slice 9's main path: the evaluation plane on the card through the
    port's stores, repos, gateways and the GBM kernel.  run_replay at the
    golden's config, each job's final MAPE per model held to the golden;
    a second run_replay of it, byte-identical; run_spot_market (adjusted
    must beat naive on each job) and run_cold_start on two jobs (borrowed
    must beat the global mean on both, transfer_source stamped).  Prints
    each part's wall time, gbm_predict launches and the engine's fit, CV,
    predict and validation dispatches.  Returns the launches of the
    phase."""
    from repro_torch.core import engine
    from repro_torch.eval import replay as R
    from repro_torch.kernels import gbm_predict as K
    t0 = time.perf_counter()
    with open(EVAL_GOLDEN) as f:
        golden = json.load(f)
    parts = {}

    def part(name, fn):
        engine.cache_clear()
        before = K.LAUNCHES
        t = time.perf_counter()
        res = fn()
        sync()
        parts[name] = {"wall_s": time.perf_counter() - t,
                       "gbm_predict_launches": K.LAUNCHES - before,
                       "dispatches": engine.cache_stats()}
        return res

    K.LAUNCHES = 0
    cfg = R.ReplayConfig(device="cuda", **EVAL_REPLAY)
    first = part("replay", lambda: R.run_replay(cfg))
    again = part("replay_rerun", lambda: R.run_replay(cfg))
    spot = part("spot_market", lambda: R.run_spot_market(
        R.SpotMarketConfig(device="cuda", **EVAL_SPOT)))
    cold = part("cold_start", lambda: R.run_cold_start(
        R.ColdStartConfig(device="cuda", **EVAL_COLD)))
    launches = K.LAUNCHES
    checkpoints = len({(r["job"], r["held_out"], r["step"])
                       for r in first.records})
    rp = parts["replay"]
    golden_rel = {}
    for job in EVAL_REPLAY["jobs"]:
        expected = golden[job]
        s = first.summary[job]
        for model, want in expected.items():
            got = s["final_mape"][model]
            golden_rel[f"{job}/{model}"] = {
                "got": got, "golden": want,
                "rel": abs(got - want) / abs(want),
                "tol": eval_tolerance(model, s["selected_counts"])}
    emit("eval", t0, replay=dict(EVAL_REPLAY), checkpoints=checkpoints,
         wall_s_per_checkpoint=rp["wall_s"] / checkpoints,
         gbm_predict_launches_per_checkpoint=(
             rp["gbm_predict_launches"] / checkpoints),
         fits_per_checkpoint=rp["dispatches"]["fit"] / checkpoints,
         cv_per_checkpoint=rp["dispatches"]["cv"] / checkpoints,
         parts=parts, fingerprint=first.fingerprint,
         rerun_identical=again.tsv == first.tsv
         and again.fingerprint == first.fingerprint,
         contributions=f"{first.accepted}/{first.contributions} accepted",
         summary={j: {"final_mape": s["final_mape"],
                      "selected_counts": s["selected_counts"],
                      "ok": s["ok"]} for j, s in first.summary.items()},
         golden=golden_rel,
         spot_market={j: {"adjusted": s["adjusted_cost"],
                          "naive": s["naive_cost"], "savings": s["savings"],
                          "diverged": f"{s['diverged']}/{s['queries']}",
                          "ok": s["ok"]} for j, s in spot.summary.items()},
         cold_start={j: {"borrowed": s["borrowed_final"],
                         "mean": s["mean_final"],
                         "beats_mean": s["beats_mean"],
                         "sources": s["sources"]}
                     for j, s in cold.summary.items()},
         gbm_predict_launches=launches)
    assert set(EVAL_REPLAY["jobs"]) == set(first.summary), first.summary
    for key, g in golden_rel.items():
        assert g["rel"] <= g["tol"], f"eval: {key} is off the golden: {g}"
    assert again.tsv == first.tsv and again.fingerprint == first.fingerprint, \
        "eval: the replay's rerun is not byte-identical"
    assert set(spot.summary) == set(EVAL_SPOT["jobs"])
    assert spot.ok, f"eval: adjusted does not beat naive: {spot.summary}"
    assert set(cold.summary) == set(EVAL_COLD["jobs"])
    for job, s in cold.summary.items():
        assert s["beats_mean"], f"eval: {job}'s borrowed MAPE: {s}"
        assert s["sources"] == [job], f"eval: {job}'s sources {s['sources']}"
    assert all(r["source"] == r["job"] for r in cold.records
               if r["model"] == "borrowed"), "eval: transfer_source unstamped"
    assert launches > 0, "eval: the GBM kernel was not launched"
    return {"launches": launches,
            "per_part": {k: v["gbm_predict_launches"]
                         for k, v in parts.items()}}


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
# The same check of bf16 decode: the kernel rounds P and the output to bf16;
# the CPU replay of its arithmetic gives 1.9e-3 to 2.2e-3 at the serving
# shapes, P rounded to fp8 e4m3 2.1e-2 to 2.7e-2, the scale off by 10%
# 0.13 or more; each case's controls must exceed the limit where more than
# one slot is kept.  PERF.md gives the card's readings.
DECODE_BF16_REL = 5e-3
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


def flash_bound_ms(B, S, H, KV, hd, causal, window, dtype, hdv=None):
    """q and k's head dim ``hd``, v's and the output's ``hdv`` (default
    ``hd``)."""
    hdv = hd if hdv is None else hdv
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * B * S * (hd + hdv) * (H + KV)     # q, k, v in; o out
    flops = 2 * B * H * (hd + hdv) * kept_pairs(S, causal, window)
    return attn_bound_ms(nbytes, flops, dtype)


def decode_bound_ms(B, H, KV, hd, n_kept, n_slots_map, dtype):
    """Only the slots the mask keeps need reading (this run's data), plus q,
    the output and the slot map."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * (2 * B * H * hd + 2 * B * KV * hd * n_kept) \
        + 4 * n_slots_map
    return attn_bound_ms(nbytes, 4 * B * H * hd * n_kept, dtype)


def _qkv(seed, B, S, H, KV, hd, dtype, L=None, hdv=None):
    import torch
    g = torch.Generator(device=LM_DEVICE).manual_seed(seed)
    L = S if L is None else L
    hdv = hd if hdv is None else hdv
    return [torch.randn(s, generator=g, device=LM_DEVICE).to(_tdtype(dtype))
            for s in ((B, S, H, hd), (B, L, KV, hd), (B, L, KV, hdv))]


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
        out.append(o.permute(2, 0, 1, 3).reshape(S, H, v.shape[-1]))
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


def traced_kernel_names(fn, done=bool, calls=3, tries=3):
    """The device events' names of ``calls`` calls of ``fn``, each
    followed by a synchronisation, pooled over torch.profiler traces until
    ``done(names)`` holds, up to ``tries`` traces (the profiler drops
    events: one trace recorded none of 20 back-to-back flash launches
    after the earlier phases)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    seen = set()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
                sync()
        seen |= {e.name[:80] for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        if done(seen):
            break
    return sorted(seen)


def _bwd_kernels_seen(names):
    """The flash backward's kernel names among traced names."""
    return {w for n in names for w in re.findall(r"flash_bwd_\w+_kernel", n)}


# the bf16 flash forward's tensor-core kernels: the equal-dim one and, for
# MLA's (96, 64), its own (PR 25)
FLASH_TC_KERNELS = ("flash_fwd_wgmma", "flash_fwd_mla")


def _flash_tc_traced(names):
    return any(k in n for n in names for k in FLASH_TC_KERNELS)


def _route_call(kind, a):
    """(the call whose kernels a route trace records, the test that a
    trace has seen the route's kernels): the bf16 flash_attention
    (``kind`` "flash") or decode_attention ("decode") on ``_qkv``'s seeded
    inputs, or mla_decode_attention ("mla") on ``_mla_inputs``', ``a``
    the shape's arguments; or ("bwd") flash_attention_bwd in
    ``a["dtype"]`` at the shape ``a`` names (B, S, H, KV, hd, hdv; by
    default gemma3-1b's training microbatch, 4 query heads over 1 of 256),
    ``a["window"]`` its window."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.modeling.attention import ring_positions
    if kind == "flash":
        q, k, v = _qkv(a["seed"], a["B"], a["S"], a["H"], a["KV"], a["hd"],
                       "bfloat16", hdv=a.get("hdv"))
        return (lambda: FA.flash_attention(q, k, v, window=a["window"]),
                _flash_tc_traced)
    if kind == "mla":
        ins = _mla_inputs(a["seed"], a["B"], a["L"], "bfloat16")
        return (lambda: DA.mla_decode_attention(*ins, a["pos"], MLA_SCALE),
                lambda names: any("mla_decode_wgmma_kernel" in n for n in names))
    if kind == "bwd":
        B, S, H, KV, hd = (a.get(n, d) for n, d in (
            ("B", TRAIN_MICRO_B), ("S", TRAIN_S), ("H", 4), ("KV", 1),
            ("hd", 256)))
        hdv = a.get("hdv") or hd
        q, k, v, do = _tensors(9, ((B, S, H, hd), (B, S, KV, hd),
                                   (B, S, KV, hdv), (B, S, H, hdv)),
                               a["dtype"])
        o, lse = FA.flash_attention_lse(q, k, v, window=a["window"])
        need = bwd_route_kernels(a["dtype"], (hd, hdv))[1]
        return (lambda: FA.flash_attention_bwd(q, k, v, o, lse, do,
                                               window=a["window"]),
                lambda names: need <= _bwd_kernels_seen(names))
    q, kc, vc = _qkv(a["seed"], a["B"], 1, a["H"], a["KV"], a["hd"],
                     "bfloat16", L=a["Lc"])
    q = q[:, 0].contiguous()
    k_pos = (ring_positions(a["Lc"], a["pos"], LM_DEVICE) if a["ring"]
             else None)
    return (lambda: DA.decode_attention(q, kc, vc, a["pos"],
                                        window=a["window"], k_pos=k_pos),
            lambda names: any("decode_kernel" in n for n in names))


def route_trace_child(kind, args):
    """``chip_smoke.py --trace KIND ARGS``: ``traced_kernel_names`` of
    ``_route_call(KIND, ARGS)`` in a fresh process; prints the names."""
    import torch
    if not torch.cuda.is_available():
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    print(json.dumps(traced_kernel_names(*_route_call(kind, args))))
    return 0


def route_trace(kind, **args):
    """(the kernel names that profiler traces of ``_route_call(kind,
    args)`` show, where they were traced): in this process, and where
    torch.profiler has stopped recording the route's device events here
    (after the earlier phases it recorded none in three traces of a jamba
    flash call, twice in seven runs, and none of a float32 flash
    backward), in a process of its own (``route_trace_child``)."""
    fn, done = _route_call(kind, args)
    names = traced_kernel_names(fn, done)
    del fn
    if done(names):
        return names, "this process"
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--trace", kind, json.dumps(args)],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0 and p.stdout.strip(), \
        f"route trace {kind}: rc {p.returncode}: {p.stderr[-2000:]}"
    return json.loads(p.stdout.strip().splitlines()[-1]), "a child process"


def flash_times(seed, B, S, H, KV, hd, window, hdv=None):
    """Kernel, plain and SDPA times of one causal bf16 flash_attention call
    at [B, S, H over KV, hd] (v heads of ``hdv``, default hd), and its
    bound.  The times are CUDA events,
    the kernel's and SDPA's over the same 20 calls; beside them the
    profiler's device times, and for each reading of the kernel and SDPA
    its achieved TFLOP/s (the operations of ``flash_bound_ms`` over the
    time).  Fails on a reading above the bf16 peak, and unless a trace
    (``route_trace``) shows the tensor-core kernel."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _qkv(seed, B, S, H, KV, hd, "bfloat16", hdv=hdv)
    kern = lm_time(lambda: FA.flash_attention(q, k, v, window=window), 20)
    traced, traced_in = route_trace("flash", seed=seed, B=B, S=S, H=H,
                                    KV=KV, hd=hd, window=window, hdv=hdv)
    assert _flash_tc_traced(traced), traced
    plain = lm_time(lambda: FA.flash_attention_plain(q, k, v,
                                                     window=window), 5)
    lib = sdpa_flash(q, k, v, True, window)
    lib_t = lm_time(lib, 20) if lib else None
    lib_err = None if lib is None else float(
        (lib().transpose(1, 2).float()
         - FA.flash_attention_plain(q, k, v, window=window).float())
        .abs().max())
    bnd, by = flash_bound_ms(B, S, H, KV, hd, True, window, "bfloat16",
                             hdv)
    flops = 2 * B * H * (hd + v.shape[-1]) * kept_pairs(S, True, window)
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
            "route_traced_in": traced_in,
            "library_max_abs_err_vs_plain": lib_err,
            "timings": {"kernel": kern, "plain": plain, "library": lib_t}}


def decode_times(seed, B, Lc, H, KV, hd, pos, window, ring):
    """Kernel, plain and SDPA times of one bf16 decode_attention call (one
    launch) over a [B, Lc, KV, hd] cache at ``pos`` (a ring cache through
    its slot map when ``ring``), and its bound.  The kernel's time is its
    profiler device time (the mean recorded launch, one launch a call, so
    a dropped event does not bias it): back-to-back calls this short are
    bound by the host's launches, which CUDA events would time."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.modeling.attention import ring_positions
    q, kc, vc = _qkv(seed, B, 1, H, KV, hd, "bfloat16", L=Lc)
    q = q[:, 0].contiguous()
    k_pos = ring_positions(Lc, pos, LM_DEVICE) if ring else None
    kern = lm_time(lambda: DA.decode_attention(
        q, kc, vc, pos, window=window, k_pos=k_pos), 200)
    traced, traced_in = route_trace("decode", seed=seed, B=B, Lc=Lc, H=H,
                                    KV=KV, hd=hd, pos=pos, window=window,
                                    ring=ring)
    assert any("decode_kernel" in n for n in traced), traced
    plain = lm_time(lambda: DA.decode_attention_plain(
        q, kc, vc, pos, window=window, k_pos=k_pos), 50)
    ok = DA._mask(k_pos, Lc, pos, window, q.device)
    lib = sdpa_decode(q, kc, vc, ok)
    lib_t = lm_time(lib, 200) if lib else None
    n_kept = int(ok.sum())
    bnd, by = decode_bound_ms(B, H, KV, hd, n_kept, Lc if ring else 0,
                              "bfloat16")
    # the events' time only where the trace recorded no launch at all
    dev = kern["device_ms"] is not None
    return {"ms": kern["device_ms"] if dev else kern["events_ms"],
            "ms_from": "profiler device time" if dev else "cuda events",
            "route_traced_in": traced_in,
            "plain_ms": plain["ms"], "bound_ms": bnd,
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


def _coarse_p_decode(q, kc, vc, ok, cap, p_type):
    """A control for the bf16 decode check: decode attention with the
    unnormalised P = exp(s - max) rounded to ``p_type`` before P.V, the
    sums taken before the rounding."""
    import torch
    B, H, hd = q.shape
    KV = kc.shape[2]
    qg = q.float().reshape(B, KV, H // KV, hd) * hd ** -0.5
    s = torch.einsum("bkgh,blkh->bkgl", qg, kc.float())
    if cap:
        s = cap * torch.tanh(s / cap)
    s = torch.where(ok, s, torch.tensor(-2.0e38, device=q.device))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bkgl,blkh->bkgh", p.to(p_type).float(), vc.float())
    return (o / p.sum(-1, keepdim=True)).reshape(B, H, hd).to(q.dtype)


def check_decode_bf16_rel(label, q, kc, vc, pos, window, cap, k_pos, got,
                          want):
    """The tighter bf16 check of one decode case: the kernel's relative
    error within DECODE_BF16_REL, and, where more than one slot is kept,
    each control (P rounded to fp8, the scale off by 10%) beyond it."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    hd = q.shape[-1]
    r = {"kernel": _rel_err(got, want)}
    assert r["kernel"] <= DECODE_BF16_REL, \
        f"decode_attention {label} bfloat16: relative error {r['kernel']} " \
        f"beyond {DECODE_BF16_REL}"
    ok = DA._mask(k_pos, kc.shape[1], pos, window, q.device)
    r["control_p_fp8"] = _rel_err(_coarse_p_decode(
        q, kc, vc, ok, cap, torch.float8_e4m3fn), want)
    r["control_scale_1.1"] = _rel_err(DA.decode_attention_plain(
        q, kc, vc, pos, window=window, softcap=cap, scale=1.1 * hd ** -0.5,
        k_pos=k_pos), want)
    if int(ok.sum()) > 1:
        for name in ("control_p_fp8", "control_scale_1.1"):
            assert r[name] > DECODE_BF16_REL, \
                f"decode_attention {label}: the bf16 check passes its " \
                f"{name} ({r[name]})"
    return r


def check_attention(flash_cases, decode_cases, seed=0):
    """Each case of both attention kernels against its plain version on
    the card, in bfloat16 and float32, within LM_TOL, each call repeated
    bit for bit, bf16 flash within FLASH_BF16_REL
    (``check_flash_bf16_rel``) and bf16 decode within DECODE_BF16_REL
    (``check_decode_bf16_rel``): the largest abs error by kernel and type,
    the cases checked, and the relative errors of bf16 flash and decode
    and their controls by kernel and case.  A flash case may end with v's
    head dim, where it differs from q and k's."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.modeling.attention import ring_positions
    worst = {"flash_attention": {}, "decode_attention": {}}
    checked = {"flash_attention": [], "decode_attention": []}
    rel = {"flash_attention": {}, "decode_attention": {}}
    for i, (label, b, S, H, KV, hd, causal, window, cap, *hdv) in \
            enumerate(flash_cases):
        for dt in ("bfloat16", "float32"):
            q, k, v = _qkv(seed + i, b, S, H, KV, hd, dt,
                           hdv=hdv[0] if hdv else None)
            got, again = (FA.flash_attention(q, k, v, causal=causal,
                                             window=window, softcap=cap)
                          for _ in range(2))
            want = FA.flash_attention_plain(q, k, v, causal=causal,
                                            window=window, softcap=cap)
            sync()
            assert torch.equal(got, again), f"flash_attention {label} " \
                f"{dt}: a repeated call gives other bits"
            excess, err = _excess(got, want, dt)
            assert excess <= 0, f"flash_attention {label} {dt}: " \
                f"{excess} beyond tolerance"
            if dt == "bfloat16":
                rel["flash_attention"][label] = check_flash_bf16_rel(
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
            got, again = (DA.decode_attention(q, kc, vc, pos, window=window,
                                              softcap=cap, k_pos=k_pos)
                          for _ in range(2))
            want = DA.decode_attention_plain(q, kc, vc, pos, window=window,
                                             softcap=cap, k_pos=k_pos)
            sync()
            assert torch.equal(got, again), f"decode_attention {label} " \
                f"{dt}: a repeated call gives other bits"
            excess, err = _excess(got, want, dt)
            assert excess <= 0, f"decode_attention {label} {dt}: " \
                f"{excess} beyond tolerance"
            if dt == "bfloat16":
                rel["decode_attention"][label] = check_decode_bf16_rel(
                    label, q, kc, vc, pos, window, cap, k_pos, got, want)
            w = worst["decode_attention"]
            w[dt] = max(w.get(dt, 0.0), err)
            checked["decode_attention"].append(f"{label} {dt}")
    return worst, checked, rel


def _flash_instance(mangled):
    """The label of a mangled kernel name of flash_attention.cu, such as
    'bf16 wgmma hd 128' (the serving instance), 'bf16 wgmma hd 128 lse'
    (training's, which also writes the log-sum-exp) or 'bf16 wgmma hd
    96/64' (MLA's q/k and v head dims: its own kernel, flash_fwd_mla_kernel,
    since PR 25), or None for another function."""
    m = re.search(r"flash_fwd_mla_kernelILb([01])E", mangled)
    if m:
        return "bf16 wgmma hd 96/64" + " lse" * (m.group(1) == "1")
    for route, pat in (("bf16 wgmma", r"flash_fwd_wgmma_kernelI"),
                       ("float32 simt", r"flash_fwd_kernelIf")):
        m = re.search(pat + r"Li(\d+)ELi(\d+)ELb([01])E", mangled)
        if m:
            dims = m.group(1) if m.group(1) == m.group(2) else \
                f"{m.group(1)}/{m.group(2)}"
            return f"{route} hd {dims}" + " lse" * (m.group(3) == "1")
    return None


def ptxas_by_instance(log, label):
    """ptxas's registers, static shared memory and spills per kernel
    function in an nvcc ``-Xptxas -v`` log, keyed by ``label(mangled
    name)``; functions it labels None are skipped."""
    per, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = label(m.group(1))
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
        m = re.search(r"(\d+) bytes stack frame", ln)
        if m:
            per[cur]["stack_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            per[cur]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            per[cur]["static_smem_bytes"] = int(m.group(1))
    for m in re.finditer(r"wgmma\.mma_async instructions are serialized"
                         r"[^\n]*?function '([^']+)'", log):
        name = label(m.group(1))
        if name in per:
            per[name]["wgmma_serialized"] = True
    return per


def tensor_core_sass(build, so_path, label):
    """{label(mangled name): {"HGMMA": n, "UTMALDG": m, "sass_sha256": a
    hash of its instructions}}: the tensor-core and TMA-load instructions
    of each labelled function in ``cuobjdump --dump-sass`` of a built
    library, and the library's totals."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(so_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    per = {}
    for part in sass.split("Function : ")[1:]:
        name = label(part.split()[0])
        if name:
            ops = [op.strip() for op in
                   re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", part)]
            per[name] = {"HGMMA": part.count("HGMMA"),
                         "UTMALDG": part.count("UTMALDG"),
                         "sass_sha256": hashlib.sha256(
                             "\n".join(ops).encode()).hexdigest()[:16]}
    return per, {"HGMMA": sass.count("HGMMA"),
                 "UTMALDG": sass.count("UTMALDG")}


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
    per = ptxas_by_instance(build.BUILD_INFO["flash_attention"]["log"],
                            _flash_instance)
    for name, info in per.items():
        if name.startswith("bf16"):
            cfg = FA.tile_config(*map(int, name.split()[3].split("/")))
            info.update(BK=cfg["BK"], stages=cfg["NS"],
                        dynamic_smem_bytes=cfg["SMEM"])
            if "BQ" in cfg:      # MLA's (96, 64): tc::MlaCfg
                info.update(BQ=cfg["BQ"], consumer_warpgroups=cfg["NWG"],
                            setmaxnreg=(cfg["PRODUCER_REGS"],
                                        cfg["CONSUMER_REGS"]))
    counts, total = tensor_core_sass(build, so_path, _flash_instance)
    for name, info in per.items():
        info.update(counts.get(name, {}))
        assert info.get("spill_stores", 1) == 0, (name, info)
        if name.startswith("bf16"):
            assert info.get("HGMMA", 0) > 0 and info.get("UTMALDG", 0) > 0, \
                (name, info)
    # the serving instances and training's (with the lse output): head
    # dims 64, 128, 256 and MLA's 96/64
    assert sum(n.startswith("bf16") and not n.endswith("lse")
               for n in per) == 4, per
    assert sum(n.startswith("bf16") and n.endswith("lse") for n in per) == 4, \
        per
    assert "bf16 wgmma hd 96/64" in per, per
    emit("flash_build", t0, instances=per, sass_total=total)


def _instance(mangled):
    """A short label of a mangled kernel name of decode_attention.cu,
    wkv6.cu, gbm_predict.cu, wkv6_bwd.cu or mamba_scan_bwd.cu, such as
    'decode bf16 hd 128 G 8', 'wkv6 hd 64' (the serving instance), 'wkv6
    hd 64 states' (the training one), 'gbm d 3 depth 3' (depth 0: the
    generic instance for 5-10), 'wkv6_bwd hd 64' (the walk; 'wkv6_bwd fold
    hd 64' and 'wkv6_bwd carry hd 64' its first two launches) or
    'mamba_scan_bwd N 16', or 'mla_decode bf16' (its wgmma kernel, which
    merges the parts in its cluster; 'mla_decode f32' and 'mla_merge f32'
    the float32 route's two launches), else None."""
    m = re.search(r"mla_(decode|merge)_(wgmma_)?kernel", mangled)
    if m:
        return f"mla_{m.group(1)} {'bf16' if m.group(2) else 'f32'}"
    m = re.search(r"decode_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E",
                  mangled)
    if m:
        dt = "f32" if m.group(1) == "f" else "bf16"
        return f"decode {dt} hd {m.group(2)} G {m.group(3)}"
    m = re.search(r"gbm_kernelILi(\d+)ELi(\d+)E", mangled)
    if m:
        return f"gbm d {m.group(1)} depth {m.group(2)}"
    m = re.search(r"wkv6_kernelILi(\d+)E(Lb1E)?", mangled)
    if m:
        return f"wkv6 hd {m.group(1)}{' states' if m.group(2) else ''}"
    m = re.search(r"(wkv6_bwd|mamba_scan_bwd)_(fold_|carry_)?kernelILi(\d+)E",
                  mangled)
    if m:
        dim = "hd" if m.group(1) == "wkv6_bwd" else "N"
        part = f"{m.group(2)[:-1]} " if m.group(2) else ""
        return f"{m.group(1)} {part}{dim} {m.group(3)}"
    return None


def sass_loops(so_path, function):
    """The loops of one kernel function in ``cuobjdump --dump-sass`` of a
    built library, the first whose mangled name matches the regex
    ``function``: for each backward branch, the span from its target to
    the branch, with the number of instructions in it and of those whose
    opcode starts LDS (shared-memory loads), FADD, ISETP and FSEL (the
    feature select's compares and selects).  With the levels and chains
    of a walk unrolled, a span's instructions over its trees are the
    issued instructions per (row, tree)."""
    from repro_torch.kernels import build
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(so_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    part = next(p for p in sass.split("Function : ")[1:]
                if re.search(function, p.split()[0]))
    code = [(int(a, 16), op.strip()) for a, op in
            re.findall(r"/\*([0-9a-f]{4})\*/\s+([^;]*);", part)]
    loops = []
    for addr, op in code:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op)
        if m and int(m.group(1), 16) < addr:
            start = int(m.group(1), 16)
            ops = [o.split()[1 if o.startswith("@") else 0]
                   for a, o in code if start <= a <= addr]
            loops.append({"from": hex(start), "to": hex(addr),
                          "instructions": len(ops),
                          **{k: sum(o.startswith(k) for o in ops)
                             for k in ("LDS", "FADD", "ISETP", "FSEL")}})
    return {"function": part.split()[0], "instructions": len(code),
            "loops": sorted(loops, key=lambda lp: lp["instructions"])}


# bytes of register spill stores and of spill loads the WKV6 kernel may
# have: it is capped at 80 registers a thread so that three blocks fit on
# an SM, and ptxas spills a few bytes there at hd 64 (4 in the kept source,
# 8 in an earlier one; PERF.md); more is a regression
WKV6_SPILL_BYTES = 8


def kernel_build_phase(build, built):
    """ptxas's registers, spills, stack and static shared memory per
    instantiation of the decode, WKV6 and GBM kernels (from
    ``build.BUILD_INFO``), the warps, dynamic shared memory and resident
    blocks an SM of a decode block, as the library reports them
    (``tile_config``), and the loops of the GBM instance that serves d 3,
    depth 3 (``sass_loops``); the same for the backward kernels of WKV6
    and the scan.  Fails if a decode, GBM or backward instantiation
    spills or a GBM one has a stack, or a WKV6 forward (serving or
    training) stores or loads more than WKV6_SPILL_BYTES of spills."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    t0 = time.perf_counter()
    per = {}
    for name in ("decode_attention", "wkv6", "gbm_predict", "wkv6_bwd",
                 "mamba_scan_bwd", "mla_decode"):
        per.update(ptxas_by_instance(build.BUILD_INFO[name]["log"],
                                     _instance))
    mla_sass, _ = tensor_core_sass(build, built["mla_decode"], _instance)
    for name, info in per.items():
        if name.startswith("mla_decode"):
            cfg = DA.mla_tile_config(
                torch.bfloat16 if name.endswith("bf16") else torch.float32,
                0)
            info.update(slots_a_tile=cfg["TS"], warps=cfg["W"],
                        dynamic_smem_bytes=cfg["SMEM"],
                        blocks_per_sm=cfg["blocks_per_sm"],
                        max_parts=cfg["max_parts"],
                        clusters_resident=cfg["clusters"],
                        **mla_sass.get(name, {}))
        if name.startswith("decode"):
            dt = torch.bfloat16 if " bf16 " in name else torch.float32
            words = name.split()
            cfg = DA.tile_config(int(words[3]), dt, int(words[5]), 0)
            info.update(warps=cfg["W"], dynamic_smem_bytes=cfg["SMEM"],
                        blocks_per_sm=cfg["blocks_per_sm"])
    assert sum(n.startswith("decode") for n in per) == 24, sorted(per)
    assert sum(n.startswith("wkv6 ") for n in per) == 6, sorted(per)
    assert sum(n.startswith("gbm") for n in per) == 30, sorted(per)
    assert sum(n.startswith(("wkv6_bwd", "mamba_scan_bwd"))
               for n in per) == 12, sorted(per)
    assert sum(n.startswith("mla_") for n in per) == 3, sorted(per)
    assert per["mla_decode bf16"].get("HGMMA", 0) > 0 and \
        per["mla_decode bf16"].get("UTMALDG", 0) > 0, per["mla_decode bf16"]
    spills = {n: i for n, i in per.items()
              if max(i.get("spill_stores", 1), i.get("spill_loads", 1))
              > (WKV6_SPILL_BYTES if n.startswith("wkv6 ") else 0)
              or (n.startswith("gbm") and i.get("stack_bytes", 1) != 0)}
    assert not spills, spills
    emit("kernel_build", t0, instances=per,
         gbm_sass_d3_depth3=sass_loops(built["gbm_predict"],
                                       r"gbm_kernelILi3ELi3E"))


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
        ("G=8 hd=64 window 256", 2, 1000, 8, 1, 64, 999, 256, 0.0, False),
        # the kernel's tiles of 32 slots and runs of 16-slot multiples: a
        # run that ends inside a tile, and warps whose slots are all masked
        ("L=1000 ragged runs G=2 hd=128", 2, 1000, 8, 4, 128, 999, 0, 0.0,
         False),
        ("ring first turn, most warps fully masked", B, 512, 4, 1, 256, 100,
         512, 0.0, True)] + [
        (f"G={g} hd={hd}", 2, 777, 2 * g, 2, hd, 700, 0, 0.0, False)
        for g in (1, 2, 4, 8) for hd in (64, 128, 256)]
    worst, checked, rel = check_attention(flash_cases, decode_cases)

    times = {}
    for name, window in (("global", 0), ("local", 512)):
        times[f"flash_{name}"] = flash_times(7, B, Sv, 4, 1, 256, window)
    for name, Lc, window, ring in (("global", L, 0, False),
                                   ("local", 512, 512, True)):
        times[f"decode_{name}"] = decode_times(
            8, B, Lc, 4, 1, 256, SERVE_PROMPT + SERVE_NEW // 2, window, ring)
    emit("lm_kernel", t0, cases=checked, max_abs_err=worst,
         tolerances=LM_TOL, bf16_rel_err=rel,
         flash_bf16_rel_limit=FLASH_BF16_REL,
         decode_bf16_rel_limit=DECODE_BF16_REL, times=times)
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
        FA.LAUNCHES = DA.LAUNCHES = 0
        t1 = time.perf_counter()
        toks = serve.run("gemma3-1b", SERVE_B, SERVE_PROMPT, SERVE_NEW,
                         smoke=False, runtime_log=log, seed=0,
                         device=LM_DEVICE)
        sync()
        wall = time.perf_counter() - t1
        launches = {"flash_attention": FA.LAUNCHES,
                    "decode_attention": DA.LAUNCHES}
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
    times = {"ms": kern["events_ms"], "ms_from": "cuda events",
             "device_ms": kern["device_ms"], "plain_ms": plain["ms"],
             "plain_ms_from": plain["ms_from"],
             "bound_ms": bnd, "bound_by": by, "library_ms": None,
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
        elif cfg.use_mla:        # each MLA weight once a token
            nr, vd = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
            macs += T * (d * cfg.q_lora_rank
                         + cfg.q_lora_rank * cfg.n_heads * nr
                         + d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                         + cfg.kv_lora_rank * cfg.n_heads
                         * (cfg.qk_nope_dim + vd) + cfg.n_heads * vd * d)
            macs += B * cfg.n_heads * (nr + vd) * kept_pairs(S, True, 0)
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
    _free_card()
    attn_times = {
        "flash_attention": flash_times(207, B, S, H, KV, hd, 0),
        "decode_attention": decode_times(
            208, B, SERVE_L, H, KV, hd, SERVE_PROMPT + SERVE_NEW // 2, 0,
            False)}
    attn = {"max_abs_err": attn_worst, "bf16_rel_err": attn_rel,
            "times": attn_times}
    _free_card()
    emit("jamba_kernel", t0, cases=checked, max_abs_err_by_dtype=worst,
         tolerance={"atol": SCAN_ATOL, "rtol": SCAN_RTOL,
                    "rtol_bf16_y": SCAN_BF16_RTOL},
         min_dt_times_A=min_dta, times=times,
         library="none: no one PyTorch call computes a selective scan",
         attention_cases=attn_checked, attention_tolerances=LM_TOL,
         flash_bf16_rel_limit=FLASH_BF16_REL,
         decode_bf16_rel_limit=DECODE_BF16_REL, attention=attn)
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
    marks = ("mamba_scan_kernel", "flash_fwd", "decode_kernel")
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
            MS.LAUNCHES = FA.LAUNCHES = DA.LAUNCHES = 0
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                toks = serve.run(JAMBA_ARCH, SERVE_B, SERVE_PROMPT,
                                 SERVE_NEW, smoke=False, runtime_log=log,
                                 seed=0, device=LM_DEVICE)
            sync()
            wall = time.perf_counter() - t1
            launches = {"mamba_scan": MS.LAUNCHES,
                        "flash_attention": FA.LAUNCHES,
                        "decode_attention": DA.LAUNCHES}
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


# --------------------------------------------------------------- MLA slice

MLA_ARCH = "minicpm3-4b"
# minicpm3-4b's attention: 40 heads; prefill's per-head q and k of 96
# (nope 64 + rope 32) and v of 64; decode's latent caches ckv 256 and
# krope 32, the scale (nope + rope)**-0.5 in both
MLA_H, MLA_HDQK, MLA_HDV, MLA_C, MLA_R = 40, 96, 64, 256, 32
MLA_SCALE = MLA_HDQK ** -0.5
# mla_parity: the same 4-layer cut at full width, float32 on both sides
# (the card's kernels, TF32 off, against the CPU's plain versions), is
# held to jamba_parity's float32 limit, JAMBA_F32_TOL
MLA_PARITY_LAYERS, MLA_PARITY_PROMPT, MLA_PARITY_STEPS = 4, 512, 8


def _mla_inputs(seed, B, L, dtype):
    """Seeded q_lat [B, 40, 256], q_rope [B, 40, 32], ckv [B, L, 256] and
    krope [B, L, 32] on the card, N(0, 1)."""
    import torch
    g = torch.Generator(device=LM_DEVICE).manual_seed(seed)
    return [torch.randn(s, generator=g, device=LM_DEVICE).to(_tdtype(dtype))
            for s in ((B, MLA_H, MLA_C), (B, MLA_H, MLA_R), (B, L, MLA_C),
                      (B, L, MLA_R))]


def mla_decode_bound_ms(B, pos, dtype):
    """The latent slots 0 .. pos of both caches read once, q_lat and q_rope
    read and the output written once, against 2 (288 + 256) flops a kept
    slot and head."""
    item = 2 if dtype == "bfloat16" else 4
    n = pos + 1
    nbytes = item * B * (n * (MLA_C + MLA_R)
                         + MLA_H * (MLA_C + MLA_R) + MLA_H * MLA_C)
    flops = 2 * B * MLA_H * n * (MLA_C + MLA_R + MLA_C)
    return attn_bound_ms(nbytes, flops, dtype)


def _coarse_p_mla(ins, pos, p_type):
    """A control for the bf16 MLA decode check: the unnormalised P =
    exp(s - max) rounded to ``p_type`` before P.ckv, the sums taken
    before the rounding."""
    import torch
    ql, qr, ckv, kr = (t.float() for t in ins)
    s = (torch.einsum("bhc,blc->bhl", ql, ckv)
         + torch.einsum("bhr,blr->bhl", qr, kr)) * MLA_SCALE
    ok = torch.arange(ckv.shape[1], device=ckv.device) <= pos
    s = torch.where(ok, s, torch.tensor(-2.0e38, device=s.device))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhl,blc->bhc", p.to(p_type).float(), ckv)
    return (o / p.sum(-1, keepdim=True)).to(ins[0].dtype)


def check_mla_decode(label, B, L, pos, seed):
    """mla_decode_attention against its plain version on the card in
    bfloat16 and float32, within LM_TOL, each call repeated bit for bit;
    bf16 also within DECODE_BF16_REL, with two controls (P rounded to fp8,
    the scale off by 10%) that must exceed it where more than one slot is
    kept.  Returns {dtype: largest abs error} and the bf16 readings."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    errs, rel = {}, None
    for dt in ("bfloat16", "float32"):
        ins = _mla_inputs(seed, B, L, dt)
        got = DA.mla_decode_attention(*ins, pos, MLA_SCALE)
        again = DA.mla_decode_attention(*ins, pos, MLA_SCALE)
        want = DA.mla_decode_attention_plain(*ins, pos, MLA_SCALE)
        sync()
        assert torch.equal(got, again), f"mla_decode {label} {dt}: a " \
            f"repeated call gives other bits"
        excess, errs[dt] = _excess(got, want, dt)
        assert excess <= 0, f"mla_decode {label} {dt}: {excess} beyond " \
            f"tolerance"
        if dt == "bfloat16":
            rel = {"kernel": _rel_err(got, want)}
            assert rel["kernel"] <= DECODE_BF16_REL, \
                f"mla_decode {label} bfloat16: relative error " \
                f"{rel['kernel']} beyond {DECODE_BF16_REL}"
            rel["control_p_fp8"] = _rel_err(
                _coarse_p_mla(ins, pos, torch.float8_e4m3fn), want)
            rel["control_scale_1.1"] = _rel_err(
                DA.mla_decode_attention_plain(*ins, pos, 1.1 * MLA_SCALE),
                want)
            if pos > 0:
                for name in ("control_p_fp8", "control_scale_1.1"):
                    assert rel[name] > DECODE_BF16_REL, \
                        f"mla_decode {label}: the bf16 check passes its " \
                        f"{name} ({rel[name]})"
        del ins, got, again, want
    return errs, rel


def mla_decode_times(seed, B, L, pos):
    """Kernel, plain and SDPA times of one bf16 mla_decode_attention call
    at batch B over L-slot caches at ``pos``, and its bound.  The kernel's
    time is its profiler device time (the mean recorded duration of each
    kernel, times its launches a call), as decode_times takes
    decode_attention's.  The bf16 kernel merges its parts inside the
    launch (a cluster a batch row): ``walk_ms`` is the same launch with
    the merge skipped, ``merge_ms`` the difference.  SDPA computes the
    same function on [q_lat | q_rope] against one latent head [ckv |
    krope] with ckv as the values, made outside the call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    ins = _mla_inputs(seed, B, L, "bfloat16")
    per_part, n_parts = DA.mla_launch_plan(torch.bfloat16, 0, pos + 1, B)
    kern = lm_time(lambda: DA.mla_decode_attention(*ins, pos, MLA_SCALE),
                   200)
    walk = lm_time(lambda: DA._mla_launch(*ins, pos, MLA_SCALE, flags=1),
                   200)
    traced, traced_in = route_trace("mla", seed=seed, B=B, L=L, pos=pos)
    assert any("mla_decode_wgmma_kernel" in n for n in traced), traced
    plain = lm_time(lambda: DA.mla_decode_attention_plain(*ins, pos,
                                                          MLA_SCALE), 50)
    lib_t = None
    if sdpa_has_gqa():
        ql, qr, ckv, kr = ins
        qt = torch.cat([ql, qr], -1)[:, :, None]             # [B, H, 1, 288]
        kt = torch.cat([ckv, kr], -1)[:, None]               # [B, 1, L, 288]
        vt = ckv[:, None]                                    # [B, 1, L, 256]
        mask = (torch.arange(L, device=ckv.device) <= pos)[None, None, None]
        lib_t = lm_time(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=MLA_SCALE, enable_gqa=True),
            200)
    bnd, by = mla_decode_bound_ms(B, pos, "bfloat16")
    dev = kern["device_ms"] is not None
    ms = kern["device_ms"] if dev else kern["events_ms"]
    walk_ms = walk["device_ms"] if walk["device_ms"] is not None \
        else walk["events_ms"]
    return {"ms": ms,
            "ms_from": "profiler device time" if dev else "cuda events",
            "walk_ms": walk_ms, "merge_ms": ms - walk_ms,
            "route_traced_in": traced_in, "plain_ms": plain["ms"],
            "bound_ms": bnd, "bound_by": by,
            "library_ms": lib_t and lib_t["ms"], "pos": pos,
            "parts": n_parts, "slots_a_part": per_part,
            "timings": {"kernel": kern, "walk": walk, "plain": plain,
                        "library": lib_t}}


def mla_kernel_phase():
    """Both kernels of minicpm3-4b's path against their plain versions on
    the card, in bfloat16 and float32, every call repeated bit for bit:
    flash attention at q/k head 96 and v head 64 (40 heads; the serving
    prompt B 8 x S 2048, S = 1, S = 129, a ragged S, and a window with a
    softcap over 8 kv heads) and the MLA decode (B 8 over the 2,120-slot
    caches at pos 0, at 2080 and at 1100, where the last part's run ends
    inside a 64-slot tile, at 191 and 192 on a part's edge; B 1; B 16).
    Then times, bounds and SDPA's times at the serving shapes, the
    decode's walk and merge apart."""
    t0 = time.perf_counter()
    B, S, L = SERVE_B, SERVE_PROMPT, SERVE_L
    flash_cases = [   # label, B, S, KV, window, softcap; 40 heads of q/k
        # 96 and v 64, causal
        ("serve", B, S, MLA_H, 0, 0.0), ("S=1", B, 1, MLA_H, 0, 0.0),
        ("S=129", 2, 129, MLA_H, 0, 0.0),
        ("ragged S=1000", 2, 1000, MLA_H, 0, 0.0),
        ("window 100 softcap 30 KV=8", 2, 700, 8, 100, 30.0)]
    decode_cases = [("serve pos 2080", B, L, 2080), ("pos 0", B, L, 0),
                    ("pos 1100, the last run ends inside a tile", B, L,
                     1100),
                    ("pos 191, a part's edge", B, L, 191),
                    ("pos 192, one slot past it", B, L, 192),
                    ("B=1 pos 2080", 1, L, 2080),
                    ("B=16 pos 2080", 16, L, 2080)]
    f_worst, _, f_rel = check_attention(
        [(label, b, s, MLA_H, kv, MLA_HDQK, True, w, cap, MLA_HDV)
         for label, b, s, kv, w, cap in flash_cases], [], seed=300)
    _free_card()
    worst = {"flash_attention_mla": f_worst["flash_attention"],
             "mla_decode": {}}
    rel = {"flash_attention_mla": f_rel["flash_attention"], "mla_decode": {}}
    for i, (label, b, Lc, pos) in enumerate(decode_cases):
        errs, rel["mla_decode"][label] = check_mla_decode(label, b, Lc, pos,
                                                          310 + i)
        for dt, e in errs.items():
            worst["mla_decode"][dt] = max(worst["mla_decode"].get(dt, 0.0),
                                          e)
        _free_card()
    times = {"flash_attention_mla": flash_times(
                 307, B, S, MLA_H, MLA_H, MLA_HDQK, 0, hdv=MLA_HDV),
             "mla_decode": mla_decode_times(
                 308, B, L, SERVE_PROMPT + SERVE_NEW // 2)}
    _free_card()
    emit("mla_kernel", t0,
         cases={k: [c[0] for c in v] for k, v in (
             ("flash_attention_mla", flash_cases),
             ("mla_decode", decode_cases))},
         max_abs_err=worst, tolerances=LM_TOL, bf16_rel_err=rel,
         flash_bf16_rel_limit=FLASH_BF16_REL,
         decode_bf16_rel_limit=DECODE_BF16_REL, times=times)
    return worst, times, rel


def mla_serve_phase():
    """minicpm3-4b at full width and depth (62 layers, d 2560) through
    ``repro_torch.launch.serve.run``: batch 8, prompt 2048, 64 new tokens,
    weights drawn on the card, after a warm-up serve of 4 tokens.  The
    counts are set to 0 just before the measured run and read just after
    it: the prefill launches the flash kernel's (96, 64) instance once a
    layer, each of the 63 decode steps the MLA decode kernel once a layer
    and the dense decode kernel never."""
    import contextlib
    import io
    import tempfile
    import torch
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    cfg = serve.card_config(MLA_ARCH)
    _free_card()
    serve.run(MLA_ARCH, SERVE_B, SERVE_PROMPT, 4, smoke=False, seed=0,
              device=LM_DEVICE)                                # warm-up
    sync()
    _free_card()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        log = os.path.join(tmp, "runtime.jsonl")
        torch.cuda.reset_peak_memory_stats()
        out = io.StringIO()
        FA.LAUNCHES = DA.LAUNCHES = DA.MLA_LAUNCHES = 0
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            toks = serve.run(MLA_ARCH, SERVE_B, SERVE_PROMPT, SERVE_NEW,
                             smoke=False, runtime_log=log, seed=0,
                             device=LM_DEVICE)
        sync()
        wall = time.perf_counter() - t1
        launches = {"flash_attention": FA.LAUNCHES,
                    "mla_decode": DA.MLA_LAUNCHES,
                    "decode_attention": DA.LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        with open(log) as f:
            rec = json.loads(f.read().splitlines()[-1])
    line = out.getvalue().strip()
    print(line, file=sys.stderr, flush=True)
    init_s = float(line.split("init ")[1].split("s;")[0])
    _free_card()
    steps = SERVE_NEW - 1
    assert cfg.n_layers == 62 and cfg.d_model == 2560, cfg
    assert rec["arch"] == MLA_ARCH and rec["batch"] == SERVE_B
    assert rec["prompt_len"] == SERVE_PROMPT and "n_layers" not in rec, rec
    assert rec["prefill_s"] > 0 and rec["decode_median_s"] > 0
    assert tuple(toks.shape) == (SERVE_B, SERVE_NEW)
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    assert launches == {"flash_attention": cfg.n_layers,
                        "mla_decode": steps * cfg.n_layers,
                        "decode_attention": 0}, launches
    slots = SERVE_PROMPT + SERVE_NEW // 2
    latent_bytes = 2 * cfg.n_layers * SERVE_B * slots * (MLA_C + MLA_R)
    emit("mla_serve", t0, arch=MLA_ARCH, layers=cfg.n_layers,
         d_model=cfg.d_model, params=cfg.param_counts()["total"],
         batch=SERVE_B, prompt_len=SERVE_PROMPT, max_new=SERVE_NEW,
         init_s=init_s, prefill_ms=rec["prefill_s"] * 1e3,
         prefill_tokens_per_s=SERVE_B * SERVE_PROMPT / rec["prefill_s"],
         decode_median_ms_per_token=rec["decode_median_s"] * 1e3,
         decode_tokens_per_s=SERVE_B / rec["decode_median_s"],
         run_wall_s=wall, peak_device_bytes=peak, launches=launches,
         bounds=dict(serve_bounds_ms(cfg, SERVE_B, SERVE_PROMPT),
                     decode_latent_cache_read_ms_mid=latent_bytes
                     / HBM_BYTES_PER_S * 1e3),
         runtime_log_line=rec)
    return launches


def mla_profile_phase():
    """profile_serving for minicpm3-4b at full width and depth: the flash
    kernel's (96, 64) instance in prefill, the MLA decode kernel and its
    merge in decode."""
    t0 = time.perf_counter()
    _free_card()
    emit("mla_profile", t0, **profile_serving(MLA_ARCH,
                                              ("flash_fwd", "mla_")))
    _free_card()


def mla_parity_phase():
    """minicpm3-4b at full width cut to 4 layers (0.44 B parameters),
    batch 1, prompt 512, 8 decode steps.  One set of float32 weights drawn
    on the card; the CPU (float32, plain versions) runs first, greedily,
    and the card's decode steps take the CPU's tokens.  The card in
    float32 (kernels, TF32 off) is held to JAMBA_F32_TOL relative on the
    last-position logits, the card in bf16 (the same weights rounded) to
    PARITY_REL_TOL; both to the CPU's greedy token at every step whose
    top-2 margin exceeds twice the card's error there (where the error
    cannot flip it), and each disagreement is recorded with its step."""
    import dataclasses
    import torch
    from repro_torch.launch.serve import card_config
    from repro_torch.modeling.model import Model, init_params
    t0 = time.perf_counter()
    _free_card()
    cfg = card_config(MLA_ARCH, n_layers=MLA_PARITY_LAYERS)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params = init_params(cfg32, 1, LM_DEVICE, gen_device=LM_DEVICE)
    S, steps = MLA_PARITY_PROMPT, MLA_PARITY_STEPS
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, S)))

    def drive(model, toks=None):
        """Prefill, then ``steps`` decode steps on ``toks`` (or greedy):
        the last position's logits a step (float64, CPU), and the tokens
        fed."""
        dev = model.device
        logits, fed = [], []
        with torch.inference_mode():
            cache = model.init_cache(1, S + steps)
            out, _ = model(prompt.to(dev), mode="prefill", cache=cache)
            for step in range(steps + 1):
                logits.append(out[0, -1].double().cpu())
                if step == steps:
                    break
                tok = (logits[-1].argmax() if toks is None
                       else toks[step]).reshape(1, 1)
                fed.append(tok)
                out, _ = model(tok.to(dev), mode="decode", pos0=S + step,
                               cache=cache)
        return logits, fed

    want, toks = drive(Model(cfg32, _cpu_f32(params)))
    gc.collect()
    report = {}
    makers = {"float32": lambda: Model(cfg32, params),
              "bfloat16": lambda: Model(cfg, _map_tree(
                  lambda t: t.to(_tdtype("bfloat16")), params))}
    limits = {"float32": JAMBA_F32_TOL, "bfloat16": PARITY_REL_TOL}
    for name, make in makers.items():
        model = make()
        got, _ = drive(model, toks)
        del model
        _free_card()
        rel, agree, decided, margins, differ = [], 0, 0, [], []
        for step, (g, w) in enumerate(zip(got, want)):
            err = (g - w).abs().max().item()
            rel.append(((g - w).norm() / w.norm()).item())
            top2 = torch.topk(w, 2).values
            margins.append((top2[0] - top2[1]).item())
            same = int(g.argmax()) == int(w.argmax())
            agree += same
            if not same:
                differ.append({"step": step, "card": int(g.argmax()),
                               "cpu": int(w.argmax()), "margin": margins[-1],
                               "max_abs_err": err})
            if margins[-1] > 2 * err:
                decided += 1
                assert same, f"{name} step {step}: greedy token differs"
        assert max(rel) <= limits[name], (name, rel)
        report[name] = {"logits_rel_err": rel,
                        "max_logits_rel_err": max(rel),
                        "greedy_tokens_agree": f"{agree}/{steps + 1}",
                        "steps_where_margin_exceeds_twice_error": decided,
                        "greedy_tokens_differing": differ,
                        "top2_margins": margins}
    del params
    _free_card()
    emit("mla_parity", t0, layers=cfg.n_layers, d_model=cfg.d_model,
         params=cfg.param_counts()["total"], prompt_len=S,
         decode_steps=steps,
         cuts=f"depth 62 -> {cfg.n_layers} layers; batch 1, prompt {S}",
         tolerance=limits, **report)
    return report


# ------------------------------------------------------------------ main


# --------------------------------------------------------- training slice

# the flash backward against flash_attention_bwd_plain on the same inputs
# (the forward kernel's o and lse) and against autograd of
# flash_attention_plain: float32 sums over up to 4096 terms in another
# order; bfloat16 (card tests: FLASH_BWD_BF16_REL in
# tests/test_torch_gpu.py) the wgmma kernels round P and dS to bf16 before
# their products, as the forward rounds P, and dq, dk and dv once at the
# end (2**-9 relative each), which the float32-inside plain version does
# not.  PERF.md gives the readings (the first, SIMT design, float32
# inside: against the plain version up to 4.6e-5, against autograd, whose
# O comes from its own float32 softmax and not the kernel's bf16-P one, up
# to 1.8e-3; a CPU replay of the wgmma route's roundings,
# tests/test_torch_flash_bwd.py, reads 2.4e-3 to 2.7e-3 against the plain
# version); the controls (delta set to 0, dS rounded to fp8 e4m3 with a
# scale per row, 0.018 or more) must exceed the limit
FLASH_BWD_F32_REL = 1e-5
FLASH_BWD_BF16_REL = 5e-3
# gemma3-1b's training microbatch: batch 8 over grad_accum 4
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 4096, 4
TRAIN_MICRO_B = 2
# minicpm3-4b's training microbatch: batch 8 over grad_accum 8; mla_train
# runs 4 steps of TRAIN_B x TRAIN_S
MLA_TRAIN_STEPS, MLA_TRAIN_MICRO_B = 4, 1
# mla_train_parity: minicpm3-4b at full width cut to 4 layers, batch 2,
# sequence 512, held to train_parity's limits
MLA_PARITY_TRAIN_LAYERS, MLA_PARITY_TRAIN_B, MLA_PARITY_TRAIN_S = 4, 2, 512
# train_parity: card against CPU after one AdamW step, one full-width
# period of gemma3-1b (6 layers), batch 2, sequence 1024.  float32: 1e-3
# relative on the loss, the grad norm, every gradient leaf and the
# parameters after the step (where decided: AdamW's first step moves an
# element by lr times its gradient's sign, so an element whose CPU
# gradient is within twice the card's difference may flip).  bfloat16, on
# the loss and the worst gradient leaf: the weights rounded to bf16
# (2**-9) and every activation and gradient rounded on the way through 6
# layers and back.  First set at 1e-1; the card read 1.3e-2 (layer 5's wq,
# PERF.md), so the bound is 5e-2.  The control, float32 on the card with
# the flash backward's delta set to 0, must exceed it (it read 9.4)
TRAIN_F32_REL = 1e-3
TRAIN_BF16_REL = 5e-2
# The float32 parameters after the step, split by the clipped gradient
# |g| that AdamW sees against its eps: the first step moves an element by
# lr g / (|g| + eps), whose change with g, eps / (|g| + eps)^2, is at most
# 1 / (4 eps) at |g| = eps and under 1e-3 / |g| where |g| > 1e3 eps.  So a
# float32 difference in g moves the parameters only where |g| is near eps,
# and where |g| > ADAMW_FAR_EPS * eps (and decided) they are held to
# TRAIN_F32_FAR_REL, float32 rounding of the update
ADAMW_FAR_EPS = 1e3
TRAIN_F32_FAR_REL = 1e-5
PARITY_TRAIN_B, PARITY_TRAIN_S = 2, 1024
# the flash backward's launches, in the order a call makes them
BWD_KERNELS = ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dkdv_sum",
               "flash_bwd_dq")


def _bwd_instance(mangled):
    """A label of a mangled kernel name of flash_attention_bwd.cu, such as
    'dkdv bf16 wgmma hd 256', 'dq f32 hd 64' (the SIMT route), 'dq f32 hd
    96/64' (MLA's q/k and v head dims), 'dkdv bf16 mla hd 96/64' (the bf16
    (96, 64) kernels of their own, flash_bwd_dkdv_mla_kernel and
    flash_bwd_dq_mla_kernel), 'dkdv sum' or 'delta f32', else
    None."""
    def dims(hd, hdv):
        return hd if hdv in (None, hd) else f"{hd}/{hdv}"
    m = re.search(r"flash_bwd_(dkdv|dq)_mla_kernel", mangled)
    if m:
        return f"{m.group(1)} bf16 mla hd 96/64"
    m = re.search(r"flash_bwd_(dkdv|dq)_wgmma_kernelILi(\d+)E(?:Li(\d+)E)?",
                  mangled)
    if m:
        return f"{m.group(1)} bf16 wgmma hd {dims(m.group(2), m.group(3))}"
    m = re.search(r"flash_bwd_(dkdv|dq)_kernelI(f|13__nv_bfloat16)Li(\d+)E"
                  r"(?:Li(\d+)E)?", mangled)
    if m:
        dt = "f32" if m.group(2) == "f" else "bf16"
        return f"{m.group(1)} {dt} hd {dims(m.group(3), m.group(4))}"
    if "flash_bwd_dkdv_sum_kernel" in mangled:
        return "dkdv sum"
    m = re.search(r"flash_bwd_delta_kernelI(f|13__nv_bfloat16)E", mangled)
    return (f"delta {'f32' if m.group(1) == 'f' else 'bf16'}" if m
            else None)


def _tensors(seed, shapes, dtype):
    import torch
    g = torch.Generator(device=LM_DEVICE).manual_seed(seed)
    return [torch.randn(s, generator=g, device=LM_DEVICE).to(_tdtype(dtype))
            for s in shapes]


def _within(got, want, rel):
    """||got - want|| <= rel ||want|| + 1e-6 sqrt(n): the absolute term
    covers gradients that are zero up to rounding (at S = 1, P = 1 and
    dP = delta, so dq and dk are float32 noise)."""
    g, w = got.double(), want.double()
    return float((g - w).norm()) <= rel * float(w.norm()) \
        + 1e-6 * w.numel() ** 0.5


def _coarse_ds_bwd(q, k, v, do, lse, delta, kw, scale):
    """A control for the bf16 check: (dq, dk) with dS rounded to fp8 e4m3
    (4 significant bits), scaled per row to e4m3's largest value."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    B, S, H, hd = q.shape
    _, ds, qg, _ = FA._probs_and_ds(q, k, v, do, lse, delta, kw["causal"],
                                    kw["window"], kw["softcap"], scale)
    amax = ds.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    ds = (ds / amax * 448.0).to(torch.float8_e4m3fn).float() * amax / 448.0
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg).to(k.dtype)
    dq = (torch.einsum("bkgqs,bskh->bqkgh", ds, k.float()) * scale)
    return dq.reshape(B, S, H, hd).to(q.dtype), dk


def check_flash_bwd(label, B, S, H, KV, hd, causal, window, cap, dtype,
                    seed, hdv=None):
    """One backward case on the card (v and dO at head dim ``hdv``, default
    ``hd``): the forward's bytes with and without its lse output; the lse
    against its plain version; the three backward launches against
    ``flash_attention_bwd_plain`` on the same inputs and against autograd
    of ``flash_attention_plain``, each repeated bit for bit; in bf16 the
    controls.  Returns the readings."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    kw = dict(causal=causal, window=window, softcap=cap)
    hdv = hd if hdv is None else hdv
    q, k, v, do = _tensors(seed, ((B, S, H, hd), (B, S, KV, hd),
                                  (B, S, KV, hdv), (B, S, H, hdv)), dtype)
    plain_fwd = FA.flash_attention(q, k, v, **kw)
    o, lse = FA.flash_attention_lse(q, k, v, **kw)
    sync()
    assert torch.equal(plain_fwd, o), \
        f"flash backward {label} {dtype}: the forward's bytes change with lse"
    lse_err = float((lse - FA.flash_attention_lse_plain(q, k, **kw))
                    .abs().max())
    assert lse_err <= 1e-4, (label, dtype, lse_err)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    sync()
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
    auto = torch.autograd.grad(FA.flash_attention_plain(qa, ka, va, **kw),
                               (qa, ka, va), do)
    limit = FLASH_BWD_F32_REL if dtype == "float32" else FLASH_BWD_BF16_REL
    r = {"lse_max_abs_err": lse_err}
    for name, g, a, w, au in zip(("dq", "dk", "dv"), got, again, want, auto):
        assert torch.equal(g, a), f"flash backward {label}: {name} repeats"
        assert bool(g.float().isfinite().all()), (label, name)
        # at S = 1 dq and dk are zero up to rounding: no relative reading
        r[name] = {"rel": _rel_err(g, w) if S > 1 else None,
                   "rel_autograd": _rel_err(g, au) if S > 1 else None,
                   "max_abs_err": float((g.float() - w.float()).abs().max())}
        for ref in (w, au):
            assert _within(g, ref, limit), \
                f"flash backward {label} {dtype} {name}: {r[name]} beyond " \
                f"{limit}"
    if dtype == "bfloat16" and H > KV:
        # the wgmma dkdv launch's per-head partials against their plain
        # version, and their sum (heads in order, one rounding) bit for bit
        delta = FA.flash_bwd_delta(o, do)
        part = FA.flash_bwd_dkdv_partials(q, k, v, do, lse, delta, **kw)
        sums = FA.flash_bwd_dkdv_sum(part, KV)
        sync()
        part_want = FA.flash_bwd_dkdv_partials_plain(q, k, v, do, lse, delta,
                                                     **kw)
        r["partials_rel"] = max(_rel_err(a, b) for a, b in
                                zip(part, part_want)) if S > 1 else None
        assert all(_within(a, b, limit) for a, b in zip(part, part_want)), \
            (label, r["partials_rel"])
        plain_sums = FA.flash_bwd_dkdv_sum_plain(part, KV)
        r["sum_bit_equal"] = all(torch.equal(a, b)
                                 for a, b in zip(sums, plain_sums))
        r["sum_max_abs_err"] = max(float((a.float() - b.float()).abs().max())
                                   for a, b in zip(sums, plain_sums))
        assert r["sum_bit_equal"], f"flash backward {label}: dkdv sum"
    if dtype == "bfloat16" and S > 1:
        scale = hd ** -0.5
        delta = FA.flash_bwd_delta_plain(o, do)
        zero = torch.zeros_like(delta)
        ctl_dk, _ = FA.flash_bwd_dkdv_plain(q, k, v, do, lse, zero, **kw)
        ctl_dq = FA.flash_bwd_dq_plain(q, k, v, do, lse, zero, **kw)
        fp8_dq, fp8_dk = _coarse_ds_bwd(q, k, v, do, lse, delta, kw, scale)
        r["control_delta_0"] = min(_rel_err(ctl_dq, want[0]),
                                   _rel_err(ctl_dk, want[1]))
        r["control_ds_fp8"] = min(_rel_err(fp8_dq, want[0]),
                                  _rel_err(fp8_dk, want[1]))
        for name in ("control_delta_0", "control_ds_fp8"):
            assert r[name] > FLASH_BWD_BF16_REL, \
                f"flash backward {label}: the bf16 check passes its " \
                f"{name} ({r[name]})"
    return r


def flash_bwd_bounds(B, S, H, KV, hd, causal, window, dtype, hdv=None):
    """Bounds of the backward's launches on this run's inputs (q and k at
    head dim ``hd``, v, dO and O at ``hdv``, default ``hd``): bytes (each
    input read once, each output written once) at the HBM rate against the
    products of the kept pairs (dkdv: S and dK over hd, dP and dV over
    hdv, 4 (hd + hdv) a pair; dq: S and dQ over hd, dP over hdv,
    4 hd + 2 hdv; delta: 2 hdv a row) at the peak of the inputs' type.  In
    bf16 with G = H / KV > 1 the dkdv launch writes float32 partials
    ([B, S, H, hd] and [B, S, H, hdv]), and flash_bwd_dkdv_sum reads them
    and writes dk and dv (G - 1 float32 adds an element, at the float32
    peak)."""
    hdv = hd if hdv is None else hdv
    item = 2 if dtype == "bfloat16" else 4
    pairs = B * H * kept_pairs(S, causal, window)
    q_b, g_b = item * B * S * H * hd, item * B * S * H * hdv
    k_b, v_b, rows = item * B * S * KV * hd, item * B * S * KV * hdv, \
        B * H * S
    part_b = 4 * B * S * H * (hd + hdv)
    split = dtype == "bfloat16" and H > KV
    out = {
        "flash_bwd_delta": attn_bound_ms(2 * g_b + 4 * rows,
                                         2 * B * S * H * hdv, dtype),
        "flash_bwd_dkdv": attn_bound_ms(
            q_b + g_b + k_b + v_b + (part_b if split else k_b + v_b)
            + 8 * rows, 4 * (hd + hdv) * pairs, dtype),
        "flash_bwd_dq": attn_bound_ms(2 * q_b + g_b + k_b + v_b + 8 * rows,
                                      (4 * hd + 2 * hdv) * pairs, dtype)}
    if split:
        out["flash_bwd_dkdv_sum"] = attn_bound_ms(
            part_b + k_b + v_b, B * S * KV * (hd + hdv) * (H // KV - 1),
            "float32")
    return out


def _sdpa_backend(fn):
    """The SDPA backend that one traced call of ``fn`` ran, by its device
    kernels' names: "cudnn", "flash", "efficient" (the CUTLASS
    memory-efficient kernels), "math" (none of those) or "not traced" (the
    profiler recorded no device event), with the names."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    if not names:
        return "not traced", names
    low = " ".join(names).lower()
    for backend, key in (("cudnn", "cudnn"), ("flash", "flash"),
                         ("efficient", "fmha")):
        if key in low:
            return backend, names
    return "math", names


def sdpa_backward_times(q, k, v, do, window):
    """SDPA's backward at the shape of [B, S, heads, hd] q, k, v and do
    (v and do may have a head dim of their own), causal (with a window,
    through a boolean mask), on [B, heads, S, hd] copies, by CUDA events:
    forward, forward and backward, and the backward as their difference,
    with the backend that took the call (``_sdpa_backend``); None where
    SDPA has no GQA."""
    import torch
    import torch.nn.functional as F
    if not sdpa_has_gqa():
        return None
    S = q.shape[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    mask = None
    if window:
        i = torch.arange(S, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                             - window)

    def fwd():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)
    f_ms, fb_ms = cuda_ms(fwd, 10), cuda_ms(fwd_bwd, 10)
    backend, names = _sdpa_backend(fwd_bwd)
    return {"forward_ms": f_ms, "forward_backward_ms": fb_ms,
            "backward_ms": fb_ms - f_ms, "backend": backend,
            "kernels": names[:12]}


def flash_bwd_times(seed, B, S, H, KV, hd, window, dtype, hdv=None,
                    trace=True):
    """CUDA-event times of each backward launch and of its plain version,
    the bounds, and SDPA's backward at the same shape (forward and
    backward less the forward, on [B, H, S, hd] copies; bf16 only); v and
    dO at head dim ``hdv`` (default ``hd``).  In
    bf16 with G > 1 the dkdv launch (its partials) and the sum are timed
    apart, the sum beside one ``torch.sum`` over the heads of the same
    partials (float32 out: without the rounding).  With ``trace``, the
    kernel names that
    profiled calls of the whole backward show (``route_trace`` "bwd", at
    this shape) go with the times, and those the traces missed; fails
    unless the route's dkdv and dq kernels were seen (at the bf16 (96, 64)
    flash_bwd_dkdv_mla and flash_bwd_dq_mla), and on any kernel of another
    route.  In bf16 the dkdv and dq launches are also repeated three times
    and must give the same bits (``repeat_bit_equal``)."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    kw = dict(window=window)
    hdv = hd if hdv is None else hdv
    q, k, v, do = _tensors(seed, ((B, S, H, hd), (B, S, KV, hd),
                                  (B, S, KV, hdv), (B, S, H, hdv)), dtype)
    o, lse = FA.flash_attention_lse(q, k, v, **kw)
    delta = FA.flash_bwd_delta(o, do)
    steps = [("flash_bwd_delta", lambda: FA.flash_bwd_delta(o, do),
              lambda: FA.flash_bwd_delta_plain(o, do))]
    split = dtype == "bfloat16" and H > KV
    if split:
        part = FA.flash_bwd_dkdv_partials(q, k, v, do, lse, delta, **kw)
        steps += [
            ("flash_bwd_dkdv",
             lambda: FA.flash_bwd_dkdv_partials(q, k, v, do, lse, delta, **kw),
             lambda: FA.flash_bwd_dkdv_partials_plain(q, k, v, do, lse, delta,
                                                      **kw)),
            ("flash_bwd_dkdv_sum", lambda: FA.flash_bwd_dkdv_sum(part, KV),
             lambda: FA.flash_bwd_dkdv_sum_plain(part, KV))]
    else:
        steps += [("flash_bwd_dkdv",
                   lambda: FA.flash_bwd_dkdv(q, k, v, do, lse, delta, **kw),
                   lambda: FA.flash_bwd_dkdv_plain(q, k, v, do, lse, delta,
                                                   **kw))]
    steps += [("flash_bwd_dq",
               lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
               lambda: FA.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw))]
    out = {}
    if dtype == "bfloat16":
        for name, fn, _ in steps[1:]:
            if name == "flash_bwd_dkdv_sum":
                continue
            runs = [fn() for _ in range(3)]
            sync()
            runs = [r if isinstance(r, (tuple, list)) else (r,) for r in runs]
            same = all(torch.equal(a, b) for r in runs[1:]
                       for a, b in zip(runs[0], r))
            assert same, f"flash backward {dtype} {name}: repeats differ"
            out.setdefault("repeat_bit_equal", {})[name] = same
            del runs
    for name, fn, plain in steps:
        out[name] = {"ms": cuda_ms(fn, 10, warm=2),
                     "plain_ms": cuda_ms(plain, 3, warm=1)}
    for name, (bnd, by) in flash_bwd_bounds(B, S, H, KV, hd, True, window,
                                            dtype, hdv).items():
        out[name].update(bound_ms=bnd, bound_by=by)
    if split:
        grouped = [t.view(B, S, KV, H // KV, -1) for t in part]
        out["flash_bwd_dkdv_sum"]["library_ms"] = cuda_ms(
            lambda: [torch.sum(t, dim=3) for t in grouped], 10, warm=2)
        del part, grouped
    if trace:
        traced, traced_in = route_trace(
            "bwd", dtype=dtype, window=window, B=B, S=S, H=H, KV=KV, hd=hd,
            hdv=hdv)
        want, need = bwd_route_kernels(dtype, (hd, hdv))
        seen = _bwd_kernels_seen(traced)
        assert need <= seen <= want, \
            f"flash backward {dtype} window {window}: the trace shows {seen}"
        out.update(trace_kernels=sorted(seen),
                   trace_missing=sorted(want - seen),
                   route_traced_in=traced_in)
    out["forward_ms"] = cuda_ms(lambda: FA.flash_attention(q, k, v, **kw), 10)
    out["sdpa"] = sdpa_backward_times(q, k, v, do, window) \
        if dtype == "bfloat16" else None
    out["backward_ms"] = sum(out[n]["ms"] for n in BWD_KERNELS if n in out)
    return out


def bwd_route_kernels(dtype, dims=None):
    """The kernels flash_attention_bwd launches in ``dtype`` at the head
    dims ``dims`` (q/k, v) with more query heads than kv heads: (all of
    them, the dkdv and dq kernels a trace must show).  The bf16 (96, 64)
    runs kernels of its own, flash_bwd_dkdv_mla and flash_bwd_dq_mla."""
    if dtype == "bfloat16" and dims == (MLA_HDQK, MLA_HDV):
        need = {"flash_bwd_dkdv_mla_kernel", "flash_bwd_dq_mla_kernel"}
        return need | {"flash_bwd_delta_kernel",
                       "flash_bwd_dkdv_sum_kernel"}, need
    if dtype == "bfloat16":
        need = {"flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel"}
        return need | {"flash_bwd_delta_kernel",
                       "flash_bwd_dkdv_sum_kernel"}, need
    need = {"flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"}
    return need | {"flash_bwd_delta_kernel"}, need


def bwd_build(build):
    """What the compiler made of flash_attention_bwd.cu, per instantiation:
    ptxas's registers, spills and stack (none may spill), for the wgmma
    instances their dynamic shared memory and tiles (``bwd_tc_config``)
    and the counts of tensor-core (HGMMA) and TMA-load (UTMALDG)
    instructions in their SASS, and a hash of every instance's SASS
    (``sass_sha256``, which ``scripts/kernel_ab.py``'s train step compares
    between trees).  Exactly 19 instances: delta in both types, dkdv and
    dq in float32 (SIMT) and bf16 (wgmma) at hd 64, 128 and 256 and at
    MLA's (96, 64) (bf16: its own kernels, 'dkdv bf16 mla hd 96/64' and
    'dq bf16 mla hd 96/64', with their consumer warpgroups and registers
    from ``bwd_tc_config``), and the dkdv sum; no bf16 SIMT instance is
    left, and no wgmma is serialised."""
    from repro_torch.kernels import flash_attention as FA
    per = ptxas_by_instance(build.BUILD_INFO["flash_attention_bwd"]["log"],
                            _bwd_instance)
    assert len(per) == 19, sorted(per)
    assert not [n for n in per if n.split()[1:3] == ["bf16", "hd"]], per
    assert {"dkdv bf16 mla hd 96/64", "dq bf16 mla hd 96/64"} <= set(per)
    spills = {n: i for n, i in per.items()
              if max(i.get("spill_stores", 1), i.get("spill_loads", 1)) > 0
              or i.get("wgmma_serialized")}
    assert not spills, spills
    so = build.build_all(["flash_attention_bwd"])["flash_attention_bwd"]
    counts, _ = tensor_core_sass(build, so, _bwd_instance)
    for name, info in per.items():
        info["sass_sha256"] = counts.get(name, {}).get("sass_sha256")
        if "wgmma" in name or "mla" in name:
            info.update(counts.get(name, {}))
            kind, dims = name.split()[0], name.split()[-1].split("/")
            cfg = FA.bwd_tc_config(*map(int, dims))[kind]
            info.update(dynamic_smem_bytes=cfg["SMEM"], BQ=cfg["BQ"],
                        BK=cfg["BK"], stages=cfg["NS"])
            if "mla" in name:
                info.update(kernel=f"flash_bwd_{kind}_mla_kernel",
                            consumer_warpgroups=cfg["NWG"],
                            threads=cfg["THREADS"],
                            producer_registers=cfg["PRODUCER_REGS"],
                            consumer_registers=cfg["CONSUMER_REGS"])
            assert info.get("HGMMA", 0) > 0 and info.get("UTMALDG", 0) > 0, \
                (name, info)
    return per


# MLA's (96, 64): minicpm3-4b's training microbatch, grouped heads (the
# bf16 partials summed at both widths), a softcap, a window across
# tiles, ragged S, S = 1; and the bf16 kernels' 128-key and 128-row
# items: the last item's second warpgroup wholly past S (S = 1,050), a
# window of 100 that ends inside the second warpgroup's keys, more
# pairs of items than SMs under G 4 (the partials and their sum at both
# widths)
MLA_BWD_CASES = [   # label, B, S, H, KV, causal, window, cap
    ("mla train H40", MLA_TRAIN_MICRO_B, TRAIN_S, MLA_H, MLA_H, True,
     0, 0.0),
    ("mla G4 H8 KV2", 1, 512, 8, 2, True, 0, 0.0),
    ("mla softcap 30", 1, 512, 8, 8, True, 0, 30.0),
    ("mla window 100 across tiles", 1, 700, 8, 8, True, 100, 0.0),
    ("mla ragged S=1000", 1, 1000, 8, 8, True, 0, 0.0),
    ("mla S=1", 2, 1, 8, 8, True, 0, 0.0),
    ("mla S=1050 second warpgroup past S", 1, 1050, 8, 8, True, 0, 0.0),
    ("mla window 100 ending in the second warpgroup", 1, 1000, 8, 8,
     True, 100, 0.0),
    ("mla G4 B2 S2048 H40 KV10", 2, 2048, MLA_H, 10, True, 0, 0.0)]


def train_kernel_phase(build):
    """The flash backward on the card: ``bwd_build`` (registers, shared
    memory, spills, HGMMA and UTMALDG per instantiation), every case of
    ``check_flash_bwd`` in bfloat16 and float32 (gemma3-1b's training
    microbatch, global and window 512, jamba's attention layer at its
    microbatch, and the edge cases: softcap, G
    1/2/4/8, non-causal, ragged S, S = 1, hd 64 and 128, a window across
    tiles), then CUDA-event times at the training shape with their bounds
    and SDPA's backward, and the kernels a profiled call runs."""
    t0 = time.perf_counter()
    per = bwd_build(build)
    B, S = TRAIN_MICRO_B, TRAIN_S
    cases = [   # label, B, S, H, KV, hd, causal, window, cap
        ("train global", B, S, 4, 1, 256, True, 0, 0.0),
        ("train local window 512", B, S, 4, 1, 256, True, 512, 0.0),
        ("softcap 50 G2", 2, 512, 8, 4, 256, True, 0, 50.0),
        ("non-causal G1 hd 128", 1, 384, 4, 4, 128, False, 0, 0.0),
        ("ragged S=1000 window 100 G4", 1, 1000, 4, 1, 256, True, 100, 0.0),
        ("G8 hd 64 window 17 across tiles", 1, 300, 16, 2, 64, True, 17,
         0.0),
        ("S=1", 2, 1, 4, 1, 256, True, 0, 0.0),
        ("S=129 hd 128 softcap 30", 2, 129, 4, 1, 128, True, 0, 30.0),
        ("non-causal window 16 hd 64", 1, 77, 2, 2, 64, False, 16, 0.0),
        # jamba's attention layer at its training microbatch
        ("jamba train H64 KV8 hd 128", 1, TRAIN_S, JAMBA_H, JAMBA_KV,
         JAMBA_HD, True, 0, 0.0)]
    rel, worst = {}, {}

    def run(label, args, dt, seed, key, hdv=None):
        r = check_flash_bwd(label, *args, dt, seed, hdv=hdv)
        rel[f"{label} {dt}"] = r
        worst[key] = max([worst.get(key, 0.0)] + [
            r[n]["max_abs_err"] for n in ("dq", "dk", "dv")])
        if "sum_max_abs_err" in r:     # the bf16 dkdv sum's cases
            worst["sum"] = max(worst.get("sum", 0.0), r["sum_max_abs_err"])
        _free_card()
    for i, c in enumerate(cases):
        for dt in ("bfloat16", "float32"):
            run(c[0], c[1:], dt, 50 + i, dt)
    for i, (label, b, s_, h, kv, causal, window, cap) in enumerate(
            MLA_BWD_CASES):
        for dt in ("bfloat16", "float32"):
            run(label, (b, s_, h, kv, MLA_HDQK, causal, window, cap), dt,
                70 + i, f"mla {dt}", hdv=MLA_HDV)
            if "sum_max_abs_err" in rel[f"{label} {dt}"]:
                worst["mla sum"] = max(worst.get("mla sum", 0.0), rel[
                    f"{label} {dt}"]["sum_max_abs_err"])
    times = {}
    for name, window in (("global", 0), ("local", 512)):
        for dt in ("bfloat16", "float32"):
            times[f"{name} {dt}"] = flash_bwd_times(9, B, S, 4, 1, 256,
                                                    window, dt)
            _free_card()
    # MLA's training microbatch: bf16, the main path's type (its trace must
    # name flash_bwd_dkdv_mla and flash_bwd_dq_mla), and float32
    for dt in ("bfloat16", "float32"):
        times[f"mla {dt}"] = flash_bwd_times(
            11, MLA_TRAIN_MICRO_B, TRAIN_S, MLA_H, MLA_H, MLA_HDQK, 0, dt,
            hdv=MLA_HDV, trace=dt == "bfloat16")
        _free_card()
    times["mla_ptxas"] = {n: i for n, i in per.items() if "mla" in n}
    emit("train_kernel", t0, ptxas=per, cases=rel, max_abs_err=worst,
         tolerances={"float32": FLASH_BWD_F32_REL,
                     "bfloat16": FLASH_BWD_BF16_REL}, times=times)
    return worst, times


def _train_flops(cfg, B, S):
    """Model FLOPs of one step (3 forward passes' worth: forward and
    backward), not counting remat's recompute: the products of the layers
    and the head (6 N per token, N the active parameters) and the
    attention layers' scores and values over the kept pairs (the WKV6 and
    scan recurrences, under 1% of a step's FLOPs, are not counted); and
    with remat="full" the recompute (the layers' and attention's forward
    once more)."""
    counts = cfg.param_counts()
    embed = cfg.padded_vocab_size * cfg.d_model
    dense = 6.0 * (counts["active"] - embed) * B * S
    head = 6.0 * cfg.d_model * cfg.padded_vocab_size * B * S
    # 2 (q.k head + v head) a kept pair and head in the forward: MLA's
    # q/k heads are nope + rope and its v heads its own (minicpm3-4b: 96
    # and 64), the other families' both resolved_head_dim
    H = cfg.n_heads
    if cfg.use_mla:
        hd_qk, hd_v = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    else:
        hd_qk = hd_v = cfg.resolved_head_dim
    attn = sum(3.0 * 2 * (hd_qk + hd_v) * H * B * kept_pairs(
        S, True, cfg.window_size if cfg.layer_kind(i) == "attn_local" else 0)
        for i in range(cfg.n_layers)
        if cfg.layer_kind(i) in ("attn", "attn_local"))
    model = dense + head + attn
    return model, model + (dense + attn) / 3.0


def train_phase():
    """gemma3-1b at full width and depth through
    ``repro_torch.launch.train.run``: 4 steps of batch 8 x 4096 (remat
    full, AdamW, 4 microbatches), the weights drawn on the card.  The
    counts are set to 0 just before the run and read just after it; the
    first step is the warm-up, outside the runtime log's median.  The
    runtime-log line goes into ``launch.autoconfig`` beside simulated H100
    records, and the analytic model's step time for the same job stands
    beside the measured one."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.datastore import RuntimeDataStore
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import autoconfig as AC
    from repro_torch.launch import train
    t0 = time.perf_counter()
    cfg = get_config("gemma3-1b")
    assert (cfg.remat, cfg.optimizer, cfg.grad_accum) == ("full", "adamw", 4)
    hist = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        log = os.path.join(tmp, "runtime.jsonl")
        _free_card()
        torch.cuda.reset_peak_memory_stats()
        FA.LAUNCHES = FA.DELTA_LAUNCHES = FA.DKDV_LAUNCHES = 0
        FA.DKDV_SUM_LAUNCHES = FA.DQ_LAUNCHES = 0
        t1 = time.perf_counter()
        losses = train.run("gemma3-1b", TRAIN_STEPS, TRAIN_B, TRAIN_S,
                           smoke=False, device=LM_DEVICE, runtime_log=log,
                           history=hist)
        sync()
        wall = time.perf_counter() - t1
        launches = {"flash_attention": FA.LAUNCHES,
                    "flash_bwd_delta": FA.DELTA_LAUNCHES,
                    "flash_bwd_dkdv": FA.DKDV_LAUNCHES,
                    "flash_bwd_dkdv_sum": FA.DKDV_SUM_LAUNCHES,
                    "flash_bwd_dq": FA.DQ_LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        with open(log) as f:
            rec = json.loads(f.read().splitlines()[-1])
        measured = AC.records_from_runtime_log(log)
    step_s = rec["median_step_s"]
    model_flops, hw_flops = _train_flops(cfg, TRAIN_B, TRAIN_S)
    h100 = AC.GPU_FAMILIES["h100-sxm"]
    job = ShapeConfig("chip_smoke_train", TRAIN_S, TRAIN_B, "train")
    predicted = AC.predicted_step_time(cfg, job, h100, 1)
    assert list(measured.machine_type) == ["h100-sxm"]
    sim = AC.simulate_runtime_records("gemma3-1b", "train_4k",
                                      chip_counts=(1, 2, 4, 8))
    store = RuntimeDataStore(sim.concat(measured), device=LM_DEVICE)
    choice, pred = AC.autoconfigure("gemma3-1b", "train_4k", store=store,
                                    chip_counts=(1, 2, 4, 8),
                                    device=LM_DEVICE)
    emit("train", t0, arch="gemma3-1b", layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab_size, batch=TRAIN_B,
         seq=TRAIN_S, grad_accum=cfg.grad_accum, remat=cfg.remat,
         optimizer=cfg.optimizer, params=cfg.param_counts()["total"],
         losses=losses, history=hist, run_wall_s=wall,
         step_s=step_s, tokens_per_s=TRAIN_B * TRAIN_S / step_s,
         model_flops_per_step=model_flops,
         mfu=model_flops / step_s / BF16_OPS_PER_S,
         hfu_with_remat=hw_flops / step_s / BF16_OPS_PER_S,
         peak_device_bytes=peak, launches=launches,
         launches_per_step={n: c / TRAIN_STEPS for n, c in launches.items()},
         runtime_log_line=rec,
         autoconfig={"predicted_step_s_h100_row": predicted,
                     "measured_step_s": step_s,
                     "measured_over_predicted": step_s / predicted,
                     "measured_row": {"X": measured.X[0].tolist(),
                                      "y": float(measured.y[0])},
                     "store_rows": len(store.data.y),
                     "train_4k_choice": dataclasses.asdict(choice),
                     "selected_model": pred.selected})
    assert len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses))
    assert losses[-1] < losses[0], f"train: the loss did not fall: {losses}"
    # every layer's backward: its 4 query heads over 1 kv head take the
    # dkdv sum (G > 1)
    micro = TRAIN_STEPS * cfg.grad_accum * cfg.n_layers
    assert cfg.n_heads > cfg.n_kv_heads
    assert launches == {"flash_attention": 2 * micro,
                        "flash_bwd_delta": micro, "flash_bwd_dkdv": micro,
                        "flash_bwd_dkdv_sum": micro,
                        "flash_bwd_dq": micro}, launches
    assert rec["device"] == torch.cuda.get_device_name(0)
    assert "n_layers" not in rec and rec["final_loss"] == losses[-1]
    return launches


def _grad_rel(got, want):
    """Per-leaf ||got - want|| / ||want|| and the global one."""
    per = {n: _rel_err(got[n], want[n]) for n in want}
    num = sum(float((got[n].double() - want[n].double()).square().sum())
              for n in want)
    den = sum(float(want[n].double().square().sum()) for n in want)
    return per, math.sqrt(num / den)


def _step_on(model, batch):
    """Gradients, metrics and the parameters after one AdamW step, as
    float32 on the card (a model on the CPU: its readings moved to the
    card, where ``_compare_step`` reads them all)."""
    import torch
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import get_optimizer
    grads, metrics = TS.compute_grads(model, batch)
    opt = get_optimizer("adamw")
    params = TS.params_of(model)
    _, _, gnorm = opt.update(grads, opt.init(params), params)
    sync()
    return ({n: g.detach().to(LM_DEVICE, torch.float32)
             for n, g in grads.items()},
            {"loss": float(metrics["loss"]), "grad_norm": float(gnorm)},
            {n: p.detach().to(LM_DEVICE, torch.float32)
             for n, p in params.items()})


def _adamw_eps():
    import inspect
    from repro_torch.train import optimizer
    return inspect.signature(optimizer.adamw).parameters["eps"].default


def _compare_step(got, want):
    """Card against CPU after one step: the loss, the grad norm, every
    gradient leaf, and the parameters after the step where decided; those
    also split by the CPU's clipped gradient |g| against AdamW's eps
    (bins up to 10 eps, up to ADAMW_FAR_EPS eps, beyond), each bin's worst
    leaf and its element count."""
    (gg, gm, gp), (wg, wm, wp) = got, want
    per, glob = _grad_rel(gg, wg)
    worst = max(per, key=per.get)
    eps = _adamw_eps()
    clip = min(1.0, 1.0 / wm["grad_norm"])   # adamw's max_grad_norm 1.0
    bins = {"g<=10eps": (0.0, 10.0),
            f"10eps<g<={ADAMW_FAR_EPS:g}eps": (10.0, ADAMW_FAR_EPS),
            f"g>{ADAMW_FAR_EPS:g}eps": (ADAMW_FAR_EPS, math.inf)}
    by_g = {b: {"rel_max": 0.0, "leaf": None, "elements": 0} for b in bins}
    prel = {}
    for n in wp:
        decided = wg[n].abs() > 2 * (gg[n] - wg[n]).abs()
        prel[n] = _rel_err(gp[n][decided], wp[n][decided]) \
            if bool(decided.any()) else 0.0
        prel[n] = prel[n] if math.isfinite(prel[n]) else 0.0
        g_eps = (wg[n] * clip).abs() / eps
        for b, (lo, hi) in bins.items():
            sel = decided & (g_eps > lo) & (g_eps <= hi)
            if not bool(sel.any()):
                continue
            r = _rel_err(gp[n][sel], wp[n][sel])
            r = r if math.isfinite(r) else 0.0
            by_g[b]["elements"] += int(sel.sum())
            if r > by_g[b]["rel_max"]:
                by_g[b].update(rel_max=r, leaf=n)
    return {"loss_rel": abs(gm["loss"] - wm["loss"]) / abs(wm["loss"]),
            "grad_norm_rel": abs(gm["grad_norm"] - wm["grad_norm"])
            / wm["grad_norm"],
            "grad_rel_global": glob, "grad_rel_max": per[worst],
            "grad_rel_max_leaf": worst,
            "params_after_rel_max": max(prel.values()),
            "params_after_rel_by_g": by_g,
            "params_after_rel_far": by_g[f"g>{ADAMW_FAR_EPS:g}eps"]
            ["rel_max"],
            "params_undecided": int(sum(
                int((wg[n].abs() <= 2 * (gg[n] - wg[n]).abs()).sum())
                for n in wg)),
            "loss": gm["loss"], "loss_cpu": wm["loss"]}


def train_parity_phase():
    """One full-width period of gemma3-1b (6 layers), batch 2, sequence
    1024, one AdamW step from the same float32 weights drawn on the CPU:
    the card in float32 (SIMT forward and backward, TF32 off) and in
    bfloat16 (the weights rounded; the wgmma forward) against the CPU in
    float32 (plain versions, remat none), and a control (float32 on the
    card with the backward's delta set to 0).  Then crash-restart on the
    card at full width with 2 layers: a crash after step 2 of 4, the
    resumed run's final loss against the uninterrupted run's."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    t0 = time.perf_counter()
    cfg = get_config("gemma3-1b", n_layers=6, grad_accum=1)
    r, cpu_s = _parity_step_readings(cfg, PARITY_TRAIN_B, PARITY_TRAIN_S, 4)

    # crash-restart on the card: 2 layers, batch 4 x 512, 4 steps
    kw = dict(smoke=False, n_layers=2, device=LM_DEVICE)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ref = train.run("gemma3-1b", 4, 4, 512, **kw)
        ck = os.path.join(tmp, "ckpt")
        crashed = False
        try:
            train.run("gemma3-1b", 4, 4, 512, ckpt_dir=ck, ckpt_every=2,
                      crash_at_step=2, **kw)
        except SystemExit as e:
            crashed = "simulated crash" in str(e)
        assert crashed, "train_parity: the run did not crash at step 2"
        resumed = train.run("gemma3-1b", 4, 4, 512, ckpt_dir=ck,
                            ckpt_every=2, **kw)
    emit("train_parity", t0, layers=cfg.n_layers, batch=PARITY_TRAIN_B,
         seq=PARITY_TRAIN_S, cpu_step_s=cpu_s, readings=r,
         tolerances={"float32": TRAIN_F32_REL, "bfloat16": TRAIN_BF16_REL,
                     "float32_params_where_g_over_eps_above":
                     [ADAMW_FAR_EPS, TRAIN_F32_FAR_REL]},
         crash_restart={"layers": 2, "batch": 4, "seq": 512,
                        "losses": ref, "resumed_losses": resumed,
                        "bit_equal": resumed[-1] == ref[-1]})
    _assert_parity("train_parity", r)
    assert len(resumed) == 2, resumed
    assert abs(resumed[-1] - ref[-1]) <= 1e-4 * abs(ref[-1]), (ref, resumed)
    return r


def _parity_step_readings(cfg, B, S, seed):
    """One AdamW step of ``cfg`` (grad_accum 1) from the same float32
    weights drawn on the CPU (seed ``seed``), batch B x S: the card in
    float32 (SIMT forward and backward, TF32 off), in bfloat16 (the weights
    rounded; the wgmma kernels) and the control (float32 on the card with
    the flash backward's delta set to 0) against the CPU in float32 (plain
    versions, remat none), each ``_compare_step``'s readings; and the
    CPU step's seconds."""
    import dataclasses
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.modeling.model import Model, init_params
    from repro_torch.train.data import make_batch
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params = init_params(cfg32, seed, "cpu")
    batch = make_batch(cfg, B, S, 0, seed=seed)
    on_card = {n: t.to(LM_DEVICE) for n, t in batch.items()}

    def to(tree, dtype):
        return _map_tree(lambda t: t.to(LM_DEVICE, dtype, copy=True), tree)
    f32 = _step_on(Model(cfg32, to(params, torch.float32)).trainable(),
                   on_card)
    bf16 = _step_on(Model(cfg, to(params, torch.bfloat16)).trainable(),
                    on_card)
    real_delta = FA.flash_bwd_delta
    try:           # the control: the backward's delta set to 0
        FA.flash_bwd_delta = lambda o, do: torch.zeros(
            o.shape[0], o.shape[2], o.shape[1], dtype=torch.float32,
            device=o.device)
        control = _step_on(Model(cfg32, to(params, torch.float32))
                           .trainable(), on_card)
    finally:
        FA.flash_bwd_delta = real_delta
    _free_card()
    t1 = time.perf_counter()         # last: the step updates params in place
    cpu = _step_on(Model(dataclasses.replace(cfg32, remat="none"),
                         params).trainable(), batch)
    cpu_s = time.perf_counter() - t1
    del params
    return {"float32": _compare_step(f32, cpu), "bfloat16": _compare_step(
        bf16, cpu), "control_delta_0": _compare_step(control, cpu)}, cpu_s


def _assert_parity(name, r):
    """float32 within TRAIN_F32_REL (and TRAIN_F32_FAR_REL where |g| >>
    eps), bf16 within TRAIN_BF16_REL, and the control beyond it."""
    a = r["float32"]
    for key in ("loss_rel", "grad_norm_rel", "grad_rel_max",
                "params_after_rel_max"):
        assert a[key] <= TRAIN_F32_REL, f"{name} float32 {key}: {a}"
    assert a["params_after_rel_far"] <= TRAIN_F32_FAR_REL, \
        f"{name} float32 where |g| >> eps: {a['params_after_rel_by_g']}"
    b = r["bfloat16"]
    assert b["loss_rel"] <= TRAIN_BF16_REL and \
        b["grad_rel_max"] <= TRAIN_BF16_REL, f"{name} bfloat16: {b}"
    assert r["control_delta_0"]["grad_rel_max"] > TRAIN_BF16_REL, \
        f"{name}: the control passes: {r['control_delta_0']}"


def mla_train_phase():
    """minicpm3-4b at full width (d 2560, 40 heads, q_lora 768, kv_lora
    256, d_ff 6400, vocab 73,448) and the depth ``launch.train`` trains
    (``train_config``) through ``repro_torch.launch.train.run``: 4 steps of
    batch 8 x 4096 (remat full, AdamW, grad_accum 8), the weights drawn on
    the card.  The counts are set to 0 just before the run and read just
    after it: every microbatch and layer runs the flash forward's (96, 64)
    instance twice (remat) and delta, dkdv and dq once each, and no dkdv
    sum (40 heads over 40).  The first step is the warm-up, outside the
    runtime log's median."""
    import tempfile
    import torch
    from repro_torch.configs import CUT_KEYS, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import autoconfig as AC
    from repro_torch.launch import train
    t0 = time.perf_counter()
    cfg = train.train_config(MLA_ARCH)
    assert (cfg.remat, cfg.optimizer, cfg.grad_accum) == ("full", "adamw", 8)
    hist = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        log = os.path.join(tmp, "runtime.jsonl")
        _free_card()
        torch.cuda.reset_peak_memory_stats()
        FA.LAUNCHES = FA.DELTA_LAUNCHES = FA.DKDV_LAUNCHES = 0
        FA.DKDV_SUM_LAUNCHES = FA.DQ_LAUNCHES = 0
        t1 = time.perf_counter()
        losses = train.run(MLA_ARCH, MLA_TRAIN_STEPS, TRAIN_B, TRAIN_S,
                           smoke=False, device=LM_DEVICE, runtime_log=log,
                           history=hist)
        sync()
        wall = time.perf_counter() - t1
        launches = {"flash_attention": FA.LAUNCHES,
                    "flash_bwd_delta": FA.DELTA_LAUNCHES,
                    "flash_bwd_dkdv": FA.DKDV_LAUNCHES,
                    "flash_bwd_dkdv_sum": FA.DKDV_SUM_LAUNCHES,
                    "flash_bwd_dq": FA.DQ_LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        with open(log) as f:
            rec = json.loads(f.read().splitlines()[-1])
    _free_card()
    step_s = rec["median_step_s"]
    model_flops, hw_flops = _train_flops(cfg, TRAIN_B, TRAIN_S)
    job = ShapeConfig("chip_smoke_train", TRAIN_S, TRAIN_B, "train")
    predicted = AC.predicted_step_time(cfg, job, AC.GPU_FAMILIES["h100-sxm"],
                                       1)
    emit("mla_train", t0, arch=MLA_ARCH, layers=cfg.n_layers,
         d_model=cfg.d_model, heads=cfg.n_heads, q_lora=cfg.q_lora_rank,
         kv_lora=cfg.kv_lora_rank, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         batch=TRAIN_B, seq=TRAIN_S, grad_accum=cfg.grad_accum,
         remat=cfg.remat, optimizer=cfg.optimizer,
         params=cfg.param_counts()["total"], losses=losses, history=hist,
         run_wall_s=wall, step_s=step_s,
         tokens_per_s=TRAIN_B * TRAIN_S / step_s,
         model_flops_per_step=model_flops,
         mfu=model_flops / step_s / BF16_OPS_PER_S,
         hfu_with_remat=hw_flops / step_s / BF16_OPS_PER_S,
         peak_device_bytes=peak, launches=launches,
         launches_per_step={n: c / MLA_TRAIN_STEPS
                            for n, c in launches.items()},
         runtime_log_line=rec,
         analytic={"predicted_step_s_h100_row": predicted,
                   "measured_step_s": step_s,
                   "measured_over_predicted": step_s / predicted})
    assert len(losses) == MLA_TRAIN_STEPS and all(map(math.isfinite, losses))
    assert losses[-1] < losses[0], f"mla_train: the loss did not fall: {losses}"
    micro = MLA_TRAIN_STEPS * cfg.grad_accum * cfg.n_layers
    assert cfg.n_heads == MLA_H and cfg.use_mla
    assert launches == {"flash_attention": 2 * micro,
                        "flash_bwd_delta": micro, "flash_bwd_dkdv": micro,
                        "flash_bwd_dkdv_sum": 0,
                        "flash_bwd_dq": micro}, launches
    assert rec["device"] == torch.cuda.get_device_name(0)
    assert rec["final_loss"] == losses[-1]
    # the runtime-log record names a depth cut where train_config made one
    assert {k: rec[k] for k in CUT_KEYS if k in rec} == (
        {"n_layers": cfg.n_layers}
        if cfg.n_layers != get_config(MLA_ARCH).n_layers else {}), rec
    return launches


def mla_train_parity_phase():
    """minicpm3-4b at full width cut to 4 layers, batch 2, sequence 512,
    one AdamW step from the same float32 weights drawn on the CPU: the card
    in float32 (the SIMT (96, 64) instances) and in bfloat16 (the wgmma
    ones) against the CPU in float32, and the delta-0 control, held to
    train_parity's limits."""
    from repro_torch.launch.train import train_config
    t0 = time.perf_counter()
    cfg = train_config(MLA_ARCH, n_layers=MLA_PARITY_TRAIN_LAYERS,
                       grad_accum=1)
    r, cpu_s = _parity_step_readings(cfg, MLA_PARITY_TRAIN_B,
                                     MLA_PARITY_TRAIN_S, 5)
    emit("mla_train_parity", t0, arch=MLA_ARCH, layers=cfg.n_layers,
         d_model=cfg.d_model, params=cfg.param_counts()["total"],
         batch=MLA_PARITY_TRAIN_B, seq=MLA_PARITY_TRAIN_S, cpu_step_s=cpu_s,
         readings=r,
         tolerances={"float32": TRAIN_F32_REL, "bfloat16": TRAIN_BF16_REL,
                     "float32_params_where_g_over_eps_above":
                     [ADAMW_FAR_EPS, TRAIN_F32_FAR_REL]})
    _assert_parity("mla_train_parity", r)
    _free_card()
    return r



# rwkv6-3b's and jamba's training microbatch: batch 8 over grad_accum 8
SSM_TRAIN_B, SSM_TRAIN_S, SSM_TRAIN_STEPS, SSM_MICRO_B = 8, 4096, 4, 1
# wkv6_bwd against wkv6_bwd_plain and autograd of wkv6_plain: float32 on
# both sides (the kernel's products are float32 FMAs, its exponentials
# MUFU's, ~1e-6 relative), sums in another order; ||got - want|| /
# ||want|| per output.  dw is d(log w) / w: the 1 / w of a decay near the
# clamp (1.2e-4) scales a float32 difference of d(log w) by up to 8,100,
# so w dw is held to WKV_BWD_REL and dw itself to WKV_BWD_DW_REL.  The
# control (the u diagonal's gradient dropped from dr, dk and du) must
# exceed the bound
WKV_BWD_REL, WKV_BWD_DW_REL = 1e-4, 1e-3
# mamba_scan_bwd against mamba_scan_bwd_plain and autograd of
# mamba_scan_plain: float32, the kernel's exponentials ex2.approx (~1e-6
# relative), sums over 16,384 channels and 4,096 steps in another order;
# the control (the checkpoints zeroed: every recomputed state wrong) must
# exceed it
SCAN_BWD_REL = 1e-4
# ssm_train_parity: rwkv6 at rwkv_parity's cut (4 layers at full width)
# and jamba at jamba_parity's (4 layers, d_ff and moe_d_ff 2,048), batch
# 1, sequence 128, one float32 AdamW step on the card against the CPU,
# held to TRAIN_F32_REL and TRAIN_F32_FAR_REL as train_parity
SSM_PARITY_B, SSM_PARITY_S = 1, 128


def wkv6_bwd_bound_ms(B, S, H, hd, ds_end=False, segments=1):
    """(least time for one wkv6_bwd call, what bounds it, the bytes the
    design moves beyond the function's own): the function reads r, k, v,
    w, dy, u and s0 (and ds_end where given) once and writes dr, dk, dv,
    dw, du and ds0 once, float32, at the HBM rate; against its float32
    operations per (b, h, chunk of 16), two a multiply-add: the strictly
    lower scores and their gradient, the two diagonals, dv (sc^T dy, diag
    dy, kd dS), da, db, drq, dkd, ddecay and the dS update, at the 67
    TFLOP/s float32 peak.  The design's own bytes, outside the bound: the
    forward's chunk states it reads instead of recomputing them; with
    ``segments`` > 1 the fold's second read of r, w and dy over the
    segments after the first, its (D, L) pairs written and read by the
    carry scan, the carried dS written and read by the walk; du's per-(b,
    segment) partials written and read."""
    low = 16 * 15 // 2
    n_chunks = S // 16
    n = B * H * n_chunks
    nbytes = 4 * (9 * B * S * H * hd + 2 * H * hd
                  + (3 if ds_end else 2) * B * H * hd * hd)
    folded = n_chunks - n_chunks // segments      # chunks after segment 0
    pairs = B * H * (segments - 1) * (hd * hd + hd)
    design_bytes = 4 * (n * hd * hd + 3 * B * H * folded * 16 * hd
                        + 2 * pairs + 2 * B * H * segments * hd * hd
                        + 2 * B * segments * H * hd)
    macs = (5 * low * hd + 2 * 16 * hd + 16 * hd + 4 * 16 * hd * hd
            + 2 * hd * hd) * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * macs / FP32_OPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")) + (design_bytes,)


def scan_bwd_bound_ms(B, S, D, N, dh_end=False):
    """(least time for one mamba_scan_bwd call, what bounds it, the bytes
    the design moves beyond the function's own): the function reads u,
    dt, dy, A, B_in, C_in and h0 (and dh_end where given) once and writes
    du, d(dt), dA, dB, dC and dh0 once, float32, at the HBM rate; against
    its operations: one exponential per (b, t, d, n) (the state's decay,
    which both h_{t-1} and the reverse step need) and some 20 float32
    operations there (the state, g, its four products and sums), split as
    ``scan_bound_ms`` splits them between the special-function units and
    float32 polynomials.  The design's own bytes, outside the bound: the
    forward's tile checkpoints it reads, the per-block partials of dB and
    dC (one block per ``block_channels(N)`` channels) and the per-b
    partials of dA, each written and read."""
    import torch
    from repro_torch.kernels import mamba_scan as MS
    n_blk = -(-D // MS.block_channels(N))
    nbytes = 4 * (5 * B * S * D + 4 * B * S * N + 2 * D * N
                  + (3 if dh_end else 2) * B * D * N)
    design_bytes = 4 * (B * -(-S // 64) * D * N + 2 * 2 * n_blk * B * S * N
                        + 2 * B * D * N)
    flops = 20 * B * S * D * N
    n_exp = B * S * D * N
    mhz = max_sm_clock_mhz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_fp32 = flops / FP32_OPS_PER_S * 1e3
    t_sfu = n_exp / (sms * SFU_PER_SM_CLOCK * mhz * 1e6) * 1e3
    t_emul = 2 * EXP_EMULATION_FMAS * n_exp / FP32_OPS_PER_S * 1e3
    f = min(max((t_sfu - t_fp32) / (t_emul + t_sfu), 0.0), 1.0)
    t_ops = max(t_fp32 + f * t_emul, (1 - f) * t_sfu)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")) + (design_bytes,)


def wkv6_bwd_launch_times(ins, states):
    """wkv6_bwd's launches at the inputs' shape, each on its own (fold,
    carry scan, walk, du's sum: ``wkv6._bwd_launch`` with one bit of
    ``parts``) by CUDA events over calls queued behind a sleeping kernel
    (``queued_ms``: the host enqueues a call slower than the card runs
    the small ones); the segments, each launch's blocks, blocks resident
    an SM (the CUDA runtime's occupancy) and waves over the card's SMs."""
    from repro_torch.kernels import wkv6 as WK
    r = ins[0]
    B, S, H, hd = r.shape
    args = (*ins[:5], states, ins[6], ins[7])
    plan = WK.bwd_plan(B, S, H, hd, r.device)
    ms = {name: queued_ms(lambda m=m: WK._bwd_launch(*args, parts=m), 10)
          for name, m in (("fold", 1), ("carry", 2), ("walk", 4),
                          ("du_sum", 8))}
    res = dict(plan["resident"], du_sum=None)
    return {"segments": plan["segments"], "launch_ms": ms,
            "sum_of_launches_ms": sum(ms.values()),
            "blocks": plan["blocks"], "resident_per_sm": res,
            "waves": {n: (-(-b // (plan["sms"] * res[n])) if res[n] else None)
                      for n, b in plan["blocks"].items()}}


def scan_bwd_launch_times(ins, chk):
    """mamba_scan_bwd's reverse walk and its fixed-order sums, each on its
    own (``mamba_scan._bwd_launch`` with one bit of ``parts``) by
    ``queued_ms``; the walk's blocks, blocks resident an SM and waves."""
    import torch
    from repro_torch.kernels import mamba_scan as MS
    u, A = ins[0], ins[2]
    B, S, D = u.shape
    N = A.shape[1]
    args = (*ins[:5], chk, ins[6], ins[7])
    ms = {name: queued_ms(lambda m=m: MS._bwd_launch(*args, parts=m), 10)
          for name, m in (("walk", 1), ("sums", 2))}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-D // MS.block_channels(N)) * B
    res = MS.bwd_resident(N)
    return {"launch_ms": ms, "sum_of_launches_ms": sum(ms.values()),
            "block_channels": MS.block_channels(N), "blocks": blocks,
            "resident_per_sm": res, "waves": -(-blocks // (sms * res))}


def _check_ssm_bwd(label, got, again, wants, names, limits):
    """Per output ||got - want|| / ||want|| against each reference; every
    output finite and repeated bit for bit.  ``limits``: name -> bound
    (a name "w*dw" holds got * w); returns the readings."""
    import torch
    r = {}
    for i, n in enumerate(names):
        g = got[i]
        assert bool(g.isfinite().all()), f"{label}: {n} not finite"
        assert torch.equal(g, again[i]), f"{label}: {n} does not repeat"
    for ref, want in wants.items():
        for n, (g_fn, w_fn, lim) in limits.items():
            rel = _rel_err(g_fn(got), w_fn(want))
            r[f"{n} vs {ref}"] = rel
            assert rel <= lim, f"{label}: {n} vs {ref} {rel} beyond {lim}"
    return r


def _wkv_bwd_inputs(seed, B, S, H, hd, s0, ds_end, clamp=False):
    """``_wkv_inputs`` plus dy (and ds_end) ~ N(0, 0.5^2); s0 zeros where
    not given (the model's training path); with ``clamp``, log w down to
    -12 and ties exp(-9) planted at one token's first dims."""
    import torch
    r, k, v, w, u, st = _wkv_inputs(seed, B, S, H, hd, s0,
                                    -12.0 if clamp else None)
    if clamp:
        w[0, 3, 0, :4] = float(np.float32(np.exp(-9.0)))
    if st is None:
        st = torch.zeros(B, H, hd, hd, device=LM_DEVICE)
    g = torch.Generator(device=LM_DEVICE).manual_seed(seed + 1)
    dy = 0.5 * torch.randn(B, S, H, hd, generator=g, device=LM_DEVICE)
    dse = (0.5 * torch.randn(B, H, hd, hd, generator=g, device=LM_DEVICE)
           if ds_end else None)
    return r, k, v, w, u, st, dy, dse


def check_wkv6_bwd(label, B, S, H, hd, s0, ds_end, clamp, seed,
                   autograd=True):
    """wkv6_bwd on the card against wkv6_bwd_plain on the same inputs and
    against autograd of wkv6_plain (through ``WKV6``'s forward too: the
    kernel's gradient by ``torch.autograd.grad`` of ``wkv6``), repeated bit
    for bit; the control drops the u diagonal's gradient."""
    import torch
    from repro_torch.kernels import wkv6 as WK
    ins = _wkv_bwd_inputs(seed, B, S, H, hd, s0, ds_end, clamp)
    r, k, v, w, u, st, dy, dse = ins
    states = WK.wkv6_with_states(*ins[:6])[2]
    got = WK.wkv6_bwd(*ins, states=states)
    again = WK.wkv6_bwd(*ins, states=states)
    del states
    sync()
    wants = {"plain": WK.wkv6_bwd_plain(*ins)}
    names = ("dr", "dk", "dv", "dw", "du", "ds0")
    if autograd:
        leaves = [t.detach().requires_grad_() for t in (r, k, v, w, u, st)]
        y, s_end = WK.wkv6_plain(*leaves)
        outs, grads_in = [y], [dy]
        if dse is not None:
            outs.append(s_end)
            grads_in.append(dse)
        wants["autograd"] = torch.autograd.grad(outs, leaves, grads_in)
        # the Function's own route: the forward kernel's states, then
        # the backward kernel
        leaves = [t.detach().requires_grad_() for t in (r, k, v, w, u, st)]
        y, s_end = WK.wkv6(*leaves)
        outs = [y] + ([s_end] if dse is not None else [])
        via = torch.autograd.grad(outs, leaves, grads_in)
        for n, a, b in zip(names, via, got):
            assert torch.equal(a, b), f"wkv6 bwd {label}: WKV6's {n}"
    lim = {n: ((lambda g, i=i: g[i]), (lambda x, i=i: x[i]), WKV_BWD_REL)
           for i, n in enumerate(names) if n != "dw"}
    lim["w*dw"] = (lambda g: g[3] * w, lambda x: x[3] * w, WKV_BWD_REL)
    lim["dw"] = (lambda g: g[3], lambda x: x[3], WKV_BWD_DW_REL)
    out = _check_ssm_bwd(f"wkv6 bwd {label}", got, again, wants, names, lim)
    # the control: the u diagonal's gradient dropped
    ddiag = (dy * v).sum(-1, keepdim=True)
    ctl = (got[0] - ddiag * u * k, got[1] - ddiag * u * r)
    want = wants["plain"]
    out["control_no_u_diagonal"] = min(_rel_err(ctl[0], want[0]),
                                       _rel_err(ctl[1], want[1]),
                                       _rel_err(torch.zeros_like(got[4]),
                                                want[4]))
    assert out["control_no_u_diagonal"] > WKV_BWD_REL, \
        f"wkv6 bwd {label}: the control passes: {out}"
    out["max_abs_err"] = max(float((a - b).abs().max())
                             for a, b in zip(got, want))
    return out


def check_scan_bwd(label, B, S, D, N, h0, dh_end, dt_max, seed,
                   autograd=True):
    """mamba_scan_bwd on the card against mamba_scan_bwd_plain on the
    same inputs and against autograd of mamba_scan_plain (and through
    ``MambaScan``), repeated bit for bit; the control zeroes the forward's
    checkpoints."""
    import torch
    from repro_torch.kernels import mamba_scan as MS
    u, dt, A, Bi, Ci, h = _scan_inputs(seed, B, S, D, N, h0, dt_max)
    if h is None:
        h = torch.zeros(B, D, N, device=LM_DEVICE)   # the model's path
    g = torch.Generator(device=LM_DEVICE).manual_seed(seed + 1)
    dy = 0.5 * torch.randn(B, S, D, generator=g, device=LM_DEVICE)
    dhe = (0.5 * torch.randn(B, D, N, generator=g, device=LM_DEVICE)
           if dh_end else None)
    ins = (u, dt, A, Bi, Ci, h, dy, dhe)
    chk = MS.mamba_scan_with_checkpoints(*ins[:6])[2]
    got = MS.mamba_scan_bwd(*ins, checkpoints=chk)
    again = MS.mamba_scan_bwd(*ins, checkpoints=chk)
    sync()
    names = ("du", "ddt", "dA", "dB", "dC", "dh0")
    wants = {"plain": MS.mamba_scan_bwd_plain(*ins)}
    if autograd:
        leaves = [t.detach().requires_grad_() for t in ins[:6]]
        y, h_end = MS.mamba_scan_plain(*leaves)
        outs = [y] + ([h_end] if dhe is not None else [])
        grads_in = [dy] + ([dhe] if dhe is not None else [])
        wants["autograd"] = torch.autograd.grad(outs, leaves, grads_in)
        leaves = [t.detach().requires_grad_() for t in ins[:6]]
        y, h_end = MS.mamba_scan(*leaves)
        outs = [y] + ([h_end] if dhe is not None else [])
        via = torch.autograd.grad(outs, leaves, grads_in)
        for n, a, b in zip(names, via, got):
            assert torch.equal(a, b), f"scan bwd {label}: MambaScan's {n}"
    lim = {n: ((lambda x, i=i: x[i]), (lambda x, i=i: x[i]), SCAN_BWD_REL)
           for i, n in enumerate(names)}
    out = _check_ssm_bwd(f"scan bwd {label}", got, again, wants, names, lim)
    ctl = MS.mamba_scan_bwd(*ins, checkpoints=torch.zeros_like(chk))
    want = wants["plain"]
    out["control_zero_checkpoints"] = max(_rel_err(a, b)
                                          for a, b in zip(ctl, want))
    assert out["control_zero_checkpoints"] > SCAN_BWD_REL, \
        f"scan bwd {label}: the control passes: {out}"
    out["max_abs_err"] = max(float((a - b).abs().max())
                             for a, b in zip(got, want))
    return out


def ssm_train_kernel_phase():
    """wkv6_bwd and mamba_scan_bwd on the card: each against its plain
    version and autograd of the plain forward at the training microbatch
    (B 1, S 4096; rwkv6-3b's 40 heads of 64, jamba's 16,384 channels of
    16 states), the serving shapes (B 8, S 2048), a given s0 / h0 and
    ds_end / dh_end, decays on all sides of the clamp, exp(dt A) that
    underflows, hd 16 and 32, N 4 and 8 with ragged S and D, chunks that
    wkv6_bwd's segments do not divide and one segment, D not a multiple of
    the scan's block channels at N 4, 8 and 16 (D % 4 != 0 too); every
    call repeated bit for bit, with a control that must exceed the bound.
    Then CUDA-event times at the training shape beside the plain
    version's and the bounds, each launch's time, blocks and waves, and
    ptxas's registers and spills for every instance of the two kernels."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import wkv6 as WK
    t0 = time.perf_counter()
    ptxas = {}
    for name in ("wkv6_bwd", "mamba_scan_bwd"):
        ptxas.update(ptxas_by_instance(build.BUILD_INFO[name]["log"],
                                       _instance))
    B, S = SSM_MICRO_B, SSM_TRAIN_S
    wkv_cases = [   # label, B, S, H, hd, s0, ds_end, clamp, autograd
        ("train", B, S, RWKV_H, RWKV_HD, False, False, False, True),
        ("serve B8 S2048", SERVE_B, SERVE_PROMPT, RWKV_H, RWKV_HD, True,
         False, False, False),
        ("s0 and ds_end given", 2, 256, 4, 64, True, True, False, True),
        ("clamp binds, ties at -9", 2, 128, 4, 64, True, True, True, True),
        ("hd 32", 1, 64, 3, 32, True, True, True, True),
        ("hd 16", 2, 48, 2, 16, False, True, True, True),
        ("63 chunks, B 2", 2, 1008, 8, 64, True, True, False, True),
        ("one segment", 1, 16, 3, 64, True, True, True, True)]
    scan_cases = [  # label, B, S, D, N, h0, dh_end, dt_max, autograd
        ("train", B, S, JAMBA_D, JAMBA_N, False, False, None, True),
        ("serve B8 S2048", SERVE_B, SERVE_PROMPT, JAMBA_D, JAMBA_N, True,
         False, None, False),
        ("h0 and dh_end given", 2, 256, 2048, 16, True, True, None, True),
        ("exp(dt A) underflows", 1, 128, 512, 8, True, True, 250.0, True),
        ("N 4, ragged S and D", 1, 100, 200, 4, True, True, None, True),
        ("N 8, D 300 of 256 a block, ragged S", 2, 200, 300, 8, True, True,
         None, True),
        ("N 16, D 129 (D % 4 != 0), ragged S", 1, 130, 129, 16, True, False,
         None, True)]
    wkv, scan = {}, {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for i, c in enumerate(wkv_cases):
        wkv[c[0]] = check_wkv6_bwd(*c[:8], 70 + i, autograd=c[8])
        wkv[c[0]]["segments"] = WK.bwd_segments(
            c[1], c[2], c[3], sms, per_sm=WK.bwd_resident(c[4])[2])
        _free_card()
    ragged = wkv["63 chunks, B 2"]["segments"]
    assert 1 < ragged and 63 % ragged, wkv      # the segments do not divide
    assert wkv["one segment"]["segments"] == 1, wkv
    for i, c in enumerate(scan_cases):
        scan[c[0]] = check_scan_bwd(*c[:8], 80 + i, autograd=c[8])
        _free_card()

    ins = _wkv_bwd_inputs(9, B, S, RWKV_H, RWKV_HD, False, False)
    states = WK.wkv6_with_states(*ins[:6])[2]
    launches = wkv6_bwd_launch_times(ins, states)
    bnd, by, design = wkv6_bwd_bound_ms(B, S, RWKV_H, RWKV_HD,
                                        segments=launches["segments"])
    wkv_t = {"ms": cuda_ms(lambda: WK.wkv6_bwd(*ins, states=states), 10),
             "launches": launches,
             "plain_ms": cuda_ms(lambda: WK.wkv6_bwd_plain(*ins), 2, warm=1),
             "forward_ms": cuda_ms(lambda: WK.wkv6(*ins[:6]), 10),
             "forward_with_states_ms": cuda_ms(
                 lambda: WK.wkv6_with_states(*ins[:6]), 10),
             "bound_ms": bnd, "bound_by": by, "design_bytes": design,
             "ms_from": "cuda events",
             "shape": f"B={B} S={S} H={RWKV_H} hd={RWKV_HD} float32"}
    del ins, states
    _free_card()
    u, dt, A, Bi, Ci, _ = _scan_inputs(9, B, S, JAMBA_D, JAMBA_N, False)
    h0 = torch.zeros(B, JAMBA_D, JAMBA_N, device=LM_DEVICE)
    dy = 0.5 * torch.randn_like(u)
    ins = (u, dt, A, Bi, Ci, h0, dy, None)
    chk = MS.mamba_scan_with_checkpoints(*ins[:6])[2]
    bnd, by, design = scan_bwd_bound_ms(B, S, JAMBA_D, JAMBA_N)
    scan_t = {"ms": cuda_ms(lambda: MS.mamba_scan_bwd(*ins, checkpoints=chk),
                            10),
              "launches": scan_bwd_launch_times(ins, chk),
              "plain_ms": cuda_ms(lambda: MS.mamba_scan_bwd_plain(*ins), 1,
                                  warm=1),
              "forward_ms": cuda_ms(lambda: MS.mamba_scan(*ins[:6]), 10),
              "forward_with_checkpoints_ms": cuda_ms(
                  lambda: MS.mamba_scan_with_checkpoints(*ins[:6]), 10),
              "bound_ms": bnd, "bound_by": by, "design_bytes": design,
              "ms_from": "cuda events",
              "shape": f"B={B} S={S} D={JAMBA_D} N={JAMBA_N} float32"}
    del ins, chk
    _free_card()
    emit("ssm_train_kernel", t0, wkv6_bwd=wkv, mamba_scan_bwd=scan,
         ptxas=ptxas,
         tolerances={"wkv6_bwd": WKV_BWD_REL, "wkv6_bwd_dw": WKV_BWD_DW_REL,
                     "mamba_scan_bwd": SCAN_BWD_REL},
         times={"wkv6_bwd": wkv_t, "mamba_scan_bwd": scan_t})
    err = {"wkv6_bwd": max(r["max_abs_err"] for r in wkv.values()),
           "mamba_scan_bwd": max(r["max_abs_err"] for r in scan.values())}
    return err, {"wkv6_bwd": wkv_t, "mamba_scan_bwd": scan_t}


def ssm_train_phase(arch):
    """rwkv6-3b whole, or jamba-1.5-large at ``launch.train``'s cut (4
    layers, d_ff and moe_d_ff 2,048), through
    ``repro_torch.launch.train.run``: 4 steps of batch 8 x 4096 (remat
    full, grad_accum 8, the config's optimizer and accumulation type),
    the weights drawn on the card.  The counts are set to 0 just before
    the run and read just after it; the first step is the warm-up, outside
    the runtime log's median.  Prints the median step, tokens/s, MFU, peak
    memory, launches a step and the analytic model's step time."""
    import tempfile
    import torch
    from repro_torch.configs import CUT_KEYS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import wkv6 as WK
    from repro_torch.launch import autoconfig as AC
    from repro_torch.launch import train
    t0 = time.perf_counter()
    cfg = train.train_config(arch)
    hist = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        log = os.path.join(tmp, "runtime.jsonl")
        _free_card()
        torch.cuda.reset_peak_memory_stats()
        WK.LAUNCHES = WK.LAUNCHES_BWD = MS.LAUNCHES = MS.LAUNCHES_BWD = 0
        FA.LAUNCHES = FA.DELTA_LAUNCHES = FA.DKDV_LAUNCHES = 0
        FA.DKDV_SUM_LAUNCHES = FA.DQ_LAUNCHES = 0
        t1 = time.perf_counter()
        losses = train.run(arch, SSM_TRAIN_STEPS, SSM_TRAIN_B, SSM_TRAIN_S,
                           smoke=False, device=LM_DEVICE, runtime_log=log,
                           history=hist)
        sync()
        wall = time.perf_counter() - t1
        launches = {"wkv6": WK.LAUNCHES, "wkv6_bwd": WK.LAUNCHES_BWD,
                    "mamba_scan": MS.LAUNCHES,
                    "mamba_scan_bwd": MS.LAUNCHES_BWD,
                    "flash_attention": FA.LAUNCHES,
                    "flash_bwd_delta": FA.DELTA_LAUNCHES,
                    "flash_bwd_dkdv": FA.DKDV_LAUNCHES,
                    "flash_bwd_dkdv_sum": FA.DKDV_SUM_LAUNCHES,
                    "flash_bwd_dq": FA.DQ_LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        with open(log) as f:
            rec = json.loads(f.read().splitlines()[-1])
    step_s = rec["median_step_s"]
    model_flops, hw_flops = _train_flops(cfg, SSM_TRAIN_B, SSM_TRAIN_S)
    job = ShapeConfig("chip_smoke_train", SSM_TRAIN_S, SSM_TRAIN_B, "train")
    predicted = AC.predicted_step_time(cfg, job, AC.GPU_FAMILIES["h100-sxm"],
                                       1)
    name = "rwkv_train" if arch == RWKV_ARCH else "jamba_train"
    emit(name, t0, arch=arch, layers=cfg.n_layers, d_model=cfg.d_model,
         d_ff=cfg.d_ff, moe_d_ff=cfg.moe_d_ff, vocab=cfg.vocab_size,
         batch=SSM_TRAIN_B, seq=SSM_TRAIN_S, grad_accum=cfg.grad_accum,
         remat=cfg.remat, optimizer=cfg.optimizer,
         grad_accum_dtype=cfg.grad_accum_dtype,
         params=cfg.param_counts()["total"],
         active_params=cfg.param_counts()["active"], losses=losses,
         history=hist, run_wall_s=wall, step_s=step_s,
         tokens_per_s=SSM_TRAIN_B * SSM_TRAIN_S / step_s,
         model_flops_per_step=model_flops,
         mfu=model_flops / step_s / BF16_OPS_PER_S,
         hfu_with_remat=hw_flops / step_s / BF16_OPS_PER_S,
         peak_device_bytes=peak, launches=launches,
         launches_per_step={n: c / SSM_TRAIN_STEPS
                            for n, c in launches.items()},
         runtime_log_line=rec,
         analytic={"predicted_step_s_h100_row": predicted,
                   "measured_step_s": step_s,
                   "measured_over_predicted": step_s / predicted})
    assert len(losses) == SSM_TRAIN_STEPS and all(map(math.isfinite, losses))
    # random weights at full width start at losses of 50 (rwkv6) and 130
    # (jamba); jamba's Adafactor at lr 1e-2 then moves the loss up and
    # down (131.9, 31.5, 84.5 in a probe run), so the check is that some
    # later step's loss is below the first
    assert min(losses[1:]) < losses[0], \
        f"{name}: the loss did not fall: {losses}"
    assert cfg.remat == "full" and cfg.grad_accum == 8
    micro = SSM_TRAIN_STEPS * cfg.grad_accum
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    n_rwkv, n_mamba = kinds.count("rwkv"), kinds.count("mamba")
    n_attn = len(kinds) - n_rwkv - n_mamba
    want = {"wkv6": 2 * micro * n_rwkv, "wkv6_bwd": micro * n_rwkv,
            "mamba_scan": 2 * micro * n_mamba,
            "mamba_scan_bwd": micro * n_mamba,
            "flash_attention": 2 * micro * n_attn,
            "flash_bwd_delta": micro * n_attn,
            "flash_bwd_dkdv": micro * n_attn,
            "flash_bwd_dkdv_sum": micro * n_attn,
            "flash_bwd_dq": micro * n_attn}
    assert launches == want, (name, launches, want)
    assert rec["device"] == torch.cuda.get_device_name(0)
    # the runtime-log record names the cut: jamba's depth and widths,
    # none for rwkv6-3b, which trains whole
    assert {k: rec[k] for k in CUT_KEYS if k in rec} == (
        {"n_layers": 4, "d_ff": 2048, "moe_d_ff": 2048}
        if arch == JAMBA_ARCH else {}), rec
    if cfg.n_experts:
        assert all(h["aux_loss"] > 0 for h in hist), hist
    return launches


def _first_adamw_step(p, g, scale):
    """The parameter after AdamW's first step from zero moments
    (``train.optimizer.adamw``'s defaults): m-hat = g, v-hat = g^2, so
    p - lr (g / (|g| + eps) + wd p), g clipped by ``scale``."""
    import inspect
    from repro_torch.train import optimizer
    d = {k: v.default for k, v in
         inspect.signature(optimizer.adamw).parameters.items()}
    gs = g * scale
    return p - d["lr"] * (gs / (gs.abs() + d["eps"]) + d["weight_decay"] * p)


def _stream_compare(card, cpu, params_cpu):
    """Card against CPU after one AdamW step, leaf by leaf (the CPU's
    gradient and parameter of a leaf copied to the card at a time, so the
    3.66 B jamba cut needs no third copy and the card does the
    arithmetic): the loss, the grad norm, every gradient leaf, and the
    parameters after the step where decided, also split by the CPU's
    clipped |g| against AdamW's eps, as ``_compare_step``."""
    (cg, cm), (wg, wm) = card, cpu
    eps = _adamw_eps()
    c_norm = math.sqrt(sum(float(g.double().square().sum())
                           for g in cg.values()))
    w_norm = math.sqrt(sum(float(g.to(LM_DEVICE).double().square().sum())
                           for g in wg.values()))
    c_clip, w_clip = min(1.0, 1.0 / c_norm), min(1.0, 1.0 / w_norm)
    bins = {"g<=10eps": (0.0, 10.0),
            f"10eps<g<={ADAMW_FAR_EPS:g}eps": (10.0, ADAMW_FAR_EPS),
            f"g>{ADAMW_FAR_EPS:g}eps": (ADAMW_FAR_EPS, math.inf)}
    by_g = {b: {"rel_max": 0.0, "leaf": None, "elements": 0} for b in bins}
    per, prel, undecided = {}, {}, 0
    num = den = 0.0
    for n, w in wg.items():
        g = cg[n].float()
        w = w.to(g.device)
        per[n] = _rel_err(g, w)
        num += float((g.double() - w.double()).square().sum())
        den += float(w.double().square().sum())
        p0 = params_cpu[n].detach().float().to(g.device)
        gp = _first_adamw_step(p0, g, c_clip)
        wp = _first_adamw_step(p0, w, w_clip)
        decided = w.abs() > 2 * (g - w).abs()
        undecided += int((~decided).sum())
        r = _rel_err(gp[decided], wp[decided]) if bool(decided.any()) else 0.0
        prel[n] = r if math.isfinite(r) else 0.0
        g_eps = (w * w_clip).abs() / eps
        for b, (lo, hi) in bins.items():
            sel = decided & (g_eps > lo) & (g_eps <= hi)
            if not bool(sel.any()):
                continue
            r = _rel_err(gp[sel], wp[sel])
            r = r if math.isfinite(r) else 0.0
            by_g[b]["elements"] += int(sel.sum())
            if r > by_g[b]["rel_max"]:
                by_g[b].update(rel_max=r, leaf=n)
        del g, w, p0, gp, wp
    worst = max(per, key=per.get)
    return {"loss_rel": abs(cm["loss"] - wm["loss"]) / abs(wm["loss"]),
            "grad_norm_rel": abs(c_norm - w_norm) / w_norm,
            "grad_rel_global": math.sqrt(num / den),
            "grad_rel_max": per[worst], "grad_rel_max_leaf": worst,
            "params_after_rel_max": max(prel.values()),
            "params_after_rel_by_g": by_g,
            "params_after_rel_far": by_g[f"g>{ADAMW_FAR_EPS:g}eps"]
            ["rel_max"], "params_undecided": undecided,
            "loss": cm["loss"], "loss_cpu": wm["loss"],
            "aux_loss": cm["aux_loss"], "aux_loss_cpu": wm["aux_loss"]}


def ssm_train_parity_phase():
    """rwkv6-3b at rwkv_parity's cut (4 layers at full width) and
    jamba-1.5-large at jamba_parity's (4 layers, d_ff and moe_d_ff 2,048,
    3.66 B), batch 1, sequence 128, one float32 step from the same weights:
    the card (the WKV6 / scan kernels forward and backward, the flash
    kernels, remat full) against the CPU (plain versions, remat none):
    loss, grad norm, every gradient leaf and the parameters after AdamW's
    first step (also split by |g| against AdamW's eps), held to
    TRAIN_F32_REL and, where |g| > 1e3 eps, TRAIN_F32_FAR_REL."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import wkv6 as WK
    from repro_torch.launch.train import train_config
    from repro_torch.modeling.model import Model, init_params
    from repro_torch.train import train_step as TS
    from repro_torch.train.data import make_batch
    t0 = time.perf_counter()
    cuts = {RWKV_ARCH: get_config(RWKV_ARCH, n_layers=4, grad_accum=1),
            JAMBA_ARCH: train_config(JAMBA_ARCH, grad_accum=1)}
    readings = {}
    for arch, cfg in cuts.items():
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    param_dtype="float32")
        params = init_params(cfg32, 5, LM_DEVICE, gen_device=LM_DEVICE)
        batch = make_batch(cfg, SSM_PARITY_B, SSM_PARITY_S, 0, seed=5)
        before = (WK.LAUNCHES_BWD, MS.LAUNCHES_BWD)
        model = Model(cfg32, params).trainable()
        grads, m = TS.compute_grads(
            model, {n: t.to(LM_DEVICE) for n, t in batch.items()})
        sync()
        bwd = (WK.LAUNCHES_BWD - before[0], MS.LAUNCHES_BWD - before[1])
        card = (grads, {"loss": float(m["loss"]),
                        "aux_loss": float(m["aux_loss"])})
        params_cpu = _cpu_f32(params)
        del model, params
        _free_card()
        t1 = time.perf_counter()
        cpu_model = Model(dataclasses.replace(cfg32, remat="none"),
                          params_cpu).trainable()
        wg, wm = TS.compute_grads(cpu_model, batch)
        cpu_s = time.perf_counter() - t1
        cpu = ({n: g.detach() for n, g in wg.items()},
               {"loss": float(wm["loss"]), "aux_loss": float(wm["aux_loss"])})
        r = _stream_compare(card, cpu, TS.params_of(cpu_model))
        r.update(layers=cfg.n_layers, params=cfg.param_counts()["total"],
                 cpu_step_s=cpu_s, bwd_launches={"wkv6_bwd": bwd[0],
                                                 "mamba_scan_bwd": bwd[1]})
        readings[arch] = r
        del card, cpu, cpu_model, params_cpu, grads, wg
        _free_card()
        kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
        assert bwd == (kinds.count("rwkv"), kinds.count("mamba")), (arch, bwd)
    emit("ssm_train_parity", t0, batch=SSM_PARITY_B, seq=SSM_PARITY_S,
         readings=readings,
         tolerances={"float32": TRAIN_F32_REL,
                     "float32_params_where_g_over_eps_above":
                     [ADAMW_FAR_EPS, TRAIN_F32_FAR_REL]})
    for arch, a in readings.items():
        for key in ("loss_rel", "grad_norm_rel", "grad_rel_max",
                    "params_after_rel_max"):
            assert a[key] <= TRAIN_F32_REL, \
                f"ssm_train_parity {arch} {key}: {a}"
        assert a["params_after_rel_far"] <= TRAIN_F32_FAR_REL, \
            f"ssm_train_parity {arch} where |g| >> eps: " \
            f"{a['params_after_rel_by_g']}"
    return readings


def ssm_bwd_kernel_line(name, launches, err, times):
    """The ``kernels`` line's entry of wkv6_bwd or mamba_scan_bwd: times
    at the training microbatch, launches on the training path."""
    t = times[name]
    src = {"wkv6_bwd": ("src/repro_torch/kernels/csrc/wkv6_bwd.cu",
                        "src/repro/kernels/wkv6.py:66"),
           "mamba_scan_bwd": ("src/repro_torch/kernels/csrc/"
                              "mamba_scan_bwd.cu",
                              "src/repro/kernels/mamba_scan.py:51")}[name]
    return {"name": name, "route": "cuda", "source": src[0],
            "replaces": f"{src[1]} (its gradient: the JAX package has no "
                        "Pallas backward)",
            "launches": launches, "max_abs_err": err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "design_bytes": t["design_bytes"],
            "ms_from": t["ms_from"], "shape": t["shape"],
            "launch_ms": t["launches"]["launch_ms"],
            "blocks": t["launches"]["blocks"],
            "waves": t["launches"]["waves"],
            "library": "none: no one PyTorch call computes it"}


def bwd_kernel_line(name, launches, err, times):
    """The ``kernels`` line's entry of one flash backward launch: times at
    gemma3-1b's training microbatch, global layer, bf16 (the main path's
    type), beside the local layer's and float32's (float32 has no dkdv
    sum)."""
    g, loc = times["global bfloat16"], times["local bfloat16"]
    f32 = times["global float32"]
    sdpa = g["sdpa"] and g["sdpa"]["backward_ms"]
    if name == "flash_bwd_dkdv_sum":
        sdpa = g[name]["library_ms"]
    out = {"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/kernels/flash_attention.py:72 (its "
                       "gradient: the JAX package has no Pallas backward)",
           "launches": launches,
           # the sum runs in bf16 only (its cases' worst, measured)
           "max_abs_err": err["sum"] if name == "flash_bwd_dkdv_sum"
           else max(err[dt] for dt in ("bfloat16", "float32")),
           "max_abs_err_by_dtype": {"bfloat16": err["sum"]}
           if name == "flash_bwd_dkdv_sum"
           else {dt: err[dt] for dt in ("bfloat16", "float32")},
           "ms": g[name]["ms"], "plain_ms": g[name]["plain_ms"],
           "bound_ms": g[name]["bound_ms"], "bound_by": g[name]["bound_by"],
           "library_ms": None if name == "flash_bwd_delta" else sdpa,
           "ms_from": "cuda events",
           "shape": f"global layer B={TRAIN_MICRO_B} S={TRAIN_S} H=4 KV=1 "
                    "hd=256 causal bf16",
           "ms_local": loc[name]["ms"], "plain_ms_local": loc[name]["plain_ms"],
           "bound_ms_local": loc[name]["bound_ms"],
           "ms_float32": f32.get(name, {}).get("ms"),
           "bound_ms_float32": f32.get(name, {}).get("bound_ms")}
    if name == "flash_bwd_dkdv_sum":
        out["library_covers"] = ("one torch.sum over the heads of the same "
                                 "partials, float32 out (no rounding)")
        out["library_ms_local"] = loc[name]["library_ms"]
    elif name != "flash_bwd_delta":
        out["library_covers"] = ("SDPA's whole backward (dq, dk and dv): "
                                 "forward and backward less the forward")
        out["library_ms_local"] = loc["sdpa"] and loc["sdpa"]["backward_ms"]
    return out


# what ``bwd_build`` read from the build log and the SASS of an instance
# (its tiles and register budgets come from the source: the phase's record)
BUILD_MEASURED = ("registers", "spill_stores", "spill_loads", "stack_bytes",
                  "static_smem_bytes", "wgmma_serialized", "HGMMA",
                  "UTMALDG", "sass_sha256")


def mla_bwd_kernel_line(name, launches, err, times):
    """The ``kernels`` line's entry of one flash backward launch at MLA's
    (96, 64) instance: times at minicpm3-4b's training microbatch, bf16
    (the main path's type), beside float32's; launches on mla_train's
    path; the library time SDPA's whole backward at the same shape, with
    the backend that took it.  dkdv and dq run bf16 kernels of their own:
    their function, what ptxas and the SASS show of them and what the
    trace saw go with them."""
    t, f32 = times["mla bfloat16"], times["mla float32"]
    sdpa = t["sdpa"]
    kind = name[len("flash_bwd_"):]
    ptxas = times["mla_ptxas"].get(f"{kind} bf16 mla hd 96/64")
    if ptxas:       # what the build log and SASS show, not the config
        ptxas = {k: v for k, v in ptxas.items() if k in BUILD_MEASURED}
    out = {"name": f"{name}_mla", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/kernels/flash_attention.py:72 (its "
                       "gradient: the JAX package has no Pallas backward)",
           "instance": "q/k head 96, v head 64 (q and k in three 32-column "
                       "boxes with 64-byte swizzle; dK and dQ one m64n96 "
                       "product a step)",
           "kernel": f"flash_bwd_{kind}_mla_kernel" if ptxas
           else "flash_bwd_delta_kernel",
           "ptxas": ptxas,
           "traced": sorted(k for k in t.get("trace_kernels", ())
                            if kind in k) if ptxas else None,
           "launches": launches,
           "max_abs_err": max(err["mla bfloat16"], err["mla float32"]),
           "max_abs_err_by_dtype": {"bfloat16": err["mla bfloat16"],
                                    "float32": err["mla float32"]},
           "ms": t[name]["ms"], "plain_ms": t[name]["plain_ms"],
           "bound_ms": t[name]["bound_ms"], "bound_by": t[name]["bound_by"],
           "library_ms": None, "ms_from": "cuda events",
           "shape": f"minicpm3-4b training microbatch B={MLA_TRAIN_MICRO_B} "
                    f"S={TRAIN_S} H=KV={MLA_H} q/k hd={MLA_HDQK} v "
                    f"hd={MLA_HDV} causal bf16",
           "ms_float32": f32[name]["ms"],
           "bound_ms_float32": f32[name]["bound_ms"]}
    if name != "flash_bwd_delta":
        out.update(library_ms=sdpa and sdpa["backward_ms"],
                   library_backend=sdpa and sdpa["backend"],
                   library_covers="SDPA's whole backward (dq, dk and dv): "
                                  "forward and backward less the forward")
    return out


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
    kernel_build_phase(build, built)
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

    # ---- main path of slice 8: the hub's public surface over a socket
    # (edge_phase sets the GBM count to 0 itself and reads it after)
    gw, n_pred, warm_s = edge_gateway()
    edge = edge_phase(gw, warm_s, n_pred)
    sidecar_phase(gw)
    profile_phase(hub, gw)
    transfer_check(gw)

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

    # ---- main path of slice 14: minicpm3-4b serving (mla_serve sets its
    # counts to 0 itself and reads them after)
    _free_card()
    mla_err, mla_times, mla_rel = mla_kernel_phase()
    mla_profile_phase()
    mla_launches = mla_serve_phase()
    mla_parity_phase()

    # ---- main path of slice 10: training (train_phase sets the flash
    # counts to 0 itself and reads them after)
    _free_card()
    bwd_err, bwd_times = train_kernel_phase(build)
    train_launches = train_phase()
    train_parity_phase()

    # ---- main path of slice 16: minicpm3-4b training (mla_train sets the
    # flash counts to 0 itself and reads them after)
    _free_card()
    mla_train_launches = mla_train_phase()
    mla_train_parity_phase()

    # ---- main paths of slice 12: RWKV and Mamba training (each phase
    # sets the counts to 0 itself and reads them after)
    _free_card()
    ssm_err, ssm_times = ssm_train_kernel_phase()
    rwkv_train_launches = ssm_train_phase(RWKV_ARCH)
    jamba_train_launches = ssm_train_phase(JAMBA_ARCH)
    ssm_train_parity_phase()
    _free_card()

    # ---- main path of slice 9: the eval plane (eval_phase sets the GBM
    # count to 0 itself and reads it after)
    evals = eval_phase()

    serve, big = times["serve_d3"], times["n2p20_d3"]
    fg, fl = lm_times["flash_global"], lm_times["flash_local"]
    dg, dl = lm_times["decode_global"], lm_times["decode_local"]
    fj, dj = (jamba_attn["times"][k]
              for k in ("flash_attention", "decode_attention"))
    fm, dm = (mla_times[k] for k in ("flash_attention_mla", "mla_decode"))
    errs = {k: {dt: max(lm_worst[k][dt], jamba_attn["max_abs_err"][k][dt])
                for dt in lm_worst[k]} for k in lm_worst}
    rels = {k: list(lm_rel[k].values())
            + list(jamba_attn["bf16_rel_err"][k].values()) for k in lm_rel}
    print(json.dumps({"kernels": [{
        "name": "gbm_predict", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gbm_predict.cu",
        "replaces": "src/repro/kernels/gbm_predict.py:58",
        "launches": launches, "max_abs_err": max_abs,
        "ms": serve["ms"], "plain_ms": serve["plain_ms"],
        "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
        "library_ms": None,
        "ms_from": "cuda events, calls queued behind a sleeping kernel",
        "ms_back_to_back": serve["ms_back_to_back"],
        "shape": f"n={N_CONTEXTS * len(SCALEOUTS)} d=3 T=200 D=3",
        "ms_n2p20": big["ms"], "plain_ms_n2p20": big["plain_ms"],
        "bound_ms_n2p20": big["bound_ms"],
        "launches_edge": edge["launches"],
        "launches_eval": evals["launches"],
        "launches_eval_by_part": evals["per_part"],
        "launches_per_choose_edge": {
            j: edge["per_request"][f"{j}_choose"] for j in EDGE_JOBS},
        "launches_per_predict_edge": {
            j: edge["per_request"][f"{j}_predict"] for j in EDGE_JOBS}}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:72",
        "launches": lm_launches["flash_attention"],
        "max_abs_err": max(errs["flash_attention"].values()),
        "max_abs_err_by_dtype": errs["flash_attention"],
        "rel_err_bf16": max(r["kernel"] for r in rels["flash_attention"]),
        "rel_err_bf16_limit": FLASH_BF16_REL,
        "rel_err_bf16_least_control": min(
            min(r["control_p_fp8"], r["control_scale_1.1"])
            for r in rels["flash_attention"] if r["control_p_fp8"] > 0),
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
        "launches_jamba_train": jamba_train_launches["flash_attention"],
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
        "max_abs_err": max(errs["decode_attention"].values()),
        "max_abs_err_by_dtype": errs["decode_attention"],
        "rel_err_bf16": max(r["kernel"] for r in rels["decode_attention"]),
        "rel_err_bf16_limit": DECODE_BF16_REL,
        "rel_err_bf16_least_control": min(
            min(r["control_p_fp8"], r["control_scale_1.1"])
            for r in rels["decode_attention"] if r["control_p_fp8"] > 0),
        "ms": dg["ms"], "plain_ms": dg["plain_ms"],
        "bound_ms": dg["bound_ms"], "bound_by": dg["bound_by"],
        "library_ms": dg["library_ms"],
        "ms_from": dg["ms_from"],
        "shape": f"global layer B={SERVE_B} L={SERVE_L} H=4 KV=1 hd=256 "
                 f"pos={dg['pos']} bf16, one launch",
        "ms_local": dl["ms"], "plain_ms_local": dl["plain_ms"],
        "bound_ms_local": dl["bound_ms"],
        "library_ms_local": dl["library_ms"],
        "launches_jamba": jamba_launches["decode_attention"],
        "shape_jamba": f"attention layer B={SERVE_B} L={SERVE_L} "
                       f"H={JAMBA_H} KV={JAMBA_KV} hd={JAMBA_HD} "
                       f"pos={dj['pos']} bf16, one launch",
        "ms_jamba": dj["ms"], "ms_from_jamba": dj["ms_from"],
        "plain_ms_jamba": dj["plain_ms"],
        "bound_ms_jamba": dj["bound_ms"], "bound_by_jamba": dj["bound_by"],
        "library_ms_jamba": dj["library_ms"]}, {
        "name": "flash_attention_mla", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:72",
        "instance": "q/k head 96, v head 64 (flash_fwd_mla_kernel, "
                    "tc::MlaCfg: 192-row items on three consumer "
                    "warpgroups, 64 keys a stage, a persistent grid)",
        "launches": mla_launches["flash_attention"],
        "max_abs_err": max(mla_err["flash_attention_mla"].values()),
        "max_abs_err_by_dtype": mla_err["flash_attention_mla"],
        "rel_err_bf16": max(r["kernel"] for r in
                            mla_rel["flash_attention_mla"].values()),
        "rel_err_bf16_limit": FLASH_BF16_REL,
        "ms": fm["ms"], "plain_ms": fm["plain_ms"],
        "bound_ms": fm["bound_ms"], "bound_by": fm["bound_by"],
        "library_ms": fm["library_ms"], "ms_from": "cuda events",
        "tflops": fm["tflops"],
        "shape": f"minicpm3-4b prefill B={SERVE_B} S={SERVE_PROMPT} "
                 f"H=KV={MLA_H} q/k hd={MLA_HDQK} v hd={MLA_HDV} causal "
                 "bf16",
        "launches_mla_train": mla_train_launches["flash_attention"]}, {
        "name": "mla_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mla_decode.cu",
        "replaces": "src/repro/modeling/attention.py:457 (MLA's absorbed "
                    "decode, in jnp: no Pallas kernel computes it)",
        "launches": mla_launches["mla_decode"],
        "max_abs_err": max(mla_err["mla_decode"].values()),
        "max_abs_err_by_dtype": mla_err["mla_decode"],
        "rel_err_bf16": max(r["kernel"] for r in
                            mla_rel["mla_decode"].values()),
        "rel_err_bf16_limit": DECODE_BF16_REL,
        "ms": dm["ms"], "plain_ms": dm["plain_ms"],
        "bound_ms": dm["bound_ms"], "bound_by": dm["bound_by"],
        "library_ms": dm["library_ms"], "ms_from": dm["ms_from"],
        "parts": dm["parts"], "slots_a_part": dm["slots_a_part"],
        "walk_ms": dm["walk_ms"], "merge_ms": dm["merge_ms"],
        "shape": f"minicpm3-4b decode B={SERVE_B} L={SERVE_L} H={MLA_H} "
                 f"C={MLA_C} R={MLA_R} pos={dm['pos']} bf16, one launch: "
                 "each batch row's parts in a thread-block cluster that "
                 "merges them (walk_ms the launch without the merge)"}, {
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6.py:66",
        "launches": wkv_launches, "max_abs_err": wkv_err,
        "launches_rwkv_train": rwkv_train_launches["wkv6"],
        "ms": wkv_times["ms"], "ms_from": wkv_times["ms_from"],
        "device_ms": wkv_times["device_ms"], "plain_ms": wkv_times["plain_ms"],
        "bound_ms": wkv_times["bound_ms"],
        "bound_by": wkv_times["bound_by"], "library_ms": None,
        "shape": f"B={SERVE_B} S={SERVE_PROMPT} H={RWKV_H} hd={RWKV_HD} "
                 "float32, given s0"}, {
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:51",
        "launches": jamba_launches["mamba_scan"],
        "launches_jamba_train": jamba_train_launches["mamba_scan"],
        "max_abs_err": max(scan_err.values()),
        "max_abs_err_by_dtype": scan_err,
        "ms": scan_times["ms"], "plain_ms": scan_times["plain_ms"],
        "bound_ms": scan_times["bound_ms"],
        "bound_by": scan_times["bound_by"], "library_ms": None,
        "shape": f"B={SERVE_B} S={SERVE_PROMPT} D={JAMBA_D} N={JAMBA_N} "
                 "float32, given h0"}] + [
        dict(bwd_kernel_line(name, train_launches[name], bwd_err,
                             bwd_times),
             launches_jamba_train=jamba_train_launches[name])
        for name in BWD_KERNELS] + [
        mla_bwd_kernel_line(name, mla_train_launches[name], bwd_err,
                            bwd_times)
        for name in ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")] + [
        dict(ssm_bwd_kernel_line("wkv6_bwd",
                                 rwkv_train_launches["wkv6_bwd"], ssm_err,
                                 ssm_times),
             launches_per_step=rwkv_train_launches["wkv6_bwd"]
             / SSM_TRAIN_STEPS),
        dict(ssm_bwd_kernel_line("mamba_scan_bwd",
                                 jamba_train_launches["mamba_scan_bwd"],
                                 ssm_err, ssm_times),
             launches_per_step=jamba_train_launches["mamba_scan_bwd"]
             / SSM_TRAIN_STEPS)]}),
        flush=True)
    print(smi, flush=True)
    if not edge["gate_ok"]:
        print(f"chip_smoke: edge: t_socket - t_tcp is "
              f"{edge['over_budget']:.4f}x t_inproc in the median triple; "
              f"the gate is <= {EDGE_BUDGET:g}", file=sys.stderr)
        return 1
    if not edge["control_fails"]:
        print(f"chip_smoke: edge: the busy-wait control reads "
              f"{edge['control']:.4f}x, inside the gate: the gate is void",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--trace":
        sys.exit(route_trace_child(sys.argv[2], json.loads(sys.argv[3])))
    sys.exit(main())
