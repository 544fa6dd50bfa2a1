#!/usr/bin/env python3
"""Compare two trees of the PyTorch/CUDA port on one card, in turns.

    python3 scripts/kernel_ab.py [--only STEP[,STEP...]] A_SRC B_SRC [C_SRC ...]

A_SRC, B_SRC, ... are directories that hold a ``repro_torch`` package (for
example ``src`` of a ``git archive`` of the parent commit and ``src`` of
this checkout).  Every step runs in a fresh process a tree, in the order
A, B, B, A (with more trees A, B, C, C, B, A), and prints one JSON line.  First gbm_predict on chip_smoke.py's
seeded ensembles (T 200, depth 3) at the serving shape (n 24,576 at d 2,
3 and 4) and at n = 2^20 (d 3), by CUDA events over calls queued behind a
sleeping kernel (``queued_ms``, the card's time) and back to back
(``cuda_ms``, which the host's enqueue rate can set), with the loops of the
SASS of the kernel instance that runs d 3, depth 3 (``sass_loops``); a
tree that plans its launch (``gbm_predict.plan``) is also timed with one
row a thread at the plan's rows a block.  Then the other kernels, on
seeded inputs made and timed with ``chip_smoke.py``'s helpers:
decode_attention in bf16 at jamba-1.5-large's decode step (B 8, L 2,120,
64 heads over 8 of 128, pos 2080) and at gemma3-1b's global and local
ring layers (4 heads over 1 of 256), by profiler device time
(``lm_time``) beside scaled_dot_product_attention's; wkv6 at rwkv6-3b's
heads (S 2048, H 40,
hd 64, float32) by CUDA events (``cuda_ms``) at B 1, 2, 4 and 8.  At B 1
and 2 each (batch, head) block has an SM to itself, so the time over S /
16 is one block's time a chunk of 16 tokens.  Then gemma3-1b, rwkv6-3b
and jamba-1.5-large (4 layers) are each served at full width through
``repro_torch.launch.serve.run`` (batch 8, prompt 2048, 64 new tokens)
after a warm-up serve of 4 tokens, giving prefill ms and the decode
median ms/token.  The step "flash" (run only when ``--only`` names it)
times flash_attention's bf16 forward, the serving launch, by CUDA events
at gemma3-1b's global and local layers (B 8, S 2048, 4 heads over 1 of
256) and jamba-1.5-large's (64 heads over 8 of 128), and hashes the
instructions of the bf16 serving instances in ``cuobjdump --dump-sass``
of the built library (the instance without the training lse output), so
that two trees show whether serving runs the same code.  The step
"train" (also run only when ``--only`` names it) hashes the SASS of every
kernel function of the flash backward's library (``bwd_sass``, the names
keyed alike across the change of the backward's template from one head
dim to a q/k and a v head dim), times the bf16 flash
backward at gemma3-1b's training microbatch (B 2, S 4096, 4 query heads
over 1 of 256, causal; the global layer and window 512) by CUDA events:
the whole backward (``flash_attention_bwd``) and each public launch
wrapper (delta, dkdv with its head sum where the tree has one, dq), with
SDPA's backward beside them, and the same at MLA's (96, 64) on
minicpm3-4b's microbatch (B 1, S 4096, 40 heads) where the tree's backward
takes that pair; then a gemma3-1b training run at full width
and depth (10 steps of 8 x 4096, the runtime log's median step, warm-up
excluded) and minicpm3-4b's as ``chip_smoke.py``'s mla_train runs it (62
layers, 4 steps of 8 x 4096, the first the warm-up).  ``bwd_sass`` leaves
out the (96, 64) functions (the SIMT instances and, since the bf16 ones
became kernels of their own, flash_bwd_dkdv_mla and flash_bwd_dq_mla), so
that two trees show whether the other 14 backward functions and the head
sum kept their SASS.  Each step of that run also records its wall and process CPU
seconds on the host, and what ``nvidia-smi`` sampled during it every
0.1 s or so: SM clock, power draw, utilization and the clock-event
(throttle) reasons.  The step "recurrences" (run only when ``--only``
names it) hashes the SASS of the WKV6 and selective-scan serving forwards
(the instances without the training outputs) and times them by CUDA
events at rwkv6-3b's and jamba's serving shapes (B 8, S 2048), then
times the training forwards (with chunk states, with tile checkpoints)
and the backward kernels wkv6_bwd and mamba_scan_bwd by CUDA events at the
training microbatch (B 1, S 4096).  The steps "rwkv_train" and
"jamba_train" (also only when ``--only`` names them) train rwkv6-3b whole
and jamba's 3.66 B cut as ``chip_smoke.py`` does (4 steps of 8 x 4096),
giving the median step and each step's wall and CPU seconds with the
card's samples.  ``--only``
takes steps from gbm, kernels, flash, train, recurrences, mla,
rwkv_train, jamba_train and the archs (minicpm3-4b among them, though the
default run leaves it out).  The step "mla" (run only when ``--only``
names it) times MLA's two kernels at minicpm3-4b's serving shapes: the
flash attention at q/k head 96 and v head 64 (B 8, S 2048, 40 heads) by
CUDA events beside SDPA's, and mla_decode (B 8, L 2,120, pos 2080) by
profiler device time, each kernel of the call apart and, where the tree
has it, the launch without its merge; and it hashes the SASS of every
other kernel function of every library (``all_sass``), so that two
trees show that only MLA's kernels changed, and apart those of MLA's
kernels (``mla_sass``), which two trees share where only the sources'
layout changed.  The step "mla_bwd" (only when ``--only`` names it)
reports one tree's bf16 flash backward at (96, 64): ptxas's registers,
spills and ``wgmma`` serialisation notes for every backward function, the
bf16 cases of ``chip_smoke.MLA_BWD_CASES`` against plain and autograd,
and delta, dkdv and dq by CUDA events at minicpm3-4b's microbatch; with
several trees it compares variants of those kernels.  The step
"train_profile" (only when ``--only`` names it) trains gemma3-1b and
minicpm3-4b (62 layers) for 3 steps of 8 x 4096 and profiles the second:
the card's busy time (the union of its kernels) and idle share of the
step, the flash backward's kernels, the heaviest kernels and the heaviest
host ops.  Needs a CUDA card.
"""
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("gemma3-1b", "rwkv6-3b", "jamba-1.5-large-398b")
GBM_SHAPES = ((24576, 2, 500), (24576, 3, 500), (24576, 4, 500),
              (2 ** 20, 3, 50))                       # n, d, calls timed
DECODE_SHAPES = {   # B, L, H, KV, hd, pos, window, ring
    "decode_jamba": (8, 2120, 64, 8, 128, 2080, 0, False),
    "decode_global": (8, 2120, 4, 1, 256, 2080, 0, False),
    "decode_local": (8, 512, 4, 1, 256, 2080, 512, True)}


def gbm(label):
    import torch
    import chip_smoke as CS
    from repro_torch.kernels import build
    from repro_torch.kernels import gbm_predict as K
    so = build.build_all(["gbm_predict"])["gbm_predict"]
    out = {"label": label, "card": CS.nvidia_smi()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    f0 = torch.tensor([0.3], device="cuda")
    ys = torch.tensor([0.0], device="cuda")
    for n, d, reps in GBM_SHAPES:
        X, feat, thr, leaf = CS.ensemble(99, n, d, 200, 3, "cuda")

        def call():
            K.gbm_predict(X, feat, thr, leaf, f0, ys)
        out[f"n{n}_d{d}"] = {"queued_ms": CS.queued_ms(call, reps),
                             "events_ms": CS.cuda_ms(call, reps)}
        if hasattr(K, "plan") and n < 2 ** 20:
            # the tree's kernel with one row a thread (no slices) at the
            # plan's rows a block: the design its slices were chosen over
            p = K.plan(n, d, 200, 3, sms)
            one = dict(p, slices=1, smem_bytes=200 * K.tree_bytes(3))
            res = torch.empty(n, device="cuda")
            out[f"n{n}_d{d}"]["one_row_a_thread_queued_ms"] = CS.queued_ms(
                lambda: K._launch(X, feat, thr, leaf, f0, ys, res, one),
                reps)
    out["sass_d3_depth3"] = CS.sass_loops(
        so, r"gbm_kernelILi3ELi3E|gbm_predict_kernelILi4EE")
    return out


def kernels(label):
    import torch
    import chip_smoke as CS
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import wkv6 as WK
    from repro_torch.modeling.attention import ring_positions
    build.build_all(["decode_attention", "wkv6"])
    out = {"label": label, "card": torch.cuda.get_device_name(0)}
    for name, (B, L, H, KV, hd, pos, window, ring) in DECODE_SHAPES.items():
        q, kc, vc = CS._qkv(0, B, 1, H, KV, hd, "bfloat16", L=L)
        q = q[:, 0].contiguous()
        kp = ring_positions(L, pos, "cuda") if ring else None
        ok = DA._mask(kp, L, pos, window, q.device)
        out[name] = {
            "kernel_device_ms": CS.lm_time(lambda: DA.decode_attention(
                q, kc, vc, pos, window=window, k_pos=kp), 200)["device_ms"],
            "sdpa_device_ms": CS.lm_time(CS.sdpa_decode(q, kc, vc, ok),
                                         200)["device_ms"]}
    for B in (1, 2, 4, 8):
        ins = CS._wkv_inputs(0, B, 2048, 40, 64)
        out[f"wkv6_B{B}_events_ms"] = CS.cuda_ms(lambda: WK.wkv6(*ins), 20)
    return out


FLASH_SHAPES = {   # B, S, H, KV, hd, window
    "flash_global": (8, 2048, 4, 1, 256, 0),
    "flash_local": (8, 2048, 4, 1, 256, 512),
    "flash_jamba": (8, 2048, 64, 8, 128, 0)}


# the serving instances whose SASS two trees compare: a kernel without a
# training template argument, or its instance with that argument false (the
# flash forward's head dim, or since MLA's (96, 64) its q/k and v head dims)
SERVING_INSTANCES = {
    "flash_attention": r"flash_fwd_wgmma_kernelILi(\d+)E(?:Li(\d+)E)?(Lb0E)?EEv",
    "wkv6": r"wkv6_kernelILi(\d+)E(Lb0E)?EEv",
    "mamba_scan": r"mamba_scan_kernelILi(\d+)E(f|13__nv_bfloat16)(Lb0E)?EEv"}


def serving_sass(so_path, kernel="flash_attention"):
    """{instance: instructions and a hash of them} of a kernel's serving
    instances in the library's SASS (``SERVING_INSTANCES``): the bf16 flash
    forward's by head dim, wkv6's by head dim, mamba_scan's by N and u's
    type."""
    from repro_torch.kernels import build
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(so_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        m = re.search(SERVING_INSTANCES[kernel], part.split()[0])
        if m:
            ops = [op.strip() for op in
                   re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", part)]
            if kernel == "mamba_scan":
                key = f"N {m.group(1)} " \
                    f"{'f32' if m.group(2) == 'f' else 'bf16'} u"
            elif kernel == "flash_attention" and m.group(2) \
                    and m.group(2) != m.group(1):
                key = f"hd {m.group(1)}/{m.group(2)}"
            else:
                key = f"hd {m.group(1)}"
            out[key] = {
                "instructions": len(ops),
                "sha256": hashlib.sha256("\n".join(ops).encode())
                .hexdigest()[:16]}
    return out


# MLA's two kernels at minicpm3-4b's serving shapes: the prefill's flash
# attention (B, S, heads, q/k head dim, v head dim) and the decode (B,
# cache slots, pos)
MLA_FLASH = (8, 2048, 40, 96, 64)
MLA_DECODE = (8, 2120, 2080)
# kernel functions that differ between trees by design in the mla step:
# MLA's flash instance (its wgmma kernel, whatever its name) and decode
MLA_FUNCTIONS = re.compile(r"flash_fwd_mla_kernel|flash_fwd_wgmma_kernelILi96ELi64E"
                           r"|mla_(decode|merge)|flash_bwd_\w+ILi96ELi64E"
                           r"|flash_bwd_\w+_mla_kernel")


def sass_name(mangled):
    """A kernel function's name without the anonymous namespace's per-file
    tag, which differs between trees, and with the flash backward's head
    dims as one number where they are equal (``<64>`` before the backward
    took a q/k and a v head dim, ``<64, 64>`` since), so that two trees
    key the same function alike."""
    name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", mangled)
    if "flash_bwd" in name:
        name = re.sub(r"Li(\d+)ELi\1E", r"Li\1E", name)
    return name


def all_sass(built):
    """({library: {function: a hash of its instructions}} of every built
    library, MLA's kernels left out; the same of MLA's kernels alone), the
    functions keyed without the anonymous namespace's per-file tag, which
    differs between trees."""
    from repro_torch.kernels import build
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.nvcc_path()), "cuobjdump")
    other, mla = {}, {}
    for lib, so_path in sorted(built.items()):
        sass = subprocess.run([cuobjdump, "--dump-sass", str(so_path)],
                              capture_output=True, text=True, check=True,
                              timeout=600).stdout
        for part in sass.split("Function : ")[1:]:
            name = sass_name(part.split()[0])
            ops = [op.strip() for op in
                   re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", part)]
            to = mla if MLA_FUNCTIONS.search(name) else other
            to.setdefault(lib, {})[name] = hashlib.sha256(
                "\n".join(ops).encode()).hexdigest()[:16]
    return other, mla


def device_ms_by_kernel(fn, reps):
    """{kernel name: mean profiler device ms of one launch, launches a
    call} over ``reps`` calls of ``fn`` after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by.setdefault(e.name[:80], []).append(e.time_range.elapsed_us())
    return {n: [sum(d) / len(d) / 1e3, len(d) / reps] for n, d in by.items()}


def mla(label):
    """MLA's two kernels, as ``chip_smoke.py`` times them: flash attention
    at q/k head 96 and v head 64 by CUDA events beside SDPA's (the same
    seeded inputs), and mla_decode by profiler device time, each kernel
    of a call by name (the first design's main launch and merge of its
    parts apart; since PR 25 one launch, and ``walk_ms`` the same launch
    without its in-cluster merge); then a hash of the SASS of every other
    kernel function of every library, which two trees must share."""
    import torch
    import chip_smoke as CS
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    built = build.build_all()
    out = {"label": label, "card": CS.nvidia_smi()}
    B, S, H, hd, hdv = MLA_FLASH
    q, k, v = CS._qkv(307, B, S, H, H, hd, "bfloat16", hdv=hdv)
    out["flash_96_64_events_ms"] = CS.cuda_ms(
        lambda: FA.flash_attention(q, k, v), 50)
    lib = CS.sdpa_flash(q, k, v, True, 0)
    out["flash_96_64_sdpa_events_ms"] = lib and CS.cuda_ms(lib, 50)
    del q, k, v
    torch.cuda.empty_cache()
    B, L, pos = MLA_DECODE
    ins = CS._mla_inputs(308, B, L, "bfloat16")
    t = CS.lm_time(lambda: DA.mla_decode_attention(*ins, pos, CS.MLA_SCALE),
                   200)
    out["mla_decode_device_ms"] = t["device_ms"]
    out["mla_decode_kernels"] = t["kernel_names"]
    out["mla_decode_device_ms_by_kernel"] = device_ms_by_kernel(
        lambda: DA.mla_decode_attention(*ins, pos, CS.MLA_SCALE), 200)
    if hasattr(DA, "_mla_launch"):
        out["mla_decode_walk_device_ms"] = CS.lm_time(
            lambda: DA._mla_launch(*ins, pos, CS.MLA_SCALE, flags=1),
            200)["device_ms"]
    out["sass"], out["mla_sass"] = all_sass(built)
    return out


def recurrences(label):
    """The serving forwards of WKV6 and the selective scan: their SASS
    hashes and CUDA-event times at rwkv6-3b's and jamba's serving shapes
    (B 8, S 2048; 40 heads of 64, 16,384 channels of 16, float32); then
    the training forwards (with chunk states, with tile checkpoints) and
    the backward kernels, wkv6_bwd and mamba_scan_bwd, by CUDA events at
    the training microbatch (B 1, S 4096)."""
    import torch
    import chip_smoke as CS
    from repro_torch.kernels import build
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import wkv6 as WK
    so = build.build_all(["wkv6", "mamba_scan", "wkv6_bwd",
                          "mamba_scan_bwd"])
    out = {"label": label, "card": CS.nvidia_smi(),
           "wkv6_sass": serving_sass(so["wkv6"], "wkv6"),
           "mamba_scan_sass": serving_sass(so["mamba_scan"], "mamba_scan")}
    ins = CS._wkv_inputs(0, 8, 2048, 40, 64)
    out["wkv6_B8_events_ms"] = CS.cuda_ms(lambda: WK.wkv6(*ins), 50)
    del ins
    ins = CS._scan_inputs(0, 8, 2048, 16384, 16)
    out["mamba_scan_B8_events_ms"] = CS.cuda_ms(lambda: MS.mamba_scan(*ins),
                                                50)
    del ins
    ins = CS._wkv_bwd_inputs(9, 1, 4096, 40, 64, False, False)
    out["wkv6_with_states_B1_S4096_events_ms"] = CS.cuda_ms(
        lambda: WK.wkv6_with_states(*ins[:6]), 10)
    st = WK.wkv6_with_states(*ins[:6])[2]
    out["wkv6_bwd_B1_S4096_events_ms"] = CS.cuda_ms(
        lambda: WK.wkv6_bwd(*ins, states=st), 10)
    del ins, st
    u, dt, A, Bi, Ci, _ = CS._scan_inputs(9, 1, 4096, 16384, 16, False)
    h0 = torch.zeros(1, 16384, 16, device="cuda")
    ins = (u, dt, A, Bi, Ci, h0, 0.5 * torch.randn_like(u), None)
    out["mamba_scan_with_checkpoints_B1_S4096_events_ms"] = CS.cuda_ms(
        lambda: MS.mamba_scan_with_checkpoints(*ins[:6]), 10)
    chk = MS.mamba_scan_with_checkpoints(*ins[:6])[2]
    out["mamba_scan_bwd_B1_S4096_events_ms"] = CS.cuda_ms(
        lambda: MS.mamba_scan_bwd(*ins, checkpoints=chk), 10)
    return out


def flash(label):
    import chip_smoke as CS
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    so = build.build_all(["flash_attention"])["flash_attention"]
    out = {"label": label, "card": CS.nvidia_smi(),
           "serving_sass": serving_sass(so)}
    for name, (B, S, H, KV, hd, window) in FLASH_SHAPES.items():
        q, k, v = CS._qkv(0, B, S, H, KV, hd, "bfloat16")
        out[f"{name}_events_ms"] = CS.cuda_ms(
            lambda: FA.flash_attention(q, k, v, window=window), 50)
    return out


TRAIN_BWD = {"bwd_global": 0, "bwd_local": 512}   # window
# minicpm3-4b's training microbatch: B 1, S 4096, 40 heads over 40 of q/k
# head 96 and v head 64, causal (a tree whose backward takes the pair)
TRAIN_BWD_MLA = (1, 4096, 40, 96, 64)
TRAIN_STEPS = 10
SMI_QUERY = "clocks.sm,power.draw,utilization.gpu,{}"
SMI_REASONS = ("clocks_event_reasons.active",
               "clocks_throttle_reasons.active")    # newer, older drivers


class StepStamps(list):
    """``history`` for ``train.run``: each step's record, stamped with the
    host clock and the process's CPU time when the step ended."""

    def append(self, rec):
        super().append(dict(rec, end=time.perf_counter(),
                            cpu=time.process_time()))


def smi_sampler(stop, samples):
    """Append (host clock, sm MHz, W, util %, reasons bitmask) samples of
    the card until ``stop`` is set."""
    for reasons in SMI_REASONS:
        query = SMI_QUERY.format(reasons)
        p = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60)
        if p.returncode == 0:
            break
    else:
        return
    while not stop.is_set():
        t = time.perf_counter()
        p = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60)
        f = [x.strip() for x in p.stdout.splitlines()[0].split(",")]
        samples.append((t, float(f[0]), float(f[1]), float(f[2]), f[3]))
        stop.wait(0.1)


def step_table(t0, cpu0, history, samples):
    """Per step: wall and CPU seconds, and the card's samples within it."""
    out, prev, prev_cpu = [], t0, cpu0
    for h in history:
        inside = [x for x in samples if prev <= x[0] < h["end"]]
        out.append({
            "step": h["step"], "s": h["seconds"],
            "cpu_s": h["cpu"] - prev_cpu, "samples": len(inside),
            "sm_mhz_min": min((x[1] for x in inside), default=None),
            "sm_mhz_max": max((x[1] for x in inside), default=None),
            "power_w_max": max((x[2] for x in inside), default=None),
            "util_pct_mean": (sum(x[3] for x in inside) / len(inside)
                              if inside else None),
            "reasons": sorted({x[4] for x in inside})})
        prev, prev_cpu = h["end"], h["cpu"]
    return out


def train(label):
    import torch
    import chip_smoke as CS
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train as T
    built = build.build_all(["flash_attention", "flash_attention_bwd"])
    out = {"label": label, "card": CS.nvidia_smi()}
    sass, _ = all_sass({"flash_attention_bwd":
                        built["flash_attention_bwd"]})
    out["bwd_sass"] = sass.get("flash_attention_bwd", {})
    B, S, H, KV, hd = CS.TRAIN_MICRO_B, CS.TRAIN_S, 4, 1, 256
    for name, window in TRAIN_BWD.items():
        q, k, v, do = CS._tensors(9, ((B, S, H, hd), (B, S, KV, hd),
                                      (B, S, KV, hd), (B, S, H, hd)),
                                  "bfloat16")
        kw = dict(window=window)
        o, lse = FA.flash_attention_lse(q, k, v, **kw)
        delta = FA.flash_bwd_delta(o, do)
        out[name] = {
            "backward_ms": CS.cuda_ms(lambda: FA.flash_attention_bwd(
                q, k, v, o, lse, do, **kw), 10, warm=2),
            "delta_ms": CS.cuda_ms(lambda: FA.flash_bwd_delta(o, do), 10),
            "dkdv_ms": CS.cuda_ms(lambda: FA.flash_bwd_dkdv(
                q, k, v, do, lse, delta, **kw), 10, warm=2),
            "dq_ms": CS.cuda_ms(lambda: FA.flash_bwd_dq(
                q, k, v, do, lse, delta, **kw), 10, warm=2),
            "sdpa": CS.sdpa_backward_times(q, k, v, do, window)}
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    Bm, Sm, Hm, hdq, hdv = TRAIN_BWD_MLA
    q, k, v, do = CS._tensors(9, ((Bm, Sm, Hm, hdq), (Bm, Sm, Hm, hdq),
                                  (Bm, Sm, Hm, hdv), (Bm, Sm, Hm, hdv)),
                              "bfloat16")
    if (hdq, hdv) in getattr(FA, "HEAD_DIM_PAIRS", ()):
        o, lse = FA.flash_attention_lse(q, k, v)
        try:
            FA.flash_attention_bwd(q, k, v, o, lse, do)
        except ValueError as e:          # a tree before the (96, 64) backward
            out["bwd_mla"] = {"refused": str(e)}
        else:
            delta = FA.flash_bwd_delta(o, do)
            out["bwd_mla"] = {
                "backward_ms": CS.cuda_ms(lambda: FA.flash_attention_bwd(
                    q, k, v, o, lse, do), 10, warm=2),
                "delta_ms": CS.cuda_ms(lambda: FA.flash_bwd_delta(o, do), 10),
                "dkdv_ms": CS.cuda_ms(lambda: FA.flash_bwd_dkdv(
                    q, k, v, do, lse, delta), 10, warm=2),
                "dq_ms": CS.cuda_ms(lambda: FA.flash_bwd_dq(
                    q, k, v, do, lse, delta), 10, warm=2),
                "sdpa": CS.sdpa_backward_times(q, k, v, do, 0)}
    del q, k, v, do
    for key, arch, steps in (("train", "gemma3-1b", TRAIN_STEPS),
                             ("mla_train", CS.MLA_ARCH, CS.MLA_TRAIN_STEPS)):
        torch.cuda.empty_cache()
        history, samples, stop = StepStamps(), [], threading.Event()
        sampler = threading.Thread(target=smi_sampler, args=(stop, samples))
        with tempfile.TemporaryDirectory() as tmp:
            log = os.path.join(tmp, "runtime.jsonl")
            torch.cuda.reset_peak_memory_stats()
            sampler.start()
            t0, cpu0 = time.perf_counter(), time.process_time()
            try:
                losses = T.run(arch, steps, CS.TRAIN_B, CS.TRAIN_S,
                               smoke=False, device="cuda", runtime_log=log,
                               history=history)
            finally:
                stop.set()
                sampler.join()
            rec = json.loads(open(log).read().splitlines()[-1])
        out[key] = {"arch": arch, "median_step_s": rec["median_step_s"],
                    "losses": losses,
                    "tokens_per_s": CS.TRAIN_B * CS.TRAIN_S
                    / rec["median_step_s"],
                    "peak_device_bytes": torch.cuda.max_memory_allocated(),
                    "steps": step_table(t0, cpu0, history, samples)}
    return out


def mla_bwd(label):
    """One tree's bf16 flash backward at MLA's (96, 64): what ptxas made of
    every backward function (registers, spills, ``wgmma`` serialisation
    notes, by ``chip_smoke.ptxas_by_instance``), the bf16 cases of
    ``chip_smoke.MLA_BWD_CASES`` held to plain and autograd
    (``check_flash_bwd``: the worst relative error of dq, dk and dv), and
    delta, dkdv and dq at minicpm3-4b's training microbatch by CUDA events
    (20 calls after 3; dkdv and dq twice)."""
    import torch
    import chip_smoke as CS
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    t0 = time.perf_counter()
    build.build_all(["flash_attention", "flash_attention_bwd"])
    out = {"label": label, "card": CS.nvidia_smi(),
           "build_s": time.perf_counter() - t0,
           "ptxas": CS.ptxas_by_instance(
               build.BUILD_INFO["flash_attention_bwd"]["log"],
               CS._bwd_instance)}
    rel = {}
    for i, (name, B, S, H, KV, causal, window, cap) in enumerate(
            CS.MLA_BWD_CASES):
        r = CS.check_flash_bwd(name, B, S, H, KV, 96, causal, window, cap,
                               "bfloat16", 70 + i, hdv=64)
        rel[name] = max(r[n]["rel"] or 0 for n in ("dq", "dk", "dv"))
        torch.cuda.empty_cache()
    out["rel"] = rel
    B, S, H, hdq, hdv = TRAIN_BWD_MLA
    q, k, v, do = CS._tensors(11, ((B, S, H, hdq), (B, S, H, hdq),
                                   (B, S, H, hdv), (B, S, H, hdv)),
                              "bfloat16")
    o, lse = FA.flash_attention_lse(q, k, v)
    delta = FA.flash_bwd_delta(o, do)
    for rep in range(2):
        out[f"dkdv_ms_{rep}"] = CS.cuda_ms(
            lambda: FA.flash_bwd_dkdv(q, k, v, do, lse, delta), 20, warm=3)
        out[f"dq_ms_{rep}"] = CS.cuda_ms(
            lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta), 20, warm=3)
    out["delta_ms"] = CS.cuda_ms(lambda: FA.flash_bwd_delta(o, do), 20)
    return out


class ProfiledSteps(StepStamps):
    """``history`` that moves a torch profiler on at the end of each step."""

    def __init__(self, prof):
        super().__init__()
        self.prof = prof

    def append(self, rec):
        super().append(rec)
        self.prof.step()


def step_profile(prof, seconds):
    """Of one profiled training step: the card's kernels (count, summed
    device ms, busy ms as the union of their intervals, idle share of the
    step's wall time), the flash backward's and the heaviest kernels by
    device time, and the heaviest host ops by self CPU time."""
    import torch
    spans, by = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not (
                getattr(e, "is_user_annotation", False)
                or e.name.startswith("ProfilerStep")):   # the step's span
            r = e.time_range
            spans.append((r.start, r.end))
            n, ms = by.get(e.name[:90], (0, 0.0))
            by[e.name[:90]] = (n + 1, ms + r.elapsed_us() / 1e3)
    spans.sort()
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy_ms = busy / 1e3
    top = sorted(by.items(), key=lambda x: -x[1][1])
    host = sorted(((e.key, e.count, e.self_cpu_time_total / 1e3)
                   for e in prof.key_averages()), key=lambda x: -x[2])
    return {"step_s": seconds, "kernels": len(spans),
            "kernel_ms": sum(ms for _, ms in by.values()),
            "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / (1e3 * seconds),
            "flash_bwd": {n: v for n, v in by.items() if "flash_bwd" in n},
            "top_kernels": top[:12],
            "top_host_self_ms": host[:12]}


def train_profile(label):
    """gemma3-1b and minicpm3-4b (62 layers) trained as the step "train"
    trains them, 3 steps of 8 x 4096: the first a warm-up, the second
    under torch.profiler (CPU and CUDA activities; ``step_profile``), the
    third plain; each step's wall seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    import chip_smoke as CS
    from repro_torch.kernels import build
    from repro_torch.launch import train as T
    build.build_all(["flash_attention", "flash_attention_bwd"])
    out = {"label": label, "card": CS.nvidia_smi()}
    for key, arch in (("train", "gemma3-1b"), ("mla_train", CS.MLA_ARCH)):
        torch.cuda.empty_cache()
        got = {}
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       schedule=schedule(wait=1, warmup=0, active=1,
                                         repeat=1),
                       on_trace_ready=lambda p: got.setdefault(
                           "profiled", step_profile(
                               p, history[-1]["seconds"])))
        history = ProfiledSteps(prof)
        with prof:
            T.run(arch, 3, CS.TRAIN_B, CS.TRAIN_S, smoke=False,
                  device="cuda", history=history)
        out[key] = {"arch": arch,
                    "steps_s": [h["seconds"] for h in history],
                    "profiled": got.get("profiled", "not traced")}
    return out


SSM_TRAIN = {"rwkv_train": "rwkv6-3b", "jamba_train": "jamba-1.5-large-398b"}


def ssm_train(label, step):
    """rwkv6-3b whole or jamba's 3.66 B cut trained as ``chip_smoke.py``'s
    rwkv_train / jamba_train train them (4 steps of 8 x 4096, the first a
    warm-up outside the runtime log's median), each step's wall and CPU
    seconds beside what ``nvidia-smi`` sampled during it."""
    import torch
    import chip_smoke as CS
    from repro_torch.launch import train as T
    arch = SSM_TRAIN[step]
    out = {"label": label, "arch": arch, "card": CS.nvidia_smi()}
    history, samples, stop = StepStamps(), [], threading.Event()
    sampler = threading.Thread(target=smi_sampler, args=(stop, samples))
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "runtime.jsonl")
        sampler.start()
        t0, cpu0 = time.perf_counter(), time.process_time()
        try:
            losses = T.run(arch, CS.SSM_TRAIN_STEPS, CS.SSM_TRAIN_B,
                           CS.SSM_TRAIN_S, smoke=False, device="cuda",
                           runtime_log=log, history=history)
        finally:
            stop.set()
            sampler.join()
        rec = json.loads(open(log).read().splitlines()[-1])
    out.update(median_step_s=rec["median_step_s"], losses=losses,
               peak_device_bytes=torch.cuda.max_memory_allocated(),
               steps=step_table(t0, cpu0, history, samples))
    return out


def serve(label, arch):
    import torch
    from repro_torch.launch import serve as S
    S.run(arch, 8, 2048, 4, smoke=False, device="cuda")       # warm-up
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "runtime.jsonl")
        S.run(arch, 8, 2048, 64, smoke=False, device="cuda",
              runtime_log=log)
        rec = json.loads(open(log).read().splitlines()[-1])
    return {"label": label, "arch": arch, "prefill_ms": rec["prefill_s"] * 1e3,
            "decode_ms_per_token": rec["decode_median_s"] * 1e3}


def one(src, label, what):
    """One step in this process, with ``src``'s repro_torch."""
    sys.path[:0] = [os.path.abspath(src), ROOT]
    step = {"gbm": gbm, "kernels": kernels, "flash": flash,
            "train": train, "recurrences": recurrences, "mla": mla,
            "mla_bwd": mla_bwd, "train_profile": train_profile}.get(what)
    if what in SSM_TRAIN:
        res = ssm_train(label, what)
    else:
        res = step(label) if step else serve(label, what)
    print(json.dumps(res), flush=True)
    return 0


def main(argv):
    if len(argv) == 4 and argv[0] == "--one":
        return one(*argv[1:])
    steps = ("gbm", "kernels") + ARCHS
    if len(argv) >= 4 and argv[0] == "--only":
        steps, argv = tuple(argv[1].split(",")), argv[2:]
    if not 2 <= len(argv) <= 26:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    order = list(range(len(argv))) + list(reversed(range(len(argv))))
    for what in steps:
        for i in order:
            label = f"{chr(ord('A') + i)}:{argv[i]}"
            p = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--one", argv[i], label, what],
                               capture_output=True, text=True)
            line = (p.stdout.strip().splitlines() or [""])[-1]
            if p.returncode or not line.startswith("{"):
                print(p.stderr[-2000:], file=sys.stderr)
                rc = 1
            print(line, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
