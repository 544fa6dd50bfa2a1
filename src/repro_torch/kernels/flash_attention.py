"""Forward flash attention: the CUDA kernel's wrapper and its plain PyTorch
version.

``flash_attention(q, k, v)`` with q [B, S, H, hd], k [B, S, KV, hd] and
v [B, S, KV, hdv] returns [B, S, H, hdv] in q's type: softmax attention
computed in float32,
scores ``(q * scale) . k`` (scale hd**-0.5 by default), an optional logit
softcap ``cap * tanh(s / cap)``, a causal mask (k <= q), a sliding window
(k > q - window) and grouped KV heads (the kv head of query head h is
h // (H // KV)).  Masked scores take the finite NEG_INF = -2e38.  hdv is
hd (64, 128 or 256) but for MLA's prefill and training (minicpm3: q and k
heads of 96, the rope part shared by every head, v heads of 64), the pair
a bf16 kernel of its own computes (``HEAD_DIM_PAIRS``;
``tile_config(96, 64)`` reads its ``tc::MlaCfg``) and the backward
kernels take as instances of their own.  It is the
port of ``repro/kernels/flash_attention.py`` (the Pallas kernel), whose
oracle is ``repro/kernels/ref.py:attention_ref``.

A CUDA tensor always launches a hand-written kernel of
``csrc/flash_attention.cu`` and raises on what it does not take; a CPU
tensor uses ``flash_attention_plain``.  There is no fallback from one to
the other.  The dtype picks the kernel:

- bfloat16, the serving route: a Hopper kernel on the tensor cores (TMA
  loads into a ring of swizzled shared-memory stages, one producer thread,
  two consumer warpgroups running ``wgmma`` for Q.K^T and P.V).  Bound by
  the tensor cores' bf16 rate at the serving shapes.  It rounds P to bf16
  before P.V, a rounding the float32-inside Pallas kernel does not make.
  MLA's (96, 64) runs ``flash_fwd_mla_kernel``: three consumer warpgroups
  over 192-row q items, q and k in 64- and 32-column boxes, a persistent
  grid whose items in flight share their heads' K and V through L2.
- float32, the parity route: the first SIMT design, float32 FMAs out of
  shared memory, bound by the float32 pipe.  wgmma would take float32 only
  as TF32, which puts the float32 parity limits at risk.

Training needs a gradient (``kernels/csrc/flash_attention_bwd.cu``, the
port's own: no Pallas kernel has a backward).  ``flash_attention`` on a
CUDA tensor that requires grad goes through ``FlashAttention``, a
``torch.autograd.Function`` whose forward launches the kernel above with
an extra float32 log-sum-exp output ``lse [B, H, S]`` and whose backward
launches ``flash_bwd_delta`` (delta = rowsum(dO * O)), ``flash_bwd_dkdv``
and ``flash_bwd_dq``.  The dtype picks their kernels as it does the
forward's:

- bfloat16: Hopper kernels on the tensor cores (TMA into rings of
  swizzled stages, a producer warp, two consumer warpgroups running
  ``wgmma`` for all five products).  dkdv runs one block per key tile and
  *query* head; with G = H / KV > 1 it writes each head's dK and dV as
  float32 partials (dK's [B, S, H, hd] and dV's [B, S, H, hdv], one
  scratch buffer), and ``flash_bwd_dkdv_sum`` adds a group's heads in the
  order g = 0 .. G-1 and rounds once.  P and dS are rounded to bf16 before
  their products, as the forward rounds P.  MLA's (96, 64) runs kernels of
  its own, ``flash_bwd_dkdv_mla`` and ``flash_bwd_dq_mla``: persistent
  grids walking pairs of 128-key (128-row) items, each consumer
  warpgroup on its own 64 keys (rows) of an item end to end; q and k in
  three 32-column boxes with 64-byte swizzle, so that dK and dQ are one
  product of width 96 a step (``bwd_tc_config(96, 64)`` reads their
  ``tc::MlaDkdvCfg`` and ``tc::MlaDqCfg``).
- float32: the first SIMT design, float32 FMAs (dkdv one block per key
  tile and kv head, the group's heads summed in registers).

Without a gradient the forward launch is the serving one, with no ``lse``.
On the CPU autograd differentiates ``flash_attention_plain``;
``flash_attention_bwd_plain`` computes what the backward kernels compute,
float32 inside, for the tests and the card's checks.

``LAUNCHES`` counts forward launches, ``DELTA_LAUNCHES``,
``DKDV_LAUNCHES``, ``DKDV_SUM_LAUNCHES`` and ``DQ_LAUNCHES`` the
backward's, so that a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

import ctypes
import re
from pathlib import Path

import torch

NEG_INF = -2.0e38
HEAD_DIMS = (64, 128, 256)      # the kernel's instantiations at hdv = hd
# (q/k head dim, v head dim) of every forward instantiation: equal, or MLA's
HEAD_DIM_PAIRS = tuple((hd, hd) for hd in HEAD_DIMS) + ((96, 64),)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
H100_SMS = 132                  # bwd_schedule places blocks on these

LAUNCHES = 0
DELTA_LAUNCHES = 0
DKDV_LAUNCHES = 0
DKDV_SUM_LAUNCHES = 0
DQ_LAUNCHES = 0


def flash_attention_plain(q, k, v, *, causal=True, window=0, softcap=0.0,
                          scale=None) -> torch.Tensor:
    """The same function in plain PyTorch, float32 inside, out in q's type:
    the Pallas kernel's arithmetic (q scaled before the product) on
    ``ref.attention_ref``'s naive full score matrix."""
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5 if scale is None else scale
    qg = q.float().reshape(B, S, KV, G, hd) * scale
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones(S, Sk, dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    s = torch.where(ok, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def _scores(q, k, causal, window, softcap, scale):
    """The forward's scores of every (query, key) pair in the float32
    route's order, [B, KV, G, S, Sk]: (s, c, dtanh, ok) with s = (q * scale)
    . k, c = cap * tanh(s / cap) (s without a softcap), dtanh = 1 -
    tanh(s / cap)**2 (None without one) and ``ok`` the masks."""
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, S, KV, H // KV, hd) * scale
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    c, dt = s, None
    if softcap:
        t = torch.tanh(s / softcap)
        c, dt = softcap * t, 1.0 - t * t
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones(S, Sk, dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    return s, c, dt, ok


def flash_attention_lse_plain(q, k, *, causal=True, window=0, softcap=0.0,
                              scale=None) -> torch.Tensor:
    """float32 [B, H, S]: each query row's natural log-sum-exp of its
    masked, softcapped scores, which the kernel writes beside its output
    for the backward."""
    B, S, H, hd = q.shape
    scale = hd ** -0.5 if scale is None else scale
    _, c, _, ok = _scores(q, k, causal, window, softcap, scale)
    lse = torch.logsumexp(torch.where(ok, c, torch.tensor(
        NEG_INF, device=q.device)), dim=-1)
    return lse.reshape(B, H, S)


def flash_bwd_delta_plain(o, do) -> torch.Tensor:
    """delta [B, H, S] float32 = sum over hd of dO * O (``flash_bwd_delta``)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _probs_and_ds(q, k, v, do, lse, delta, causal, window, softcap, scale):
    """P recomputed from the saved LSE, and dS = P (dP - delta) dtanh, both
    [B, KV, G, S, Sk] float32; with the scaled q groups (head dim hd) and
    dO groups (v's head dim)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    s, c, dt, ok = _scores(q, k, causal, window, softcap, scale)
    rows = (B, KV, G, S, 1)
    p = torch.where(ok, torch.exp(c - lse.float().reshape(rows)),
                    torch.zeros((), device=q.device))
    dog = do.float().reshape(B, S, KV, G, do.shape[-1])
    dp = torch.einsum("bqkgh,bskh->bkgqs", dog, v.float())
    ds = p * (dp - delta.float().reshape(rows))
    if dt is not None:
        ds = ds * dt
    qg = q.float().reshape(B, S, KV, G, hd) * scale
    return p, ds, qg, dog


def flash_bwd_dkdv_plain(q, k, v, do, lse, delta, *, causal=True, window=0,
                         softcap=0.0, scale=None):
    """(dk, dv) in k's type (``flash_bwd_dkdv``): dV = sum_i P dO and dK =
    sum_i dS (q * scale) over the query rows and the group's heads."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    p, ds, qg, dog = _probs_and_ds(q, k, v, do, lse, delta, causal, window,
                                   softcap, scale)
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dog)
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dkdv_partials_plain(q, k, v, do, lse, delta, *, causal=True,
                                  window=0, softcap=0.0, scale=None):
    """(dK [B, S, H, hd], dV [B, S, H, hdv]) float32: each query head's own
    dK and dV, before a group's heads are added: what the bf16 dkdv kernel
    writes when G > 1."""
    B, S, H, hd = q.shape
    scale = hd ** -0.5 if scale is None else scale
    p, ds, qg, dog = _probs_and_ds(q, k, v, do, lse, delta, causal, window,
                                   softcap, scale)
    dv = torch.einsum("bkgqs,bqkgh->bskgh", p, dog)
    dk = torch.einsum("bkgqs,bqkgh->bskgh", ds, qg)
    return dk.reshape(B, S, H, hd), dv.reshape(B, S, H, v.shape[-1])


def flash_bwd_dkdv_sum_plain(part, kv_heads, dtype=torch.bfloat16):
    """(dk, dv) in ``dtype`` from the partials (dK [B, S, H, hd], dV
    [B, S, H, hdv]): a group's heads added in the order g = 0 .. G-1 in
    float32, rounded once."""
    out = []
    for t in part:
        B, S, H, d = t.shape
        p = t.float().reshape(B, S, kv_heads, H // kv_heads, d)
        acc = p[:, :, :, 0]
        for g in range(1, H // kv_heads):
            acc = acc + p[:, :, :, g]
        out.append(acc.to(dtype))
    return out[0], out[1]


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, causal=True, window=0,
                       softcap=0.0, scale=None) -> torch.Tensor:
    """dq in q's type (``flash_bwd_dq``): scale * sum_j dS k."""
    B, S, H, hd = q.shape
    scale = hd ** -0.5 if scale is None else scale
    _, ds, _, _ = _probs_and_ds(q, k, v, do, lse, delta, causal, window,
                                softcap, scale)
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.float()) * scale
    return dq.reshape(B, S, H, hd).to(q.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal=True, window=0,
                              softcap=0.0, scale=None):
    """(dq, dk, dv) of attention, from the forward's output ``o`` and log-
    sum-exp ``lse`` [B, H, S], as the three backward kernels compute them,
    in their order: delta = rowsum(dO * O); P = exp(c - lse) recomputed
    from the scores; dV; dP = dO . v; dS = P (dP - delta) times the
    softcap's 1 - tanh**2; dK; dQ.  float32 inside, out in the inputs'
    types."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    delta = flash_bwd_delta_plain(o, do)
    dk, dv = flash_bwd_dkdv_plain(q, k, v, do, lse, delta, **kw)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


def _constexprs(body, env) -> dict:
    """``static constexpr int NAME = expr;`` of a C++ struct body evaluated
    in order over ``env`` (integer division, C's a ? b : c)."""
    for name, expr in re.findall(r"static constexpr int (\w+) =\s*([^;]+);",
                                 body):
        expr = " ".join(expr.split())
        m = re.fullmatch(r"(.+?)\?(.+?):(.+)", expr)
        if m:                          # C's a ? b : c
            expr = f"({m[2]}) if ({m[1]}) else ({m[3]})"
        env[name] = int(eval(expr.replace("/", "//"), {}, env))
    return env


def _bwd_source() -> str:
    return (Path(__file__).parent / "csrc" /
            "flash_attention_bwd.cu").read_text()


def bwd_tile_config(hd, hdv=None) -> dict:
    """The float32 (SIMT) backward kernels' tiling at q/k head dim ``hd``
    and v head dim ``hdv`` (default ``hd``), read from ``Tiles<HDQK, HDV>``
    in ``csrc/flash_attention_bwd.cu``: BQ query rows a step, BK keys a
    tile, LD, LDV and PLD (padded rows, floats), NG and NGV (float4 column
    groups a thread), and the dynamic shared memory of a dkdv and a dq
    block in bytes."""
    body = re.search(r"struct Tiles \{(.*?)\n\};", _bwd_source(), re.S)[1]
    env = _constexprs(body, {"HDQK": hd, "HDV": hd if hdv is None else hdv})
    env["DKDV_SMEM"] = 4 * env["DKDV_FLOATS"]
    env["DQ_SMEM"] = 4 * env["DQ_FLOATS"]
    return env


def bwd_tc_config(hd, hdv=None) -> dict:
    """The bf16 (wgmma) backward kernels' tiling at q/k head dim ``hd`` and
    v head dim ``hdv`` (default ``hd``), read from ``tc::DkdvCfg<HDQK,
    HDV>`` and ``tc::DqCfg<HDQK, HDV>`` in the source: {"dkdv": {BK keys a
    block, BQ query rows a stage, NS stages, CHUNKS 64-column chunks of a
    q/k row, SMEM bytes of dynamic shared memory a block, ...}, "dq": {BQ
    rows a block, BK keys a stage, NS, SMEM, ...}}.  For MLA's (96, 64)
    its own kernels' ``tc::MlaDkdvCfg`` and ``tc::MlaDqCfg`` (NWG consumer
    warpgroups of 64 keys or rows; dkdv: BK keys an item, BQ query rows a
    stage; dq: BQ rows an item, BK keys a stage; CW columns of a q/k box,
    NS, SMEM, THREADS, the registers of producer and consumers, ...)."""
    tc = _bwd_source()
    tc = tc[tc.index("namespace tc {"):]
    hdv = hd if hdv is None else hdv
    env = {"HDQK": hd, "HDV": hdv}
    structs = (("dkdv", "MlaDkdvCfg"), ("dq", "MlaDqCfg")) \
        if (hd, hdv) == (96, 64) else (("dkdv", "DkdvCfg"), ("dq", "DqCfg"))
    return {name: _constexprs(re.search(
        rf"struct {struct} \{{(.*?)\n\}};", tc, re.S)[1], dict(env))
        for name, struct in structs}


def _mla_bwd_plan(S, causal, window) -> dict:
    """The bf16 (96, 64) kernels' plan (``flash_bwd_dkdv_mla`` and
    ``flash_bwd_dq_mla``) for one (batch, head), as their loops compute it:
    items of ITEM keys (dkdv) or query rows (dq), NWG warpgroups of 64
    each; "units", the pairs of items that a block of the persistent grid
    takes at once (tiles p and n - 1 - p, the causal mask's longer first;
    one item where they meet), in order; each item's stages (query rows of
    BQ, key tiles of BK) and each warpgroup's live ones, the range left
    when the stages that every mask empties for its own keys or rows are
    taken off both ends.  "blocks" lists (first key or row of a
    warpgroup, its live stages) for every warpgroup inside S, in the order
    the items run."""
    t = bwd_tc_config(96, 64)
    out = {"route": "wgmma"}
    for name in ("dkdv", "dq"):
        c = t[name]
        dkdv = name == "dkdv"
        item, step = (c["BK"], c["BQ"]) if dkdv else (c["BQ"], c["BK"])
        nt = -(-S // item)
        units = []
        for p in range((nt + 1) // 2):
            first = p if dkdv else nt - 1 - p
            units.append([first] + ([nt - 1 - first] if nt - 1 - p != p
                                    else []))
        items, blocks = [], []
        for x in (x for u in units for x in u):
            t0 = x * item
            if dkdv:
                lo = t0 if causal else 0
                hi = min(S, t0 + item - 1 + window) if window else S
            else:
                hi = min(S, t0 + item) if causal else S
                lo = max(0, t0 - window + 1) if window else 0
            stages = list(range(lo // step * step, hi, step))
            wgs = []
            for w in range(c["NWG"]):
                r0 = t0 + 64 * w

                def dead(u, r0=r0):
                    if r0 >= S:
                        return True
                    if dkdv:       # u: the stage's first query row
                        return (causal and u + step - 1 < r0) or \
                            (window and u - window >= r0 + 63)
                    return (causal and u > r0 + 63) or \
                        (window and u + step - 1 <= r0 - window)
                a, e = 0, len(stages)
                while a < e and dead(stages[a]):
                    a += 1
                while e > a and dead(stages[e - 1]):
                    e -= 1
                wgs.append((r0, stages[a:e]))
                if r0 < S:
                    blocks.append((r0, stages[a:e]))
            items.append({"t0": t0, "stages": stages, "warpgroups": wgs})
        out[name] = {"BQ": step if dkdv else item,
                     "BK": item if dkdv else step, "ITEM": item,
                     "NWG": c["NWG"], "units": [len(u) for u in units],
                     "items": items, "blocks": blocks}
    return out


def bwd_plan(S, hd, causal, window, dtype=torch.float32, hdv=None) -> dict:
    """The backward kernels' launch plan along the sequence for ``dtype``'s
    route, as their loops compute it: {"route": "simt" or "wgmma", "dkdv":
    {"BQ", "BK", "blocks": [(k0, [first rows of the query tiles it
    visits]), ...]}, "dq": {"BQ", "BK", "blocks": [(q0, [first keys of the
    key tiles it visits]), ...] in launch order}}.  A simt dkdv block covers
    every query head of a kv group; a wgmma one a single query head.  The
    bf16 (96, 64) route's persistent kernels: ``_mla_bwd_plan``."""
    if dtype == torch.bfloat16 and (hd, hd if hdv is None else hdv) == \
            (96, 64):
        return _mla_bwd_plan(S, causal, window)
    if dtype == torch.bfloat16:
        t = bwd_tc_config(hd, hdv)
        tiles = {n: (t[n]["BQ"], t[n]["BK"]) for n in ("dkdv", "dq")}
        route = "wgmma"
    else:
        t = bwd_tile_config(hd, hdv)
        tiles = dict.fromkeys(("dkdv", "dq"), (t["BQ"], t["BK"]))
        route = "simt"
    BQ, BK = tiles["dkdv"]
    dkdv = []
    for k0 in range(0, S, BK):
        q_lo = k0 if causal else 0
        q_hi = min(S, k0 + BK - 1 + window) if window else S
        dkdv.append((k0, list(range(q_lo // BQ * BQ, q_hi, BQ))))
    BQ2, BK2 = tiles["dq"]
    nq = -(-S // BQ2)
    dq = []
    for x in range(nq):
        q0 = (nq - 1 - x) * BQ2
        k_hi = min(S, q0 + BQ2) if causal else S
        k_lo = max(0, q0 - window + 1) if window else 0
        dq.append((q0, list(range(k_lo // BK2 * BK2, k_hi, BK2))))
    return {"route": route,
            "dkdv": {"BQ": BQ, "BK": BK, "blocks": dkdv},
            "dq": {"BQ": BQ2, "BK": BK2, "blocks": dq}}


def bwd_schedule(S, hd, causal, window, B, H, KV, dtype, hdv=None) -> dict:
    """Blocks and makespan of each backward launch, in tile steps (one
    step: a query tile of a dkdv block, a key tile of a dq block, 4096
    pairs at 64 x 64; a simt dkdv block takes G steps a query tile): the
    blocks in launch order, each to the SM that frees first, one block an
    SM (shared memory allows no second).  The bf16 (96, 64) kernels are
    persistent: min(units, 132) blocks, block x taking units x, x + 132,
    ... of the (batch, head)-major order, an item costing its warpgroups'
    live stages; with "items", "units" and "longest" (the costliest
    item)."""
    import heapq
    plan = bwd_plan(S, hd, causal, window, dtype, hdv)
    G = H // KV
    if "units" in plan["dkdv"]:
        out = {}
        for name in ("dkdv", "dq"):
            p = plan[name]
            cost = [sum(len(s) for _, s in it["warpgroups"])
                    for it in p["items"]]
            each = iter(cost)
            units = [sum(next(each) for _ in range(n))
                     for n in p["units"]] * (B * H)
            grid = min(H100_SMS, len(units))
            load = [0] * grid
            for u, c in enumerate(units):
                load[u % grid] += c
            out[name] = {"blocks": grid, "items": len(cost) * B * H,
                         "units": len(units), "steps": sum(units),
                         "longest": max(cost), "makespan": max(load)}
        return out
    if plan["route"] == "wgmma":      # key / query tiles slowest
        dkdv = [len(t) for _, t in plan["dkdv"]["blocks"]
                for _ in range(B * H)]
        dq = [len(t) for _, t in plan["dq"]["blocks"] for _ in range(B * H)]
    else:                             # grid (tiles, heads, B), x fastest
        dkdv = [G * len(t) for _ in range(B * KV)
                for _, t in plan["dkdv"]["blocks"]]
        dq = [len(t) for _ in range(B * H) for _, t in plan["dq"]["blocks"]]
    out = {}
    for name, costs in (("dkdv", dkdv), ("dq", dq)):
        free = [0] * min(H100_SMS, len(costs))
        for c in costs:
            heapq.heappush(free, heapq.heappop(free) + c)
        out[name] = {"blocks": len(costs), "steps": sum(costs),
                     "longest": max(costs), "makespan": max(free)}
    return out


def tile_config(hd, hdv=None) -> dict:
    """The bf16 kernel's tiling at q/k head dim ``hd`` and v head dim
    ``hdv`` (default ``hd``), read from its source: ``tc::Cfg<hd, hdv>``'s
    constants (BK keys per stage, NS stages, SMEM bytes of dynamic shared
    memory a block, ...) with HD (= hd), HDQK, HDV and kBQ, the query rows
    of a block; for MLA's (96, 64) ``tc::MlaCfg``'s (NWG consumer
    warpgroups, BQ query rows an item, BK, NS, the box sizes, SMEM, ...)."""
    src = (Path(__file__).parent / "csrc" / "flash_attention.cu").read_text()
    tc = src[src.index("namespace tc {"):]
    hdv = hd if hdv is None else hdv
    if (hd, hdv) == (96, 64):
        return _constexprs(re.search(r"struct MlaCfg \{(.*?)\n\};", tc,
                                     re.S)[1], {"HDQK": hd, "HDV": hdv})
    env = {"HD": hd, "HDQK": hd, "HDV": hdv,
           "kBQ": int(re.search(r"constexpr int kBQ = (\d+);", tc)[1])}
    return _constexprs(re.search(r"struct Cfg \{(.*?)\n\};", tc, re.S)[1],
                       env)


def _check(q, k, v, window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.dtype not in DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    B, S, H, hd = q.shape
    KV, hdv = k.shape[2], v.shape[-1]
    if tuple(k.shape) != (B, S, KV, hd) or \
            tuple(v.shape) != (B, S, KV, hdv):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if (hd, hdv) not in HEAD_DIM_PAIRS:
        raise ValueError(f"head dims (q/k {hd}, v {hdv}) not among the "
                         f"kernel's {HEAD_DIM_PAIRS}")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} kv heads")
    if B > 65535 or H > 65535 or S >= 2 ** 31 - 128 \
            or -(-S // 128) * B * H >= 2 ** 31:
        raise ValueError(f"grid too large: B {B}, H {H}, S {S}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    return B, S, H, KV, hd


def _lib():
    from repro_torch.kernels.build import load
    fn = load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p]
    return fn


def _bwd_lib(fn_name):
    from repro_torch.kernels.build import load
    fn = getattr(load("flash_attention_bwd"), fn_name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        if fn_name == "flash_bwd_delta_launch":
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
        elif fn_name == "flash_bwd_dkdv_sum_launch":
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]
        else:
            n_ptr = 9 if fn_name == "flash_bwd_dkdv_launch" else 7
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_int, ctypes.c_void_p]
    return fn


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel failed to launch: CUDA error {rc}")


def _cuda_only(q, what):
    if q.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {q.device}")


def _forward(q, k, v, causal, window, softcap, scale, with_lse):
    """One launch of the forward kernel: (out, lse or None)."""
    global LAUNCHES
    B, S, H, KV, hd = _check(q, k, v, window)
    hdv = v.shape[-1]
    scale = hd ** -0.5 if scale is None else scale
    out = q.new_empty(B, S, H, hdv)
    lse = (torch.empty(B, H, S, dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B * S == 0:
        return out, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if with_lse else None, B, S, H, KV, hd, hdv,
                DTYPES[q.dtype], float(scale), int(causal), int(window),
                float(softcap), q.device.index or 0, stream)
    _raise_on(rc, "flash_attention")
    LAUNCHES += 1
    return out, lse


def flash_attention_lse(q, k, v, *, causal=True, window=0, softcap=0.0,
                        scale=None):
    """(out, lse): attention and each row's float32 log-sum-exp [B, H, S].
    On a CUDA tensor one launch of the forward kernel with its lse output;
    on a CPU tensor the plain versions."""
    if q.device.type == "cpu":
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        return (flash_attention_plain(q, k, v, **kw),
                flash_attention_lse_plain(q, k, **kw))
    _cuda_only(q, "flash_attention")
    return _forward(q, k, v, causal, window, softcap, scale, True)


def _check_bwd(q, k, v, do, lse, delta, window):
    """The forward's checks (``_check``: the head-dim pair among
    ``HEAD_DIM_PAIRS``), and do [B, S, H, hdv], lse and delta [B, H, S]."""
    B, S, H, KV, hd = _check(q, k, v, window)
    want = (B, S, H, v.shape[-1])
    if do.dtype != q.dtype or tuple(do.shape) != want \
            or not do.is_contiguous() or do.device != q.device:
        raise ValueError(f"do must be a contiguous {q.dtype} {want} on "
                         f"{q.device}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, S) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{(B, H, S)} on {q.device}")
    return B, S, H, KV, hd


def flash_bwd_delta(o, do) -> torch.Tensor:
    """delta [B, H, S] float32 = rowsum(dO * O): one launch of
    ``flash_bwd_delta`` on a CUDA tensor, the plain version on the CPU."""
    global DELTA_LAUNCHES
    if o.device.type == "cpu":
        return flash_bwd_delta_plain(o, do)
    _cuda_only(o, "flash_bwd_delta")
    if o.dtype not in DTYPES or do.dtype != o.dtype or do.shape != o.shape \
            or not (o.is_contiguous() and do.is_contiguous()) \
            or o.dim() != 4 or do.device != o.device:
        raise ValueError("o and do must be contiguous [B, S, H, hd] tensors "
                         "of one type, float32 or bfloat16")
    B, S, H, hd = o.shape
    delta = torch.empty(B, H, S, dtype=torch.float32, device=o.device)
    if B * S * H == 0:
        return delta
    stream = torch.cuda.current_stream(o.device).cuda_stream
    rc = _bwd_lib("flash_bwd_delta_launch")(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(), B, S, H, hd,
        DTYPES[o.dtype], o.device.index or 0, stream)
    _raise_on(rc, "flash_bwd_delta")
    DELTA_LAUNCHES += 1
    return delta


def _launch_dkdv(q, k, v, do, lse, delta, outs, kw):
    """One launch of the dkdv kernel into ``outs``: (dk, dv), or the bf16
    route's float32 partials, one buffer of dK's [B, S, H, hd] then dV's
    [B, S, H, hdv]."""
    global DKDV_LAUNCHES
    B, S, H, KV, hd = _check_bwd(q, k, v, do, lse, delta, kw["window"])
    scale = hd ** -0.5 if kw["scale"] is None else kw["scale"]
    part = outs if isinstance(outs, torch.Tensor) else None
    if q.dtype == torch.bfloat16 and H != KV and part is None:
        raise ValueError("bf16 with H > KV writes per-head partials")
    ptrs = [None, None, part.data_ptr()] if part is not None else \
        [outs[0].data_ptr(), outs[1].data_ptr(), None]
    if B * S == 0:
        return
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _bwd_lib("flash_bwd_dkdv_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *ptrs, B, S, H, KV, hd,
        v.shape[-1], DTYPES[q.dtype], float(scale), int(kw["causal"]),
        int(kw["window"]),
        float(kw["softcap"]), q.device.index or 0, stream)
    _raise_on(rc, "flash_bwd_dkdv")
    DKDV_LAUNCHES += 1


def flash_bwd_dkdv_partials(q, k, v, do, lse, delta, *, causal=True,
                            window=0, softcap=0.0, scale=None):
    """(dK [B, S, H, hd], dV [B, S, H, hdv]) float32, each query head's dK
    and dV before its group is summed: one launch of the bf16
    ``flash_bwd_dkdv`` kernel on a CUDA tensor, which writes both into one
    buffer (dV's after dK's), ``flash_bwd_dkdv_partials_plain`` on the
    CPU."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return flash_bwd_dkdv_partials_plain(q, k, v, do, lse, delta, **kw)
    _cuda_only(q, "flash_bwd_dkdv")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the partials are the bf16 route's, got {q.dtype}")
    B, S, H, hd = q.shape
    hdv = v.shape[-1]
    buf = torch.empty(B * S * H * (hd + hdv), dtype=torch.float32,
                      device=q.device)
    _launch_dkdv(q, k, v, do, lse, delta, buf, kw)
    n = B * S * H * hd
    return buf[:n].view(B, S, H, hd), buf[n:].view(B, S, H, hdv)


def flash_bwd_dkdv_sum(part, kv_heads):
    """(dk, dv) in bf16 from the partials (dK [B, S, H, hd], dV [B, S, H,
    hdv]): one launch of ``flash_bwd_dkdv_sum`` on a CUDA tensor,
    ``flash_bwd_dkdv_sum_plain`` on the CPU."""
    global DKDV_SUM_LAUNCHES
    pk, pv = part
    if pk.device.type == "cpu":
        return flash_bwd_dkdv_sum_plain(part, kv_heads)
    _cuda_only(pk, "flash_bwd_dkdv_sum")
    if any(t.dtype != torch.float32 or t.dim() != 4 or not t.is_contiguous()
           or t.device != pk.device for t in part) \
            or pk.shape[:3] != pv.shape[:3] or kv_heads < 1 \
            or pk.shape[2] % kv_heads \
            or (pk.shape[3], pv.shape[3]) not in HEAD_DIM_PAIRS:
        raise ValueError("part must be contiguous float32 [B, S, H, hd] and "
                         "[B, S, H, hdv] with H a multiple of kv_heads and "
                         f"(hd, hdv) among {HEAD_DIM_PAIRS}, summed into "
                         "bf16")
    B, S, H, hd = pk.shape
    hdv = pv.shape[3]
    dk = torch.empty(B, S, kv_heads, hd, dtype=torch.bfloat16,
                     device=pk.device)
    dv = torch.empty(B, S, kv_heads, hdv, dtype=torch.bfloat16,
                     device=pk.device)
    if B * S == 0:
        return dk, dv
    stream = torch.cuda.current_stream(pk.device).cuda_stream
    rc = _bwd_lib("flash_bwd_dkdv_sum_launch")(
        pk.data_ptr(), pv.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S,
        kv_heads, H // kv_heads, hd, hdv, pk.device.index or 0, stream)
    _raise_on(rc, "flash_bwd_dkdv_sum")
    DKDV_SUM_LAUNCHES += 1
    return dk, dv


def flash_bwd_dkdv(q, k, v, do, lse, delta, *, causal=True, window=0,
                   softcap=0.0, scale=None):
    """(dk, dv) on a CUDA tensor: one launch of ``flash_bwd_dkdv``, and in
    bf16 with more query heads than kv heads its partials summed by one
    launch of ``flash_bwd_dkdv_sum``; the plain version on the CPU."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return flash_bwd_dkdv_plain(q, k, v, do, lse, delta, **kw)
    _cuda_only(q, "flash_bwd_dkdv")
    if q.dtype == torch.bfloat16 and q.shape[2] != k.shape[2]:
        return flash_bwd_dkdv_sum(flash_bwd_dkdv_partials(
            q, k, v, do, lse, delta, **kw), k.shape[2])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_dkdv(q, k, v, do, lse, delta, (dk, dv), kw)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal=True, window=0,
                 softcap=0.0, scale=None) -> torch.Tensor:
    """dq: one launch of ``flash_bwd_dq`` on a CUDA tensor, the plain
    version on the CPU."""
    global DQ_LAUNCHES
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    _cuda_only(q, "flash_bwd_dq")
    B, S, H, KV, hd = _check_bwd(q, k, v, do, lse, delta, window)
    scale = hd ** -0.5 if scale is None else scale
    dq = torch.empty_like(q)
    if B * S == 0:
        return dq
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _bwd_lib("flash_bwd_dq_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, S, H, KV, hd,
        v.shape[-1], DTYPES[q.dtype], float(scale), int(causal), int(window),
        float(softcap), q.device.index or 0, stream)
    _raise_on(rc, "flash_bwd_dq")
    DQ_LAUNCHES += 1
    return dq


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=0,
                        softcap=0.0, scale=None):
    """(dq, dk, dv) from the forward's ``o`` and ``lse``: the three backward
    launches on a CUDA tensor, ``flash_attention_bwd_plain`` on the CPU."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    # every check before the first launch (delta will have lse's shape)
    _check_bwd(q, k, v, do, lse, lse, window)
    delta = flash_bwd_delta(o, do)
    dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, **kw)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention on the card with a gradient: the forward kernel with its
    lse output, then the three backward kernels.  CUDA tensors only."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        o, lse = _forward(q, k, v, causal, window, softcap, scale, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None) -> torch.Tensor:
    """Attention [B, S, H, hd] in q's type.  On a CUDA tensor this launches
    the kernel on the current stream, through ``FlashAttention`` when an
    input requires grad; on a CPU tensor it is ``flash_attention_plain``,
    which autograd differentiates."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap, scale)
    return _forward(q, k, v, causal, window, softcap, scale, False)[0]
