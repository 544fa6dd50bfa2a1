"""The flash-attention backward on the CPU: ``flash_attention_bwd_plain``
against autograd of ``flash_attention_plain`` and against ``jax.vjp`` of
``repro.kernels.ref.attention_ref`` (windows, softcap, G 1/2/4/8, ragged
and non-causal S, and MLA's q/k head 96 with v head 64), the log-sum-exp
the forward kernel writes, and a CPU replay of both routes' launch plans
(tiles read from ``Tiles<HDQK, HDV>``, ``tc::DkdvCfg`` and ``tc::DqCfg``
in the CUDA source at equal head dims, and ``tc::MlaDkdvCfg`` and
``tc::MlaDqCfg`` of the bf16 (96, 64) kernels): which query tiles a key
tile's dkdv block visits and which key tiles a query tile's dq block
visits under the masks (at (96, 64) in bf16: the persistent kernels'
128-key and 128-row items, each warpgroup's live stages and the pairs of
items a block takes); dK / dV summed per kv group over (head, query
tile) in the simt kernel's order, or per query head into float32 partials
that are then added in head order (the wgmma route); the blocks and
makespan of each launch at the training shape; and the wgmma route's
bf16 roundings of P and dS against the card's bf16 bound.

Inputs are seeded with numpy.  Tolerances: float32 throughout, sums in
another order, so 2e-5 absolute plus 1e-4 relative on gradients of order
1; the replay of the plan 1e-5 relative in norm against the plain version,
and a control that leaves out one visited tile (or one head's partial)
must miss that by far; the bf16 roundings within 5e-3 relative, the card
tests' bound, which P and dS in fp8 must exceed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import attention_ref
from repro_torch.kernels import flash_attention as FA

ATOL, RTOL = 2e-5, 1e-4

CASES = [
    # (B, S, H, KV, hd, causal, window, cap[, hdv: v's head dim, else hd])
    (2, 37, 4, 2, 32, True, 0, 0.0),        # G 2, ragged
    (1, 50, 4, 1, 16, True, 8, 30.0),       # G 4, window, softcap
    (2, 20, 2, 2, 8, False, 0, 0.0),        # G 1, non-causal
    (1, 33, 8, 2, 16, False, 5, 10.0),      # non-causal with a window
    (1, 70, 8, 1, 16, True, 17, 0.0),       # G 8
    (1, 1, 4, 1, 8, True, 0, 0.0),          # S = 1
    # MLA's (96, 64): heads of one group each, grouped, masks, softcap
    (1, 45, 3, 3, 96, True, 0, 0.0, 64),
    (2, 29, 4, 2, 96, True, 9, 30.0, 64),
    (1, 24, 2, 1, 96, False, 0, 0.0, 64),
]


def _hdv(case):
    return case[8] if len(case) > 8 else case[4]


def _inputs(case, seed=0):
    B, S, H, KV, hd = case[:5]
    hdv = _hdv(case)
    rng = np.random.default_rng(seed + S)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hdv), (B, S, H, hdv))]


def _kw(case):
    return dict(causal=case[5], window=case[6], softcap=case[7])


def _plain_bwd(case, arrays):
    q, k, v, do = (torch.tensor(a) for a in arrays)
    kw = _kw(case)
    o = FA.flash_attention_plain(q, k, v, **kw)
    lse = FA.flash_attention_lse_plain(q, k, **kw)
    return FA.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw), (o, lse)


@pytest.mark.parametrize("case", CASES)
def test_bwd_plain_matches_autograd_of_plain(case):
    arrays = _inputs(case)
    got, _ = _plain_bwd(case, arrays)
    q, k, v = (torch.tensor(a).requires_grad_() for a in arrays[:3])
    out = FA.flash_attention_plain(q, k, v, **_kw(case))
    want = torch.autograd.grad(out, (q, k, v), torch.tensor(arrays[3]))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", CASES)
def test_bwd_plain_matches_jax_grad_of_attention_ref(case):
    """``attention_ref`` takes one head dim; at hdv < hd, v and dO are
    zero-padded to hd: the padded output columns are zero and take no
    gradient, so dq and dk are unchanged and dv's first hdv columns are
    the unpadded dv."""
    arrays = _inputs(case, 1)
    got, _ = _plain_bwd(case, arrays)
    hd, hdv = case[4], _hdv(case)
    pad = [(0, 0)] * 3 + [(0, hd - hdv)]
    q, k, v, do = (jnp.asarray(np.pad(a, pad) if i >= 2 else a)
                   for i, a in enumerate(arrays))
    grads = jax.jit(lambda q, k, v, do: jax.vjp(
        lambda q, k, v: attention_ref(q, k, v, **_kw(case)), q, k, v)[1](do))
    want = list(grads(q, k, v, do))
    want[2] = np.asarray(want[2])[..., :hdv]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("case", CASES)
def test_lse_reproduces_the_forward(case):
    """P = exp(c - lse) over the kept pairs gives the forward's output:
    the lse is what the backward needs."""
    q, k, v, _ = (torch.tensor(a) for a in _inputs(case))
    kw = _kw(case)
    lse = FA.flash_attention_lse_plain(q, k, **kw)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    _, c, _, ok = FA._scores(q, k, kw["causal"], kw["window"], kw["softcap"],
                             hd ** -0.5)
    p = torch.where(ok, torch.exp(c - lse.reshape(B, KV, H // KV, S, 1)),
                    torch.zeros(()))
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v).reshape(B, S, H, _hdv(case))
    torch.testing.assert_close(o, FA.flash_attention_plain(q, k, v, **kw),
                               atol=ATOL, rtol=RTOL)


def test_bwd_tile_config_read_from_the_source():
    """The SIMT kernels' tiles at every head-dim pair; at (96, 64) q/k rows
    of 100 floats, v rows of 68, two float4 column groups a thread for q/k
    (the second over columns 64-95 only: 16 + 8 threads of a row group
    cover 96 columns once) and one for v."""
    for hd, hdv in FA.HEAD_DIM_PAIRS:
        t = FA.bwd_tile_config(hd, hdv)
        assert t["BQ"] == 64 and t["BK"] == (32 if hd == 256 else 64)
        assert t["LD"] == hd + 4 and t["LDV"] == hdv + 4
        assert t["PLD"] == t["BK"] + 1
        assert t["NGV"] == hdv // 64
        # thread tc's group gg: columns 64 gg + 4 tc .. + 3 inside the row
        cols = [64 * gg + 4 * tc + e for gg in range(t["NG"])
                for tc in range(16) for e in range(4) if 64 * gg + 4 * tc < hd]
        assert sorted(cols) == list(range(hd))
        # a block's shared memory fits what Hopper gives one block
        assert max(t["DKDV_SMEM"], t["DQ_SMEM"]) <= 232448
    assert FA.bwd_tile_config(96, 64)["NG"] == 2


@pytest.mark.parametrize("hd,hdv", [(64, 64), (128, 128), (256, 256),
                                    (96, 64)])
def test_bwd_tc_config_read_from_the_source(hd, hdv):
    """The bf16 kernels' tiles, read from ``tc::DkdvCfg`` / ``tc::DqCfg``:
    64 keys a dkdv block over 64-row query stages, 128 rows a dq block
    (two warpgroups of 64) over 32 or 64 keys a stage, in column chunks of
    64 columns (128 bytes).  MLA's (96, 64) has kernels of its own
    (``tc::MlaDkdvCfg`` / ``tc::MlaDqCfg``): dkdv items of 128 keys on two
    consumer warpgroups over 64-row Q/dO stages, dq items of 64 rows a
    consumer warpgroup over 64-key K/V stages, q and k in three 32-column
    (64-byte) boxes, and the registers setmaxnreg hands out within the
    SM's 65,536.  wgmma's shapes (rows of 64, widths a multiple of 16); the
    bytes of every tile a multiple of 1024 (the 128-byte swizzle's atom,
    twice the 64-byte one's), and the shared memory within what Hopper
    gives one block."""
    t = FA.bwd_tc_config(hd, hdv)
    kv, dq = t["dkdv"], t["dq"]
    assert kv["NS"] >= 2 and dq["NS"] >= 2
    for c in (kv, dq):
        assert c["BQ"] % 64 == 0 and c["BK"] % 16 == 0
        for n in ("Q_BYTES", "G_BYTES", "K_BYTES", "V_BYTES"):
            assert c[n] % 1024 == 0, n
        assert c["SMEM"] <= 232448
    if (hd, hdv) == (96, 64):
        assert (kv["NWG"], kv["BK"], kv["BQ"]) == (2, 128, 64)
        assert (dq["NWG"], dq["BQ"], dq["BK"]) == (2, 128, 64)
        for c in (kv, dq):
            assert (c["HDQK"], c["HDV"], c["CW"], c["CHUNKS"]) == \
                (96, 64, 32, 3)
            assert c["THREADS"] == 128 * (c["NWG"] + 1)
            assert (c["PRODUCER_REGS"], c["CONSUMER_REGS"]) == (40, 232)
            assert 128 * (c["PRODUCER_REGS"] + c["NWG"] *
                          c["CONSUMER_REGS"]) <= 65536
        assert (kv["K_BYTES"], kv["V_BYTES"]) == (128 * 192, 128 * 128)
        assert kv["SMEM"] == 1024 + kv["K_BYTES"] + kv["V_BYTES"] + \
            kv["NS"] * (kv["Q_BYTES"] + kv["G_BYTES"] + kv["L_BYTES"]) + \
            kv["BAR_BYTES"]
        assert dq["STAGE_BYTES"] == dq["K_BYTES"] + dq["V_BYTES"]
        assert dq["SMEM"] == 1024 + dq["Q_BYTES"] + dq["G_BYTES"] + \
            dq["NS"] * dq["STAGE_BYTES"] + dq["BAR_BYTES"]
        # the source header's 123 and 121 KB
        assert round(kv["SMEM"] / 1024) == 123
        assert round(dq["SMEM"] / 1024) == 121
        return
    assert (kv["BK"], kv["BQ"]) == (64, 64)
    assert (dq["BQ"], dq["BK"]) == (128, 32 if hd == 256 else 64)
    assert kv["CHUNKS"] == dq["CHUNKS"] == hd // 64
    assert (kv["K_BYTES"], kv["V_BYTES"]) == (128 * hd, 128 * hdv)
    assert kv["X_BYTES"] == 4 * kv["BK"] * kv["BQ"]    # float32 P dtanh
    assert kv["SMEM"] == 1024 + kv["K_BYTES"] + kv["V_BYTES"] + kv["NS"] * \
        (kv["Q_BYTES"] + kv["G_BYTES"]) + kv["X_BYTES"] + \
        kv["NS"] * kv["L_BYTES"] + kv["BAR_BYTES"]
    assert dq["SMEM"] == 1024 + dq["Q_BYTES"] + dq["G_BYTES"] + dq["NS"] * \
        (dq["K_BYTES"] + dq["V_BYTES"]) + dq["BAR_BYTES"]
    # hd 256: K, V, two Q/dO stages and the exchange as the header says
    if hd == 256:
        assert round(kv["SMEM"] / 1024) == 210 and \
            round(dq["SMEM"] / 1024) == 193


ROUTES = [torch.float32, torch.bfloat16]
PLAN_CASES = [
    # (S, hd, hdv, causal, window)
    (300, 256, 256, True, 0), (300, 256, 256, True, 40),
    (257, 64, 64, True, 128), (200, 128, 128, False, 0),
    (130, 64, 64, False, 17), (64, 128, 128, True, 1), (1, 64, 64, True, 0),
    (300, 96, 64, True, 0), (257, 96, 64, True, 100), (130, 96, 64, False, 0),
    # the (96, 64) bf16 items: the last item's second warpgroup past S, a
    # window that ends inside the second warpgroup's keys
    (1050, 96, 64, True, 0), (1000, 96, 64, True, 100),
]


def _tiles(plan, name):
    """(query rows, keys) of a plan's block entry: a block's tiles, or at
    the bf16 (96, 64) one warpgroup's 64 keys (dkdv) or rows (dq) against
    a stage."""
    p = plan[name]
    if "items" not in p:
        return p["BQ"], p["BK"]
    return (p["BQ"], 64) if name == "dkdv" else (64, p["BK"])


@pytest.mark.parametrize("dtype", ROUTES)
@pytest.mark.parametrize("S,hd,hdv,causal,window", PLAN_CASES)
def test_bwd_plan_covers_every_kept_pair(S, hd, hdv, causal, window, dtype):
    """Every (query, key) pair the masks keep lies in exactly one tile pair
    that a dkdv block visits for each query head (the simt block loops over
    its group's heads, the wgmma block is one head's; at the bf16 (96, 64)
    one warpgroup's keys) and in exactly one that a dq block visits; each
    key tile and each query tile has one block, query tiles launched
    longest causal rows first (at the bf16 (96, 64) the longest item
    first)."""
    plan = FA.bwd_plan(S, hd, causal, window, dtype, hdv)
    assert plan["route"] == ("wgmma" if dtype == torch.bfloat16 else "simt")
    qp, kp = np.arange(S)[:, None], np.arange(S)[None, :]
    ok = np.ones((S, S), bool)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    for name in ("dkdv", "dq"):
        BQ, BK = _tiles(plan, name)
        seen = np.zeros((S, S), int)
        for t0, tiles in plan[name]["blocks"]:
            for u0 in tiles:
                q0, k0 = (u0, t0) if name == "dkdv" else (t0, u0)
                seen[q0:q0 + BQ, k0:k0 + BK] += 1
        assert (seen[ok] == 1).all(), name
    BK = _tiles(plan, "dkdv")[1]
    keys = [k0 for k0, _ in plan["dkdv"]["blocks"]]
    BQ = _tiles(plan, "dq")[0]
    dq_rows = [q0 for q0, _ in plan["dq"]["blocks"]]
    assert sorted(dq_rows) == list(range(0, S, BQ))
    if "items" in plan["dq"]:
        assert sorted(keys) == list(range(0, S, BK))
        item = plan["dq"]["ITEM"]
        assert plan["dq"]["items"][0]["t0"] == (S - 1) // item * item
        assert plan["dkdv"]["items"][0]["t0"] == 0
    else:
        assert keys == list(range(0, S, BK))
        assert dq_rows[0] == (S - 1) // BQ * BQ
    if causal:                 # no tile entirely above the diagonal
        BQ = plan["dkdv"]["BQ"]
        for k0, q_tiles in plan["dkdv"]["blocks"]:
            assert all(q0 + BQ - 1 >= k0 for q0 in q_tiles)


def _mla_seen(plan, name, S, drop=None):
    """How often each (query, key) pair lies in a live stage of a warpgroup
    of the bf16 (96, 64) plan's items; ``drop`` (item, warpgroup) leaves
    out that warpgroup's last live stage (a control)."""
    p = plan[name]
    seen = np.zeros((S, S), int)
    for x, it in enumerate(p["items"]):
        for w, (r0, live) in enumerate(it["warpgroups"]):
            if (x, w) == drop:
                live = live[:-1]
            for u0 in live:
                if name == "dkdv":
                    seen[u0:u0 + p["BQ"], r0:r0 + 64] += 1
                else:
                    seen[r0:r0 + 64, u0:u0 + p["BK"]] += 1
    return seen


@pytest.mark.parametrize("S,causal,window", [
    (4096, True, 0), (1050, True, 0), (1000, True, 100), (700, True, 100),
    (2048, True, 0), (300, False, 0), (129, False, 40), (1, True, 0)])
def test_mla_bwd_items_warpgroups_and_order_cover_each_kept_pair_once(
        S, causal, window):
    """The bf16 (96, 64) kernels' persistent plan: the units (pairs of
    tiles p and n - 1 - p, the causal mask's longer first, one item where
    they meet) take every item of a (batch, head) once; each warpgroup's
    live stages cover every kept pair of its 64 keys (dkdv) or rows (dq)
    exactly once, and the stages it skips hold no kept pair (nor does any
    warpgroup past S); a plan that drops one warpgroup's last live stage
    misses kept pairs.  The schedule's steps are the live warpgroup
    stages."""
    plan = FA.bwd_plan(S, 96, causal, window, torch.bfloat16, 64)
    qp, kp = np.arange(S)[:, None], np.arange(S)[None, :]
    ok = np.ones((S, S), bool)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    for name in ("dkdv", "dq"):
        p = plan[name]
        item = p["ITEM"]
        nt = -(-S // item)
        t0s = [it["t0"] for it in p["items"]]
        assert sorted(t0s) == [x * item for x in range(nt)]
        assert sum(p["units"]) == nt and p["units"].count(1) == nt % 2
        assert len(p["units"]) == (nt + 1) // 2
        x = 0
        for n in p["units"]:
            pair = t0s[x:x + n]
            assert sum(pair) == (nt - 1) * item if n == 2 else \
                pair[0] == (nt - 1) // 2 * item
            if causal and n == 2:      # the longer first
                assert (pair[0] < pair[1]) == (name == "dkdv")
            x += n
        seen = _mla_seen(plan, name, S)
        assert (seen[ok] == 1).all(), name
        assert seen.max() <= 1
        for it in p["items"]:
            for r0, live in it["warpgroups"]:
                for u0 in it["stages"]:
                    rows, keys = (slice(u0, u0 + p["BQ"]),
                                  slice(r0, r0 + 64)) if name == "dkdv" \
                        else (slice(r0, r0 + 64), slice(u0, u0 + p["BK"]))
                    assert bool(ok[rows, keys].any()) == (u0 in live), \
                        (name, r0, u0)
                if r0 >= S:
                    assert live == []
        # the control: one warpgroup's last live stage left out
        x, w = next((x, w) for x, it in enumerate(p["items"])
                    for w, (_, live) in enumerate(it["warpgroups"]) if live)
        assert (_mla_seen(plan, name, S, drop=(x, w))[ok] == 0).any(), name
        sched = FA.bwd_schedule(S, 96, causal, window, 1, 1, 1,
                                torch.bfloat16, 64)[name]
        assert sched["steps"] == sum(len(live) for it in p["items"]
                                     for _, live in it["warpgroups"])
        assert sched["items"] == nt and sched["units"] == len(p["units"])


def test_bwd_schedule_fills_the_card_at_the_training_shape():
    """The source header's block counts and makespans (tile steps of 4096
    pairs on 132 SMs) at gemma3-1b's training microbatch: the wgmma dkdv
    launch splits a kv group's 4 heads over 512 blocks, so that its
    longest block is 64 steps and its makespan within 2% of the ideal
    (steps / 132); the simt one, 256 blocks of 4 heads each, took 256."""
    B, S, H, KV, hd = 2, 4096, 4, 1, 256
    got = {w: FA.bwd_schedule(S, hd, True, w, B, H, KV, torch.bfloat16)
           for w in (0, 512)}
    assert got[0]["dkdv"] == {"blocks": 512, "steps": 16640, "longest": 64,
                              "makespan": 127}
    assert got[0]["dq"]["blocks"] == 256 and got[0]["dq"]["makespan"] == 128
    assert got[512]["dkdv"]["blocks"] == 512 and \
        got[512]["dkdv"]["makespan"] == 36
    assert got[512]["dq"]["makespan"] == 40
    for name in ("dkdv", "dq"):
        assert got[0][name]["makespan"] <= 1.02 * got[0][name]["steps"] / 132
    simt = FA.bwd_schedule(S, hd, True, 0, B, H, KV, torch.float32)
    assert simt["dkdv"]["blocks"] == 256 and \
        simt["dkdv"]["makespan"] == simt["dkdv"]["longest"] == 256
    # MLA's training microbatch (B 1, S 4096, 40 heads over 40, causal):
    # the (96, 64) kernels are persistent, one block an SM walking pairs of
    # items (tile t and tile n - 1 - t of a head), each pair 127 + 3 = 130
    # warpgroup stages: a makespan of 650 against the ideal 630.3 (the
    # source header's numbers; single items in the forward's rotated order
    # would take 846)
    mla = FA.bwd_schedule(4096, 96, True, 0, 1, 40, 40, torch.bfloat16, 64)
    assert mla["dkdv"] == {"blocks": 132, "items": 1280, "units": 640,
                           "steps": 83200, "longest": 127, "makespan": 650}
    assert mla["dq"] == mla["dkdv"]
    # more pairs than SMs under G 4 (B 2, S 2048, 40 heads over 10)
    g4 = FA.bwd_schedule(2048, 96, True, 0, 2, 40, 10, torch.bfloat16, 64)
    assert g4["dkdv"]["units"] == 640 and g4["dkdv"]["makespan"] == 330


def _round(x, dtype):
    return x.to(dtype).float() if dtype is not None else x


def _replay(case, arrays, hd_tiles, dtype=torch.float32, drop=None,
            p_type=None):
    """The kernels' order of work on the CPU, float32, for ``dtype``'s
    route at the tiles of the instance at ``hd_tiles``.  simt: for each
    dkdv block (key tile, batch, kv head) the group's heads and the plan's
    query tiles, dK and dV of the group added tile by tile.  wgmma: for
    each dkdv block (key tile, batch, query head) its own dK and dV,
    written as float32 partials, then each group's heads added in the
    order g = 0 .. G-1.  For each dq block the plan's key tiles.  P and dS
    of each tile pair come from the saved lse and delta.  ``drop``: "tile"
    leaves out the last query tile of every key tile, "head" the last head
    of every group from the sum (controls).  ``p_type`` rounds P and dS to
    that type before their products (the bf16 route's roundings)."""
    B, S, H, KV, hd, causal, window, cap = case[:8]
    hdv = _hdv(case)
    q, k, v, do = (torch.tensor(a) for a in arrays)
    kw = _kw(case)
    o = FA.flash_attention_plain(q, k, v, **kw)
    lse = FA.flash_attention_lse_plain(q, k, **kw)
    delta = FA.flash_bwd_delta_plain(o, do)
    hd_tiles, hdv_tiles = hd_tiles if isinstance(hd_tiles, tuple) else \
        (hd_tiles, hd_tiles)
    plan = FA.bwd_plan(S, hd_tiles, causal, window, dtype, hdv_tiles)
    G, scale = H // KV, hd ** -0.5
    part = (torch.zeros(B, S, H, hd), torch.zeros(B, S, H, hdv))
    dk, dv, dq = torch.zeros_like(k), torch.zeros_like(v), torch.zeros_like(q)

    def tile(b, h, q0, k0, BQ, BK):
        qs = q[b, q0:q0 + BQ, h] * scale
        ks, vs = k[b, k0:k0 + BK, h // G], v[b, k0:k0 + BK, h // G]
        g = do[b, q0:q0 + BQ, h]
        s = qs @ ks.T
        c, dt = s, torch.ones_like(s)
        if cap:
            t = torch.tanh(s / cap)
            c, dt = cap * t, 1 - t * t
        qi = torch.arange(q0, q0 + qs.shape[0])[:, None]
        kj = torch.arange(k0, k0 + ks.shape[0])[None, :]
        ok = torch.ones_like(s, dtype=torch.bool)
        if causal:
            ok &= kj <= qi
        if window:
            ok &= kj > qi - window
        p = torch.where(ok, torch.exp(c - lse[b, h, q0:q0 + BQ, None]), 0.0)
        ds = p * dt * (g @ vs.T - delta[b, h, q0:q0 + BQ, None])
        return _round(p, p_type), _round(ds, p_type), qs, ks, g

    BQ, BK = _tiles(plan, "dkdv")
    for b in range(B):
        for k0, q_tiles in plan["dkdv"]["blocks"]:
            tiles = q_tiles[:-1] if drop == "tile" and q_tiles else q_tiles
            for h in range(H):
                for q0 in tiles:
                    p, ds, qs, _, g = tile(b, h, q0, k0, BQ, BK)
                    if plan["route"] == "wgmma":
                        part[1][b, k0:k0 + BK, h] += p.T @ g
                        part[0][b, k0:k0 + BK, h] += ds.T @ qs
                    else:
                        dv[b, k0:k0 + BK, h // G] += p.T @ g
                        dk[b, k0:k0 + BK, h // G] += ds.T @ qs
    if plan["route"] == "wgmma":
        if drop == "head":
            for t in part:
                t.reshape(B, S, KV, G, -1)[:, :, :, G - 1] = 0.0
        dk, dv = FA.flash_bwd_dkdv_sum_plain(part, KV, torch.float32)
    BQ, BK = _tiles(plan, "dq")
    for b in range(B):
        for h in range(H):
            for q0, k_tiles in plan["dq"]["blocks"]:
                for k0 in k_tiles:
                    _, ds, _, ks, _ = tile(b, h, q0, k0, BQ, BK)
                    dq[b, q0:q0 + BQ, h] += ds @ ks * scale
    return dq, dk, dv


def _rel(a, b):
    return float((a - b).double().norm() / b.double().norm())


@pytest.mark.parametrize("case,hd_tiles,dtype", [
    ((2, 300, 4, 1, 16, True, 40, 0.0), 256, torch.float32),  # BK 32
    ((1, 257, 8, 2, 16, True, 0, 30.0), 64, torch.float32),   # G 4, softcap
    ((1, 200, 4, 4, 16, False, 17, 0.0), 128, torch.float32),
    ((2, 300, 4, 1, 16, True, 40, 0.0), 256, torch.bfloat16),  # G 4
    ((1, 257, 8, 2, 16, True, 0, 30.0), 64, torch.bfloat16),
    ((1, 200, 4, 4, 16, False, 17, 0.0), 128, torch.bfloat16),  # G 1
    # the (96, 64) instances' plans, at q/k 24 and v 16
    ((1, 150, 4, 2, 24, True, 0, 0.0, 16), (96, 64), torch.float32),
    ((1, 150, 4, 2, 24, True, 30, 20.0, 16), (96, 64), torch.bfloat16),
    # the bf16 (96, 64) items: the last one's second warpgroup past S
    ((1, 210, 2, 1, 24, True, 0, 0.0, 16), (96, 64), torch.bfloat16),
])
def test_replay_of_the_kernel_plan_matches_plain(case, hd_tiles, dtype):
    """The plan of the kernel instance at ``hd_tiles`` (its tile sizes)
    replayed at a small head dim gives the plain version's dq, dk, dv; a
    plan that skips one query tile per key tile does not, and on the
    wgmma route (G > 1) neither does a sum that leaves out one head's
    partial."""
    arrays = _inputs(case, 2)
    want, _ = _plain_bwd(case, arrays)
    got = _replay(case, arrays, hd_tiles, dtype)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5
    controls = ["tile"] + (["head"] if dtype == torch.bfloat16
                           and case[2] > case[3] else [])
    for drop in controls:
        control = _replay(case, arrays, hd_tiles, dtype, drop=drop)
        assert _rel(control[1], want[1]) > 1e-2, drop
        assert _rel(control[2], want[2]) > 1e-2, drop


@pytest.mark.parametrize("case", [(2, 37, 8, 2, 32, True, 9, 20.0),
                                  (1, 37, 8, 2, 96, True, 9, 20.0, 64)])
def test_dkdv_partials_summed_in_head_order_give_the_plain_dkdv(case):
    """``flash_bwd_dkdv_partials_plain`` summed by
    ``flash_bwd_dkdv_sum_plain`` (g = 0 .. G-1, float32, one rounding)
    equals ``flash_bwd_dkdv_plain``, each partial at its own width; the CPU
    wrappers route to them."""
    q, k, v, do = (torch.tensor(a) for a in _inputs(case, 3))
    kw = _kw(case)
    o = FA.flash_attention_plain(q, k, v, **kw)
    lse = FA.flash_attention_lse_plain(q, k, **kw)
    delta = FA.flash_bwd_delta_plain(o, do)
    part = FA.flash_bwd_dkdv_partials(q, k, v, do, lse, delta, **kw)
    assert [tuple(t.shape) for t in part] == [tuple(q.shape),
                                              tuple(do.shape)]
    assert all(t.dtype == torch.float32 for t in part)
    dk, dv = FA.flash_bwd_dkdv_sum_plain(part, 2, torch.float32)
    want = FA.flash_bwd_dkdv_plain(q, k, v, do, lse, delta, **kw)
    for g, w in zip((dk, dv), want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=RTOL)
    bf = FA.flash_bwd_dkdv_sum(part, 2)
    assert all(t.dtype == torch.bfloat16 for t in bf)
    torch.testing.assert_close(bf[0], dk.to(torch.bfloat16), atol=0, rtol=0)


# the card's bf16 bound (tests/test_torch_gpu.py, chip_smoke.py)
FLASH_BWD_BF16_REL = 5e-3


@pytest.mark.parametrize("case,hd_tiles", [
    ((1, 256, 4, 1, 64, True, 0, 0.0), 256),
    ((1, 200, 8, 2, 32, True, 40, 30.0), 64),
])
def test_bf16_roundings_of_p_and_ds_stay_within_the_bound(case, hd_tiles):
    """The wgmma route's own roundings, replayed in float32 on inputs
    rounded to bf16: P and dS rounded to bf16 before their products, dq,
    dk and dv once at the end.  Against the plain version (float32 inside,
    outputs rounded once) they stay within the card's FLASH_BWD_BF16_REL,
    while the same replay with P and dS in fp8 e4m3 does not: the bound
    can see a coarser P or dS."""
    arrays = [a.astype(np.float32) for a in _inputs(case, 4)]
    arrays = [torch.tensor(a).to(torch.bfloat16).float().numpy()
              for a in arrays]
    want, _ = _plain_bwd(case, arrays)
    want = [w.to(torch.bfloat16).float() for w in want]
    got = _replay(case, arrays, hd_tiles, torch.bfloat16,
                  p_type=torch.bfloat16)
    rels = [_rel(g.to(torch.bfloat16).float(), w) for g, w in zip(got, want)]
    assert max(rels) <= FLASH_BWD_BF16_REL, rels
    assert min(rels) > 1e-4, rels          # the roundings are there
    coarse = _replay(case, arrays, hd_tiles, torch.bfloat16,
                     p_type=torch.float8_e4m3fn)
    assert min(_rel(g, w) for g, w in zip(coarse, want)) > \
        FLASH_BWD_BF16_REL
