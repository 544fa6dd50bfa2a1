"""The flash-attention backward on the CPU: ``flash_attention_bwd_plain``
against autograd of ``flash_attention_plain`` and against ``jax.vjp`` of
``repro.kernels.ref.attention_ref`` (windows, softcap, G 1/2/4/8, ragged
and non-causal S), the log-sum-exp the forward kernel writes, and a CPU
replay of the backward kernels' plan: which query tiles a key tile's dkdv
block visits and which key tiles a query tile's dq block visits under the
masks (read from ``Tiles<HD>`` in the CUDA source), and dK / dV summed per
kv group over (head, query tile) in the kernel's order.

Inputs are seeded with numpy.  Tolerances: float32 throughout, sums in
another order, so 2e-5 absolute plus 1e-4 relative on gradients of order
1; the replay of the plan 1e-5 relative in norm against the plain version,
and a control that leaves out one visited tile must miss that by far.
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
    # (B, S, H, KV, hd, causal, window, cap)
    (2, 37, 4, 2, 32, True, 0, 0.0),        # G 2, ragged
    (1, 50, 4, 1, 16, True, 8, 30.0),       # G 4, window, softcap
    (2, 20, 2, 2, 8, False, 0, 0.0),        # G 1, non-causal
    (1, 33, 8, 2, 16, False, 5, 10.0),      # non-causal with a window
    (1, 70, 8, 1, 16, True, 17, 0.0),       # G 8
    (1, 1, 4, 1, 8, True, 0, 0.0),          # S = 1
]


def _inputs(case, seed=0):
    B, S, H, KV, hd = case[:5]
    rng = np.random.default_rng(seed + S)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd))]


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
    arrays = _inputs(case, 1)
    got, _ = _plain_bwd(case, arrays)
    q, k, v, do = (jnp.asarray(a) for a in arrays)
    grads = jax.jit(lambda q, k, v, do: jax.vjp(
        lambda q, k, v: attention_ref(q, k, v, **_kw(case)), q, k, v)[1](do))
    for g, w in zip(got, grads(q, k, v, do)):
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
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v).reshape(B, S, H, hd)
    torch.testing.assert_close(o, FA.flash_attention_plain(q, k, v, **kw),
                               atol=ATOL, rtol=RTOL)


def test_bwd_tile_config_read_from_the_source():
    for hd in (64, 128, 256):
        t = FA.bwd_tile_config(hd)
        assert t["BQ"] == 64 and t["BK"] == (32 if hd == 256 else 64)
        assert t["LD"] == hd + 4 and t["PLD"] == t["BK"] + 1
        # a block's shared memory fits what Hopper gives one block
        assert max(t["DKDV_SMEM"], t["DQ_SMEM"]) <= 232448


PLAN_CASES = [
    # (S, hd, causal, window)
    (300, 256, True, 0), (300, 256, True, 40), (257, 64, True, 128),
    (200, 128, False, 0), (130, 64, False, 17), (64, 128, True, 1),
    (1, 64, True, 0),
]


@pytest.mark.parametrize("S,hd,causal,window", PLAN_CASES)
def test_bwd_plan_covers_every_kept_pair(S, hd, causal, window):
    """Every (query, key) pair the masks keep lies in a tile pair that
    both blocks visit; each key tile and each query tile has one block,
    query tiles launched longest causal rows first."""
    plan = FA.bwd_plan(S, hd, causal, window)
    BQ, BK = plan["BQ"], plan["BK"]
    qp, kp = np.arange(S)[:, None], np.arange(S)[None, :]
    ok = np.ones((S, S), bool)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    seen_dkdv = np.zeros_like(ok)
    for k0, q_tiles in plan["dkdv"]:
        for q0 in q_tiles:
            seen_dkdv[q0:q0 + BQ, k0:k0 + BK] = True
    seen_dq = np.zeros_like(ok)
    for q0, k_tiles in plan["dq"]:
        for k0 in k_tiles:
            seen_dq[q0:q0 + BQ, k0:k0 + BK] = True
    assert not (ok & ~seen_dkdv).any() and not (ok & ~seen_dq).any()
    assert [k0 for k0, _ in plan["dkdv"]] == list(range(0, S, BK))
    assert sorted(q0 for q0, _ in plan["dq"]) == list(range(0, S, BQ))
    assert [q0 for q0, _ in plan["dq"]][0] == (S - 1) // BQ * BQ
    if causal:                 # no tile entirely above the diagonal
        for k0, q_tiles in plan["dkdv"]:
            assert all(q0 + BQ - 1 >= k0 for q0 in q_tiles)


def _replay(case, arrays, hd_tiles, drop=None):
    """The kernels' order of work on the CPU, float32: for each dkdv block
    (key tile, batch, kv head) the group's heads and the plan's query
    tiles, P and dS of each tile pair from the saved lse and delta, dK and
    dV added tile by tile; for each dq block the plan's key tiles.
    ``drop`` leaves out the last query tile of every key tile (a
    control)."""
    B, S, H, KV, hd, causal, window, cap = case
    q, k, v, do = (torch.tensor(a) for a in arrays)
    kw = _kw(case)
    o = FA.flash_attention_plain(q, k, v, **kw)
    lse = FA.flash_attention_lse_plain(q, k, **kw)
    delta = FA.flash_bwd_delta_plain(o, do)
    plan = FA.bwd_plan(S, hd_tiles, causal, window)
    BQ, BK = plan["BQ"], plan["BK"]
    G, scale = H // KV, hd ** -0.5
    dk, dv, dq = torch.zeros_like(k), torch.zeros_like(v), torch.zeros_like(q)

    def tile(b, h, q0, k0):
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
        ds = p * (g @ vs.T - delta[b, h, q0:q0 + BQ, None]) * dt
        return p, ds, qs, ks, g

    for b in range(B):
        for kh in range(KV):
            for k0, q_tiles in plan["dkdv"]:
                tiles = q_tiles[:-1] if drop and q_tiles else q_tiles
                for h in range(kh * G, (kh + 1) * G):
                    for q0 in tiles:
                        p, ds, qs, _, g = tile(b, h, q0, k0)
                        dv[b, k0:k0 + BK, kh] += p.T @ g
                        dk[b, k0:k0 + BK, kh] += ds.T @ qs
        for h in range(H):
            for q0, k_tiles in plan["dq"]:
                for k0 in k_tiles:
                    _, ds, _, ks, _ = tile(b, h, q0, k0)
                    dq[b, q0:q0 + BQ, h] += ds @ ks * scale
    return dq, dk, dv


def _rel(a, b):
    return float((a - b).double().norm() / b.double().norm())


@pytest.mark.parametrize("case,hd_tiles", [
    ((2, 300, 4, 1, 16, True, 40, 0.0), 256),     # BK 32: 10 key tiles
    ((1, 257, 8, 2, 16, True, 0, 30.0), 64),       # BK 64, G 4, softcap
    ((1, 200, 4, 4, 16, False, 17, 0.0), 128),     # non-causal window
])
def test_replay_of_the_kernel_plan_matches_plain(case, hd_tiles):
    """The plan of the kernel instance at ``hd_tiles`` (its tile sizes)
    replayed at a small head dim gives the plain version's dq, dk, dv; a
    plan that skips one query tile per key tile does not."""
    arrays = _inputs(case, 2)
    want, _ = _plain_bwd(case, arrays)
    got = _replay(case, arrays, hd_tiles)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5
    control = _replay(case, arrays, hd_tiles, drop=True)
    assert _rel(control[1], want[1]) > 1e-2
    assert _rel(control[2], want[2]) > 1e-2
