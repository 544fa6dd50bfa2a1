"""The gradient of the port's WKV6 on the CPU: ``wkv6_bwd_plain`` (the
reverse chunk walk that ``csrc/wkv6_bwd.cu`` follows) against autograd of
the port's ``wkv6_plain`` and against ``jax.grad`` of the JAX package's
oracle ``repro.kernels.ref.wkv6_chunked_ref``, with and without s0 and
the gradient of the final state, at hd 16, 32 and 64, with decays on the
three sides of the clamp of log w at -9 in every case (below it, exactly
at it, above it).  The kernel is held against ``wkv6_bwd_plain`` on the
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.  The kernel
splits each (b, h)'s chunks into segments whose dS comes from the later
segments' folds: ``wkv6_bwd_plain(..., segments=n)`` walks them that way
and is held to the same references, with segment counts that do not
divide the chunks, one segment, slow decays (so the carry matters) and
decay products that underflow to 0.

Inputs are made from a seed with numpy and handed to both frameworks.
Tolerance: float32 on all sides with sums in another order, so 1e-5
relative in norm on dr, dk, dv, du and ds0.  dw is d(log w) / w: the
1 / w of a decay near the clamp (w = 1.2e-4) scales a float32 difference
of d(log w) by up to 8,100, so w dw (= d(log w) on the unclamped side) is
held to 1e-5 and dw itself to 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro_torch.kernels import wkv6 as K

REL, DW_REL = 1e-5, 1e-3
W_TIE = np.float32(np.exp(-9.0))     # float32 log of it is -9.0 exactly


def _rel(got, want):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-300))


def _inputs(seed, B, S, H, hd, s0, ds_end):
    """r, k, v, u, s0 ~ N(0, 0.5^2); decays w = exp(-exp(x)), x ~ N(0, 2^2)
    clipped to [-8, 2.5] (log w down to -12, below the clamp), with one
    token's first dims set to the tie exp(-9) and another's to 1e-5
    (below); dy, ds_end ~ N(0, 0.5^2)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (0.5 * rng.standard_normal(s)).astype(np.float32)  # noqa
    r, k, v, dy = (f(B, S, H, hd) for _ in range(4))
    x = np.clip(2.0 * rng.standard_normal((B, S, H, hd)), -8.0, 2.5)
    w = np.exp(-np.exp(x)).astype(np.float32)
    w[0, 3, 0, :4] = W_TIE
    w[-1, S - 2, -1, :3] = np.float32(1e-5)
    u = (0.3 * rng.standard_normal((H, hd))).astype(np.float32)
    return (r, k, v, w, u, f(B, H, hd, hd) if s0 else None, dy,
            f(B, H, hd, hd) if ds_end else None)


def _jax_grads(r, k, v, w, u, s0, dy, ds_end):
    def loss(r, k, v, w, u, s0):
        y, s_end = R.wkv6_chunked_ref(r, k, v, w, u, s0)
        out = jnp.sum(y * dy)
        return out if ds_end is None else out + jnp.sum(s_end * ds_end)
    s0_ = jnp.zeros(r.shape[:1] + r.shape[2:3] + r.shape[3:] * 2,
                    jnp.float32) if s0 is None else jnp.asarray(s0)
    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (r, k, v, w, u)), s0_)]


def _autograd(r, k, v, w, u, s0, dy, ds_end):
    ins = [torch.tensor(a, requires_grad=True) for a in (r, k, v, w, u)]
    s0_t = (torch.zeros(r.shape[0], r.shape[2], r.shape[3], r.shape[3])
            if s0 is None else torch.tensor(s0)).requires_grad_(True)
    y, s_end = K.wkv6_plain(*ins, s0_t)
    loss = (y * torch.tensor(dy)).sum()
    if ds_end is not None:
        loss = loss + (s_end * torch.tensor(ds_end)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, ins + [s0_t])]


def _check(got, want, w, label):
    names = ("dr", "dk", "dv", "dw", "du", "ds0")
    for n, g, x in zip(names, got, want):
        if n == "dw":
            assert _rel(g * w, x * w) <= REL, (label, n, _rel(g * w, x * w))
            assert _rel(g, x) <= DW_REL, (label, n, _rel(g, x))
        else:
            assert _rel(g, x) <= REL, (label, n, _rel(g, x))


CASES = [   # B, chunks, H, hd, s0 given, ds_end given
    (2, 3, 2, 16, True, True),
    (1, 2, 3, 32, False, True),
    (2, 2, 2, 64, True, False),
    (1, 3, 1, 64, False, False),
]


@pytest.mark.parametrize("B,n,H,hd,s0,ds_end", CASES)
def test_wkv6_bwd_plain_matches_autograd_and_jax(B, n, H, hd, s0, ds_end):
    ins = _inputs(B * 100 + n * 10 + hd, B, 16 * n, H, hd, s0, ds_end)
    r, k, v, w, u, st, dy, dse = ins
    got = [g.numpy() for g in K.wkv6_bwd_plain(
        *(None if a is None else torch.tensor(a) for a in ins))]
    # the wrapper on a CPU tensor is the plain version
    t = [None if a is None else torch.tensor(a) for a in ins]
    wrapped = K.wkv6_bwd(*t, states=K.wkv6_with_states(*t[:6])[2])
    for a, b in zip(got, wrapped):
        np.testing.assert_array_equal(a, b.numpy())
    _check(got, _autograd(*ins), w, "autograd")
    _check(got, _jax_grads(*ins), w, "jax.grad")


def test_clamp_gradient_is_jax_maximum_on_all_three_sides():
    """d log_decay / dw is 1 / w above the clamp, 0.5 / w at log w = -9
    exactly (``jnp.maximum``'s tie; ``torch.clamp`` would give 1 / w) and 0
    below, also at w = 0 (a decay that underflowed); autograd of
    ``log_decay`` agrees, and so does ``jax.grad`` where w > 0 (it reads
    NaN at w = 0)."""
    w = np.array([0.5, W_TIE, 1e-5, 0.0, 1.0], np.float32)
    assert np.log(W_TIE) == np.float32(-9.0)
    got = K.log_decay_grad(torch.tensor(w)).numpy()
    want = np.array([2.0, 0.5 / W_TIE, 0.0, 0.0, 1.0], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    wt = torch.tensor(w, requires_grad=True)
    (auto,) = torch.autograd.grad(K.log_decay(wt).sum(), wt)
    np.testing.assert_allclose(auto.numpy(), want, rtol=1e-6)
    jg = jax.grad(lambda x: jnp.sum(jnp.maximum(
        jnp.log(jnp.maximum(x, 1e-38)), -9.0)))(jnp.asarray(w))
    pos = w > 0
    np.testing.assert_allclose(np.asarray(jg)[pos], want[pos], rtol=1e-6)


def test_tie_reaches_dw_with_half_the_gradient():
    """At the planted ties dw agrees with jax.grad, and a backward that
    took the whole gradient through the clamp (``torch.clamp``'s rule)
    would read twice the value there.  A tie's decay (1.2e-4) all but cuts
    the chunk at its token, so its d(log w) is some 1e-5 of the largest
    and float32 differences read a few percent of it: the ties are held to
    5% relative, where the control reads 100%."""
    ins = _inputs(7, 1, 32, 1, 16, True, True)
    w = ins[3]
    tie = w == W_TIE
    assert tie.sum() == 4 and (w < W_TIE).any() and (w > W_TIE).any()
    got = K.wkv6_bwd_plain(*(None if a is None else torch.tensor(a)
                             for a in ins))[3].numpy()
    want = _jax_grads(*ins)[3]
    assert np.all(np.abs(want[tie]) > 0)
    assert _rel(got[tie], want[tie]) <= 0.05
    assert _rel(2 * got[tie], want[tie]) > 0.5


def test_chunk_states_are_the_forward_states():
    """The state entering every chunk (the forward kernel's training
    output): the first is s0, the one after the last is s_end, and the
    chunked plain forward over a prefix ends at the next one."""
    r, k, v, w, u, s0, _, _ = _inputs(3, 2, 48, 2, 16, True, False)
    t = [torch.tensor(a) for a in (r, k, v, w, u, s0)]
    y, s_end, st = K.wkv6_with_states(*t)
    assert st.shape == (2, 2, 3, 16, 16)
    torch.testing.assert_close(st[:, :, 0], t[5], rtol=0, atol=0)
    y2, s2 = K.wkv6_plain(*(a[:, :32] for a in t[:4]), t[4], t[5])
    torch.testing.assert_close(st[:, :, 2], s2, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(y, K.wkv6_plain(*t)[0], rtol=0, atol=0)


def _slow_decays(seed, shape, mean):
    """w = exp(-exp(x)), x ~ N(mean, 1) clipped to [-8, 2.5] (w > 0, where
    jax.grad of the clamp is finite): at mean -3, w near 0.95, so dS
    carries across many chunks; at mean 1.1, log w near -3 and a chunk's
    e^last near e^-48, whose product over 3 chunks underflows to 0."""
    rng = np.random.default_rng(seed)
    x = np.clip(mean + rng.standard_normal(shape), -8.0, 2.5)
    return np.exp(-np.exp(x)).astype(np.float32)


SEGMENT_CASES = [   # B, chunks, H, hd, segments, s0, ds_end, decay mean
    (2, 5, 2, 16, 2, True, True, -3.0),      # 5 chunks over 2 segments
    (1, 7, 2, 32, 3, False, True, -3.0),     # 7 over 3
    (2, 4, 1, 64, 4, True, False, -3.0),     # one chunk a segment
    (1, 3, 2, 16, 1, True, True, -3.0),      # one segment
    (1, 9, 1, 16, 3, False, True, 1.1),      # decay products underflow
]


@pytest.mark.parametrize("B,n,H,hd,segs,s0,ds_end,mean", SEGMENT_CASES)
def test_segmented_walk_matches_jax_and_the_sequential_walk(
        B, n, H, hd, segs, s0, ds_end, mean):
    ins = list(_inputs(B * 31 + n * 7 + segs, B, 16 * n, H, hd, s0, ds_end))
    ins[3] = _slow_decays(n + segs, ins[3].shape, mean)
    t = [None if a is None else torch.tensor(a) for a in ins]
    got = [g.numpy() for g in K.wkv6_bwd_plain(*t, segments=segs)]
    assert all(np.isfinite(g).all() for g in got)
    seq = [g.numpy() for g in K.wkv6_bwd_plain(*t)]
    _check(got, seq, ins[3], "sequential walk")
    _check(got, _jax_grads(*ins), ins[3], "jax.grad")
    if mean > 0:    # the products of 3 chunks' decays are exactly 0
        D, _ = K.segment_folds_plain(t[0], t[3], t[6], segs)
        assert (D[:, :, 1:] == 0).float().mean() > 0.9


@pytest.mark.parametrize("n,segs", [(5, 2), (7, 3), (4, 4), (6, 1)])
def test_segment_carry_is_the_sequential_ds(n, segs):
    """X_s from the later segments' folds equals the dS the sequential walk
    carries into segment s's last chunk: the walk's dS over a prefix of
    chunks ends at the next segment's start."""
    B, H, hd = 1, 2, 16
    r, k, v, w, u, s0, dy, dse = _inputs(n * 10 + segs, B, 16 * n, H, hd,
                                         True, True)
    w = _slow_decays(n, w.shape, -3.0)
    t = [torch.tensor(a) for a in (r, k, v, w, u, s0, dy, dse)]
    carry = K.segment_carry_plain(
        *K.segment_folds_plain(t[0], t[3], t[6], segs), t[7])
    bounds = K.segment_bounds(n, segs)
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(c1 > c0 for c0, c1 in bounds)
    torch.testing.assert_close(carry[:, :, -1], t[7], rtol=0, atol=0)
    for q in range(segs - 1):
        c1 = bounds[q][1]       # segment q ends where q + 1 begins
        tail = [a[:, 16 * c1:] for a in (t[0], t[1], t[2], t[3])]
        st = K.chunk_states_plain(*t[:4], t[5])[:, :, c1]
        want = K.wkv6_bwd_plain(*tail, t[4], st, t[6][:, 16 * c1:],
                                t[7])[5]
        torch.testing.assert_close(carry[:, :, q], want, rtol=1e-5,
                                   atol=1e-6)


def test_bwd_segments_plan():
    """The segments of rwkv6-3b's shapes on 132 SMs, two blocks an SM:
    13 at the training microbatch (B 1, S 4096, H 40: 520 blocks, 2
    waves), 4 at B 8, S 2048; never more than the chunks, one for one
    chunk; and no count with a shorter makespan."""
    assert K.bwd_segments(1, 4096, 40, 132) == 13
    assert K.bwd_segments(8, 2048, 40, 132) == 4
    assert K.bwd_segments(1, 16, 40, 132) == 1
    for B, S, H in [(1, 4096, 40), (2, 1008, 8), (8, 32, 40), (1, 48, 1)]:
        n, got = S // 16, K.bwd_segments(B, S, H, 132)
        assert 1 <= got <= min(n, K.BWD_MAX_SEGMENTS)

        def span(s):
            return -(-B * H * s // 264) * (-(-n // s) + 1)
        assert span(got) == min(span(s) for s in range(
            1, min(n, K.BWD_MAX_SEGMENTS) + 1))
