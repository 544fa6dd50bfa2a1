"""The port's WKV6 CUDA kernel replayed on the CPU.

``csrc/wkv6.cu`` cannot run here.  ``replay`` repeats its order of work in
float32 torch: one (batch, head) walks its chunks of 16 tokens in order
with the state carried from chunk to chunk; in each chunk the decay
prefix is the kernel's (sums over groups of 4 tokens, then a two-step
shuffle scan of the group sums: not a sequential cumsum), the decayed
operands are made once, the scores
sit beside r exp(cum_excl) in one matrix A = [sc | rq] with the u diagonal
on sc's diagonal and zeros above it, the outputs are one product
A . [v ; S] of depth 16 + hd, and the state update S' = diag(decay) S +
kd^T v reads the state from before the chunk.  The three products are the
kernel's 3xTF32 tensor-core products: each operand split into two TF32
parts (round to nearest, ties away, 10 stored mantissa bits) and a.b taken
as (a_lo b_hi + a_hi b_lo) + a_hi b_hi with float32 sums.  As a control,
the same replay with plain TF32 products (a_hi b_hi alone) must fall
outside the limits.  It is held against
``wkv6_plain``, against ``wkv6_sequential_plain`` on decays clamped at
log w >= -9 (what the chunked form computes), and against the Pallas
kernel in interpret mode, at ``tests/test_kernels.py``'s wkv6 tolerance,
atol 2e-4 and rtol 1e-3.

This checks the algorithm and its order of work, not the kernel: a fault
of the .cu cannot show here.  The kernel itself is held against both
plain versions on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.

Inputs are made from a seed with numpy and handed to both frameworks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import wkv6 as pallas_wkv6
from repro_torch.kernels import wkv6 as K

ATOL, RTOL = 2e-4, 1e-3
C = K.CHUNK


def _inputs(seed, B, S, H, hd, s0=False, log_w_min=None, zero_u=False):
    """r, k, v ~ N(0, 0.5^2); decays in RWKV6's domain w = exp(-exp(x)),
    x = clip(N(0, 1), -8, 2), or log w uniform in [log_w_min, -0.01];
    u ~ N(0, 0.3^2) (or 0); s0 ~ N(0, 0.5^2) or None."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, S, H, hd)) for _ in range(3))
    if log_w_min is None:
        w = np.exp(-np.exp(np.clip(rng.standard_normal((B, S, H, hd)),
                                   -8.0, 2.0)))
    else:
        w = np.exp(rng.uniform(log_w_min, -0.01, (B, S, H, hd)))
    u = np.zeros((H, hd)) if zero_u else 0.3 * rng.standard_normal((H, hd))
    st = 0.5 * rng.standard_normal((B, H, hd, hd)) if s0 else None
    return [None if a is None else a.astype(np.float32)
            for a in (r, k, v, w, u, st)]


def shuffle_scan(x):
    """The inclusive prefix over the token axis (dim -2, 16 long) as the
    kernel adds it: each lane sums its 4 tokens in order, the 4 lanes of a
    dim scan their sums in two shuffle steps (lane q adds lane q - 1, then
    lane q >= 2 adds lane q - 2), and each lane adds its exclusive part to
    its own sums."""
    loc = torch.cumsum(x.reshape(*x.shape[:-2], 4, 4, x.shape[-1]), dim=-2)
    tot = loc[..., 3, :]                                   # [..., 4, hd]
    x1 = tot.clone()
    x1[..., 1:, :] = tot[..., 1:, :] + tot[..., :-1, :]
    x2 = x1.clone()
    x2[..., 2:, :] = x1[..., 2:, :] + x1[..., :-2, :]
    excl = x2 - tot
    return (loc + excl[..., None, :]).reshape(x.shape)


def tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it: the 13 low mantissa
    bits dropped, to nearest, ties away from zero."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def mm3(a, b):
    """a @ b as the kernel's 3xTF32 mma.sync computes it."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def mm1(a, b):
    """a @ b in plain TF32, one product of the rounded operands: what the
    kernel would compute without the two correction products."""
    return tf32(a) @ tf32(b)


def replay(r, k, v, w, u, s0=None, mm=mm3):
    """The kernel's arithmetic on float32 [B, S, H, hd] inputs: (y, s_end),
    with its three products taken by ``mm``."""
    r, k, v, w, u = (torch.as_tensor(a) for a in (r, k, v, w, u))
    B, S, H, hd = r.shape
    n = S // C
    rc, kc, vc, wc = (a.reshape(B, n, C, H, hd).permute(1, 0, 3, 2, 4)
                      for a in (r, k, v, w))                # [n, B, H, C, hd]
    s = (torch.zeros(B, H, hd, hd) if s0 is None
         else torch.as_tensor(s0).clone())
    lower = torch.ones(C, C, dtype=torch.bool).tril(-1)
    eye = torch.eye(C, dtype=torch.bool)
    ys = []
    for i in range(n):
        r_, k_, v_, w_ = rc[i], kc[i], vc[i], wc[i]
        lw = torch.clamp(torch.log(torch.clamp(w_, min=1e-38)),
                         min=K.LOG_W_MIN)
        cm = shuffle_scan(lw)
        ce = cm - lw
        ref = cm[..., C // 2:C // 2 + 1, :]
        last = cm[..., C - 1:, :]
        a = r_ * torch.exp(ce - ref)
        b = k_ * torch.exp(ref - cm)
        rq = r_ * torch.exp(ce)
        kd = k_ * torch.exp(last - cm)
        decay = torch.exp(last)[..., 0, :]                   # [B, H, hd]
        # the u diagonal: 8-dim partial sums, then their sum
        diag = (r_ * u[None, :, None, :] * k_).reshape(
            B, H, C, hd // 8, 8).sum(-1).sum(-1)
        sc = mm(a, b.transpose(-1, -2))
        sc = torch.where(lower, sc, torch.zeros(()))
        sc = torch.where(eye, diag[..., :, None], sc)
        A = torch.cat([sc, rq], dim=-1)                      # [B, H, C, C+hd]
        Bm = torch.cat([v_, s], dim=-2)                      # [B, H, C+hd, hd]
        ys.append(mm(A, Bm))
        s = decay[..., :, None] * s + mm(kd.transpose(-1, -2), v_)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, S, H, hd)
    return y, s


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL, err_msg=msg)


def test_tf32_split_keeps_float32_accuracy():
    """TF32 keeps 10 mantissa bits; the split keeps about 21, and the
    3xTF32 product of 64-term rows is within 1e-5 relative of float64."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal(4096).astype(np.float32))
    assert float(((tf32(x) - x) / x).abs().max()) <= 2.0 ** -11
    lo = tf32(x - tf32(x))
    assert float(((tf32(x) + lo - x) / x).abs().max()) <= 2.0 ** -20
    a, b = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
            for s in ((16, 64), (64, 64)))
    want = a.double() @ b.double()
    rel = float(((mm3(a, b).double() - want).norm() / want.norm()))
    assert rel < 1e-5
    assert float(((tf32(a) @ tf32(b)).double() - want).norm()
                 / want.norm()) > 1e-4    # one TF32 product is not enough


def test_shuffle_scan_is_the_prefix_sum():
    x = torch.as_tensor(np.random.default_rng(0).uniform(
        -9.0, 0.0, (3, C, 5)).astype(np.float32))
    np.testing.assert_allclose(shuffle_scan(x).numpy(),
                               torch.cumsum(x.double(), 1).numpy(),
                               rtol=1e-6, atol=1e-5)


CASES = [
    # (B, S, H, s0 given, log w down to, u = 0): hd 64, rwkv6-3b's
    (2, 256, 4, True, None, False),      # 16 chunks, given s0
    (2, 64, 4, False, None, False),      # s0 None
    (1, 16, 1, True, None, False),       # one chunk, B 1, H 1
    (2, 128, 2, True, -12.0, False),     # decays past the clamp
    (1, 96, 3, True, None, True),        # u = 0
]


@pytest.mark.parametrize("B,S,H,has_s0,log_w_min,zero_u", CASES)
def test_replay_matches_both_plain_versions_and_pallas(B, S, H, has_s0,
                                                      log_w_min, zero_u):
    hd = 64
    ins = _inputs(S + 7 * H + B, B, S, H, hd, has_s0, log_w_min, zero_u)
    y, s = replay(*ins)
    assert y.shape == (B, S, H, hd) and s.shape == (B, H, hd, hd)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    t = [None if a is None else torch.as_tensor(a) for a in ins]
    y_p, s_p = K.wkv6_plain(*t)
    _close(y, y_p, "wkv6_plain")
    _close(s, s_p, "wkv6_plain")
    w_c = torch.clamp(t[3], min=float(np.exp(K.LOG_W_MIN)))
    y_q, s_q = K.wkv6_sequential_plain(t[0], t[1], t[2], w_c, t[4], t[5])
    _close(y, y_q, "wkv6_sequential_plain")
    _close(s, s_q, "wkv6_sequential_plain")
    y_j, s_j = pallas_wkv6(*(None if a is None else jnp.asarray(a)
                             for a in ins), interpret=True)
    _close(y, y_j, "pallas")
    _close(s, s_j, "pallas")


@pytest.mark.parametrize("B,S,H,has_s0,log_w_min,zero_u", CASES)
def test_plain_tf32_products_break_the_limits(B, S, H, has_s0, log_w_min,
                                              zero_u):
    """The control of the test above: the same replay with each product in
    plain TF32 (the correction products dropped) falls outside atol 2e-4,
    rtol 1e-3 of wkv6_plain on every case, so the limits that hold the
    kernel tell 3xTF32 from TF32."""
    hd = 64
    ins = _inputs(S + 7 * H + B, B, S, H, hd, has_s0, log_w_min, zero_u)
    y, s = replay(*ins, mm=mm1)
    y_p, s_p = K.wkv6_plain(*(None if a is None else torch.as_tensor(a)
                              for a in ins))
    excess = max(float(((g - w).abs() - ATOL - RTOL * w.abs()).max())
                 for g, w in ((y, y_p), (s, s_p)))
    assert excess > 0, excess


def test_replay_carries_state_across_calls():
    """A sequence split across two calls, the second taking the first's
    state, as the serving path's prefill chunks may be."""
    r, k, v, w, u, s0 = _inputs(41, 2, 160, 2, 64, s0=True)
    y, s = replay(r, k, v, w, u, s0)
    y1, s1 = replay(*(a[:, :64] for a in (r, k, v, w)), u, s0)
    y2, s2 = replay(*(a[:, 64:] for a in (r, k, v, w)), u, s1)
    _close(torch.cat([y1, y2], 1), y)
    _close(s2, s)
