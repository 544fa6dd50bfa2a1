"""The port's WKV6 on the CPU: ``wkv6_plain`` (the chunked recurrence) and
``wkv6_sequential_plain`` (the exact one) against the JAX package's Pallas
kernel (interpret mode, as ``tests/test_kernels.py`` runs it) and its two
oracles in ``repro/kernels/ref.py``.  The CUDA kernel itself is held
against both plain versions on the card by ``tests/test_torch_gpu.py``.

Inputs are made from a seed with numpy and handed to both frameworks.
Tolerance: ``tests/test_kernels.py``'s for wkv6, atol 2e-4 and rtol 1e-3
(float32 sums over hd and 16-token chunks taken in another order, and
exponents of up to 72 in the chunked form).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.kernels.wkv6 import wkv6 as pallas_wkv6
from repro_torch.kernels import wkv6 as K

ATOL, RTOL = 2e-4, 1e-3


def _inputs(seed, B, S, H, hd, decay=1.0, s0=False, log_w_min=None):
    """r, k, v [B, S, H, hd], w in (0, 1), u [H, hd] and s0 (or None).
    The decays are RWKV6's domain, w = exp(-exp(x)) with x <= 2 (as
    test_kernels.py draws them), or log w uniform in [log_w_min, -0.01]."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, S, H, hd)) for _ in range(3))
    if log_w_min is None:
        x = np.clip(decay * rng.standard_normal((B, S, H, hd)), -8.0, 2.0)
        w = np.exp(-np.exp(x))
    else:
        w = np.exp(rng.uniform(log_w_min, -0.01, (B, S, H, hd)))
    u = 0.3 * rng.standard_normal((H, hd))
    st = 0.5 * rng.standard_normal((B, H, hd, hd)) if s0 else None
    f32 = lambda a: None if a is None else a.astype(np.float32)  # noqa: E731
    return [f32(a) for a in (r, k, v, w, u, st)]


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL, err_msg=msg)


CASES = [
    # (B, n_chunks, H, hd, decay scale, s0 given): test_kernels.py's sweep
    # (B 1-2, 2-6 chunks, H 2/4, hd 16/32, decays over the RWKV domain)
    (1, 2, 2, 16, 0.2, False),
    (2, 2, 4, 32, 2.0, False),
    (1, 6, 4, 16, 1.0, True),
    (2, 3, 2, 32, 0.5, True),
    (2, 6, 2, 16, 2.0, False),
    (1, 4, 4, 32, 1.5, True),
]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_and_both_oracles(case):
    B, n, H, hd, decay, has_s0 = case
    r, k, v, w, u, s0 = _inputs(n * 10 + hd, B, 16 * n, H, hd, decay, has_s0)
    y, s = K.wkv6_plain(*map(_t, (r, k, v, w, u, s0)))
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == r.shape and s.shape == (B, H, hd, hd)
    for name, (yw, sw) in {
            "pallas": pallas_wkv6(*map(_j, (r, k, v, w, u, s0)),
                                  interpret=True),
            "wkv6_chunked_ref": R.wkv6_chunked_ref(
                *map(_j, (r, k, v, w, u, s0))),
            "wkv6_ref": R.wkv6_ref(*map(_j, (r, k, v, w, u, s0)))}.items():
        _close(y, yw, name)
        _close(s, sw, name)


@pytest.mark.parametrize("log_w_min", [-9.0, -12.0])
def test_clamp_region(log_w_min):
    """Decays down to the clamp and past it (log w to -12): the chunked
    forms clamp log w at -9 alike, and equal the exact recurrence run on
    the clamped decays."""
    r, k, v, w, u, s0 = _inputs(3, 2, 64, 2, 32, s0=True,
                                log_w_min=log_w_min)
    y, s = K.wkv6_plain(*map(_t, (r, k, v, w, u, s0)))
    y_p, s_p = pallas_wkv6(*map(_j, (r, k, v, w, u, s0)), interpret=True)
    _close(y, y_p)
    _close(s, s_p)
    y_c, s_c = R.wkv6_chunked_ref(*map(_j, (r, k, v, w, u, s0)))
    _close(y, y_c)
    _close(s, s_c)
    w_clamped = np.maximum(w, np.float32(np.exp(K.LOG_W_MIN)))
    y_e, s_e = R.wkv6_ref(*map(_j, (r, k, v, w_clamped, u, s0)))
    _close(y, y_e)
    _close(s, s_e)
    y_q, s_q = K.wkv6_sequential_plain(*map(_t, (r, k, v, w_clamped, u,
                                                 s0)))
    _close(y, y_q)
    _close(s, s_q)


def test_log_decay_clamps_at_minus_nine():
    """atol 1e-7: torch's vectorised float32 log is accurate in absolute,
    not relative, terms near w = 1."""
    w = torch.tensor([0.0, 1e-30, np.exp(-9.5), np.exp(-3.0), 0.999])
    got = K.log_decay(w)
    want = np.maximum(np.log(np.maximum(w.numpy(), np.float32(1e-38))),
                      np.float32(-9.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert got.dtype == torch.float32


def test_carried_state_split_equals_one_call():
    """Splitting a sequence across two calls, the second taking the first's
    state, equals one call (test_kernels.py's test_wkv6_carried_state,
    with u = 0 as there)."""
    r, k, v, w, u, _ = _inputs(9, 1, 64, 2, 32, decay=0.5)
    u = np.zeros_like(u)
    y, s = K.wkv6_plain(*map(_t, (r, k, v, w, u)))
    y1, s1 = K.wkv6_plain(*(_t(a[:, :32]) for a in (r, k, v, w)), _t(u))
    y2, s2 = K.wkv6_plain(*(_t(a[:, 32:]) for a in (r, k, v, w)), _t(u),
                          s1)
    _close(torch.cat([y1, y2], 1), y)
    _close(s2, s)
    yj, sj = pallas_wkv6(*map(_j, (r, k, v, w, u)), interpret=True)
    _close(y, yj)
    _close(s, sj)


@pytest.mark.parametrize("S,has_s0", [(1, True), (20, False), (37, True)])
def test_sequential_plain_matches_ref(S, has_s0):
    """Any length, a multiple of 16 or not."""
    r, k, v, w, u, s0 = _inputs(S, 2, S, 4, 16, s0=has_s0)
    y, s = K.wkv6_sequential_plain(*map(_t, (r, k, v, w, u, s0)))
    y_r, s_r = R.wkv6_ref(*map(_j, (r, k, v, w, u, s0)))
    assert y.shape == r.shape
    _close(y, y_r)
    _close(s, s_r)


def test_wrapper_on_cpu_is_the_plain_version():
    r, k, v, w, u, s0 = _inputs(5, 1, 32, 2, 16, s0=True)
    before = K.LAUNCHES
    y, s = K.wkv6(*map(_t, (r, k, v, w, u, s0)))
    assert K.LAUNCHES == before
    y_p, s_p = K.wkv6_plain(*map(_t, (r, k, v, w, u, s0)))
    assert torch.equal(y, y_p) and torch.equal(s, s_p)
    with pytest.raises(ValueError, match="multiple"):
        K.wkv6(*(_t(a[:, :20]) for a in (r, k, v, w)), _t(u))
