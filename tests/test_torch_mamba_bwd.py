"""The gradient of the port's selective scan on the CPU:
``mamba_scan_bwd_plain`` (the reverse walk over tiles of 64 steps, each
recomputed from the forward's checkpoint, that ``csrc/mamba_scan_bwd.cu``
follows) against autograd of the port's ``mamba_scan_plain`` and against
``jax.grad`` of the JAX package's oracle
``repro.kernels.ref.mamba_scan_ref``, with and without h0 and the
gradient of the final state, at N 4, 8 and 16, S across tiles (ragged and
whole) and decays exp(dt A) that underflow to 0.  The kernel is held
against ``mamba_scan_bwd_plain`` on the card by ``tests/test_torch_gpu.py``
and ``chip_smoke.py``.

Inputs are made from a seed with numpy and handed to both frameworks.
Tolerance: float32 on all sides with sums in another order, 1e-5 relative
in norm on every gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro_torch.kernels import mamba_scan as K

REL = 1e-5


def _rel(got, want):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-300))


def _inputs(seed, B, S, D, N, h0, dh_end, dt_max=None):
    """u, B_in, C_in, h0, dy, dh_end ~ N(0, 0.5^2); dt = softplus(N(0,
    0.3^2)) (or uniform in [0, dt_max]); A = -exp(N(0, 0.3^2))."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (0.5 * rng.standard_normal(s)).astype(np.float32)  # noqa
    u, dy = f(B, S, D), f(B, S, D)
    if dt_max is None:
        dt = np.log1p(np.exp(0.3 * rng.standard_normal((B, S, D))))
    else:
        dt = rng.uniform(0.0, dt_max, (B, S, D))
    A = -np.exp(0.3 * rng.standard_normal((D, N)))
    return (u, dt.astype(np.float32), A.astype(np.float32), f(B, S, N),
            f(B, S, N), f(B, D, N) if h0 else None, dy,
            f(B, D, N) if dh_end else None)


def _jax_grads(u, dt, A, B_in, C_in, h0, dy, dh_end):
    def loss(u, dt, A, B_in, C_in, h0):
        y, h_end = R.mamba_scan_ref(u, dt, A, B_in, C_in, h0)
        out = jnp.sum(y * dy)
        return out if dh_end is None else out + jnp.sum(h_end * dh_end)
    h0_ = (jnp.zeros((u.shape[0], u.shape[2], A.shape[1]), jnp.float32)
           if h0 is None else jnp.asarray(h0))
    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (u, dt, A, B_in, C_in)), h0_)]


def _autograd(u, dt, A, B_in, C_in, h0, dy, dh_end):
    ins = [torch.tensor(a, requires_grad=True)
           for a in (u, dt, A, B_in, C_in)]
    h0_t = (torch.zeros(u.shape[0], u.shape[2], A.shape[1]) if h0 is None
            else torch.tensor(h0)).requires_grad_(True)
    y, h_end = K.mamba_scan_plain(*ins, h0_t)
    loss = (y * torch.tensor(dy)).sum()
    if dh_end is not None:
        loss = loss + (h_end * torch.tensor(dh_end)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, ins + [h0_t])]


def _check(got, want, label):
    for n, g, x in zip(("du", "ddt", "dA", "dB", "dC", "dh0"), got, want):
        assert _rel(g, x) <= REL, (label, n, _rel(g, x))


CASES = [   # B, S, D, N, h0 given, dh_end given, dt_max
    (2, 100, 24, 4, True, True, None),      # a ragged second tile
    (1, 128, 40, 8, False, True, None),     # two whole tiles
    (2, 64, 16, 16, True, False, None),     # one tile
    (1, 150, 24, 16, False, False, None),
    (1, 80, 16, 8, True, True, 250.0),      # exp(dt A) underflows to 0
]


@pytest.mark.parametrize("B,S,D,N,h0,dh_end,dt_max", CASES)
def test_mamba_scan_bwd_plain_matches_autograd_and_jax(B, S, D, N, h0,
                                                       dh_end, dt_max):
    ins = _inputs(B * 1000 + S + N, B, S, D, N, h0, dh_end, dt_max)
    got = [g.numpy() for g in K.mamba_scan_bwd_plain(
        *(None if a is None else torch.tensor(a) for a in ins))]
    assert all(np.isfinite(g).all() for g in got)
    t = [None if a is None else torch.tensor(a) for a in ins]
    wrapped = K.mamba_scan_bwd(
        *t, checkpoints=K.mamba_scan_with_checkpoints(*t[:6])[2])
    for a, b in zip(got, wrapped):
        np.testing.assert_array_equal(a, b.numpy())
    _check(got, _autograd(*ins), "autograd")
    _check(got, _jax_grads(*ins), "jax.grad")
    if dt_max is not None:    # the decays that a division would need
        e = np.exp(ins[1][..., None] * ins[2])
        assert (e == 0).mean() > 0.2


def test_checkpoints_are_the_states_entering_each_tile():
    """The forward's training output: the state entering every tile of
    64 steps (h0 first), each the plain forward's state over the prefix."""
    u, dt, A, B_in, C_in, h0, _, _ = _inputs(5, 2, 130, 8, 4, True, False)
    t = [torch.tensor(a) for a in (u, dt, A, B_in, C_in, h0)]
    y, h_end, chk = K.mamba_scan_with_checkpoints(*t)
    assert chk.shape == (2, 3, 8, 4) and chk.shape[1] == -(-130 // K.TILE)
    torch.testing.assert_close(chk[:, 0], t[5], rtol=0, atol=0)
    for j in (1, 2):
        _, h = K.mamba_scan_plain(*(a[:, :64 * j] for a in t[:2]), t[2],
                                  *(a[:, :64 * j] for a in t[3:5]), t[5])
        torch.testing.assert_close(chk[:, j], h, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(y, K.mamba_scan_plain(*t)[0], rtol=0, atol=0)
