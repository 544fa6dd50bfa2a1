"""The port's selective scan on the CPU: ``mamba_scan_plain`` against the JAX
package's Pallas kernel (interpret mode, as ``tests/test_kernels.py`` runs
it) and its oracle ``repro/kernels/ref.py::mamba_scan_ref``; the wrapper's
checks of what the CUDA kernel takes.  The kernel itself is held against
the plain version on the card by ``tests/test_torch_gpu.py``.

Inputs are made from a seed with numpy and handed to both frameworks, as
``test_kernels.py`` draws them: u, B, C ~ N(0, 0.5^2), dt = softplus(N(0,
0.3^2)), A = -exp(N(0, 0.3^2)) random in every entry.  Tolerance:
``test_kernels.py``'s for mamba_scan, atol 2e-5 and rtol 1e-4 (float32
products in another order); y in bf16 gets one bf16 step (2**-7
relative), since both sides round float32 values that differ in the last
bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.kernels.mamba_scan import mamba_scan as pallas_scan
from repro_torch.kernels import mamba_scan as K

ATOL, RTOL = 2e-5, 1e-4
BF16_RTOL = 2.0 ** -7


def _softplus(x):
    return np.logaddexp(x, 0.0)


def _inputs(seed, B, S, D, N, h0=False):
    rng = np.random.default_rng(seed)
    u = 0.5 * rng.standard_normal((B, S, D))
    dt = _softplus(0.3 * rng.standard_normal((B, S, D)))
    A = -np.exp(0.3 * rng.standard_normal((D, N)))
    Bi, Ci = (0.5 * rng.standard_normal((B, S, N)) for _ in range(2))
    h = 0.5 * rng.standard_normal((B, D, N)) if h0 else None
    return [None if a is None else a.astype(np.float32)
            for a in (u, dt, A, Bi, Ci, h)]


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, msg="", rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=ATOL,
                               rtol=rtol, err_msg=msg)


# (B, S, D, N): test_kernels.py's sweep (B 1-2, S 64/128, D 128/256, N 4/8)
# and the jamba smoke width (d_inner 256, N 16)
SHAPES = [(1, 64, 128, 4), (2, 64, 256, 8), (1, 128, 256, 4),
          (2, 128, 128, 8), (2, 64, 256, 16)]


@pytest.mark.parametrize("h0", [False, True], ids=["h0=None", "h0 given"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_and_ref(shape, h0):
    B, S, D, N = shape
    ins = _inputs(S + D + N + B, B, S, D, N, h0)
    y, h = K.mamba_scan_plain(*map(_t, ins))
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, D) and h.shape == (B, D, N)
    for name, (yw, hw) in {
            "pallas": pallas_scan(*map(_j, ins), chunk=32, d_block=128,
                                  interpret=True),
            "mamba_scan_ref": R.mamba_scan_ref(*map(_j, ins))}.items():
        _close(y, yw, name)
        _close(h, hw, name)


def test_wrapper_on_cpu_is_the_plain_version():
    ins = [_t(a) for a in _inputs(1, 2, 64, 128, 16, h0=True)]
    before = K.LAUNCHES
    y, h = K.mamba_scan(*ins)
    y_p, h_p = K.mamba_scan_plain(*ins)
    assert torch.equal(y, y_p) and torch.equal(h, h_p)
    assert K.LAUNCHES == before        # nothing launched on the CPU


def test_split_sequence_carries_the_state():
    """Two calls, the second starting from the first's h_end, equal one
    call over the whole sequence, and the reference."""
    u, dt, A, Bi, Ci, h0 = _inputs(5, 2, 128, 256, 16, h0=True)
    y, h = K.mamba_scan_plain(*map(_t, (u, dt, A, Bi, Ci, h0)))
    cut = 37
    y1, h1 = K.mamba_scan_plain(*map(_t, (u[:, :cut], dt[:, :cut], A,
                                          Bi[:, :cut], Ci[:, :cut], h0)))
    y2, h2 = K.mamba_scan_plain(_t(u[:, cut:]), _t(dt[:, cut:]), _t(A),
                                _t(Bi[:, cut:]), _t(Ci[:, cut:]), h1)
    _close(torch.cat([y1, y2], 1), y)
    _close(h2, h)
    yr, hr = R.mamba_scan_ref(*map(_j, (u, dt, A, Bi, Ci, h0)))
    _close(h2, hr, "ref")


def test_bfloat16_u_returns_bfloat16_y():
    """u in bf16: y comes back in bf16 as the Pallas kernel returns it,
    h_end in float32."""
    u, dt, A, Bi, Ci, h0 = _inputs(9, 2, 64, 256, 8, h0=True)
    ub = torch.as_tensor(u).bfloat16()
    y, h = K.mamba_scan_plain(ub, *map(_t, (dt, A, Bi, Ci, h0)))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    yw, hw = pallas_scan(jnp.asarray(ub.float().numpy()).astype(jnp.bfloat16),
                         *map(_j, (dt, A, Bi, Ci, h0)), chunk=32,
                         d_block=128, interpret=True)
    assert yw.dtype == jnp.bfloat16
    _close(y.float(), np.asarray(yw.astype(jnp.float32)), rtol=BF16_RTOL)
    _close(h, hw)


def test_exponentials_that_underflow():
    """dt * A down to about -70: exp underflows towards 0 and the state
    forgets; the plain version matches the reference there too."""
    rng = np.random.default_rng(11)
    u, _, A, Bi, Ci, h0 = _inputs(11, 1, 64, 128, 8, h0=True)
    dt = rng.uniform(0.0, 20.0, u.shape).astype(np.float32)
    assert (dt.max() * A).min() < -45
    y, h = K.mamba_scan_plain(*map(_t, (u, dt, A, Bi, Ci, h0)))
    yr, hr = R.mamba_scan_ref(*map(_j, (u, dt, A, Bi, Ci, h0)))
    _close(y, yr)
    _close(h, hr)


def _bad_inputs():
    ins = [_t(a) for a in _inputs(3, 1, 16, 32, 16, h0=True)]
    u, dt, A, Bi, Ci, h0 = ins
    return [
        ((u.double(), dt, A, Bi, Ci, h0), TypeError),        # u float64
        ((u, dt.bfloat16(), A, Bi, Ci, h0), TypeError),      # dt not float32
        ((u, dt, A, Bi, Ci, h0.bfloat16()), TypeError),
        ((u, dt[:, :8].contiguous(), A, Bi, Ci, h0), ValueError),
        ((u, dt, A[:16].contiguous(), Bi, Ci, h0), ValueError),
        ((u, dt, A, Bi[:, :, :8].contiguous(), Ci, h0), ValueError),
        ((u, dt, A, Bi, Ci, h0[:, :16].contiguous()), ValueError),
        ((u.transpose(1, 2).contiguous().transpose(1, 2), dt, A, Bi, Ci,
          h0), ValueError),                                 # strided u
        ((u, dt, A[:, :12].contiguous(), Bi[..., :12].contiguous(),
          Ci[..., :12].contiguous(), h0[..., :12].contiguous()),
         ValueError),                                       # N = 12
        ((u[0], dt, A, Bi, Ci, h0), ValueError),            # u not 3-d
    ]


@pytest.mark.parametrize("case", range(len(_bad_inputs())))
def test_check_refuses_what_the_kernel_does_not_take(case):
    """The checks a CUDA tensor goes through before a launch, run on CPU
    tensors: dtypes, shapes, contiguity and N."""
    args, err = _bad_inputs()[case]
    with pytest.raises(err):
        K._check(*args)


def test_check_accepts_what_the_kernel_takes():
    ins = [_t(a) for a in _inputs(4, 2, 16, 100, 8, h0=True)]
    assert K._check(*ins) == (2, 16, 100, 8)
    ins[0] = ins[0].bfloat16()
    assert K._check(*ins[:5], None) == (2, 16, 100, 8)
