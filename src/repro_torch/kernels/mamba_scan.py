"""The Mamba selective scan: the CUDA kernel's wrapper and its plain PyTorch
version.

    h_t = exp(dt_t * A) h_{t-1} + (dt_t * u_t) B_t
    y_t = C_t . h_t

``mamba_scan(u, dt, A, B_in, C_in, h0)`` with u, dt [B, S, D], A [D, N],
B_in, C_in [B, S, N] and h0 [B, D, N] (zeros when None) returns
(y [B, S, D] in u's type, h_end [B, D, N] float32).  It is the port of
``repro/kernels/mamba_scan.py`` (the Pallas kernel, float32 inside); its
oracle is ``repro/kernels/ref.py``'s ``mamba_scan_ref`` (the sequential
recurrence), ported as ``mamba_scan_plain``.  The D-skip term is not part
of the scan: the model adds it.

A CUDA tensor always launches the hand-written kernel
(``csrc/mamba_scan.cu``) and raises on what it does not take: u float32 or
bfloat16, dt, A, B_in, C_in and h0 float32, all contiguous on one card,
N in ``STATE_DIMS``.  A CPU tensor uses ``mamba_scan_plain``.  There is no
fallback from one to the other.  ``LAUNCHES`` counts kernel launches, so
that a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

STATE_DIMS = (4, 8, 16)       # the kernel's instantiations of N
U_DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = 0


def mamba_scan_plain(u, dt, A, B_in, C_in, h0=None):
    """The recurrence one step at a time in plain PyTorch, float32 inside
    (``ref.mamba_scan_ref``); y is returned in u's type."""
    Bb, S, D = u.shape
    N = A.shape[1]
    uf, dtf = u.float(), dt.float()
    Bf, Cf, Af = B_in.float(), C_in.float(), A.float()
    h = (torch.zeros(Bb, D, N, dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    y = torch.empty(Bb, S, D, dtype=torch.float32, device=u.device)
    for t in range(S):
        dA = torch.exp(dtf[:, t, :, None] * Af)
        h = dA * h + (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :]
        y[:, t] = torch.einsum("bdn,bn->bd", h, Cf[:, t])
    return y.to(u.dtype), h


def _check(u, dt, A, B_in, C_in, h0):
    named = [("u", u), ("dt", dt), ("A", A), ("B_in", B_in), ("C_in", C_in)]
    if h0 is not None:
        named.append(("h0", h0))
    for name, t in named:
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = U_DTYPES if name == "u" else (torch.float32,)
        if t.dtype not in want:
            raise TypeError(f"the kernel takes {name} in "
                            f"{[str(d) for d in want]}, got {t.dtype}")
    if u.dim() != 3:
        raise ValueError(f"u must be [B, S, D], got {tuple(u.shape)}")
    B, S, D = u.shape
    if A.dim() != 2 or A.shape[0] != D:
        raise ValueError(f"A must be [{D}, N], got {tuple(A.shape)}")
    N = A.shape[1]
    shapes = {"dt": (dt, (B, S, D)), "B_in": (B_in, (B, S, N)),
              "C_in": (C_in, (B, S, N))}
    if h0 is not None:
        shapes["h0"] = (h0, (B, D, N))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{tuple(t.shape)}")
    if N not in STATE_DIMS:
        raise ValueError(f"d_state {N} not in the kernel's {STATE_DIMS}")
    if not 0 < B <= 65535 or S <= 0 or D <= 0:
        raise ValueError(f"shape out of range: B {B}, S {S}, D {D}")
    return B, S, D, N


def _lib():
    from repro_torch.kernels.build import load
    fn = load("mamba_scan").mamba_scan_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
    return fn


def mamba_scan(u, dt, A, B_in, C_in, h0=None):
    """(y [B, S, D] in u's type, h_end [B, D, N] float32).  On a CUDA
    tensor this launches the kernel on the current stream; on a CPU tensor
    it is ``mamba_scan_plain``."""
    global LAUNCHES
    if u.device.type == "cpu":
        return mamba_scan_plain(u, dt, A, B_in, C_in, h0)
    if u.device.type != "cuda":
        raise ValueError(f"no mamba_scan for device {u.device}")
    B, S, D, N = _check(u, dt, A, B_in, C_in, h0)
    y = torch.empty_like(u)
    h_end = torch.empty(B, D, N, dtype=torch.float32, device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    rc = _lib()(u.data_ptr(), dt.data_ptr(), A.data_ptr(), B_in.data_ptr(),
                C_in.data_ptr(), None if h0 is None else h0.data_ptr(),
                y.data_ptr(), h_end.data_ptr(), B, S, D, N,
                int(u.dtype == torch.bfloat16), u.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan kernel failed to launch: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return y, h_end
