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

The gradient (the JAX package differentiates its associative scan with
``jax.grad``; no Pallas kernel has one): the forward's training instance
also writes the state entering every tile of ``TILE`` steps, [B, S / TILE,
D, N] float32; ``mamba_scan_bwd_plain`` and the kernel of
``csrc/mamba_scan_bwd.cu`` (``mamba_scan_bwd``, ``LAUNCHES_BWD``) walk the
tiles in reverse, recompute each tile's states from its checkpoint and walk
its steps in reverse with

    g_t = C_t dy_t + exp(dt_{t+1} A) g_{t+1}    (g_{S-1} adds dh_end)
    du_t = dt_t sum_n g_t B_t,   d(dt)_t = u_t sum_n g_t B_t
                                 + sum_n g_t h_{t-1} exp(dt_t A) A
    dA += g_t h_{t-1} exp(dt_t A) dt_t,   dB_t = sum_d g_t dt_t u_t,
    dC_t = sum_d dy_t h_t,   dh0 = exp(dt_0 A) g_0.

h_{t-1} is never had by dividing out the decay: exp(dt A) underflows to 0
at jamba's A and dt.  ``MambaScan`` is the autograd Function of the card;
``mamba_scan`` goes through it when an input on the card requires grad
(float32 u only); on the CPU autograd differentiates ``mamba_scan_plain``.
"""
from __future__ import annotations

import ctypes

import torch

STATE_DIMS = (4, 8, 16)       # the kernel's instantiations of N
U_DTYPES = (torch.float32, torch.bfloat16)
TILE = 64                     # steps between the forward's checkpoints

LAUNCHES = 0
LAUNCHES_BWD = 0


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


def tile_states_plain(u, dt, A, B_in, C_in, h0=None, *, tile=TILE):
    """The state entering every tile of ``tile`` steps, [B, ceil(S /
    tile), D, N] float32 (the first is h0, or zeros), by
    ``mamba_scan_plain``'s recurrence: what the forward kernel's training
    instance writes for the backward."""
    Bb, S, D = u.shape
    N = A.shape[1]
    uf, dtf, Bf, Af = u.float(), dt.float(), B_in.float(), A.float()
    h = (torch.zeros(Bb, D, N, dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    out = []
    for t in range(S):
        if t % tile == 0:
            out.append(h)
        h = torch.exp(dtf[:, t, :, None] * Af) * h + \
            (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :]
    return torch.stack(out, dim=1)


def mamba_scan_bwd_plain(u, dt, A, B_in, C_in, h0, dy, dh_end=None, *,
                         tile=TILE, checkpoints=None):
    """(du, d(dt) [B, S, D], dA [D, N], dB_in, dC_in [B, S, N], dh0
    [B, D, N]), float32: the gradient of ``mamba_scan_plain``'s (y, h_end)
    against dy and dh_end (None: zeros).  The tiles' entering states come
    from ``checkpoints`` (as the forward kernel writes them) or
    ``tile_states_plain``; each tile's states are recomputed from its
    checkpoint, then its steps are walked in reverse (the module's
    docstring has the recurrence)."""
    Bb, S, D = u.shape
    if checkpoints is None:
        checkpoints = tile_states_plain(u, dt, A, B_in, C_in, h0, tile=tile)
    uf, dtf, Af = u.float(), dt.float(), A.float()
    Bf, Cf, dyf = B_in.float(), C_in.float(), dy.float()
    du, ddt = torch.zeros_like(uf), torch.zeros_like(dtf)
    dB, dC = torch.zeros_like(Bf), torch.zeros_like(Cf)
    dA = torch.zeros_like(Af)
    g = (torch.zeros_like(checkpoints[:, 0]) if dh_end is None
         else dh_end.float().clone())      # e_{t+1} g_{t+1}, then dh_t
    for j in reversed(range(checkpoints.shape[1])):
        t0, t1 = j * tile, min((j + 1) * tile, S)
        hs = [checkpoints[:, j].float()]          # h_{t0-1}, ..., h_{t1-1}
        for t in range(t0, t1):
            hs.append(torch.exp(dtf[:, t, :, None] * Af) * hs[-1]
                      + (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :])
        for t in reversed(range(t0, t1)):
            h_prev, h_t = hs[t - t0], hs[t - t0 + 1]
            g = g + Cf[:, t, None, :] * dyf[:, t, :, None]
            e = torch.exp(dtf[:, t, :, None] * Af)
            dC[:, t] = torch.einsum("bd,bdn->bn", dyf[:, t], h_t)
            dB[:, t] = torch.einsum("bdn,bd->bn", g, dtf[:, t] * uf[:, t])
            dx = torch.einsum("bdn,bn->bd", g, Bf[:, t])
            ge = g * h_prev * e
            du[:, t] = dx * dtf[:, t]
            ddt[:, t] = dx * uf[:, t] + (ge * Af).sum(-1)
            dA = dA + (ge * dtf[:, t, :, None]).sum(0)
            g = e * g
    return du, ddt, dA, dB, dC, g


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


def _lib(name="mamba_scan_launch", lib="mamba_scan", n_ptr=9, n_int=6):
    from repro_torch.kernels.build import load
    fn = getattr(load(lib), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
            ctypes.c_void_p]
    return fn


def _forward(u, dt, A, B_in, C_in, h0, checkpoints: bool):
    """(y, h_end, the tile checkpoints or None): one launch of the forward
    kernel, its training instance when ``checkpoints``."""
    global LAUNCHES
    B, S, D, N = _check(u, dt, A, B_in, C_in, h0)
    y = torch.empty_like(u)
    h_end = torch.empty(B, D, N, dtype=torch.float32, device=u.device)
    chk = (torch.empty(B, -(-S // TILE), D, N, dtype=torch.float32,
                       device=u.device) if checkpoints else None)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    rc = _lib()(u.data_ptr(), dt.data_ptr(), A.data_ptr(), B_in.data_ptr(),
                C_in.data_ptr(), None if h0 is None else h0.data_ptr(),
                y.data_ptr(), h_end.data_ptr(),
                None if chk is None else chk.data_ptr(), B, S, D, N,
                int(u.dtype == torch.bfloat16), u.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan kernel failed to launch: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return y, h_end, chk


def mamba_scan_with_checkpoints(u, dt, A, B_in, C_in, h0=None):
    """(y, h_end, the state entering every tile [B, ceil(S / TILE), D,
    N]): the forward kernel's training instance on a CUDA tensor,
    ``mamba_scan_plain`` and ``tile_states_plain`` on a CPU tensor."""
    if u.device.type == "cpu":
        return (*mamba_scan_plain(u, dt, A, B_in, C_in, h0),
                tile_states_plain(u, dt, A, B_in, C_in, h0))
    if u.device.type != "cuda":
        raise ValueError(f"no mamba_scan for device {u.device}")
    return _forward(u, dt, A, B_in, C_in, h0, True)


def _check_bwd(u, dt, A, B_in, C_in, chk, dy, dh_end):
    B, S, D, N = _check(u, dt, A, B_in, C_in, None)
    if u.dtype != torch.float32:
        raise TypeError(f"the gradient takes float32 u, got {u.dtype}")
    named = [("checkpoints", chk, (B, -(-S // TILE), D, N)),
             ("dy", dy, (B, S, D))]
    if dh_end is not None:
        named.append(("dh_end", dh_end, (B, D, N)))
    for name, t, shape in named:
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{tuple(t.shape)}")
    # the kernel reads A, B_in, C_in, the checkpoints and dh_end 4 states
    # at a time, and writes dh0 and dA's partials so
    for name, t in [("A", A), ("B_in", B_in), ("C_in", C_in),
                    ("checkpoints", chk), ("dh_end", dh_end)]:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return B, S, D, N


def bwd_resident(N):
    """Blocks of mamba_scan_bwd's reverse walk resident on one SM of the
    current card at state size N, as the CUDA runtime computes them."""
    from repro_torch.kernels.build import load
    fn = load("mamba_scan_bwd").mamba_scan_bwd_resident
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int]
    got = fn(N)
    if got <= 0:
        raise RuntimeError(f"mamba_scan_bwd occupancy at N {N}: {got}")
    return got


def block_channels(N):
    """The channels one block of ``csrc/mamba_scan_bwd.cu`` owns at state
    size N (512 threads of 4 states each: 128 at N 16), which sizes its
    per-block partials of dB and dC."""
    from repro_torch.kernels.build import load
    fn = load("mamba_scan_bwd").mamba_scan_bwd_block_channels
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int]
    return fn(N)


def mamba_scan_bwd(u, dt, A, B_in, C_in, h0, dy, dh_end=None, *,
                   checkpoints):
    """(du, d(dt), dA, dB_in, dC_in, dh0), float32, given the checkpoints
    of ``mamba_scan_with_checkpoints`` on the same inputs (they carry h0).
    On a CUDA tensor one call of ``csrc/mamba_scan_bwd.cu`` (the reverse
    walk, one block per ``block_channels(N)`` channels and batch row, then
    the sums over blocks and over b in launches of fixed order); on a CPU
    tensor ``mamba_scan_bwd_plain``."""
    global LAUNCHES_BWD
    if u.device.type == "cpu":
        return mamba_scan_bwd_plain(u, dt, A, B_in, C_in, h0, dy, dh_end,
                                    checkpoints=checkpoints)
    if u.device.type != "cuda":
        raise ValueError(f"no mamba_scan_bwd for device {u.device}")
    _check_bwd(u, dt, A, B_in, C_in, checkpoints, dy, dh_end)
    grads = _bwd_launch(u, dt, A, B_in, C_in, checkpoints, dy, dh_end)
    LAUNCHES_BWD += 1
    return grads


def _bwd_launch(u, dt, A, B_in, C_in, checkpoints, dy, dh_end, parts=3):
    """(du, d(dt), dA, dB_in, dC_in, dh0): one call of
    ``csrc/mamba_scan_bwd.cu``'s entry on checked CUDA tensors, with the
    launches whose bits are in ``parts`` (1 the reverse walk, 2 the sums
    over blocks and over b; one alone times those launches, on fresh
    scratch)."""
    B, S, D = u.shape
    N = A.shape[1]
    f32 = dict(dtype=torch.float32, device=u.device)
    du, ddt = torch.empty_like(u), torch.empty_like(dt)
    dA, dh0 = torch.empty(D, N, **f32), torch.empty(B, D, N, **f32)
    dB, dC = torch.empty(B, S, N, **f32), torch.empty(B, S, N, **f32)
    n_blk = -(-D // block_channels(N))
    part_b = torch.empty(n_blk, B, S, N, **f32)
    part_c = torch.empty(n_blk, B, S, N, **f32)
    part_a = torch.empty(B, D, N, **f32)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    rc = _lib("mamba_scan_bwd_launch", "mamba_scan_bwd", 17, 6)(
        u.data_ptr(), dt.data_ptr(), A.data_ptr(), B_in.data_ptr(),
        C_in.data_ptr(), checkpoints.data_ptr(), dy.data_ptr(),
        None if dh_end is None else dh_end.data_ptr(), du.data_ptr(),
        ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        dh0.data_ptr(), part_b.data_ptr(), part_c.data_ptr(),
        part_a.data_ptr(), B, S, D, N, parts, u.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan_bwd kernel failed to launch: CUDA "
                           f"error {rc}")
    return du, ddt, dA, dB, dC, dh0


class MambaScan(torch.autograd.Function):
    """The selective scan on the card with a gradient: the forward
    kernel's training instance (it also writes the tile checkpoints), then
    ``mamba_scan_bwd``.  CUDA tensors, float32 u; a None gradient of h_end
    stands for zeros."""

    @staticmethod
    def forward(ctx, u, dt, A, B_in, C_in, h0):
        y, h_end, chk = _forward(u, dt, A, B_in, C_in, h0, True)
        ctx.save_for_backward(u, dt, A, B_in, C_in, chk)
        ctx.set_materialize_grads(False)
        return y, h_end

    @staticmethod
    def backward(ctx, dy, dh_end):
        u, dt, A, B_in, C_in, chk = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(u)
        grads = mamba_scan_bwd(
            u, dt, A, B_in, C_in, None, dy.contiguous(),
            None if dh_end is None else dh_end.contiguous(), checkpoints=chk)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def mamba_scan(u, dt, A, B_in, C_in, h0=None):
    """(y [B, S, D] in u's type, h_end [B, D, N] float32).  On a CUDA
    tensor this launches the kernel on the current stream, through
    ``MambaScan`` when an input requires grad (float32 u only); on a CPU
    tensor it is ``mamba_scan_plain``, which autograd differentiates."""
    if u.device.type == "cpu":
        return mamba_scan_plain(u, dt, A, B_in, C_in, h0)
    if u.device.type != "cuda":
        raise ValueError(f"no mamba_scan for device {u.device}")
    _check(u, dt, A, B_in, C_in, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (u, dt, A, B_in, C_in, h0)):
        if u.dtype != torch.float32:
            raise TypeError(f"the gradient takes float32 u, got {u.dtype}")
        return MambaScan.apply(u, dt, A, B_in, C_in, h0)
    return _forward(u, dt, A, B_in, C_in, h0, False)[:2]
