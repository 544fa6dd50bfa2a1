"""WKV6, the RWKV6 linear-attention recurrence: the CUDA kernel's wrapper and
its two plain PyTorch versions.

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)

``wkv6(r, k, v, w, u, s0)`` with r, k, v, w [B, S, H, hd] (w the decay in
(0, 1)), u [H, hd] and s0 [B, H, hd, hd] (zeros when None) returns
(y [B, S, H, hd], s_end [B, H, hd, hd]), both float32.  It is the port of
``repro/kernels/wkv6.py`` (the Pallas kernel): chunks of 16 tokens, the
per-step log-decay clamped at -9, the chunk-local exponents referenced to
the decay prefix at the middle of the chunk.  Its oracles are
``repro/kernels/ref.py``: ``wkv6_chunked_ref`` (the same chunked math,
ported as ``wkv6_plain``) and ``wkv6_ref`` (the exact sequential
recurrence without the clamp, ported as ``wkv6_sequential_plain``).

A CUDA tensor always launches the hand-written kernel (``csrc/wkv6.cu``)
and raises on what it does not take: float32 only, contiguous, hd in
``HEAD_DIMS``, S a positive multiple of 16.  A CPU tensor uses
``wkv6_plain``.  There is no fallback from one to the other.  ``LAUNCHES``
counts kernel launches, so that a run can show that its main path went
through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

CHUNK = 16
LOG_W_MIN = -9.0      # the clamp of the per-step log-decay (wkv6.py:75-78)
HEAD_DIMS = (16, 32, 64)      # the kernel's instantiations

LAUNCHES = 0


def log_decay(w: torch.Tensor) -> torch.Tensor:
    """The clamped per-step log-decay, float32: log w >= -9 (w >= 1.2e-4).
    A contribution below that dies within a step at float32 precision, and
    the clamp bounds the chunk-local exponents to 8 * 9 = 72."""
    return torch.clamp(torch.log(torch.clamp(w.float(), min=1e-38)),
                       min=LOG_W_MIN)


def wkv6_plain(r, k, v, w, u, s0=None, *, chunk=CHUNK):
    """The chunked recurrence in plain PyTorch, float32 inside and out
    (``ref.wkv6_chunked_ref``): within a chunk a masked strictly-lower
    [C, C] score matrix in log space against the mid-chunk reference, the
    ``u`` diagonal and the carried state; across chunks only the state."""
    B, S, H, hd = r.shape
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    n, C = S // chunk, chunk
    rc, kc, vc, wc = [a.float().reshape(B, n, C, H, hd).permute(1, 0, 3, 2, 4)
                      for a in (r, k, v, w)]             # [n, B, H, C, hd]
    lw = log_decay(wc)
    s = (torch.zeros(B, H, hd, hd, dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    u_ = u.float()[None, :, None, :]
    lower = torch.ones(C, C, dtype=torch.bool, device=r.device).tril(-1)
    ys = []
    for i in range(n):
        r_, k_, v_, lw_ = rc[i], kc[i], vc[i], lw[i]
        cum = torch.cumsum(lw_, dim=2)              # inclusive decay prefix
        cum_excl = cum - lw_
        ref = cum[:, :, C // 2:C // 2 + 1, :]       # mid-chunk reference
        a_sc = r_ * torch.exp(cum_excl - ref)
        b_sc = k_ * torch.exp(ref - cum)
        sc = torch.einsum("bhtd,bhsd->bhts", a_sc, b_sc)
        sc = torch.where(lower, sc, torch.zeros((), device=r.device))
        diag = torch.einsum("bhtd,bhtd->bht", r_ * u_, k_)
        y = torch.einsum("bhts,bhsd->bhtd", sc, v_) + diag[..., None] * v_
        y = y + torch.einsum("bhtd,bhdv->bhtv", r_ * torch.exp(cum_excl), s)
        last = cum[:, :, -1:, :]
        kd = k_ * torch.exp(last - cum)
        s = torch.exp(last)[:, :, 0, :, None] * s + torch.einsum(
            "bhsd,bhsv->bhdv", kd, v_)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, S, H, hd)
    return y, s


def wkv6_sequential_plain(r, k, v, w, u, s0=None):
    """The exact recurrence one token at a time, float32, no clamp
    (``ref.wkv6_ref``)."""
    B, S, H, hd = r.shape
    s = (torch.zeros(B, H, hd, hd, dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    u_ = u.float()[None, :, :, None]
    ys = []
    for t in range(S):
        r_t, k_t, v_t, w_t = (a[:, t].float() for a in (r, k, v, w))
        kv = k_t[..., :, None] * v_t[..., None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t, s + u_ * kv))
        s = w_t[..., :, None] * s + kv
    return torch.stack(ys, dim=1), s


def _check(r, k, v, w, u, s0, chunk):
    if chunk != CHUNK:
        raise ValueError(f"the kernel takes chunk={CHUNK}, got {chunk}")
    named = [("r", r), ("k", k), ("v", v), ("w", w), ("u", u)]
    if s0 is not None:
        named.append(("s0", s0))
    for name, t in named:
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if r.dim() != 4:
        raise ValueError(f"r must be [B, S, H, hd], got {tuple(r.shape)}")
    B, S, H, hd = r.shape
    for name, t in named[1:4]:
        if t.shape != r.shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, r is "
                             f"{tuple(r.shape)}")
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"u must be [{H}, {hd}], got {tuple(u.shape)}")
    if s0 is not None and tuple(s0.shape) != (B, H, hd, hd):
        raise ValueError(f"s0 must be [{B}, {H}, {hd}, {hd}], got "
                         f"{tuple(s0.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in the kernel's {HEAD_DIMS}")
    if S <= 0 or S % CHUNK:
        raise ValueError(f"S={S} is not a positive multiple of {CHUNK}")
    if not 0 < B <= 65535 or not 0 < H <= 65535:
        raise ValueError(f"grid out of range: B {B}, H {H}")
    return B, S, H, hd


def _lib():
    from repro_torch.kernels.build import load
    fn = load("wkv6").wkv6_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
    return fn


def wkv6(r, k, v, w, u, s0=None, *, chunk=CHUNK):
    """(y [B, S, H, hd], s_end [B, H, hd, hd]), float32.  On a CUDA tensor
    this launches the kernel on the current stream; on a CPU tensor it is
    ``wkv6_plain``."""
    global LAUNCHES
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, s0, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"no wkv6 for device {r.device}")
    B, S, H, hd = _check(r, k, v, w, u, s0, chunk)
    y = torch.empty_like(r)
    s_end = torch.empty(B, H, hd, hd, dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = _lib()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), None if s0 is None else s0.data_ptr(),
                y.data_ptr(), s_end.data_ptr(), B, S, H, hd,
                r.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel failed to launch: CUDA error {rc}")
    LAUNCHES += 1
    return y, s_end
