"""Forward flash attention: the CUDA kernel's wrapper and its plain PyTorch
version.

``flash_attention(q, k, v)`` with q [B, S, H, hd] and k, v [B, S, KV, hd]
returns [B, S, H, hd] in q's type: softmax attention computed in float32,
scores ``(q * scale) . k`` (scale hd**-0.5 by default), an optional logit
softcap ``cap * tanh(s / cap)``, a causal mask (k <= q), a sliding window
(k > q - window) and grouped KV heads (the kv head of query head h is
h // (H // KV)).  Masked scores take the finite NEG_INF = -2e38.  It is the
port of ``repro/kernels/flash_attention.py`` (the Pallas kernel), whose
oracle is ``repro/kernels/ref.py:attention_ref``.

A CUDA tensor always launches a hand-written kernel of
``csrc/flash_attention.cu`` and raises on what it does not take; a CPU
tensor uses ``flash_attention_plain``.  There is no fallback from one to
the other.  The dtype picks the kernel:

- bfloat16, the serving route: a Hopper kernel on the tensor cores (TMA
  loads into a ring of swizzled shared-memory stages, one producer thread,
  two consumer warpgroups running ``wgmma`` for Q.K^T and P.V).  Bound by
  the tensor cores' bf16 rate at the serving shapes.  It rounds P to bf16
  before P.V, a rounding the float32-inside Pallas kernel does not make.
- float32, the parity route: the first SIMT design, float32 FMAs out of
  shared memory, bound by the float32 pipe.  wgmma would take float32 only
  as TF32, which puts the float32 parity limits at risk.

``LAUNCHES`` counts kernel launches, so that a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import ctypes
import re
from pathlib import Path

import torch

NEG_INF = -2.0e38
HEAD_DIMS = (64, 128, 256)      # the kernel's instantiations
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0


def flash_attention_plain(q, k, v, *, causal=True, window=0, softcap=0.0,
                          scale=None) -> torch.Tensor:
    """The same function in plain PyTorch, float32 inside, out in q's type:
    the Pallas kernel's arithmetic (q scaled before the product) on
    ``ref.attention_ref``'s naive full score matrix."""
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5 if scale is None else scale
    qg = q.float().reshape(B, S, KV, G, hd) * scale
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones(S, Sk, dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    s = torch.where(ok, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def tile_config(hd) -> dict:
    """The bf16 kernel's tiling at head dim ``hd``, read from its source:
    ``tc::Cfg<hd>``'s constants (BK keys per stage, NS stages, SMEM bytes
    of dynamic shared memory a block, ...) with HD and kBQ, the query rows
    of a block."""
    src = (Path(__file__).parent / "csrc" / "flash_attention.cu").read_text()
    tc = src[src.index("namespace tc {"):]
    env = {"HD": hd,
           "kBQ": int(re.search(r"constexpr int kBQ = (\d+);", tc)[1])}
    body = re.search(r"struct Cfg \{(.*?)\n\};", tc, re.S)[1]
    for name, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);",
                                 body):
        m = re.fullmatch(r"(.+?)\?(.+?):(.+)", expr)
        if m:                          # C's a ? b : c
            expr = f"({m[2]}) if ({m[1]}) else ({m[3]})"
        env[name] = int(eval(expr.replace("/", "//"), {}, env))
    return env


def _check(q, k, v, window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.dtype not in DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if tuple(k.shape) != (B, S, KV, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in the kernel's {HEAD_DIMS}")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} kv heads")
    if B > 65535 or H > 65535 or S >= 2 ** 31 - 128 \
            or -(-S // 128) * B * H >= 2 ** 31:
        raise ValueError(f"grid too large: B {B}, H {H}, S {S}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    return B, S, H, KV, hd


def _lib():
    from repro_torch.kernels.build import load
    fn = load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p]
    return fn


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None) -> torch.Tensor:
    """Attention [B, S, H, hd] in q's type.  On a CUDA tensor this launches
    the kernel on the current stream; on a CPU tensor it is
    ``flash_attention_plain``."""
    global LAUNCHES
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    B, S, H, KV, hd = _check(q, k, v, window)
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if B * S == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, H, KV, hd, DTYPES[q.dtype], float(scale), int(causal),
                int(window), float(softcap), q.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel failed to launch: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return out
