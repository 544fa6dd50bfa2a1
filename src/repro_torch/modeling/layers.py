"""Common building blocks of the LM stack: norms, softcap, RoPE, FFN and the
seeded parameter init.

Port of ``repro/modeling/layers.py``.  The numerics follow the JAX package:
``rms_norm`` computes in float32 and scales by ``(1 + w)``; ``softcap`` is
``cap * tanh(x / cap)`` in float32; RoPE rotates split halves (not
interleaved pairs) in float32; ``gelu_mlp`` uses the tanh approximation,
which is ``jax.nn.gelu``'s default.

``init_normal`` draws a leaf as ``materialize`` does: N(0, 1) times
``scale / sqrt(fan_in)`` where fan_in is the product of every dim but the
last (``scale`` itself for embeddings), zeros for norms.  The numbers come
from a ``torch.Generator`` and differ from ``jax.random``'s: tests hand
both frameworks the same weights through ``modeling.convert``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def rope_freqs(positions: torch.Tensor, dim: int, theta: float):
    """positions [*, S] -> (sin, cos) each [*, S, dim//2], float32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
    """x [..., S, H, hd]; sin/cos [..., S, hd//2] broadcast over heads."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    s, c = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def ffn_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ p["w_up"].to(x.dtype)
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["w_down"].to(x.dtype)


def init_normal(shape: Sequence[int], gen: torch.Generator, dtype,
                device, scale: float = 1.0, embed: bool = False,
                lead: int = 0) -> torch.Tensor:
    """One leaf of ``materialize``'s "normal"/"embed" init, drawn in
    float32 on the generator's device (the CPU's gives the same weights on
    every device) and moved to ``device`` in ``dtype``.  ``lead`` > 0 draws
    one slice of a stacked [lead, *shape] leaf of the JAX tree, whose
    fan_in counts the leading axis."""
    fan = [lead, *shape] if lead else list(shape)
    fan_in = (fan[0] if fan else 1) if len(fan) <= 1 else math.prod(fan[:-1])
    std = scale if embed else scale / math.sqrt(max(fan_in, 1))
    v = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return v.mul_(std).to(device=device, dtype=dtype)
