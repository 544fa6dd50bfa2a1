"""Mamba (selective state-space) layer of the Jamba hybrid architecture.

Port of ``repro/modeling/mamba.py``: an input projection to (u, z), a
causal depthwise convolution over u with a carried tail of d_conv - 1 raw
rows, silu, the selective scan with input-dependent dt, B and C, the D
skip, a silu(z) gate and the output projection.

The casts are the reference's: the projections and the convolution in the
activation type; dt = softplus(dt_proj(.) + dt_bias), A = -exp(A_log) and
the scan in float32; y + D_skip * u in float32, then the activation type.

The reference walks a prefill in chunks of 128 tokens, each an associative
scan over [B, C, d_inner, N] carrying (state, conv tail) from chunk to
chunk.  The port convolves the whole prompt with the cached tail and makes
one ``kernels.mamba_scan`` call over the whole sequence from the cached
state (on the card the hand-written kernel, and in training its autograd
Function ``MambaScan`` with the hand-written backward): the same
recurrence, without the [B, C, d_inner, N] intermediates.  A decode step
(S = 1) is the single update in plain PyTorch; it never launches the
kernel.  The cache
{"h", "conv"} lives in the activation type, as the reference keeps it, and
is overwritten in place after a prefill and after each step.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba_scan import mamba_scan

CHUNK = 128     # the reference's prefill chunk: S must be a multiple of it


def mamba_defs(cfg: ModelConfig) -> dict:
    """The layer's leaves (``mamba_defs``): name -> (shape, init, scale),
    with ``materialize``'s kinds: "normal" draws N(0, 1) * scale /
    sqrt(fan_in), "ones" fills with ``scale``, "zeros" with 0."""
    d, din = cfg.d_model, cfg.mamba_d_inner
    n, dtr, dc = cfg.mamba_d_state, cfg.resolved_dt_rank, cfg.mamba_d_conv
    return {
        "in_proj": ((d, 2 * din), "normal", 1.0),
        "conv_w": ((dc, din), "normal", 1.0),
        "conv_b": ((din,), "zeros", 1.0),
        "x_proj": ((din, dtr + 2 * n), "normal", 1.0),
        "dt_proj": ((dtr, din), "normal", 1.0),
        "dt_bias": ((din,), "ones", 0.01),
        "A_log": ((din, n), "ones", 0.5),
        "D_skip": ((din,), "ones", 1.0),
        "out_proj": ((din, d), "normal", 1.0),
    }


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """Zeroed state (``mamba_cache_defs``) in the activation type:
    h [B, d_inner, N] and the conv tail [B, d_conv - 1, d_inner]."""
    din = cfg.mamba_d_inner
    return {"h": torch.zeros(batch, din, cfg.mamba_d_state, dtype=dtype,
                             device=device),
            "conv": torch.zeros(batch, cfg.mamba_d_conv - 1, din,
                                dtype=dtype, device=device)}


def _causal_conv(u, tail, w, b):
    """u [B, S, din], tail [B, dc - 1, din], w [dc, din] -> (y [B, S, din],
    new tail): the last dc - 1 rows of the raw input after the old tail."""
    dc, S = w.shape[0], u.shape[1]
    full = torch.cat([tail.to(u.dtype), u], dim=1)       # [B, S + dc - 1, din]
    y = full[:, 0:S] * w[0]
    for k in range(1, dc):
        y = y + full[:, k:k + S] * w[k]
    new_tail = full[:, -(dc - 1):] if dc > 1 else tail
    return y + b, new_tail


def _ssm(p, u_c, h_prev):
    """The selective scan over u_c [B, S, din] (after conv and silu) from
    h_prev [B, din, N] float32 -> (y [B, S, din] in u_c's type, h_end
    float32)."""
    dt_ = u_c.dtype
    n, dtr = p["A_log"].shape[-1], p["dt_proj"].shape[0]
    dtBC = u_c @ p["x_proj"].to(dt_)
    dt_raw, B_ssm, C_ssm = torch.split(dtBC, [dtr, n, n], dim=-1)
    dt = F.softplus((dt_raw @ p["dt_proj"].to(dt_)).float()
                    + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())                      # [din, N]
    uf = u_c.float()
    Bf, Cf = B_ssm.float().contiguous(), C_ssm.float().contiguous()
    if u_c.shape[1] == 1:          # a decode step: one update, no kernel
        h = torch.exp(dt[:, 0, :, None] * A) * h_prev + \
            (dt[:, 0] * uf[:, 0])[..., None] * Bf[:, 0, None, :]
        y = torch.einsum("bdn,bn->bd", h, Cf[:, 0])[:, None]
    else:
        y, h = mamba_scan(uf.contiguous(), dt.contiguous(), A.contiguous(),
                          Bf, Cf, h_prev.contiguous())
    y = y + p["D_skip"].float() * uf
    return y.to(dt_), h


def mamba_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, *, mode: str,
                cache: Optional[dict]) -> torch.Tensor:
    """x [B, S, D] -> out [B, S, D].  mode: train | prefill | decode.  With
    a cache, a prefill starts from its state and tail and a decode step
    takes one token; both overwrite the cache in place."""
    B, S, _ = x.shape
    dt_ = x.dtype
    din = cfg.mamba_d_inner
    uz = x @ p["in_proj"].to(dt_)
    u, z = uz[..., :din], uz[..., din:]
    w, b = p["conv_w"].to(dt_), p["conv_b"].to(dt_)
    if mode == "decode":
        if S != 1 or cache is None:
            raise ValueError("decode takes one token per row and a cache")
    else:
        chunk = min(CHUNK, S)
        if S % chunk:
            raise ValueError(f"S={S} is not a multiple of {chunk}, the "
                             "reference's prefill chunk")
    if cache is not None:
        h0, tail0 = cache["h"].float(), cache["conv"].to(dt_)
    else:
        h0 = torch.zeros(B, din, cfg.mamba_d_state, dtype=torch.float32,
                         device=x.device)
        tail0 = torch.zeros(B, cfg.mamba_d_conv - 1, din, dtype=dt_,
                            device=x.device)
    y_c, tail = _causal_conv(u, tail0, w, b)
    y, h = _ssm(p, F.silu(y_c), h0)
    if cache is not None:
        cache["h"].copy_(h)
        cache["conv"].copy_(tail)
    y = y * F.silu(z)
    return y @ p["out_proj"].to(dt_)
