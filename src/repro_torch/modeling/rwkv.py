"""RWKV6 ("Finch") layer: data-dependent-decay linear attention.

Port of ``repro/modeling/rwkv.py``:
  token shift  ddlerp mixing of x_t with x_{t-1} (per-projection deltas
               from a small two-layer lora over the shifted difference)
  time mix     per-channel data-dependent decay w_t = exp(-exp(...)), the
               matrix-valued per-head state S_t = diag(w_t) S_{t-1} +
               k_t v_t^T, out_t = r_t . (diag(u) k_t v_t^T + S_{t-1}),
               group-normed and gated by silu(g_t)
  channel mix  token-shifted squared-relu FFN with a sigmoid receptance

The casts are the reference's: projections in the activation type, the
decay lora's sum, r, k, v, w and the state in float32.  The routing is the
reference's too (``rwkv.py:131-149``): S >= 32 with S % 16 == 0 (prefill)
goes through ``kernels.wkv6`` (on the card the hand-written kernel, which
clamps log w at -9, and in training its autograd Function ``WKV6`` with
the hand-written backward), every other length, decode included, through
the exact sequential recurrence here, which has no clamp and which
autograd differentiates, as ``jax.grad`` does the reference's.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.wkv6 import wkv6

LORA_MIX = 32
LORA_DECAY = 64
GROUP_NORM_EPS = 64e-5


def n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def tm_defs(cfg: ModelConfig) -> dict:
    """Time-mix leaves (``rwkv_tm_defs``): name -> (shape, init, scale),
    with ``materialize``'s kinds: "normal" draws N(0, 1) * scale /
    sqrt(fan_in), "ones" fills with ``scale``, "zeros" with 0."""
    d = cfg.d_model
    h, hd = n_heads(cfg), cfg.rwkv_head_dim
    return {
        "maa_x": ((d,), "zeros", 1.0),
        "maa_rkvwg": ((5, d), "zeros", 1.0),
        "maa_w1": ((d, 5 * LORA_MIX), "normal", 0.1),
        "maa_w2": ((5, LORA_MIX, d), "normal", 0.1),
        "decay": ((d,), "ones", -4.0),
        "decay_w1": ((d, LORA_DECAY), "normal", 0.1),
        "decay_w2": ((LORA_DECAY, d), "normal", 0.1),
        "bonus_u": ((h, hd), "normal", 0.5),
        "wr": ((d, d), "normal", 1.0),
        "wk": ((d, d), "normal", 1.0),
        "wv": ((d, d), "normal", 1.0),
        "wg": ((d, d), "normal", 1.0),
        "wo": ((d, d), "normal", 1.0),
        "ln_x_scale": ((d,), "ones", 1.0),
        "ln_x_bias": ((d,), "zeros", 1.0),
    }


def cm_defs(cfg: ModelConfig) -> dict:
    """Channel-mix leaves (``rwkv_cm_defs``), as ``tm_defs``."""
    d, f = cfg.d_model, cfg.d_ff
    return {
        "maa_k": ((d,), "zeros", 1.0),
        "maa_r": ((d,), "zeros", 1.0),
        "wk": ((d, f), "normal", 1.0),
        "wv": ((f, d), "normal", 1.0),
        "wr": ((d, d), "normal", 1.0),
    }


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """Zeroed state (``rwkv_cache_defs``) in the activation type, as the
    reference keeps it: s [B, H, hd, hd], x_tm and x_cm [B, d]."""
    h, hd, d = n_heads(cfg), cfg.rwkv_head_dim, cfg.d_model
    return {"s": torch.zeros(batch, h, hd, hd, dtype=dtype, device=device),
            "x_tm": torch.zeros(batch, d, dtype=dtype, device=device),
            "x_cm": torch.zeros(batch, d, dtype=dtype, device=device)}


def _shift(x, x_prev):
    """x [B, S, D], x_prev [B, D] -> the x_{t-1} sequence and the new
    carry x[:, -1]."""
    prev = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    return prev, x[:, -1, :]


def _group_norm(x, scale, bias, h, eps=GROUP_NORM_EPS):
    """Per-head group norm over [B, S, D] viewed as [B, S, H, hd], in
    float32 with the population variance."""
    B, S, D = x.shape
    xh = x.reshape(B, S, h, D // h).float()
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, unbiased=False)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(B, S, D) * scale + bias).to(x.dtype)


def _recurrent(r, k, v, w, u, s):
    """The sequential recurrence (``rwkv.py:137-149``): r, k, v, w
    [B, S, H, hd] float32, u [H, hd], s [B, H, hd, hd] -> (y, s_end).
    It is the model's decode path; ``kernels.wkv6.wkv6_sequential_plain``
    computes the same function as the oracle that the kernel is held to,
    as the reference keeps ``ref.wkv6_ref`` apart from its model."""
    u_ = u[None, :, :, None]
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + u_ * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def rwkv_time_mix(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                  cache_s: Optional[torch.Tensor] = None,
                  cache_x: Optional[torch.Tensor] = None):
    """x [B, S, D] -> (out [B, S, D], new state [B, H, hd, hd] float32,
    new x carry [B, D])."""
    B, S, D = x.shape
    h, hd = n_heads(cfg), cfg.rwkv_head_dim
    dt = x.dtype
    x_prev0 = cache_x if cache_x is not None else x.new_zeros(B, D)
    prev, x_carry = _shift(x, x_prev0)
    xx = prev - x

    # ddlerp: data-dependent interpolation deltas for r, k, v, w, g
    xxx = x + xx * p["maa_x"].to(dt)
    lora = torch.tanh(xxx @ p["maa_w1"].to(dt)).reshape(B, S, 5, LORA_MIX)
    deltas = torch.einsum("bsfm,fmd->bsfd", lora, p["maa_w2"].to(dt))
    mixed = x[:, :, None, :] + xx[:, :, None, :] * (
        p["maa_rkvwg"].to(dt)[None, None] + deltas)
    xr, xk, xv, xw, xg = mixed.unbind(dim=2)

    r = xr @ p["wr"].to(dt)
    k = xk @ p["wk"].to(dt)
    v = xv @ p["wv"].to(dt)
    g = xg @ p["wg"].to(dt)
    dlora = torch.tanh(xw @ p["decay_w1"].to(dt)) @ p["decay_w2"].to(dt)
    logw = -torch.exp(p["decay"].float() + dlora.float())
    w = torch.exp(logw)                                  # [B, S, D] in (0, 1)

    rh, kh, vh = (a.reshape(B, S, h, hd).float() for a in (r, k, v))
    wh = w.reshape(B, S, h, hd)
    u = p["bonus_u"].float()
    s0 = (cache_s.float() if cache_s is not None
          else torch.zeros(B, h, hd, hd, dtype=torch.float32,
                           device=x.device))

    if S >= 32 and S % 16 == 0:
        y, s_end = wkv6(rh, kh, vh, wh, u, s0, chunk=16)
    else:
        y, s_end = _recurrent(rh, kh, vh, wh, u, s0)
    y = _group_norm(y.reshape(B, S, D), p["ln_x_scale"].float(),
                    p["ln_x_bias"].float(), h)
    y = (y * F.silu(g).float()).to(dt)
    return y @ p["wo"].to(dt), s_end, x_carry


def rwkv_channel_mix(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                     cache_x: Optional[torch.Tensor] = None):
    """x [B, S, D] -> (out [B, S, D], new x carry [B, D])."""
    B, S, D = x.shape
    dt = x.dtype
    x_prev0 = cache_x if cache_x is not None else x.new_zeros(B, D)
    prev, x_carry = _shift(x, x_prev0)
    xx = prev - x
    xk = x + xx * p["maa_k"].to(dt)
    xr = x + xx * p["maa_r"].to(dt)
    kk = torch.square(torch.relu(xk @ p["wk"].to(dt)))
    vv = kk @ p["wv"].to(dt)
    rr = torch.sigmoid(xr @ p["wr"].to(dt))
    return rr * vv, x_carry
