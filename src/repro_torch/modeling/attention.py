"""Attention layers of the dense decoder: GQA/MQA/MHA, sliding windows and
KV caches.

Port of the non-MLA path of ``repro/modeling/attention.py``.  Parameters
keep the JAX layouts: wq [d, H, hd], wk/wv [d, KV, hd], wo [H, hd, d];
caches are [B, L, KV, hd].

``attention_impl`` selects nothing here.  The JAX package's four variants
(reference, blocked, blocked_tri, banded) compute one function; in the
port prefill and training go through ``kernels.flash_attention`` (on the
card the hand-written kernel, on the CPU its plain version) and decode
through ``kernels.decode_attention``.

Unlike the JAX package, which returns new cache arrays, the port writes the
caches in place: a decode step stores one slot and a prefill its rows,
without copying the rest of the cache.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ATTN_LOCAL, ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.modeling.layers import apply_rope, rope_freqs

EMPTY_SLOT = 2 ** 30     # position of a ring slot no token has filled yet


def attn_shapes(cfg: ModelConfig) -> dict:
    """The layer's parameter shapes (``attn_defs``)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {"wq": (d, cfg.n_heads, hd), "wk": (d, cfg.n_kv_heads, hd),
            "wv": (d, cfg.n_kv_heads, hd), "wo": (cfg.n_heads, hd, d)}


def cache_len(cfg: ModelConfig, max_seq: int, kind: str) -> int:
    """Slots of a layer's cache (``attn_cache_defs``): a local layer keeps a
    ring of ``window`` slots when the sequence can outgrow it."""
    if kind == ATTN_LOCAL and cfg.window_size:
        return min(max_seq, cfg.window_size)
    return max_seq


def init_attn_cache(cfg: ModelConfig, batch: int, max_seq: int, kind: str,
                    dtype, device) -> dict:
    shape = (batch, cache_len(cfg, max_seq, kind), cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def ring_positions(buf: int, pos: int, device) -> torch.Tensor:
    """int32 [buf]: the absolute position held in each slot of a ring cache
    once the token at ``pos`` is written at slot ``pos % buf``; slots that no
    token has reached yet map to EMPTY_SLOT (``attention.py:377-385``)."""
    idx = torch.arange(buf, device=device, dtype=torch.int32)
    slot, turn = pos % buf, pos // buf
    offs = torch.where(idx <= slot, turn * buf + idx, (turn - 1) * buf + idx)
    return torch.where(offs < 0, EMPTY_SLOT, offs).to(torch.int32)


def attn_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, *, kind: str,
               mode: str, pos0: int, cache: Optional[dict],
               ring_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One self-attention layer.  mode: train | prefill | decode.

    ``pos0`` is the absolute position of x[:, 0], a host int; train and
    prefill start at 0.  A prefill writes the cache (the ring layout of
    ``attention.py:410-414`` when the prompt outgrows the ring), a decode
    step writes slot ``pos0 % L`` and attends through the cache.
    ``ring_pos`` is ``ring_positions(window, pos0)``, which the model
    computes once per decode step for all local layers."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    cap = cfg.attn_logit_softcap
    local = kind == ATTN_LOCAL
    window = cfg.window_size if local else 0
    theta = min(cfg.rope_theta, 10_000.0) if local else cfg.rope_theta

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    q_pos = torch.arange(S, device=x.device) + pos0
    sin, cos = rope_freqs(q_pos, hd, theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    v = v.contiguous()          # the kernels take contiguous rows

    if mode == "decode":
        if S != 1:
            raise ValueError(f"decode takes one token per row, got {S}")
        buf = cache["k"].shape[1]
        slot = pos0 % buf
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        k_pos = None
        if window and buf == window:
            k_pos = ring_pos if ring_pos is not None else \
                ring_positions(buf, pos0, x.device)
        o = decode_attention(q[:, 0], cache["k"], cache["v"], pos0,
                             window=window, softcap=cap, k_pos=k_pos)[:, None]
    else:
        if pos0 != 0:
            raise ValueError("train and prefill start at position 0")
        if cache is not None:
            buf = cache["k"].shape[1]
            if buf >= S:
                cache["k"][:, :S] = k.to(cache["k"].dtype)
                cache["v"][:, :S] = v.to(cache["v"].dtype)
            else:      # ring: the last buf rows, slot(p) = p % buf
                shift = S % buf
                cache["k"].copy_(torch.roll(k[:, -buf:], shift, dims=1))
                cache["v"].copy_(torch.roll(v[:, -buf:], shift, dims=1))
        o = flash_attention(q, k, v, causal=True, window=window, softcap=cap)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
