"""Attention layers of the dense decoder: GQA/MQA/MHA, sliding windows,
multi-head latent attention (MLA) and KV caches.

Port of ``repro/modeling/attention.py``.  Parameters keep the JAX layouts:
wq [d, H, hd], wk/wv [d, KV, hd], wo [H, hd, d]; caches are [B, L, KV,
hd].  MLA (minicpm3-4b, ``_mla_apply``) keeps its seven leaves
(``mla_defs``) and its two latent caches, ckv [B, L, kv_lora] and krope
[B, L, rope]: train and prefill expand the latents into per-head keys
(q/k head nope + rope, the rope part shared by every head) and values (v
head) for ``kernels.flash_attention``; decode stays in the absorbed form,
q_nope . wk_b against ckv, through ``kernels.decode_attention.
mla_decode_attention``, and applies wv_b to its output.  The absorption
products and the projections are einsums, as the JAX package leaves them
to XLA.

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
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  mla_decode_attention)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.modeling.layers import apply_rope, rms_norm, rope_freqs

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


# ------------------------------------------------------------------- MLA

def mla_defs(cfg: ModelConfig) -> dict:
    """The MLA layer's leaves (``attn_defs`` with ``use_mla``): name ->
    (shape, init, scale), with ``materialize``'s kinds."""
    d, H = cfg.d_model, cfg.n_heads
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": ((d, cfg.q_lora_rank), "normal", 1.0),
        "q_norm": ((cfg.q_lora_rank,), "zeros", 1.0),
        "wq_b": ((cfg.q_lora_rank, H, nd + rd), "normal", 1.0),
        "wkv_a": ((d, cfg.kv_lora_rank + rd), "normal", 1.0),
        "kv_norm": ((cfg.kv_lora_rank,), "zeros", 1.0),
        "wkv_b": ((cfg.kv_lora_rank, H, nd + vd), "normal", 1.0),
        "wo": ((H, vd, d), "normal", 1.0),
    }


def init_mla_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                   device) -> dict:
    """The latent caches (``attn_cache_defs`` with ``use_mla``): ckv [B, L,
    kv_lora] and krope [B, L, rope], zeroed."""
    return {"ckv": torch.zeros(batch, max_seq, cfg.kv_lora_rank,
                               dtype=dtype, device=device),
            "krope": torch.zeros(batch, max_seq, cfg.qk_rope_dim,
                                 dtype=dtype, device=device)}


def mla_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, *, mode: str,
              pos0: int, cache: Optional[dict]) -> torch.Tensor:
    """One MLA layer (``_mla_apply``).  mode: train | prefill | decode.

    Train and prefill attend through per-head keys [k_nope | k_rope]
    (q/k head nope + rope) and values (v head) made from the latent; a
    prefill writes ckv and the roped krope into the caches.  A decode
    step writes slot ``pos0`` of both caches and attends in absorbed form:
    q_lat = q_nope . wk_b against ckv, the output through wv_b."""
    B, S, _ = x.shape
    nd, rd = cfg.qk_nope_dim, cfg.qk_rope_dim
    C, H = cfg.kv_lora_rank, cfg.n_heads
    scale = (nd + rd) ** -0.5
    cq = rms_norm(x @ p["wq_a"].to(x.dtype), p["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, p["wq_b"].to(x.dtype))
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    ckv_full = x @ p["wkv_a"].to(x.dtype)
    ckv = rms_norm(ckv_full[..., :C], p["kv_norm"], cfg.norm_eps)
    q_pos = torch.arange(S, device=x.device) + pos0
    sin, cos = rope_freqs(q_pos, rd, cfg.rope_theta)
    q_rope = apply_rope(q_rope, sin, cos)
    k_rope = apply_rope(ckv_full[..., C:][:, :, None, :], sin, cos)[:, :, 0]
    wkv_b = p["wkv_b"].to(x.dtype)
    wk_b, wv_b = wkv_b[..., :nd], wkv_b[..., nd:]

    if mode == "decode":
        if S != 1:
            raise ValueError(f"decode takes one token per row, got {S}")
        cache["ckv"][:, pos0] = ckv[:, 0].to(cache["ckv"].dtype)
        cache["krope"][:, pos0] = k_rope[:, 0].to(cache["krope"].dtype)
        q_lat = torch.einsum("bhk,chk->bhc", q_nope[:, 0], wk_b)
        o_lat = mla_decode_attention(q_lat.contiguous(),
                                     q_rope[:, 0].contiguous(), cache["ckv"],
                                     cache["krope"], pos0, scale)
        o = torch.einsum("bhc,chv->bhv", o_lat, wv_b)[:, None]
    else:
        if pos0 != 0:
            raise ValueError("train and prefill start at position 0")
        if cache is not None:
            cache["ckv"][:, :S] = ckv.to(cache["ckv"].dtype)
            cache["krope"][:, :S] = k_rope.to(cache["krope"].dtype)
        k = torch.cat([torch.einsum("bsc,chk->bshk", ckv, wk_b),
                       k_rope[:, :, None, :].expand(B, S, H, rd)], dim=-1)
        v = torch.einsum("bsc,chv->bshv", ckv, wv_b).contiguous()
        o = flash_attention(torch.cat([q_nope, q_rope], dim=-1), k, v,
                            causal=True, scale=scale)
    return torch.einsum("bshv,hvd->bsd", o, p["wo"].to(x.dtype))
