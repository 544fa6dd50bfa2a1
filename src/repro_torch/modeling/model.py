"""The decoder: embeddings, one Python loop over the layers, final norm and
the tied head.

Port of ``repro/modeling/model.py`` for the dense attention families
(gemma3, gemma2, deepseek-7b), multi-head latent attention (minicpm3-4b),
RWKV6 (rwkv6-3b), the Mamba + attention hybrid (jamba-1.5-large) and
attention + MoE (olmoe-1b-7b).  The JAX
package scans over pattern periods to keep its compiled graph small;
PyTorch runs eagerly, so the blocks and the tail are one loop over
``cfg.n_layers`` layers, each an attention (MLA where ``cfg.use_mla``),
Mamba or RWKV layer by ``cfg.layer_kind(i)``, whose FFN is an MoE where
``cfg.is_moe_layer(i)``.
``modeling.convert`` carries a JAX parameter tree into this model;
``Model.from_seed`` draws weights with ``materialize``'s distributions.

Sharding does nothing on one card, so ``sharding.shard`` and
``_maybe_shard_heads`` have no counterpart.  What the slice does not cover
raises ``NotImplementedError`` at construction.

Serving builds the weights frozen.  Training (``repro_torch.train``) calls
``Model.trainable()``, which makes every weight require grad, and
``hidden_forward`` (the backbone and the summed MoE router loss, for the
chunked loss) in train mode with a gradient runs each layer under
``cfg.remat``: "full" recomputes the layer in the backward
(``torch.utils.checkpoint``, the JAX package's ``nothing_saveable``),
"dots" keeps the outputs of its matrix products and recomputes the rest,
"none" keeps everything.  On the card an attention layer's flash
attention (MLA's at q/k head 96, v head 64), an RWKV layer's WKV6 and a
Mamba layer's scan run through their autograd Functions
(``kernels.flash_attention.FlashAttention``, ``kernels.wkv6.WKV6``,
``kernels.mamba_scan.MambaScan``: the forward kernel, then its hand-written
backward kernels), so under "full" the forward kernel runs twice a layer;
on the CPU autograd differentiates their plain versions.
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import MAMBA, RWKV, ModelConfig
from repro_torch.core.models.api import as_device
from repro_torch.modeling import attention, mamba, moe, rwkv
from repro_torch.modeling.layers import (ffn_apply, init_normal, rms_norm,
                                         softcap)

_WAITS = "not ported yet (ROADMAP.md §1, the queue of modules)"


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port's LM slice does not
    cover yet."""
    missing = []
    if cfg.use_mla and cfg.attn_logit_softcap:
        missing.append("MLA with a logit softcap")
    if cfg.n_encoder_layers or cfg.frontend != "none":
        missing.append("encoders and frontends")
    if cfg.kv_cache_dtype:
        missing.append(f"kv_cache_dtype={cfg.kv_cache_dtype!r}")
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)}: "
                                  f"{_WAITS}")


def check_trainable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless the port can train ``cfg``: it
    trains what it serves (``check_supported``), MLA included, whose
    attention runs the flash backward's (96, 64) instances on the card."""
    check_supported(cfg)


# the matrix products whose outputs remat="dots" keeps (the JAX package's
# dots_with_no_batch_dims_saveable; einsum reaches aten through bmm)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _pdict(d: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _frozen(v) for k, v in d.items()})


class DecoderLayer(nn.Module):
    """One pre-norm attention layer, then its FFN or MoE
    (``layer_apply``).  ``p`` holds ln1, attn {wq, wk, wv, wo}, ln2, ffn
    {w_up, w_down[, w_gate]} or moe {router, w_up, w_down[, w_gate]} and,
    with ``post_norm``, ln1_post and ln2_post.  ``forward`` returns (x,
    aux): aux is the MoE's router loss, a float32 scalar, or None."""

    def __init__(self, cfg: ModelConfig, i: int, p: dict):
        super().__init__()
        self.cfg, self.kind = cfg, cfg.layer_kind(i)
        self._init_mixer(p)
        self.moe = moe.MoE(cfg, p["moe"]) if "moe" in p else None
        self.ffn = _pdict(p["ffn"]) if "ffn" in p else None
        self.norms = _pdict({k: v for k, v in p.items()
                             if k.startswith("ln")})

    def _init_mixer(self, p: dict) -> None:
        self.attn = _pdict(p["attn"])

    def init_cache(self, batch: int, max_seq: int, dtype, device) -> dict:
        return attention.init_attn_cache(self.cfg, batch, max_seq, self.kind,
                                         dtype, device)

    def mix(self, h, *, mode: str, pos0: int, cache: Optional[dict],
            ring_pos=None):
        return attention.attn_apply(self.cfg, self.attn, h, kind=self.kind,
                                    mode=mode, pos0=pos0, cache=cache,
                                    ring_pos=ring_pos)

    def forward(self, x, *, mode: str, pos0: int, cache: Optional[dict],
                ring_pos=None):
        cfg, n = self.cfg, self.norms
        h = self.mix(rms_norm(x, n["ln1"], cfg.norm_eps), mode=mode,
                     pos0=pos0, cache=cache, ring_pos=ring_pos)
        if cfg.post_norm:
            h = rms_norm(h, n["ln1_post"], cfg.norm_eps)
        x = x + h
        h = rms_norm(x, n["ln2"], cfg.norm_eps)
        aux = None
        if self.moe is not None:
            h, aux = self.moe(h)
        else:
            h = ffn_apply(self.ffn, h, cfg.act)
        if cfg.post_norm:
            h = rms_norm(h, n["ln2_post"], cfg.norm_eps)
        return x + h, aux


class MambaLayer(DecoderLayer):
    """One pre-norm Mamba layer, then its FFN or MoE (the MAMBA branch of
    ``layer_apply``).  ``p`` holds mamba (``mamba.mamba_defs``) in place of
    attn.  A cache {"h", "conv"} is read and then overwritten in place."""

    def _init_mixer(self, p: dict) -> None:
        self.mamba = _pdict(p["mamba"])

    def init_cache(self, batch: int, max_seq: int, dtype, device) -> dict:
        return mamba.init_mamba_cache(self.cfg, batch, dtype, device)

    def mix(self, h, *, mode: str, pos0: int, cache: Optional[dict],
            ring_pos=None):
        return mamba.mamba_apply(self.cfg, self.mamba, h, mode=mode,
                                 cache=cache)


class MlaLayer(DecoderLayer):
    """One pre-norm MLA layer, then its FFN or MoE (``attn_apply`` with
    ``use_mla``).  ``p`` holds attn with MLA's leaves (``attention.
    mla_defs``); its cache {"ckv", "krope"} is written in place."""

    def init_cache(self, batch: int, max_seq: int, dtype, device) -> dict:
        return attention.init_mla_cache(self.cfg, batch, max_seq, dtype,
                                        device)

    def mix(self, h, *, mode: str, pos0: int, cache: Optional[dict],
            ring_pos=None):
        return attention.mla_apply(self.cfg, self.attn, h, mode=mode,
                                   pos0=pos0, cache=cache)


class RwkvLayer(nn.Module):
    """One pre-norm RWKV6 layer: time mix, then channel mix (the RWKV
    branch of ``layer_apply``).  ``p`` holds ln1, tm (``rwkv.tm_defs``),
    ln2, cm (``rwkv.cm_defs``) and, with ``post_norm``, ln1_post and
    ln2_post.  A cache {"s", "x_tm", "x_cm"} is read and then overwritten
    in place, cast to its own type as the reference casts it."""

    def __init__(self, cfg: ModelConfig, i: int, p: dict):
        super().__init__()
        self.cfg = cfg
        self.tm = _pdict(p["tm"])
        self.cm = _pdict(p["cm"])
        self.norms = _pdict({k: v for k, v in p.items()
                             if k.startswith("ln")})

    def init_cache(self, batch: int, max_seq: int, dtype, device) -> dict:
        return rwkv.init_rwkv_cache(self.cfg, batch, dtype, device)

    def forward(self, x, *, mode: str, pos0: int, cache: Optional[dict],
                ring_pos=None):
        cfg, n = self.cfg, self.norms
        h = rms_norm(x, n["ln1"], cfg.norm_eps)
        h, s_new, x_tm = rwkv.rwkv_time_mix(
            cfg, self.tm, h, cache_s=cache["s"] if cache else None,
            cache_x=cache["x_tm"] if cache else None)
        if cfg.post_norm:
            h = rms_norm(h, n["ln1_post"], cfg.norm_eps)
        x = x + h
        h = rms_norm(x, n["ln2"], cfg.norm_eps)
        h, x_cm = rwkv.rwkv_channel_mix(
            cfg, self.cm, h, cache_x=cache["x_cm"] if cache else None)
        if cache:
            cache["s"].copy_(s_new)
            cache["x_tm"].copy_(x_tm)
            cache["x_cm"].copy_(x_cm)
        if cfg.post_norm:
            h = rms_norm(h, n["ln2_post"], cfg.norm_eps)
        return x + h, None


class Model(nn.Module):
    """``params``: {"embed" [V, d], "final_norm" [d], "layers": [one dict
    per layer, as ``DecoderLayer``, ``MambaLayer`` or ``RwkvLayer`` takes],
    and "lm_head" [d, V] when the embeddings are not tied}, as tensors on
    one device."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        check_supported(cfg)
        if len(params["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(params['layers'])} layers given, "
                             f"{cfg.name} has {cfg.n_layers}")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.embed = _frozen(params["embed"])
        self.final_norm = _frozen(params["final_norm"])
        self.lm_head = (None if cfg.tie_embeddings
                        else _frozen(params["lm_head"]))
        kinds = {RWKV: RwkvLayer, MAMBA: MambaLayer}
        attn = MlaLayer if cfg.use_mla else DecoderLayer
        self.layers = nn.ModuleList(
            kinds.get(cfg.layer_kind(i), attn)(cfg, i, p)
            for i, p in enumerate(params["layers"]))

    @classmethod
    def from_seed(cls, cfg: ModelConfig, seed: int = 0, device="cuda",
                  gen_device="cpu") -> "Model":
        return cls(cfg, init_params(cfg, seed, device, gen_device))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def trainable(self) -> "Model":
        """Make every weight require grad, for training; raises for what
        the port cannot train (``check_trainable``)."""
        check_trainable(self.cfg)
        return self.requires_grad_(True)

    def init_cache(self, batch: int, max_seq: int) -> List[dict]:
        """Zeroed caches, one per layer, in the activation type: {"k", "v"}
        [batch, max_seq or the window, KV, hd] for an attention layer,
        {"ckv", "krope"} [batch, max_seq, kv_lora or rope] for an MLA one,
        {"s", "x_tm", "x_cm"} for an RWKV layer and {"h", "conv"} for a
        Mamba layer, whose sizes do not depend on ``max_seq``."""
        return [layer.init_cache(batch, max_seq, self.dtype, self.device)
                for layer in self.layers]

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens].to(self.dtype)
        return (x * math.sqrt(self.cfg.d_model)).to(self.dtype)

    def lm_logits(self, x: torch.Tensor) -> torch.Tensor:
        w = self.embed.T if self.lm_head is None else self.lm_head
        return softcap(x @ w.to(x.dtype), self.cfg.final_logit_softcap)

    def _remat(self, layer):
        """``layer`` run under ``cfg.remat`` (train mode with a gradient)."""
        remat = self.cfg.remat
        if remat == "none":
            return layer
        if remat == "full":
            return functools.partial(ckpt.checkpoint, layer,
                                     use_reentrant=False)
        if remat == "dots":
            return functools.partial(
                ckpt.checkpoint, layer, use_reentrant=False,
                context_fn=functools.partial(
                    ckpt.create_selective_checkpoint_contexts, _dots_policy))
        raise ValueError(f"unknown remat {remat!r}")

    def hidden_forward(self, tokens: torch.Tensor, *, mode: str = "train",
                       pos0: int = 0, cache: Optional[List[dict]] = None):
        """tokens [B, S] -> (hidden [B, S, d] after the final norm, aux),
        aux being the MoE layers' summed router loss (a float32 scalar, 0
        without MoE layers).  The head is applied separately, so that
        training can take a sequence-chunked loss (``hidden_forward`` of
        ``repro/modeling/model.py``)."""
        cfg = self.cfg
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode != "train" and cache is None:
            raise ValueError(f"{mode} needs a cache")
        grad = torch.is_grad_enabled() and any(
            p.requires_grad for p in self.parameters())
        if grad:
            check_trainable(cfg)
        x = self.embed_tokens(tokens)
        ring_pos = None
        if mode == "decode" and cfg.window_size and any(
                "k" in c and c["k"].shape[1] == cfg.window_size
                for c in cache):
            ring_pos = attention.ring_positions(cfg.window_size, pos0,
                                                x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, layer in enumerate(self.layers):
            run = self._remat(layer) if grad and mode == "train" else layer
            x, a = run(x, mode=mode, pos0=pos0,
                       cache=cache[i] if cache is not None else None,
                       ring_pos=ring_pos)
            if a is not None:
                aux = aux + a
        return rms_norm(x, self.final_norm, cfg.norm_eps), aux

    def forward(self, tokens: torch.Tensor, *, mode: str = "train",
                pos0: int = 0, cache: Optional[List[dict]] = None):
        """tokens [B, S] -> (logits [B, S, V], cache); prefill returns only
        the last position's logits, [B, 1, V].  ``pos0`` (a host int) is
        the position of tokens[:, 0]; a decode step takes S = 1 and writes
        the caches in place."""
        x, _ = self.hidden_forward(tokens, mode=mode, pos0=pos0, cache=cache)
        if mode == "prefill":
            x = x[:, -1:]             # only the next-token head is needed
        return self.lm_logits(x), cache


def init_params(cfg: ModelConfig, seed: int, device="cuda",
                gen_device="cpu") -> dict:
    """Seeded parameters in ``cfg.param_dtype`` with ``materialize``'s
    distributions (``modeling/layers.py``): a layer inside the scanned
    blocks draws each leaf with the fan-in of its stacked
    [n_scan_blocks, ...] JAX leaf, a tail layer with its own.  The numbers
    come from a ``torch.Generator`` on ``gen_device`` seeded with ``seed``:
    the CPU's by default, so that one seed gives the same weights on every
    device.  A CUDA generator draws on the card instead, with other
    numbers; a full-width model's billions of normals take minutes on the
    host."""
    check_supported(cfg)
    dev = as_device(device)
    dt = getattr(torch, cfg.param_dtype)
    gen = torch.Generator(device=gen_device).manual_seed(seed)
    d = cfg.d_model
    out = {"embed": init_normal((cfg.padded_vocab_size, d), gen, dt, dev,
                                scale=0.02, embed=True),
           "final_norm": torch.zeros(d, dtype=dt, device=dev),
           "layers": []}
    if not cfg.tie_embeddings:
        out["lm_head"] = init_normal((d, cfg.padded_vocab_size), gen, dt, dev)
    ffn = {"w_up": (d, cfg.d_ff), "w_down": (cfg.d_ff, d)}
    if cfg.act == "swiglu":
        ffn["w_gate"] = (d, cfg.d_ff)
    norms = ["ln1", "ln2"] + (["ln1_post", "ln2_post"] if cfg.post_norm
                              else [])
    in_blocks = cfg.n_scan_blocks * cfg.pattern_period
    for i in range(cfg.n_layers):
        lead = cfg.n_scan_blocks if cfg.scan_layers and i < in_blocks else 0
        layer = {n: torch.zeros(d, dtype=dt, device=dev) for n in norms}

        def leaves(defs):
            return {n: _leaf(shape, kind, scale, gen, dt, dev, lead)
                    for n, (shape, kind, scale) in defs.items()}

        def normals(shapes):
            return {n: init_normal(s, gen, dt, dev, lead=lead)
                    for n, s in shapes.items()}
        kind = cfg.layer_kind(i)
        if kind == RWKV:
            layer["tm"] = leaves(rwkv.tm_defs(cfg))
            layer["cm"] = leaves(rwkv.cm_defs(cfg))
        else:
            if kind == MAMBA:
                layer["mamba"] = leaves(mamba.mamba_defs(cfg))
            elif cfg.use_mla:
                layer["attn"] = leaves(attention.mla_defs(cfg))
            else:
                layer["attn"] = normals(attention.attn_shapes(cfg))
            if cfg.is_moe_layer(i):
                layer["moe"] = normals(moe.moe_shapes(cfg))
            else:
                layer["ffn"] = normals(ffn)
        out["layers"].append(layer)
    return out


def _leaf(shape, kind, scale, gen, dt, dev, lead) -> torch.Tensor:
    """One leaf of ``materialize``'s "normal", "ones" (filled with
    ``scale``) or "zeros" kind."""
    if kind == "normal":
        return init_normal(shape, gen, dt, dev, scale=scale, lead=lead)
    return torch.full(shape, scale if kind == "ones" else 0.0, dtype=dt,
                      device=dev)
