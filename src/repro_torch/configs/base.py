"""Model / workload configuration system.

Every assigned architecture is a ``ModelConfig`` registered under its public id
(``--arch <id>``).  Input shapes are ``ShapeConfig`` instances; the cross product
(arch x shape) defines the dry-run / roofline cells.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

from typing import Callable, Dict, Tuple


# Layer kinds appearing in ``block_pattern`` (repeated cyclically over depth).
ATTN = "attn"            # full (global) attention
ATTN_LOCAL = "attn_local"  # sliding-window attention
MAMBA = "mamba"          # selective-scan SSM layer
RWKV = "rwkv"            # RWKV6 time-mix layer


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    """Complete architecture description (decoder unless ``n_encoder_layers``>0)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- layer pattern -------------------------------------------------
    block_pattern: Tuple[str, ...] = (ATTN,)
    window_size: int = 0             # sliding window for ATTN_LOCAL layers
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    rope_theta: float = 10_000.0

    # --- MLA (multi-head latent attention) -----------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ------------------------------------------------------------
    n_experts: int = 0
    n_experts_active: int = 0
    moe_d_ff: int = 0
    moe_period: int = 1              # layer i is MoE iff n_experts>0 and i % moe_period == moe_period-1
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM ------------------------------------------------------------
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0           # 0 -> ceil(d_model / 16)
    rwkv_head_dim: int = 64

    # --- encoder/decoder + modality frontend ----------------------------
    n_encoder_layers: int = 0        # >0 => encoder-decoder
    frontend: str = "none"           # none | vit_stub | audio_stub
    frontend_dim: int = 0            # raw embedding dim produced by the stub frontend

    # --- numerics / perf knobs ------------------------------------------
    act: str = "swiglu"              # swiglu | gelu_mlp
    norm_eps: float = 1e-6
    post_norm: bool = False          # gemma2-style post-layer norms
    tie_embeddings: bool = True
    dtype: str = "bfloat16"          # activation dtype
    param_dtype: str = "bfloat16"
    remat: str = "full"              # none | full | dots
    scan_layers: bool = True
    seq_shard_residual: bool = False  # SP on the scan carry (giant archs)
    attention_impl: str = "reference"  # reference | blocked | blocked_tri
    moe_impl: str = "ep"             # ep (shard_map expert parallel) | dense
    optimizer: str = "adamw"         # adamw | adafactor
    grad_accum: int = 1              # microbatch count in the train step
    grad_accum_dtype: str = "float32"  # bfloat16 halves the accum buffer
    loss_chunk: int = 512            # seq-chunked cross-entropy (0 = full)
    fsdp: bool = True                # shard weights over (pod,data) axes
    pure_dp: bool = False            # small models: use ALL axes as data
                                     # parallelism (no TP), replicated weights
    kv_cache_dtype: str = ""         # "int8" = quantized serving KV cache

    # ---------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab_size(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def pattern_period(self) -> int:
        """Layers per scanned block: lcm(attention pattern, MoE period)."""
        p = len(self.block_pattern)
        if self.n_experts > 0:
            p = math.lcm(p, self.moe_period)
        return p

    @property
    def n_scan_blocks(self) -> int:
        return self.n_layers // self.pattern_period

    @property
    def n_tail_layers(self) -> int:
        return self.n_layers - self.n_scan_blocks * self.pattern_period

    def layer_kind(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    def is_moe_layer(self, i: int) -> bool:
        return self.n_experts > 0 and (i % self.moe_period) == self.moe_period - 1

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    # --- parameter counting (for roofline MODEL_FLOPS = 6*N*D) -----------
    def param_counts(self) -> Dict[str, int]:
        """Returns {"total": N, "active": N_active} (embedding included)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_total = 0
        n_active = 0

        def attn_params() -> int:
            if self.use_mla:
                q = d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                    self.qk_nope_dim + self.qk_rope_dim)
                kv = d * (self.kv_lora_rank + self.qk_rope_dim) + self.kv_lora_rank * (
                    self.n_heads * (self.qk_nope_dim + self.v_head_dim))
                o = self.n_heads * self.v_head_dim * d
                return q + kv + o
            return d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d

        def dense_ffn(ff: int) -> int:
            mult = 3 if self.act == "swiglu" else 2
            return mult * d * ff

        def mamba_params() -> int:
            din, n, dtr = self.mamba_d_inner, self.mamba_d_state, self.resolved_dt_rank
            return (d * 2 * din + din * self.mamba_d_conv + din * (dtr + 2 * n)
                    + dtr * din + din * n + din + din * d)

        def rwkv_params() -> int:
            # time-mix: r/k/v/g/o projections + decay & mix loras; channel-mix: k/v/r
            tm = 5 * d * d + d * 64 * 2 + d * 32 * 5 + 5 * 32 * d
            cm = d * self.d_ff + self.d_ff * d + d * d
            return tm + cm

        layers = self.n_layers + self.n_encoder_layers
        for i in range(layers):
            kind = self.layer_kind(i % max(self.n_layers, 1)) if i < self.n_layers else ATTN
            if kind in (ATTN, ATTN_LOCAL):
                n_total += attn_params(); n_active += attn_params()
            elif kind == MAMBA:
                n_total += mamba_params(); n_active += mamba_params()
            elif kind == RWKV:
                n_total += rwkv_params(); n_active += rwkv_params()
            if kind != RWKV:  # rwkv_params already includes channel-mix
                if self.is_moe_layer(i % max(self.n_layers, 1)) and i < self.n_layers:
                    mult = 3 if self.act == "swiglu" else 2
                    n_total += self.n_experts * mult * d * self.moe_d_ff + d * self.n_experts
                    n_active += self.n_experts_active * mult * d * self.moe_d_ff + d * self.n_experts
                else:
                    n_total += dense_ffn(self.d_ff); n_active += dense_ffn(self.d_ff)
        if self.n_encoder_layers > 0:       # decoder cross-attention blocks
            n_total += self.n_layers * attn_params()
            n_active += self.n_layers * attn_params()
        if self.frontend != "none":
            n_total += self.frontend_dim * d
            n_active += self.frontend_dim * d
        emb = self.padded_vocab_size * d * (1 if self.tie_embeddings else 2)
        n_total += emb; n_active += emb
        return {"total": n_total, "active": n_active}


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


# The four assigned LM shapes.
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in _REGISTRY:
        from repro_torch import configs  # noqa: F401  (trigger registration)
    cfg = _REGISTRY[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def list_archs():
    from repro_torch import configs  # noqa: F401
    return sorted(_REGISTRY)


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch x shape) cell."""
    if shape.name == "long_500k":
        sub_quadratic = any(k in (MAMBA, RWKV, ATTN_LOCAL) for k in cfg.block_pattern)
        if not sub_quadratic:
            return False, "pure full-attention arch: long_500k requires sub-quadratic attention"
        if cfg.n_encoder_layers > 0:
            return False, "encoder-decoder: 500k-token decode out of domain"
    return True, ""
