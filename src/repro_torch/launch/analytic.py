"""Analytic FLOP / HBM-byte / collective-byte model per (arch x shape x mesh).

A copy of ``repro/launch/analytic.py``, which imports no JAX, with its
imports rewired to ``repro_torch.configs``; its numbers are the JAX
package's for every config and shape (tests/test_torch_autoconfig.py).
The text below is the original's: "HBM" and "Pallas flash kernel" read as
the card's device memory and the port's flash kernel.

Why this exists: XLA's ``compiled.cost_analysis()`` counts a ``scan`` body
ONCE regardless of trip count (verified experimentally — see EXPERIMENTS.md
§Dry-run methodology), and every model here scans over layers, microbatches
and sequence chunks.  The roofline therefore uses this analytic model as the
primary FLOPs/bytes source; it is validated against cost_analysis on
fully-unrolled miniature variants (tests/test_analytic.py) and collective
bytes are cross-checked against finite-differenced HLO parses.

Conventions:
  - matmul FLOPs = 2*M*N*K; backward = 2x forward; full remat adds +1x
    forward of the rematerialized stack (train multiplier 4, no-remat 3).
  - attention: impl-aware (blocked rectangle = full S*S_pad even under the
    causal mask; triangle = exact causal; banded = S*(window+chunk)).
  - HBM bytes: weights 3x per microbatch (fwd read, bwd read, grad write) +
    optimizer state traffic + major activation streams; the jnp blocked-
    attention path materializes per-chunk score tiles in HBM whereas the
    Pallas flash kernel keeps them in VMEM — both are modeled so the kernel's
    memory-term win is visible in §Perf.
  - collectives: FSDP all-gathers (x3 with remat: fwd, bwd-recompute, bwd),
    grad reduce-scatter per microbatch, TP all-reduces (or SP AG+RS), MoE
    psum, logits all-reduce.  Ring formulas: AG/RS (n-1)/n, AR 2(n-1)/n.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, MAMBA, RWKV,
                                      ModelConfig, ShapeConfig)

BYTES = {"bfloat16": 2, "float32": 4, "float16": 2, "int8": 1}


@dataclass
class Cost:
    flops: float = 0.0                 # per device
    hbm_bytes: float = 0.0             # per device
    coll: Dict[str, float] = field(default_factory=dict)  # wire bytes/device

    def add_coll(self, kind: str, b: float):
        self.coll[kind] = self.coll.get(kind, 0.0) + b

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())


def _ring_ag(total_bytes, n):          # all-gather / reduce-scatter wire
    return total_bytes * (n - 1) / max(n, 1)


def _ring_ar(total_bytes, n):          # all-reduce wire
    return 2.0 * total_bytes * (n - 1) / max(n, 1)


def analytic_cost(cfg: ModelConfig, shape: ShapeConfig,
                  mesh_shape: Dict[str, int]) -> Cost:
    c = Cost()
    dp = mesh_shape.get("pod", 1) * mesh_shape.get("data", 1)
    tp = mesh_shape.get("model", 1)
    n_dev = dp * tp
    D = cfg.d_model
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    V = cfg.padded_vocab_size
    act_b = BYTES[cfg.dtype]
    par_b = BYTES[cfg.param_dtype]
    train = shape.kind == "train"
    decode = shape.kind == "decode"
    # tokens processed this step, per device (batch sharded over dp)
    B_loc = max(shape.global_batch // dp, 1)
    S = 1 if decode else shape.seq_len
    L_ctx = shape.seq_len            # cache length for decode
    toks = B_loc * S
    k_micro = cfg.grad_accum if train else 1
    # fwd-multiplier: fwd + bwd(2x) + remat recompute(1x)
    fmul = (4.0 if cfg.remat != "none" else 3.0) if train else 1.0

    counts = cfg.param_counts()
    n_embed = cfg.padded_vocab_size * D * (1 if cfg.tie_embeddings else 2)
    # dense per-token matmul params, active (moe top-k only)
    n_matmul_active = counts["active"] - n_embed

    # ---------------- matmul FLOPs (projections, ffn, moe, logits) --------
    c.flops += fmul * 2.0 * n_matmul_active / tp * toks
    if cfg.n_experts:
        # EP capacity slack: dispatch buffers padded to capacity_factor
        moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
        mult = 3 if cfg.act == "swiglu" else 2
        moe_flops = 2.0 * mult * D * cfg.moe_d_ff * cfg.n_experts_active
        c.flops += fmul * (cfg.capacity_factor - 1.0) * moe_flops \
            * moe_layers / tp * toks
    c.flops += fmul * 2.0 * D * V / tp * toks          # logits head

    # ---------------- attention score/value FLOPs -------------------------
    def layer_kinds():
        for i in range(cfg.n_layers):
            yield cfg.layer_kind(i)

    CHUNK = 1024
    for kind in layer_kinds():
        if kind not in (ATTN, ATTN_LOCAL):
            continue
        if cfg.use_mla:
            qk_d, v_d, heads = (cfg.qk_nope_dim + cfg.qk_rope_dim,
                                cfg.v_head_dim, H)
        else:
            qk_d, v_d, heads = hd, hd, H
        h_loc = max(heads // tp, 1)
        if decode:
            kv_len = min(L_ctx, cfg.window_size) if (
                kind == ATTN_LOCAL and cfg.window_size) else L_ctx
            if not cfg.use_mla and KV % 16 != 0:
                kv_len = kv_len / tp      # cache sharded on sequence
                h_loc = heads             # all heads, partial seq
            c.flops += 2.0 * B_loc * h_loc * kv_len * (qk_d + v_d)
            continue
        if kind == ATTN_LOCAL and cfg.window_size:
            kv_eff = min(cfg.window_size + CHUNK, S)   # banded
        elif cfg.attention_impl == "blocked_tri":
            kv_eff = (S + CHUNK) / 2.0                 # exact triangle
        elif cfg.attention_impl == "reference":
            kv_eff = S
        else:
            kv_eff = S                                  # rectangle (masked)
        c.flops += fmul * 2.0 * B_loc * h_loc * S * kv_eff * (qk_d + v_d)

    # ---------------- ssm FLOPs -------------------------------------------
    for kind in layer_kinds():
        if kind == MAMBA:
            din_loc = cfg.mamba_d_inner / tp
            c.flops += fmul * 6.0 * toks * din_loc * cfg.mamba_d_state
        elif kind == RWKV:
            hw = cfg.rwkv_head_dim
            n_h_loc = (D / hw) / tp
            chunk = 16
            # intra scores+values 2*(2*C*hw) + cross/state 2*(2*hw*hw)/token
            c.flops += fmul * toks * n_h_loc * (4.0 * chunk * hw + 4.0 * hw * hw)

    # ---------------- HBM bytes -------------------------------------------
    w_dev = counts["total"] * par_b / n_dev
    if train:
        c.hbm_bytes += 3.0 * w_dev * k_micro           # fwd+bwd reads, grad w
        opt_b = 8.0 if cfg.optimizer == "adamw" else 0.1
        c.hbm_bytes += counts["total"] * opt_b / n_dev * 2.0   # read+write
    else:
        c.hbm_bytes += w_dev
    # activation streams: ~12 tensor reads/writes of [toks, D] per layer
    seq_div = tp if cfg.seq_shard_residual else 1
    c.hbm_bytes += fmul * cfg.n_layers * 12.0 * toks * D * act_b / seq_div
    # jnp blocked attention spills per-chunk score tiles (flash kernel: no)
    if not decode and cfg.attention_impl in ("blocked", "reference"):
        n_attn = sum(1 for k in layer_kinds() if k in (ATTN, ATTN_LOCAL))
        c.hbm_bytes += fmul * n_attn * B_loc * (H / tp) * S * min(S, 1024) * 4.0 * 2
    if decode:
        # KV cache read (the decode bottleneck)
        for i, kind in enumerate(layer_kinds()):
            if kind not in (ATTN, ATTN_LOCAL):
                if kind == MAMBA:
                    c.hbm_bytes += 2 * B_loc * cfg.mamba_d_inner \
                        * cfg.mamba_d_state * 4.0 / tp
                elif kind == RWKV:
                    c.hbm_bytes += 2 * B_loc * D * cfg.rwkv_head_dim * 4.0 / tp
                continue
            if cfg.use_mla:
                per_tok = cfg.kv_lora_rank + cfg.qk_rope_dim
                c.hbm_bytes += B_loc * (L_ctx / tp) * per_tok * act_b
            else:
                kv_len = min(L_ctx, cfg.window_size) if (
                    kind == ATTN_LOCAL and cfg.window_size) else L_ctx
                kv_b = BYTES[cfg.kv_cache_dtype or cfg.dtype]
                if cfg.kv_cache_dtype == "int8":
                    kv_b += 2.0 / hd              # per-(pos,head) bf16 scale
                c.hbm_bytes += 2 * B_loc * kv_len * KV * hd * kv_b / tp
        c.hbm_bytes += B_loc * V / tp * 4.0            # logits

    # ---------------- collectives ----------------------------------------
    # FSDP weight all-gather (weights sharded over dp on the fsdp dims)
    acc_b = BYTES.get(cfg.grad_accum_dtype, 4)
    if dp > 1 and cfg.fsdp:
        ag_rounds = (3.0 * k_micro if train and cfg.remat != "none"
                     else (2.0 * k_micro if train else 1.0))
        c.add_coll("all-gather", ag_rounds * _ring_ag(
            counts["total"] * par_b / tp, dp))
        if train:
            # grad reduce-scatter per microbatch (accum-dtype partials)
            c.add_coll("reduce-scatter", k_micro * _ring_ag(
                counts["total"] * acc_b / tp, dp))
    elif dp > 1 and train:
        # replicated weights: grads accumulate locally, one DP all-reduce
        c.add_coll("all-reduce", _ring_ar(counts["total"] * acc_b / tp, dp))
    # TP activation collectives: 2 per layer fwd (+2 bwd) of [toks, D]
    if tp > 1:
        rounds = 4.0 * k_micro if train else 2.0
        per_layer = toks / k_micro * D * act_b if train else toks * D * act_b
        n_res_layers = cfg.n_layers * 2            # attn/ssm + ffn sublayers
        if cfg.seq_shard_residual:
            # SP: AG + RS instead of AR (half wire each, same sum)
            c.add_coll("all-gather", rounds / 2 * n_res_layers
                       * _ring_ag(per_layer, tp))
            c.add_coll("reduce-scatter", rounds / 2 * n_res_layers
                       * _ring_ag(per_layer, tp))
        else:
            c.add_coll("all-reduce", rounds / 2 * n_res_layers
                       * _ring_ar(per_layer, tp))
        # logits softmax partial reductions (small) + embedding grads
        c.add_coll("all-reduce", _ring_ar(toks * 4.0, tp))
    return c
