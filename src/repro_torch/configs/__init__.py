"""Architecture registry: importing this package registers all configs.

A copy of ``repro/configs`` (pure data) with its imports rewired, so that
the port needs nothing of the JAX package."""
from repro_torch.configs import (deepseek_7b, gemma2_2b, gemma3_1b,
                                 internvl2_2b, jamba_1_5_large,
                                 kimi_k2_1t_a32b, minicpm3_4b, olmoe_1b_7b,
                                 rwkv6_3b, seamless_m4t_medium)
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      get_config, list_archs, supports_shape)
import dataclasses

# the fields of a configuration that a run on one card may cut from the
# architecture's own (its depth, FFN and expert widths), as a runtime-log
# record names them
CUT_KEYS = ("n_layers", "d_ff", "moe_d_ff")


def smoke_config(name: str, **extra) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: same layer pattern and
    code paths, tiny dims, fp32, exactness-oracle impls."""
    cfg = get_config(name)
    period = cfg.pattern_period
    small = dict(
        n_layers=min(cfg.n_layers, period + cfg.n_tail_layers if cfg.n_tail_layers
                     else period),
        d_model=128,
        n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256, vocab_size=512,
        window_size=min(cfg.window_size, 16) if cfg.window_size else 0,
        dtype="float32", param_dtype="float32",
        attention_impl="reference", moe_impl="dense",
        remat="none", seq_shard_residual=False, grad_accum=1,
        optimizer="adamw",
    )
    if cfg.n_kv_heads == 1:
        small["n_kv_heads"] = 1
    if cfg.n_experts:
        small.update(n_experts=8, n_experts_active=2, moe_d_ff=64)
    if cfg.use_mla:
        small.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                     qk_rope_dim=8, v_head_dim=16)
    if cfg.frontend != "none":
        small.update(frontend_dim=24)
    if cfg.n_encoder_layers:
        small.update(n_encoder_layers=2)
    if cfg.block_pattern and "rwkv" in cfg.block_pattern:
        small.update(rwkv_head_dim=32, d_model=128)  # 4 rwkv heads
    small.update(extra)
    return dataclasses.replace(cfg, **small)
