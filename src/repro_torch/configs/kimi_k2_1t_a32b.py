"""Kimi K2: trillion-parameter MoE, 384 experts top-8 (paper-table config).
[arXiv:2501.kimi2; unverified]"""
from repro_torch.configs.base import ATTN, ModelConfig, register


@register("kimi-k2-1t-a32b")
def kimi_k2() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
        d_ff=2048, vocab_size=163840,
        block_pattern=(ATTN,),
        n_experts=384, n_experts_active=8, moe_d_ff=2048, moe_period=1,
        rope_theta=50_000.0,
        optimizer="adafactor", seq_shard_residual=True,
        attention_impl="blocked", grad_accum=8, grad_accum_dtype="bfloat16",
    )
