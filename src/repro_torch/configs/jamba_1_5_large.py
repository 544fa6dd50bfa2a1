"""Jamba-1.5-Large (398B): Mamba+attention 7:1 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ATTN, MAMBA, ModelConfig, register


@register("jamba-1.5-large-398b")
def jamba() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=24576, vocab_size=65536,
        block_pattern=(MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA, MAMBA),
        n_experts=16, n_experts_active=2, moe_d_ff=24576, moe_period=2,
        optimizer="adafactor", seq_shard_residual=True,
        attention_impl="blocked", grad_accum=8, grad_accum_dtype="bfloat16",
    )
