"""OLMoE-1B-7B: 64 experts top-8 MoE. [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ATTN, ModelConfig, register


@register("olmoe-1b-7b")
def olmoe() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab_size=50304,
        block_pattern=(ATTN,),
        n_experts=64, n_experts_active=8, moe_d_ff=1024, moe_period=1,
        attention_impl="blocked",
        grad_accum=4,
    )
