"""Gemma3-1B: 5:1 local:global attention, window 512, 128k-capable rope.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ATTN, ATTN_LOCAL, ModelConfig, register


@register("gemma3-1b")
def gemma3_1b() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", family="dense",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
        d_ff=6912, vocab_size=262144,
        block_pattern=(ATTN_LOCAL,) * 5 + (ATTN,), window_size=512,
        rope_theta=1_000_000.0, act="gelu_mlp",
        attention_impl="blocked",
        grad_accum=4,
    )
