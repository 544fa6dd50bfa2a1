"""InternVL2-2B: InternViT frontend (stub) + InternLM2-1.8B backbone.
[arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ATTN, ModelConfig, register


@register("internvl2-2b")
def internvl2_2b() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b", family="vlm",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
        d_ff=8192, vocab_size=92553,
        block_pattern=(ATTN,),
        rope_theta=1_000_000.0,
        frontend="vit_stub", frontend_dim=1024,
        attention_impl="blocked",
        grad_accum=4,
    )
