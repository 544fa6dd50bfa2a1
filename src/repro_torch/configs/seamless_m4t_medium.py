"""SeamlessM4T-medium backbone: 12L encoder + 12L decoder, audio frontend stub.
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ATTN, ModelConfig, register


@register("seamless-m4t-medium")
def seamless() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="audio",
        n_layers=12, n_encoder_layers=12,
        d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab_size=256206,
        block_pattern=(ATTN,),
        frontend="audio_stub", frontend_dim=80,
        attention_impl="blocked",
        grad_accum=4,
    )
