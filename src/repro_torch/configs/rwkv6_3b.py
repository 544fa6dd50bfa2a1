"""RWKV6-3B "Finch": attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
from repro_torch.configs.base import RWKV, ModelConfig, register


@register("rwkv6-3b")
def rwkv6_3b() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="ssm",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
        d_ff=8960, vocab_size=65536,
        block_pattern=(RWKV,), rwkv_head_dim=64,
        grad_accum=8,
    )
