"""DeepSeek-7B: llama-architecture dense. [arXiv:2401.02954; hf]"""
from repro_torch.configs.base import ATTN, ModelConfig, register


@register("deepseek-7b")
def deepseek_7b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b", family="dense",
        n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=11008, vocab_size=102400,
        block_pattern=(ATTN,),
        attention_impl="blocked",
        grad_accum=8,
    )
