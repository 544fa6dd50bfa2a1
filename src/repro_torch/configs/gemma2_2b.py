"""Gemma2-2B: local/global alternating attention, logit softcaps, post-norms.
[arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ATTN, ATTN_LOCAL, ModelConfig, register


@register("gemma2-2b")
def gemma2_2b() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b", family="dense",
        n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
        d_ff=9216, vocab_size=256000,
        block_pattern=(ATTN_LOCAL, ATTN), window_size=4096,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        post_norm=True, act="gelu_mlp",
        attention_impl="blocked",
        grad_accum=4,
    )
