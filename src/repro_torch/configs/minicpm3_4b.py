"""MiniCPM3-4B: dense with multi-head latent attention (MLA).
[hf:openbmb/MiniCPM3-4B; hf]"""
from repro_torch.configs.base import ATTN, ModelConfig, register


@register("minicpm3-4b")
def minicpm3() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b", family="dense",
        n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
        d_ff=6400, vocab_size=73448,
        block_pattern=(ATTN,),
        use_mla=True, q_lora_rank=768, kv_lora_rank=256,
        qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
        attention_impl="blocked",
        seq_shard_residual=True,
        grad_accum=8,
    )
