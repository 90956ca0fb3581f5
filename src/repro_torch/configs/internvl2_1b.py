"""internvl2-1b [vlm]: Qwen2-0.5B backbone, 24L d=896 14H (GQA kv=2) ff=4864.

InternViT vision frontend is a stub — callers pass precomputed patch
embeddings, prepended to the token sequence.  arXiv:2404.16821.
"""
from repro_torch.configs.base import ModelConfig, register


@register("internvl2-1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", family="vlm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=4864, vocab_size=151655,
        mlp_type="swiglu", attn_qkv_bias=True, rope_theta=1e6,
        frontend="patch", frontend_len=256,
        tie_embeddings=True,
    )
