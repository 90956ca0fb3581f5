"""phi4-mini-3.8b [dense]: 32L d=3072 24H (GQA kv=8) ff=8192 vocab=200064.

RoPE + SwiGLU + GQA, arXiv:2412.08905.
"""
from repro_torch.configs.base import ModelConfig, register


@register("phi4-mini-3.8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=200064,
        mlp_type="swiglu", rope_theta=10000.0,
        tie_embeddings=True,
    )
