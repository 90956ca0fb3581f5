"""seamless-m4t-large-v2 [audio]: enc-dec 24L+24L d=1024 16H ff=8192 v=256206.

Transformer backbone only: the conformer audio frontend is a stub —
callers pass precomputed frame embeddings, fed to the encoder.
Sinusoidal positions (NLLB-style).  arXiv:2308.11596.
"""
from repro_torch.configs.base import ModelConfig, register


@register("seamless-m4t-large-v2")
def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="encdec",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=8192, vocab_size=256206,
        mlp_type="gelu", pos_embedding="sinusoidal",
        enc_layers=24, frontend="frames", frontend_len=4096,
        tie_embeddings=True,
    )
