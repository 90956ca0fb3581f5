"""mamba2-2.7b [ssm]: 64L d_model=2560, attn-free, vocab=50280, ssm_state=128.

SSD (state-space duality), arXiv:2405.21060.  d_inner = 2*d_model = 5120,
head_dim 64 -> 80 SSD heads, ngroups=1, conv kernel 4.
"""
from repro_torch.configs.base import ModelConfig, register


@register("mamba2-2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1, head_dim=64,
        d_ff=0, vocab_size=50280,
        layer_pattern=("ssm",),
        ssm_state=128, ssm_head_dim=64, ssm_groups=1, ssm_expand=2,
        ssm_chunk=128, conv_kernel=4,
        tie_embeddings=True,
    )
