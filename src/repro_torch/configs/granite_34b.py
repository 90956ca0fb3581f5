"""granite-34b [dense]: 88L d=6144 48H (MQA kv=1) ff=24576 vocab=49152.

Code model, arXiv:2405.04324.  The 34B param count implies a 2-matmul
(non-gated) GELU MLP at d_ff = 4*d_model, MQA attention.
"""
from repro_torch.configs.base import ModelConfig, register


@register("granite-34b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b", family="dense",
        n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
        d_ff=24576, vocab_size=49152,
        mlp_type="gelu",
    )
