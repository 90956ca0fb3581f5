"""The paper's own benchmark "architecture": bare skewed/squared matmuls.

The JAX package's benchmark harness sweeps it to reproduce Fig. 4/5 and the
vertex-count table; the port serves it like the other dense configs.
"""
from repro_torch.configs.base import ModelConfig, register


@register("paper-skewmm")
def config() -> ModelConfig:
    return ModelConfig(
        name="paper-skewmm", family="dense",
        n_layers=1, d_model=3584, n_heads=1, n_kv_heads=1, head_dim=128,
        d_ff=3584, vocab_size=256,
        mlp_type="gelu", dtype="float32",
    )
