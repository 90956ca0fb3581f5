"""command-r-35b [dense]: 40L d=8192 64H (GQA kv=8) ff=22528 vocab=256000.

GQA, no biases.  hf:CohereForAI/c4ai-command-r-v01.
"""
from repro_torch.configs.base import ModelConfig, register


@register("command-r-35b")
def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b", family="dense",
        n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=22528, vocab_size=256000,
        mlp_type="swiglu", rope_theta=8e6,
        tie_embeddings=True,
    )
