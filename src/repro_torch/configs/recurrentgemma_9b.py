"""recurrentgemma-9b [hybrid]: 38L d=4096 16H (MQA kv=1) ff=12288 vocab=256000.

Griffin: repeating (RG-LRU, RG-LRU, local-attn) with 2048-token window,
lru_width=4096, GeGLU MLP.  arXiv:2402.19427.
"""
from repro_torch.configs.base import ModelConfig, register


@register("recurrentgemma-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
        d_ff=12288, vocab_size=256000,
        mlp_type="swiglu",
        layer_pattern=("rec", "rec", "attn_local"),
        local_window=2048, lru_width=4096, conv_kernel=4,
        embed_scale=True, tie_embeddings=True,
    )
