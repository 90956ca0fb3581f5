"""gemma2-27b [dense]: 46L d=4608 32H (GQA kv=16) ff=36864 vocab=256000.

Local(4096-window)/global alternating attention, attn softcap 50, final
logit softcap 30, post-norms, sqrt(d) embed scaling.  arXiv:2408.00118.
"""
from repro_torch.configs.base import ModelConfig, register


@register("gemma2-27b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b", family="dense",
        n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
        d_ff=36864, vocab_size=256000,
        mlp_type="swiglu",
        layer_pattern=("attn_local", "attn_global"),
        local_window=4096, attn_softcap=50.0, final_softcap=30.0,
        use_post_norm=True, embed_scale=True, tie_embeddings=True,
    )
