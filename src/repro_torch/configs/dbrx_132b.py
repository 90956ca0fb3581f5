"""dbrx-132b [moe]: 40L d=6144 48H (GQA kv=8) expert_ff=10752 vocab=100352.

16 experts, top-4, fine-grained SwiGLU experts.  hf:databricks/dbrx-base.
"""
from repro_torch.configs.base import ModelConfig, register


@register("dbrx-132b")
def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=10752, vocab_size=100352,
        layer_pattern=("attn_moe",),
        n_experts=16, n_experts_per_tok=4, moe_d_ff=10752,
        rope_theta=5e5,
    )
