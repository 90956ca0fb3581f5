"""deepseek-v3-671b [moe]: 61L d=7168 128H MLA, 1 shared + 256 routed top-8.

MLA (q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64, v 128), fine-grained
expert ff=2048, first 3 layers dense (ff=18432), MTP head.  arXiv:2412.19437.
"""
from repro_torch.configs.base import ModelConfig, register


@register("deepseek-v3-671b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
        d_ff=18432, vocab_size=129280,
        layer_pattern=("attn_moe",),
        n_experts=256, n_experts_per_tok=8, n_shared_experts=1,
        moe_d_ff=2048, first_k_dense=3, capacity_factor=1.25,
        use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        mtp_heads=1,
    )
