"""Architecture config system + registry.

One `ModelConfig` describes any member of the zoo (dense / MoE / SSM / hybrid
/ enc-dec / VLM).  Each ported architecture gets a module under
`repro_torch.configs` registering its exact published config; `reduced()`
derives the same-family smoke-test config.  The port registers the dense
archs it can run; the dataclass keeps every field so configs stay
field-for-field comparable with the JAX package's.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

_REGISTRY: dict[str, Callable[[], "ModelConfig"]] = {}

ARCH_IDS = ["phi4-mini-3.8b"]

_MODULE_FOR = {
    "phi4-mini-3.8b": "phi4_mini_3p8b",
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    mlp_type: str = "swiglu"       # swiglu | gelu
    attn_qkv_bias: bool = False
    rope_theta: float = 10000.0
    pos_embedding: str = "rope"    # rope | sinusoidal
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    local_window: int | None = None
    # The repeating block-kind unit, e.g. ("attn_global",) or
    # ("attn_local", "attn_global") or ("rec", "rec", "attn_local").
    layer_pattern: tuple[str, ...] = ("attn_global",)
    use_post_norm: bool = False
    embed_scale: bool = False      # gemma-style sqrt(d) embedding scaling

    # MoE
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    first_k_dense: int = 0
    router_aux_coef: float = 0.001

    # MLA (deepseek)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp_heads: int = 0             # multi-token-prediction extra heads

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 128
    ssm_expand: int = 2
    conv_kernel: int = 4

    # RG-LRU (recurrentgemma)
    lru_width: int = 0
    rglru_c: float = 8.0

    # enc-dec
    enc_layers: int = 0

    # modality frontend stub: number of precomputed prefix embeddings
    frontend: str | None = None    # None | patch | frames
    frontend_len: int = 256

    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # ---- derived ----
    @property
    def d_inner(self) -> int:      # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def q_dim(self) -> int:
        if self.use_mla:
            return self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.n_heads * self.head_dim

    @property
    def kv_cache_kind(self) -> str:
        if self.use_mla:
            return "mla"
        return "gqa"

    def stage_list(self) -> list[tuple[tuple[str, ...], int]]:
        """[(unit_pattern, n_repeats)] covering all decoder layers exactly."""
        stages: list[tuple[tuple[str, ...], int]] = []
        layers = self.n_layers
        if self.first_k_dense:
            dense_unit = tuple(k.replace("_moe", "_dense")
                               for k in self.layer_pattern)
            stages.append((dense_unit, self.first_k_dense
                           // len(self.layer_pattern)))
            layers -= self.first_k_dense
        unit = self.layer_pattern
        n_full = layers // len(unit)
        if n_full:
            stages.append((unit, n_full))
        rem = layers - n_full * len(unit)
        if rem:
            stages.append((unit[:rem], 1))
        return stages

    def reduced(self) -> "ModelConfig":
        """Same-family tiny config for CPU smoke tests."""
        unit = len(self.layer_pattern)
        n_layers = max(unit, 2 * unit) + (1 if self.name ==
                                          "recurrentgemma-9b" else 0)
        if self.first_k_dense:
            n_layers = max(n_layers, 2)
        kv = min(self.n_kv_heads, 2)
        heads = max(kv, 4 if self.n_heads >= 4 else self.n_heads)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=128,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            local_window=min(self.local_window, 64) if self.local_window
            else None,
            n_experts=min(self.n_experts, 8) or 0,
            n_experts_per_tok=min(self.n_experts_per_tok, 2) or 0,
            moe_d_ff=128 if self.moe_d_ff else 0,
            first_k_dense=min(self.first_k_dense, 1),
            q_lora_rank=64 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_nope_dim=32 if self.qk_nope_dim else 0,
            qk_rope_dim=16 if self.qk_rope_dim else 0,
            v_head_dim=32 if self.v_head_dim else 0,
            ssm_state=min(self.ssm_state, 32) or 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=32,
            lru_width=128 if self.lru_width else 0,
            enc_layers=min(self.enc_layers, 2),
            frontend_len=16 if self.frontend else 0,
            mtp_heads=min(self.mtp_heads, 1),
            dtype="float32",
        )

    def decode_scale(self) -> "ModelConfig":
        """Decode-scale weight matrices on whatever layer stack `self` has.

        Apply on top of `reduced()` for the decode / GEMV smoke: the
        reduced dims (d_model=128, vocab=512) keep every decode GEMM at
        one grid step for *any* schedule, so the planner correctly stays
        dense there and the split-K family is unreachable.  K >= 1024
        puts the decode-step GEMMs inside the GEMV regime while staying
        small enough (~20M params fp32) for interpret-mode CI.
        """
        return dataclasses.replace(
            self,
            name=self.name + "-decode",
            d_model=1024,
            n_heads=8,
            n_kv_heads=min(8, self.n_kv_heads) if self.n_kv_heads else 8,
            head_dim=128,
            d_ff=2048,
            vocab_size=4096,
        )


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        if name in _MODULE_FOR:
            importlib.import_module(
                f"repro_torch.configs.{_MODULE_FOR[name]}")
        if name not in _REGISTRY:
            raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return _REGISTRY[name]()


def all_arch_ids() -> list[str]:
    return list(ARCH_IDS)
