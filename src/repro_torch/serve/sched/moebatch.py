"""Cross-request MoE batching arithmetic.

The MoE layer packs routed tokens into (n_experts, capacity) slots and
runs the expert GEMMs as one `grouped_matmul` — so slot fill is purely a
function of how many tokens hit the layer together.  A request decoded
alone contributes 1 token against the floor capacity (8 per expert):
utilization of a few percent.  The scheduler's batched decode feeds all
live rows through one step, merging every request's expert GEMMs into
the same capacity slots — `min_full_batch` tells it which batch bucket
reaches exact fill.

Fill here is the *structural* bound min(T*k, E*cap)/(E*cap): capacity is
sized for balanced routing, so the bound is what the slot geometry
admits and it is static (trace-safe) — which is exactly what the
committed bench baselines need.  `moe.track_capacity_slots()` records
these numbers into `guard.health` from inside the dispatch itself.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe


def has_moe(cfg: ModelConfig) -> bool:
    return any(
        k.endswith("_moe") for unit, _ in cfg.stage_list() for k in unit
    )


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Per-expert slot capacity for a dispatch of `n_tokens` tokens."""
    return moe._capacity(n_tokens, cfg)


def total_slots(n_tokens: int, cfg: ModelConfig) -> int:
    return cfg.n_experts * capacity(n_tokens, cfg)


def slot_utilization(n_tokens: int, cfg: ModelConfig) -> float:
    """Structural capacity-slot fill for a joint dispatch of n_tokens."""
    total = total_slots(n_tokens, cfg)
    return min(n_tokens * cfg.n_experts_per_tok, total) / total


def slot_underfill(n_tokens: int, cfg: ModelConfig) -> int:
    """Empty slots a dispatch of `n_tokens` ships to `grouped_matmul`."""
    total = total_slots(n_tokens, cfg)
    return total - min(n_tokens * cfg.n_experts_per_tok, total)


def min_full_batch(cfg: ModelConfig, limit: int = 1 << 16) -> int:
    """Smallest joint token count with zero slot underfill.

    The scheduler targets the first batch bucket >= this, so decode-time
    expert GEMMs always ship full capacity slots (the satellite
    assertion: `moe_slots_underfilled == 0` on the batched path).
    """
    t = 1
    while t <= limit:
        if slot_underfill(t, cfg) == 0:
            return t
        t += 1
    raise ValueError(
        f"no token count <= {limit} fills capacity slots exactly "
        f"(E={cfg.n_experts}, k={cfg.n_experts_per_tok}, "
        f"cf={cfg.capacity_factor})"
    )
