"""Guarded execution: fault injection, validation, fallback, telemetry.

The JAX package's `repro.guard`, ported: the robustness floor under the
plan→tune→serve path.  Four modules:

  * `faults` — deterministic seedable fault injection behind the
    thread-local `fault_scope()` context (mirrors `mm_config()`);
  * `validate` — pre-dispatch plan re-costing against the AMP budget
    plus the NaN/Inf output scrub;
  * `fallback` — the typed `GuardError` hierarchy, retry/backoff
    primitives, and the one-way degradation ladder
    tuned → modeled → conservative k_inner → PyTorch reference;
  * `health` — process-wide counters (over `repro_torch.obs.metrics`)
    surfaced through bench provenance.

With no `fault_scope()` armed and no ladder tripped every hook is a
no-op: a dispatch launches the same kernel it launches unguarded.  On
CUDA tensors only an injected fault moves a rung; a real one raises.
`reset()` returns the process to a clean slate (ladders un-tripped,
counters zeroed) — tests and measurement phases only.
"""

from repro_torch.guard import health
from repro_torch.guard.fallback import (
    LEVELS,
    Backoff,
    CacheFault,
    GuardError,
    Ladder,
    NumericFault,
    PlanValidationError,
    StragglerGuard,
    TransientFault,
    ladder,
    reset_ladders,
    retry_call,
)
from repro_torch.guard.faults import FAULT_KINDS, FaultSpec, fault_scope
from repro_torch.guard.validate import engaged

__all__ = [
    "LEVELS",
    "FAULT_KINDS",
    "Backoff",
    "CacheFault",
    "FaultSpec",
    "GuardError",
    "Ladder",
    "NumericFault",
    "PlanValidationError",
    "StragglerGuard",
    "TransientFault",
    "engaged",
    "fault_scope",
    "health",
    "ladder",
    "reset",
    "reset_ladders",
    "retry_call",
]


def reset() -> None:
    """Clean slate: un-trip every ladder and zero every counter."""
    reset_ladders()
    health.reset()
