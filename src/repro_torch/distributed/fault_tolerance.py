"""Fault tolerance: retries, straggler deadlines, elastic restart planning.

Thin wrappers over the guard subsystem's primitives
(`repro_torch.guard.fallback`), so the training loop and the guarded
matmul path share one retry/backoff implementation and one health ledger:

  * StepGuard — runs one training step with a wall-clock deadline
    (straggler mitigation: a step exceeding `deadline_factor` x the
    trailing median is declared straggled; on a fleet the caller would
    re-dispatch it onto a re-formed mesh) — `fallback.StragglerGuard`;
  * retry_step — bounded retry of a step on transient failure with
    jittered exponential backoff, replaying from the last known-good state
    (the step function is pure, so the replay is exact) —
    `fallback.retry_call`;
  * ElasticPlan — given a checkpoint's mesh shape and the surviving device
    count, pick the largest valid mesh and report the resharding plan
    (checkpoints are mesh-agnostic, see `checkpoint.ckpt`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.guard.fallback import (Backoff, StragglerGuard,
                                        TransientFault, retry_call)


class StepFailed(TransientFault):
    """A training step failed transiently (injected or infrastructure)."""


# Short jittered backoff between step replays: long enough to ride out a
# transient device hiccup, de-synchronized so replaying workers do not
# re-collide, short enough to be invisible in the tests.
_STEP_BACKOFF = Backoff(base_s=0.002, max_s=0.05, jitter_frac=0.5)


class StepGuard(StragglerGuard):
    """Trailing-median straggler deadline for training steps (the
    historical name for `guard.fallback.StragglerGuard`)."""


def retry_step(step_fn: Callable[[Any, Any], Any], state: Any, batch: Any,
               *, max_retries: int = 2,
               on_failure: Callable[[int, Exception], None] | None = None):
    """Run step_fn(state, batch), replaying from `state` on failure.

    step_fn is pure, so re-execution from the same inputs is exact;
    `state` is only replaced on success, which is what makes the retry
    safe (no torn optimizer updates).  Retries ride
    `guard.fallback.retry_call`: jittered backoff between attempts, every
    replay counted in the guard health ledger.
    """
    return retry_call(lambda: step_fn(state, batch),
                      max_retries=max_retries, retry_on=(StepFailed,),
                      backoff=_STEP_BACKOFF, on_failure=on_failure)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    old_mesh: tuple[int, ...]
    new_mesh: tuple[int, ...]
    reshard: bool

    @property
    def chips(self) -> int:
        n = 1
        for s in self.new_mesh:
            n *= s
        return n


def plan_elastic_restart(old_mesh: tuple[int, ...], surviving_chips: int,
                         model_axis: int) -> ElasticPlan:
    """Largest (dp, model) mesh with the fixed model axis that fits the
    surviving chips.  DP shrinks or grows; the TP degree is kept because
    the param sharding (and so the per-chip memory) depends on it."""
    if surviving_chips < model_axis:
        raise ValueError(
            f"cannot keep TP={model_axis} with {surviving_chips} chips")
    dp = surviving_chips // model_axis
    new = (dp, model_axis)
    return ElasticPlan(old_mesh=tuple(old_mesh), new_mesh=new,
                       reshard=tuple(old_mesh) != new)
