"""Pre-dispatch plan validation and the non-finite output scrub.

Every plan a guarded dispatch is about to run — tuned, modeled or
cached — is re-costed here against the resolved chip's AMP budget
(`amp * vmem_bytes`, the same arithmetic the planners search under) and
rejected with a typed `PlanValidationError` when it no longer fits.
The dense re-cost takes the chip, `plan.vmem_bytes(d, chip)`, as the
port's planner does: on `gpu_h100` a split-K plan's second pass counts
the strip K4 stages, not the whole partial slab, so every plan the
planner returns passes its own validator on every chip.  The planners'
minimum-granule fail-over plan (`chip.mxu_sublanes` x `mxu_lanes`) is
always admitted: it is the floor the conservative rung stands on.

`scrub` is the numeric gate: a guarded kernel's output is checked for
NaN/Inf before anyone downstream can consume it.  With the guard
disengaged it returns the output untouched.  Engaged, an eager output
is read once on the host and a non-finite one raises `NumericFault`
(the ladder's cue to degrade).  While a CUDA graph is being captured no
device value may be read on the host, so with a fault scope armed the
scrub records a `torch.where` that substitutes the oracle's result
(the counterpart of the JAX package's traced branch); without one the
output is left untouched (the substitution would double every matmul).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import hw
from repro_torch.core.costmodel import BlockPlan, MatmulDims
from repro_torch.guard import faults, health
from repro_torch.guard.fallback import (
    CacheFault,
    NumericFault,
    PlanValidationError,
    max_floor,
)
from repro_torch.obs import spans as _obs
from repro_torch.sparse.costmodel import sparse_vmem_bytes
from repro_torch.sparse.layout import LayoutSummary


def engaged() -> bool:
    """Is any guard machinery live (fault scope armed or ladder tripped)?

    When False, every guard hook is a no-op and dispatch behavior is
    identical to the unguarded path.
    """
    return faults.active() is not None or max_floor() > 0


def budget_for(amp: float, chip: hw.ChipSpec, site: str) -> tuple[int, bool]:
    """The validation byte budget, possibly squeezed by amp_overflow.

    Returns (effective budget, squeezed?).
    """
    return faults.squeeze_budget(int(amp * chip.vmem_bytes), site)


def _reject(need: int, budget: int, real_budget: int, squeezed: bool,
            what: str) -> None:
    """Raise the typed rejection, ledgering an amp_overflow injection
    only when the squeeze flipped the decision (a squeeze the plan
    survives is not a fault)."""
    health.record("plans_rejected")
    injected = squeezed and need <= real_budget
    if injected:
        health.record("faults_injected")
        health.record("injected_amp_overflow")
    _obs.event("validate", what, need=need, budget=budget, rejected=True,
               injected=injected)
    raise PlanValidationError(
        f"{what}: working set {need} B exceeds AMP budget {budget} B",
        injected=injected)


def _check_corrupt(plan: BlockPlan, what: str) -> None:
    if faults.is_corrupt_plan(plan):
        raise CacheFault(f"{what}: corrupt tuned-cache plan "
                         f"({plan.bm}x{plan.bk}x{plan.bn})", injected=True)


def validate_dense(plan: BlockPlan, m: int, k: int, n: int, *,
                   batch: int = 1, dtype_bytes: int, amp: float,
                   chip: hw.ChipSpec, site: str = "dense") -> None:
    """Re-cost a dense plan against the AMP budget; raise on overflow."""
    _check_corrupt(plan, site)
    sub, lane = chip.mxu_sublanes, chip.mxu_lanes
    if plan.bm <= sub and plan.bk <= lane and plan.bn <= lane:
        return  # the minimum-granule fail-over floor is always admitted
    d = MatmulDims(m=m, k=k, n=n, dtype_bytes=dtype_bytes, batch=batch)
    budget, squeezed = budget_for(amp, chip, site)
    need = plan.vmem_bytes(d, chip)
    if need > budget:
        _reject(need, budget, int(amp * chip.vmem_bytes), squeezed,
                f"{site} plan {plan.schedule}/{plan.bm}x{plan.bk}x{plan.bn}")


def validate_sparse(plan: BlockPlan, summary: LayoutSummary, n: int, *,
                    dtype_bytes: int, amp: float, chip: hw.ChipSpec,
                    site: str = "sparse") -> None:
    """Re-cost a block-sparse plan (index tables included) likewise."""
    _check_corrupt(plan, site)
    if plan.bn <= chip.mxu_lanes:
        return  # minimum-granule rhs block: the fail-over floor
    budget, squeezed = budget_for(amp, chip, site)
    need = sparse_vmem_bytes(summary, plan, dtype_bytes)
    if need > budget:
        _reject(need, budget, int(amp * chip.vmem_bytes), squeezed,
                f"{site} plan {plan.schedule}/bn{plan.bn}")


def validate_grouped(plan: BlockPlan, groups: int, m: int, k: int, *,
                     dtype_bytes: int, amp: float, chip: hw.ChipSpec,
                     site: str = "grouped") -> None:
    """Re-cost a grouped (block-diagonal) plan likewise."""
    _check_corrupt(plan, site)
    sub, lane = chip.mxu_sublanes, chip.mxu_lanes
    if plan.bm <= sub and plan.bk <= lane and plan.bn <= lane:
        return
    budget, squeezed = budget_for(amp, chip, site)
    need = _grouped_need(plan, groups, m, k, dtype_bytes)
    if need > budget:
        _reject(need, budget, int(amp * chip.vmem_bytes), squeezed,
                f"{site} plan {plan.bm}x{plan.bk}x{plan.bn}")


@functools.lru_cache(maxsize=4096)
def _grouped_need(plan: BlockPlan, groups: int, m: int, k: int,
                  dtype_bytes: int) -> int:
    """A grouped plan's working set (memoised: building the block-diagonal
    summary costs more than the rest of the validation together, and a
    served model validates the same few plans every step)."""
    summary = LayoutSummary.block_diag(groups, m, k, (plan.bm, plan.bk))
    return sparse_vmem_bytes(summary, plan, dtype_bytes)


# ------------------------------------------------------------------ scrub
def capturing() -> bool:
    """Is a CUDA graph being captured on the current stream?"""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def scrub(out: torch.Tensor, site: str, *, injected: int = 0,
          ref_fn=None) -> torch.Tensor:
    """Gate a kernel output on finiteness before anyone consumes it.

    Disengaged: the output, untouched.  Engaged and eager: a NaN/Inf
    raises `NumericFault` — the injected count is ledgered as caught
    here, at detection.  During a CUDA graph capture with a fault scope
    armed: substitute the oracle via `torch.where` (no host read may
    happen mid-capture); with no scope the output passes untouched.
    """
    if capturing():
        if faults.active() is None or ref_fn is None:
            return out
        if injected:
            health.record("faults_caught", injected)
            health.record("scrub_substituted")
        ok = torch.isfinite(out).all()
        return torch.where(ok, out, ref_fn().to(out.dtype))
    if not engaged():
        return out
    if bool(torch.isfinite(out).all()):
        return out
    if injected:
        health.record("faults_caught", injected)
    e = NumericFault(f"non-finite kernel output at {site}",
                     injected=bool(injected))
    e._counted = True  # ledgered above at detection, not per-handler
    raise e
