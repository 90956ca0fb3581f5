"""Deterministic, seedable fault injection for the plan→tune→serve path.

The chaos half of the guard subsystem: a thread-local `fault_scope()`
context (mirroring `mm_config()` — layered, field-wise override,
innermost wins) arms a set of fault kinds, and the instrumented layers
call the `maybe_*` hooks at their injection sites.  Whether a given
draw fires is a pure function of (seed, kind, site, draw index), so a
failing chaos run replays exactly from its seed — no RNG state leaks
between scopes, and two threads with different scopes never interfere.

Fault taxonomy (`FAULT_KINDS`):

  nan_output / inf_output   poison one element of a kernel's output
                            (the silent-corruption class the NaN scrub
                            must catch before decode samples from it)
  amp_overflow              squeeze the validator's AMP budget so a
                            legitimately-planned block no longer fits
                            (the stale-cost-model class)
  cache_corrupt             serve an absurd plan from the tuned-cache
                            lookup (the stale/corrupt tune-cache class)
  transient_raise           raise `TransientFault` from the kernel call
                            (the retryable infrastructure-blip class)
  tuner_outlier             inflate one timing repeat by `outlier_x`
                            (the GC-pause class MAD rejection absorbs)

Every hook no-ops (and costs one thread-local read) when no scope is
active, so production dispatch is unaffected.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import zlib
from typing import Iterator

import torch

from repro_torch.core.costmodel import BlockPlan
from repro_torch.guard import health
from repro_torch.guard.fallback import TransientFault

FAULT_KINDS = (
    "nan_output",
    "inf_output",
    "amp_overflow",
    "cache_corrupt",
    "transient_raise",
    "tuner_outlier",
)

# The corrupted-cache sentinel: blocks no registered chip could ever
# hold (128Ki^3 at any dtype is ~10^5x over every SRAM budget), so the
# planners' existing feasibility re-check rejects it deterministically.
_CORRUPT_BLOCK = 1 << 17


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """The fully-resolved fault plan one scope runs under."""

    kinds: tuple[str, ...] = FAULT_KINDS
    seed: int = 0
    rate: float = 1.0
    max_transient: int = 1
    amp_squeeze: float = 64.0
    outlier_x: float = 50.0

    def __post_init__(self):
        kinds = (self.kinds,) if isinstance(self.kinds, str) else tuple(self.kinds)
        bad = [k for k in kinds if k not in FAULT_KINDS]
        if bad:
            raise ValueError(
                f"unknown fault kinds {bad}; must be from {FAULT_KINDS}")
        object.__setattr__(self, "kinds", kinds)
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.amp_squeeze < 1.0:
            raise ValueError("amp_squeeze must be >= 1 (it divides the budget)")


class _ScopeState:
    """One active scope: its merged spec + per-(kind, site) draw ledger."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.draws: dict[tuple[str, str], int] = {}
        self.transient_fired: dict[str, int] = {}


_TLS = threading.local()


def _stack() -> list:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def active() -> FaultSpec | None:
    """The innermost scope's spec, or None when injection is disarmed."""
    stack = _stack()
    return stack[-1].spec if stack else None


def _state() -> _ScopeState | None:
    stack = _stack()
    return stack[-1] if stack else None


_FIELDS = frozenset(f.name for f in dataclasses.fields(FaultSpec))


@contextlib.contextmanager
def fault_scope(**overrides) -> Iterator[FaultSpec]:
    """Arm fault injection for the dynamic extent of the block.

    Mirrors `mm_config`: fields left as None fall through to the
    enclosing scope (or the `FaultSpec` defaults), innermost wins
    field-wise, and the stack is thread-local.  The draw ledger resets
    at entry, so a scope's firing pattern depends only on its merged
    spec and the sequence of hook calls inside it::

        with fault_scope(kinds=("nan_output",), seed=7):
            out = ops.skew_matmul(a, b)   # poisoned, caught, degraded
    """
    bad = set(overrides) - _FIELDS
    if bad:
        raise TypeError(f"unknown fault_scope fields {sorted(bad)}; "
                        f"known: {sorted(_FIELDS)}")
    base = active()
    merged = dataclasses.asdict(base) if base is not None else {}
    merged.update({k: v for k, v in overrides.items() if v is not None})
    spec = FaultSpec(**merged)
    stack = _stack()
    stack.append(_ScopeState(spec))
    try:
        yield spec
    finally:
        stack.pop()


# ---------------------------------------------------------------- firing
def _fire(kind: str, site: str) -> bool:
    """One deterministic draw: does `kind` fire at `site` right now?

    The decision hashes (seed, kind, site, per-site draw index) — stable
    across processes and replayable from the seed alone.  rate=1.0
    always fires; rate=0.0 never does.
    """
    state = _state()
    if state is None or kind not in state.spec.kinds:
        return False
    n = state.draws.get((kind, site), 0)
    state.draws[(kind, site)] = n + 1
    if state.spec.rate >= 1.0:
        return True
    h = zlib.crc32(f"{state.spec.seed}/{kind}/{site}/{n}".encode())
    return (h / 2**32) < state.spec.rate


# ----------------------------------------------------------------- hooks
def maybe_poison(out: torch.Tensor, site: str) -> tuple[torch.Tensor, int]:
    """Poison a kernel output under nan_output / inf_output.

    Returns (possibly-poisoned output, number of faults injected).  The
    first element is NaN'd and the last Inf'd, so both kinds can fire on
    one call and the scrub must catch either.  The poison lands on a
    clone of the flattened output: the kernel's own buffer (which a
    caller may hold) is never written.  The writes are device fills (no
    host-to-device copy), so a CUDA graph capture can record them.
    """
    injected = 0
    flat = None
    if _fire("nan_output", site):
        flat = out.reshape(-1).clone()
        flat[:1].fill_(float("nan"))
        health.record("faults_injected")
        health.record("injected_nan_output")
        injected += 1
    if _fire("inf_output", site):
        if flat is None:
            flat = out.reshape(-1).clone()
        flat[-1:].fill_(float("inf"))
        health.record("faults_injected")
        health.record("injected_inf_output")
        injected += 1
    if flat is not None:
        out = flat.reshape(out.shape)
    return out, injected


def maybe_raise_transient(site: str) -> None:
    """Raise an injected `TransientFault` under transient_raise.

    Fires at most `max_transient` times per site per scope, so a bounded
    retry loop is guaranteed to reach a clean attempt eventually.
    """
    state = _state()
    if state is None:
        return
    if state.transient_fired.get(site, 0) >= state.spec.max_transient:
        return
    if _fire("transient_raise", site):
        state.transient_fired[site] = state.transient_fired.get(site, 0) + 1
        health.record("faults_injected")
        health.record("injected_transient_raise")
        raise TransientFault(f"injected transient fault at {site}",
                             injected=True)


def squeeze_budget(budget: int, site: str) -> tuple[int, bool]:
    """Shrink a validation budget under amp_overflow.

    Returns (effective budget, squeezed?).  The *injection* is only
    counted by the validator when the squeeze actually flips a
    feasibility decision — a squeeze a conservative plan still fits is
    not a fault, and counting it would break the
    faults_caught == faults_injected ledger.
    """
    if _fire("amp_overflow", site):
        spec = active()
        return max(1, int(budget / spec.amp_squeeze)), True
    return budget, False


def maybe_corrupt_lookup(plan, site: str):
    """Replace a tuned-cache lookup result under cache_corrupt.

    Fires on hits *and* misses (a corrupt cache can fabricate entries),
    returning the sentinel plan `is_corrupt_plan` recognizes; the
    planners' budget re-check rejects it and counts the catch.
    """
    if _fire("cache_corrupt", site):
        health.record("faults_injected")
        health.record("injected_cache_corrupt")
        return corrupt_plan()
    return plan


def corrupt_plan() -> BlockPlan:
    """The absurd-blocks sentinel a corrupted cache entry decodes to."""
    return BlockPlan(_CORRUPT_BLOCK, _CORRUPT_BLOCK, _CORRUPT_BLOCK,
                     schedule="k_inner")


def is_corrupt_plan(plan: BlockPlan | None) -> bool:
    return plan is not None and plan.bm == plan.bk == plan.bn == _CORRUPT_BLOCK


def outlier_scale(site: str) -> float | None:
    """Timing-inflation factor for one repeat under tuner_outlier
    (None = clean repeat).  `bench.timing.measure` multiplies the
    repeat's wall time by this and counts the injection; its MAD
    rejection counts the catch when the inflated sample is excluded."""
    if _fire("tuner_outlier", site):
        health.record("faults_injected")
        health.record("injected_tuner_outlier")
        return active().outlier_x
    return None
