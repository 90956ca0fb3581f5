"""Typed guard failures, bounded retry/backoff, and the degradation ladder.

The recovery half of the guard subsystem.  Three mechanisms:

  * `GuardError` hierarchy — every failure the guard layer can surface
    is typed (validation, transient, numeric, cache), carries an
    `injected` flag tying it back to `fault_scope()`, and is counted
    exactly once in `health` no matter how many handlers see it;
  * `retry_call` + `Backoff` — bounded re-execution for transient
    faults with deterministic jittered exponential backoff;
  * the ladder — per-site one-way degradation tuned → modeled →
    conservative k_inner → PyTorch reference.  `Ladder.trip` latches: once
    a level has failed, every later dispatch at that site starts below
    it for the life of the process (no flapping between a flaky tuned
    plan and its fallback).  `run_laddered` is the dispatch loop
    `kernels/ops.py` routes auto-planned matmuls through.

The reference rung runs the plain PyTorch oracle (`kernels/ref.py`) —
no hand-written kernel, no planning, no poisoning hooks — so the chain
provably terminates with oracle-exact output.  Only a `GuardError` moves
a rung: any other exception (a CUDA build error, a library that does not
load, a launch error raised by a binding) propagates untouched, so a
broken kernel is never hidden behind the oracle.  On CUDA tensors the
dispatch sites go further (`strict`): only a fault that `fault_scope()`
injected moves a rung, and a real one (a kernel's non-finite output, a
validator rejecting a plan its planner chose) raises, so the plain
version never quietly takes a hand-written kernel's place on the card.
"""

from __future__ import annotations

import dataclasses
import statistics
import threading
import time
import zlib
from typing import Any, Callable

from repro_torch.guard import health
from repro_torch.obs import spans as _obs

LEVELS = ("tuned", "modeled", "conservative", "reference")


# ------------------------------------------------------------ exceptions
class GuardError(RuntimeError):
    """Base of every typed guard failure.

    `injected` marks faults that originated in `fault_scope()` (so the
    health ledger can keep faults_caught == faults_injected); counting
    is idempotent via `count_caught`.
    """

    def __init__(self, *args, injected: bool = False):
        super().__init__(*args)
        self.injected = injected
        self._counted = False


class PlanValidationError(GuardError):
    """Pre-dispatch validation rejected a plan (AMP budget exceeded)."""


class TransientFault(GuardError):
    """A retryable infrastructure blip (kernel raise, preemption)."""


class NumericFault(GuardError):
    """A kernel produced non-finite output (caught by the scrub)."""


class CacheFault(GuardError):
    """A tuned-cache entry was corrupt or unusable."""


def count_caught(e: BaseException) -> None:
    """Record an injected fault as caught, exactly once per exception."""
    if getattr(e, "injected", False) and not getattr(e, "_counted", False):
        e._counted = True
        health.record("faults_caught")


# --------------------------------------------------------------- backoff
@dataclasses.dataclass(frozen=True)
class Backoff:
    """Deterministic jittered exponential backoff schedule.

    delay(attempt) = min(base_s * factor^attempt, max_s), scaled by a
    jitter in [1 - jitter_frac, 1 + jitter_frac] hashed from (seed,
    attempt) — reproducible like everything else in the guard layer,
    but de-synchronized across seeds so retrying workers don't
    stampede in lockstep.
    """

    base_s: float = 0.001
    factor: float = 2.0
    max_s: float = 0.05
    jitter_frac: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.base_s < 0 or self.max_s < 0:
            raise ValueError("backoff delays must be non-negative")
        if not 0.0 <= self.jitter_frac <= 1.0:
            raise ValueError(f"jitter_frac must be in [0, 1], "
                             f"got {self.jitter_frac}")

    def delay(self, attempt: int) -> float:
        d = min(self.base_s * self.factor ** attempt, self.max_s)
        if self.jitter_frac:
            u = zlib.crc32(f"{self.seed}/{attempt}".encode()) / 2**32
            d *= 1.0 + self.jitter_frac * (2.0 * u - 1.0)
        return d


def retry_call(
    fn: Callable[[], Any],
    *,
    max_retries: int = 2,
    retry_on: tuple = (TransientFault,),
    backoff: Backoff | None = None,
    on_failure: Callable[[int, Exception], None] | None = None,
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Run `fn()` with up to `max_retries` re-executions on `retry_on`.

    Callers pass pure functions (replay is exact); non-retryable
    exceptions propagate immediately.  Every caught retryable exception
    is ledgered via `count_caught`; each re-execution bumps the
    `retries` counter.  On exhaustion the last exception is re-raised.
    """
    err: Exception | None = None
    for attempt in range(max_retries + 1):
        try:
            return fn()
        except retry_on as e:
            count_caught(e)
            err = e
            if on_failure:
                on_failure(attempt, e)
            if attempt < max_retries:
                health.record("retries")
                _obs.event("retry", type(e).__name__, attempt=attempt)
                if backoff is not None:
                    sleep(backoff.delay(attempt))
    raise err


# ---------------------------------------------------------------- ladder
_REG_LOCK = threading.Lock()
_LADDERS: dict[str, "Ladder"] = {}
# The deepest floor across all sites, kept by `Ladder.trip` (floors only
# descend) so that `max_floor()` — read on every eager dispatch through
# `validate.engaged()` — is one global read, not a locked scan.
_MAX_FLOOR = 0


class Ladder:
    """Per-site one-way degradation latch over `LEVELS`.

    `floor` is the index of the highest level still trusted; `trip`
    moves it down (toward "reference") and never back up.  All state
    transitions are process-wide and thread-safe — two serving threads
    share one ladder per site, which is the point (no flapping).
    """

    def __init__(self, site: str):
        self.site = site
        self._floor = 0
        self.trips: list[tuple[str, str]] = []

    @property
    def floor(self) -> int:
        return self._floor

    @property
    def level(self) -> str:
        return LEVELS[self._floor]

    def start(self, preferred: str) -> int:
        """Where a dispatch preferring `preferred` actually starts."""
        return max(LEVELS.index(preferred), self._floor)

    def trip(self, level: str, reason: str) -> None:
        """Latch `level` as failed: future dispatches start below it."""
        global _MAX_FLOOR
        with _REG_LOCK:
            nxt = min(LEVELS.index(level) + 1, len(LEVELS) - 1)
            self.trips.append((level, reason))
            if nxt > self._floor:
                self._floor = nxt
                _MAX_FLOOR = max(_MAX_FLOOR, nxt)
                health.record("fallbacks")
                health.set_gauge("fallback_level", nxt)


def ladder(site: str) -> Ladder:
    """The process-wide ladder for a dispatch site ("dense", ...)."""
    with _REG_LOCK:
        lad = _LADDERS.get(site)
        if lad is None:
            lad = _LADDERS[site] = Ladder(site)
        return lad


def reset_ladders() -> None:
    """Forget every latch.  Tests and the `guard` bench suite only."""
    global _MAX_FLOOR
    with _REG_LOCK:
        _LADDERS.clear()
        _MAX_FLOOR = 0


def max_floor() -> int:
    """The deepest floor across all sites (the health gauge's source)."""
    return _MAX_FLOOR


# -------------------------------------------------------------- dispatch
_KERNEL_BACKOFF = Backoff(base_s=0.001, max_s=0.02, jitter_frac=0.5)


def guarded_kernel(run: Callable[[], Any], site: str,
                   ref_fn: Callable[[], Any] | None = None) -> Any:
    """One kernel execution under the fault hooks + NaN/Inf scrub.

    Wraps `run()` with transient injection, output poisoning and the
    scrub (`validate.scrub`), retrying transient faults with jittered
    backoff.  `NumericFault` is *not* retried — a poisoned output is
    deterministic under replay, so the remedy is a ladder trip, not a
    re-run.  Disengaged (no fault scope, no tripped ladder) every hook is
    a no-op, so `run()` is called once, directly.
    """
    from repro_torch.guard import faults, validate  # guard-internal cycle

    if not validate.engaged():
        return run()

    def attempt():
        faults.maybe_raise_transient(site)
        out = run()
        out, injected = faults.maybe_poison(out, site)
        return validate.scrub(out, site, injected=injected, ref_fn=ref_fn)

    return retry_call(attempt, max_retries=2, backoff=_KERNEL_BACKOFF)


def run_laddered(
    site: str,
    preferred: str,
    plan_for: Callable[[str], Any],
    validate_plan: Callable[[Any, str], None],
    run_kernel: Callable[[Any, str], Any],
    ref_fn: Callable[[], Any],
    strict: bool = False,
) -> Any:
    """The guarded dispatch loop: walk the ladder until a level delivers.

    Per level: build a plan, validate it against the AMP budget, run the
    kernel guarded (retry + scrub).  A `GuardError` at a level is
    counted, trips the latch, and drops to the next level; the terminal
    "reference" rung runs `ref_fn` (the PyTorch oracle) and cannot fail.
    Non-guard exceptions propagate untouched — real bugs stay loud.
    `strict` (the operands are on the card) re-raises a `GuardError` that
    no fault scope injected, before it trips anything.
    """
    lad = ladder(site)
    for level in LEVELS[lad.start(preferred):]:
        idx = LEVELS.index(level)
        with _obs.span("rung", level, site=site, index=idx) as sp:
            if level == "reference":
                _obs.annotate("dispatch", rung=level, rung_index=idx)
                return ref_fn()
            try:
                plan = plan_for(level)
                validate_plan(plan, level)
                out = guarded_kernel(lambda: run_kernel(plan, level), site,
                                     ref_fn)
                _obs.annotate("dispatch", rung=level, rung_index=idx)
                return out
            except GuardError as e:
                if strict and not e.injected:
                    raise
                count_caught(e)
                sp.set(error=type(e).__name__)
                lad.trip(level, f"{type(e).__name__}: {e}")
    return ref_fn()


# ------------------------------------------------------------ stragglers
@dataclasses.dataclass
class StragglerGuard:
    """Trailing-median wall-clock deadline for repeated step execution.

    `run(fn)` -> (result, straggled): a step exceeding `deadline_factor`
    x the trailing median (once `min_history` steps are banked) is
    flagged so the caller can re-dispatch it.
    """

    deadline_factor: float = 3.0
    min_history: int = 5
    history_cap: int = 50
    _history: list = dataclasses.field(default_factory=list)

    def run(self, fn: Callable[[], Any]) -> tuple[Any, bool]:
        t0 = time.monotonic()
        out = fn()
        dt = time.monotonic() - t0
        straggled = False
        if len(self._history) >= self.min_history:
            med = statistics.median(self._history)
            straggled = dt > self.deadline_factor * med
        self._history.append(dt)
        if len(self._history) > self.history_cap:
            self._history.pop(0)
        return out, straggled
