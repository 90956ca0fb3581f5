"""Attribution clocks — the injectable `measured_us` source.

`SimClock` is the test surface: it "measures" a dispatch at exactly the
cost model's prediction, so traces are deterministic, integer-exact
across hosts, and per-class drift is identically zero — any non-zero
drift in a sim-clock run means the modeled/measured plumbing itself
broke.  `WallClock` is the live surface, and never waits for the card
inside a traced dispatch: on the card a pair of CUDA events on the
current stream brackets the thunk, so `measured_us` is the time the
stream took from the dispatch's first launch to its last, and the pairs
are read once, when the `trace_scope` closes (`resolve`: one synchronise,
then each span's `measured_us` and its drift sample).  A thunk whose
output is not on the card is timed by `perf_counter` at once.  While a
CUDA graph is being captured the thunk runs (it is recorded, not
executed) and the measurement is None, as a traced output gives in the
JAX package.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from repro_torch.obs.spans import capturing


class SimClock:
    """Modeled measurer: measured == modeled, exactly."""

    wall = False

    def measure(
        self, fn: Callable[[], Any], modeled_us: float | None = None,
        span: Any = None,
    ) -> tuple[Any, float | None]:
        del span
        return fn(), modeled_us


class WallClock:
    """perf_counter span timestamps; CUDA-event dispatch times on the card,
    read when the scope closes."""

    wall = True

    def __init__(self):
        self._t0 = time.perf_counter()
        self._pending: list[tuple[Any, Any, Any]] = []

    def now_us(self) -> float:
        """Microseconds since this clock was armed (span timestamps)."""
        return (time.perf_counter() - self._t0) * 1e6

    def measure(
        self, fn: Callable[[], Any], modeled_us: float | None = None,
        span: Any = None,
    ) -> tuple[Any, float | None]:
        """(fn's output, its us) — or None for the us when the card's
        event pair is deferred to `resolve()` onto `span`."""
        del modeled_us
        if capturing():
            return fn(), None
        start = None
        if span is not None and torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = fn()
        if start is not None and isinstance(out, torch.Tensor) \
                and out.is_cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._pending.append((span, start, end))
            return out, None
        return out, (time.perf_counter() - t0) * 1e6

    def resolve(self) -> None:
        """Stamp every deferred span's `measured_us` from its event pair
        (one synchronise for all) and fold its drift sample."""
        if not self._pending:
            return
        from repro_torch.obs.attribution import fold_drift

        torch.cuda.synchronize()
        pending, self._pending = self._pending, []
        for sp, start, end in pending:
            sp.set(measured_us=start.elapsed_time(end) * 1e3)
            fold_drift(sp)


def make_clock(kind: str | None):
    """CLI helper: 'sim' → SimClock, 'wall' → WallClock, None → None."""
    if kind is None or kind == "none":
        return None
    if kind == "sim":
        return SimClock()
    if kind == "wall":
        return WallClock()
    raise ValueError(f"unknown clock kind {kind!r} (expected sim|wall|none)")
