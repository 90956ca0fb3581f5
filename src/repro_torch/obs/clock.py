"""Attribution clocks — the injectable `measured_us` source.

`SimClock` is the test surface: it "measures" a dispatch at exactly the
cost model's prediction, so traces are deterministic, integer-exact
across hosts, and per-class drift is identically zero — any non-zero
drift in a sim-clock run means the modeled/measured plumbing itself
broke.  `WallClock` is the live surface: `perf_counter` around the
thunk, bracketed by `torch.cuda.synchronize()` on the output's device
(before the start, so work queued earlier is not charged to this
dispatch, and after the thunk, so measured_us covers the device's
execution rather than the launch) — the counterpart of the JAX clock's
`block_until_ready`.  While a CUDA graph is being captured nothing may
synchronise: the thunk runs (it is recorded, not executed) and the
measurement is None, as a traced output gives in the JAX package.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch


class SimClock:
    """Modeled measurer: measured == modeled, exactly."""

    wall = False

    def measure(
        self, fn: Callable[[], Any], modeled_us: float | None = None
    ) -> tuple[Any, float | None]:
        return fn(), modeled_us


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class WallClock:
    """perf_counter measurer, synchronised on the card around the thunk."""

    wall = True

    def __init__(self):
        self._t0 = time.perf_counter()

    def now_us(self) -> float:
        """Microseconds since this clock was armed (span timestamps)."""
        return (time.perf_counter() - self._t0) * 1e6

    def measure(
        self, fn: Callable[[], Any], modeled_us: float | None = None
    ) -> tuple[Any, float | None]:
        del modeled_us
        if _capturing():
            return fn(), None
        synced = torch.cuda.is_initialized()
        if synced:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if isinstance(out, torch.Tensor) and out.is_cuda:
            torch.cuda.synchronize(out.device)
        elif synced:
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e6


def make_clock(kind: str | None):
    """CLI helper: 'sim' → SimClock, 'wall' → WallClock, None → None."""
    if kind is None or kind == "none":
        return None
    if kind == "sim":
        return SimClock()
    if kind == "wall":
        return WallClock()
    raise ValueError(f"unknown clock kind {kind!r} (expected sim|wall|none)")
