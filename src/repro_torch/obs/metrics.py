"""Unified metrics registry — counters, gauges, and histograms.

One process-wide `Registry` (module-level `REGISTRY`) holds
`guard.health`'s monotonic counters, its high-water `fallback_level`
gauge and the histograms (per-shape-class drift; the serving scheduler's
latency distributions once it is ported).  Handles are typed — a name
registered as a counter cannot later be read as a histogram — and every
mutation takes the registry's single RLock, so concurrent increments
from several threads stay exact.

`counts()` is the `health.snapshot()` contract (non-zero integer
values, sorted by name) the JAX chaos baselines are gated on;
`snapshot()` is the full structured view.
"""

from __future__ import annotations

import math
import threading
from typing import Iterable


def percentile_nearest_rank(values: list[float], p: float) -> float:
    """Nearest-rank percentile (ceil(p/100·N), clamped to [1, N])."""
    if not values:
        raise ValueError("percentile of empty list")
    ordered = sorted(values)
    rank = min(len(ordered), max(1, math.ceil(p / 100.0 * len(ordered))))
    return ordered[rank - 1]


class Counter:
    """Monotonic integer counter."""

    kind = "counter"

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self._lock = lock
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += int(n)

    def value(self) -> int:
        with self._lock:
            return self._value

    def _clear(self) -> None:
        self._value = 0


class Gauge:
    """Point-in-time value.  ``mode="last"`` keeps the latest set;
    ``mode="max"`` is a high-water mark that never rolls back (the
    `fallback_level` semantics the old health module implemented
    implicitly)."""

    kind = "gauge"

    def __init__(self, name: str, lock: threading.RLock, mode: str = "last"):
        if mode not in ("last", "max"):
            raise ValueError(f"gauge mode must be 'last' or 'max', got {mode!r}")
        self.name = name
        self.mode = mode
        self._lock = lock
        self._value: float | int = 0

    def set(self, value: float | int) -> None:
        with self._lock:
            if self.mode == "max":
                self._value = max(self._value, value)
            else:
                self._value = value

    def value(self) -> float | int:
        with self._lock:
            return self._value

    def _clear(self) -> None:
        self._value = 0


class Histogram:
    """Append-only distribution with nearest-rank percentiles."""

    kind = "histogram"

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self._lock = lock
        self._values: list[float] = []

    def observe(self, value: float) -> None:
        with self._lock:
            self._values.append(float(value))

    def observe_many(self, values: Iterable[float]) -> None:
        with self._lock:
            self._values.extend(float(v) for v in values)

    def count(self) -> int:
        with self._lock:
            return len(self._values)

    def total(self) -> float:
        with self._lock:
            return sum(self._values)

    def values(self) -> list[float]:
        with self._lock:
            return list(self._values)

    def percentile(self, p: float, default: float | None = None) -> float | None:
        """Nearest-rank percentile; `default` instead of raising when
        the distribution is empty (the zero-request serve-run guard)."""
        with self._lock:
            if not self._values:
                return default
            return percentile_nearest_rank(self._values, p)

    def _clear(self) -> None:
        self._values = []


class Registry:
    """Create-or-get typed metric handles under one lock."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, cls, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, self._lock, **kwargs)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}, not {cls.kind}"
            )
        for k, v in kwargs.items():
            if getattr(m, k) != v:
                raise ValueError(
                    f"metric {name!r} already registered with {k}={getattr(m, k)!r}"
                )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str, mode: str = "last") -> Gauge:
        return self._get(name, Gauge, mode=mode)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    # Convenience one-shot mutators (the health-module verbs).
    def inc(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).observe(value)

    def value(self, name: str) -> int | float:
        """Current value of a counter or gauge (0 when absent)."""
        with self._lock:
            m = self._metrics.get(name)
        if isinstance(m, (Counter, Gauge)):
            return m.value()
        return 0

    def counts(self) -> dict[str, int]:
        """Non-zero counter + gauge values as a sorted int dict — the
        `health.snapshot()` compatibility surface."""
        with self._lock:
            out = {}
            for name, m in self._metrics.items():
                if isinstance(m, (Counter, Gauge)):
                    v = m.value()
                    if v:
                        out[name] = int(v)
            return dict(sorted(out.items()))

    def histograms(self) -> dict[str, Histogram]:
        with self._lock:
            return {
                name: m
                for name, m in self._metrics.items()
                if isinstance(m, Histogram)
            }

    def snapshot(self) -> dict[str, dict]:
        """Full structured view: every metric, typed."""
        with self._lock:
            out: dict[str, dict] = {}
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if isinstance(m, Counter):
                    out[name] = {"kind": "counter", "value": m.value()}
                elif isinstance(m, Gauge):
                    out[name] = {"kind": "gauge", "mode": m.mode, "value": m.value()}
                else:
                    out[name] = {
                        "kind": "histogram",
                        "count": m.count(),
                        "p50": m.percentile(50),
                        "p95": m.percentile(95),
                        "p99": m.percentile(99),
                    }
            return out

    def reset(self) -> None:
        """Drop every metric — counters, gauges and histograms.  This is
        the unified reset behind `guard.reset()`; callers re-create
        handles on next use (nothing in the stack holds one long-term),
        and a post-reset registry is indistinguishable from a fresh one
        — the disarmed zero-cost contract checks exactly that."""
        with self._lock:
            self._metrics.clear()


REGISTRY = Registry()
