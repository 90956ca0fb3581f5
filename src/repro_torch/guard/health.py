"""Process-wide health counters, backed by a plain dict.

The JAX package's verbs and counter names; its metrics-registry facade
(and with it the histogram percentiles of the bench-provenance fragment)
waits for the obs port.  Counters the port records:

  tuned_hits / tuned_misses   plan_mode="tuned" cache resolution
  tuned_hits_gemv             hits whose cached winner is split-K
  cache_quarantined           an unusable default tune cache was moved
                              aside (`tune.runtime.get_active_cache`)
  calibration_rejected        a calibration fit failed its spread gate

Counters are monotonic within a process; `reset()` is for tests and
measurement phases.
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()
_COUNTS: dict[str, int] = {}
_GAUGES: dict[str, int] = {}


def record(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` (creating it at zero)."""
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def set_gauge(name: str, value: int) -> None:
    """Raise gauge `name` to `value` if it exceeds the current reading
    (gauges are high-water marks)."""
    with _LOCK:
        _GAUGES[name] = max(_GAUGES.get(name, int(value)), int(value))


def get(name: str) -> int:
    with _LOCK:
        return _COUNTS.get(name, _GAUGES.get(name, 0))


def snapshot() -> dict[str, int]:
    """All non-zero counters and gauges, sorted by name (a copy)."""
    with _LOCK:
        merged = {**_GAUGES, **_COUNTS}
    return {k: v for k, v in sorted(merged.items()) if v}


def reset() -> None:
    """Zero every counter and gauge."""
    with _LOCK:
        _COUNTS.clear()
        _GAUGES.clear()


def provenance_fields() -> dict[str, int] | None:
    """The non-zero counters as a bench-provenance fragment
    (`bench.record.Provenance.guard`), or None on a clean process."""
    return snapshot() or None
