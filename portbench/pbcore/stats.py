"""Percentiles: nearest rank, no interpolation (the rule the port's
serving telemetry uses, frozen here)."""

from __future__ import annotations

import math


def percentile(values, p: float) -> float | None:
    """The nearest-rank p-th percentile of `values`; None when empty."""
    if not values:
        return None
    ordered = sorted(values)
    rank = max(1, math.ceil(p / 100 * len(ordered)))
    return float(ordered[rank - 1])
