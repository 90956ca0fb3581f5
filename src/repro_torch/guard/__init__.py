"""Guarded execution.  Ported so far: the `health` counters the tuned
planner and the calibration fit report into.  Faults, plan validation and
the degradation ladder are not ported yet."""

from repro_torch.guard import health

__all__ = ["health"]
