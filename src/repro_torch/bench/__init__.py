"""Measurement helpers: `timing` (per-call timing with CUDA events on the
card, robust statistics) and the pieces of `record` the tune cache needs.
The record / io / compare / suite harness is not ported yet."""

from repro_torch.bench.record import SchemaError, git_sha
from repro_torch.bench.timing import Timing, measure, reject_outliers

__all__ = ["SchemaError", "Timing", "git_sha", "measure", "reject_outliers"]
