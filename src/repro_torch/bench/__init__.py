"""Structured benchmark results: records, timing, IO, suites, regression gate.

Every benchmark row is a `BenchResult` (measured median / IQR time +
deterministic modeled metrics + provenance); runs are written as
``BENCH_<timestamp>.json`` documents, and `compare` diffs a run against
baselines with per-metric tolerances: tight for modeled quantities,
informational for measured time.  `timing.measure` times a call with CUDA
events on the card.  The documents are the JAX package's, so the JAX
baselines under ``benchmarks/baselines/`` read and compare as they are.
"""

from repro_torch.bench import compare, io, record, suite, timing
from repro_torch.bench.compare import Report, Tolerance, metric_tolerance
from repro_torch.bench.record import (BenchResult, Provenance, SchemaError,
                                      git_sha)
from repro_torch.bench.suite import BenchSuite, Recorder, RunContext
from repro_torch.bench.timing import Timing, measure, reject_outliers

__all__ = [
    "compare",
    "io",
    "record",
    "suite",
    "timing",
    "Report",
    "Tolerance",
    "metric_tolerance",
    "BenchResult",
    "Provenance",
    "SchemaError",
    "git_sha",
    "BenchSuite",
    "Recorder",
    "RunContext",
    "Timing",
    "measure",
    "reject_outliers",
]
