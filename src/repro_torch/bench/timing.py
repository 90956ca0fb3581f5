"""Per-call timing with robust statistics.

`measure(fn, *args)` times ``fn(*args)``: one untimed warm-up call (it
builds a kernel on first use), then ``repeats`` repeats of ``iters``
calls each.  Iterations never overlap:

* when any argument is a CUDA tensor, each call is bracketed by a pair of
  CUDA events on the current stream, and the host waits for the end event
  before the next call, so a repeat is the sum of device-timed calls;
* otherwise (CPU tensors, whose operations return when done) the host
  clock times each call.

Each repeat contributes elapsed / iters.  Repeats are screened with
one-sided MAD outlier rejection (a repeat slower than the median by more
than 3.5 normalized median-absolute-deviations, with a 5% floor on the
threshold width, is dropped and counted in `Timing.outliers`; fewer than
4 repeats are always kept), and the median of the rest is the result,
with the interquartile range beside it.  The JAX package's
`tuner_outlier` fault hook waits for the guard port.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable

import torch

_MAD_CUTOFF = 3.5
_MAD_NORMALIZE = 1.4826
_REL_FLOOR = 0.05


@dataclasses.dataclass(frozen=True)
class Timing:
    """Per-call time: median / IQR in microseconds over the repeats that
    survived outlier rejection (`outliers` = rejected count)."""

    median_us: float
    iqr_us: float
    repeats: int
    iters: int
    outliers: int = 0

    @property
    def us_per_call(self) -> float:
        return self.median_us


def reject_outliers(samples: list[float]) -> list[int]:
    """Indices of samples surviving one-sided MAD rejection."""
    if len(samples) < 4:
        return list(range(len(samples)))
    med = statistics.median(samples)
    mad = statistics.median(abs(x - med) for x in samples)
    cutoff = med + max(_MAD_CUTOFF * _MAD_NORMALIZE * mad, _REL_FLOOR * med)
    return [i for i, x in enumerate(samples) if x <= cutoff]


def _cuda_device(args) -> torch.device | None:
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            return a.device
    return None


def measure(fn: Callable[..., Any], *args: Any, iters: int = 3,
            repeats: int = 5) -> Timing:
    """Time ``fn(*args)``: median per-call microseconds over ``repeats``."""
    if iters < 1 or repeats < 1:
        raise ValueError(f"iters and repeats must be >= 1, got "
                         f"{iters}/{repeats}")
    dev = _cuda_device(args)
    fn(*args)
    if dev is not None:
        torch.cuda.synchronize(dev)
        stream = torch.cuda.current_stream(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    per_call_us = []
    for _ in range(repeats):
        total_us = 0.0
        for _ in range(iters):
            if dev is None:
                t0 = time.perf_counter()
                fn(*args)
                total_us += (time.perf_counter() - t0) * 1e6
            else:
                start.record(stream)
                fn(*args)
                end.record(stream)
                end.synchronize()
                total_us += start.elapsed_time(end) * 1e3
        per_call_us.append(total_us / iters)
    kept = [per_call_us[i] for i in reject_outliers(per_call_us)]
    iqr = 0.0
    if len(kept) >= 2:
        q1, _, q3 = statistics.quantiles(kept, n=4)
        iqr = q3 - q1
    return Timing(median_us=statistics.median(kept), iqr_us=iqr,
                  repeats=repeats, iters=iters,
                  outliers=len(per_call_us) - len(kept))
