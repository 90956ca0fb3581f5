"""Per-call timing with robust statistics.

`measure(fn, *args)` times ``fn(*args)``: one untimed warm-up call (it
builds a kernel on first use), then ``repeats`` repeats of ``iters``
calls each.  Iterations never overlap, and every call is timed to the end
of its work, as the reference's `block_until_ready` on the output does:

* when a CUDA tensor is found in the arguments or in the warm-up call's
  result (at any depth of dicts, lists, tuples and dataclass fields), each
  call is bracketed by a pair of CUDA events on that tensor's device's
  current stream, and the host waits for the end event before the next
  call, so a repeat is the sum of device-timed calls;
* otherwise the host clock times each call, and when CUDA is initialised
  the host synchronizes the current device before it stops the clock, so
  a closure that launches CUDA work and returns nothing of it is still
  timed to its end.

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


def iter_tensors(obj):
    """Every tensor in `obj`, descending into dicts, lists, tuples and
    dataclass instances."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from iter_tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from iter_tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from iter_tensors(getattr(obj, f.name))


def cuda_device(*objs) -> torch.device | None:
    """The device of the first CUDA tensor found in `objs`, or None."""
    for t in iter_tensors(objs):
        if t.is_cuda:
            return t.device
    return None


def _wait_host() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure(fn: Callable[..., Any], *args: Any, iters: int = 3,
            repeats: int = 5) -> Timing:
    """Time ``fn(*args)``: median per-call microseconds over ``repeats``."""
    if iters < 1 or repeats < 1:
        raise ValueError(f"iters and repeats must be >= 1, got "
                         f"{iters}/{repeats}")
    out = fn(*args)
    dev = cuda_device(args, out)
    del out
    if dev is None:
        _wait_host()
    else:
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
                _wait_host()
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
