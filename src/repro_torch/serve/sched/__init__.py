"""Continuous-batching serving scheduler over tuned shape classes.

The paper's verdict is that the IPU-style chips win exactly the skewed
regimes serving generates (decode: a few rows against 32k+ cache
columns) — but only if the kernels see a *small, pre-planned* set of
shapes.  This package is the piece that makes that true under a request
stream:

* `queue`     — `Request` / `RequestQueue` / `AdmissionPolicy` on a
                deterministic simulated `Clock` (exact replay).
* `buckets`   — `BucketTable`: power-of-two batch and prompt buckets
                aligned with `tune.shapeclass` representatives, plus the
                meta-device GEMM-spec capture that builds/validates the
                tuned cache covering every shape the loop can issue.
* `loop`      — `Scheduler`: the continuous-batching step loop
                (prefill-on-admission, batched decode through one CUDA
                graph per batch bucket on the card, join/leave via a
                KV-slot free-list, no re-padding of survivors).
* `moebatch`  — capacity-slot arithmetic for the cross-request MoE
                batcher (full `grouped_matmul` slots at the right batch).
* `telemetry` — queue latency / TTFT percentiles, throughput counters,
                mirrored into the `guard.health` registry.
"""

from repro_torch.serve.sched.buckets import (
    BucketTable,
    assert_covered,
    build_tuned_cache,
    capture_gemm_specs,
    modeled_step_seconds,
)
from repro_torch.serve.sched.loop import Scheduler, scripted_trace
from repro_torch.serve.sched.moebatch import (
    min_full_batch,
    slot_underfill,
    slot_utilization,
)
from repro_torch.serve.sched.queue import (AdmissionPolicy, Clock, Request,
                                           RequestQueue)
from repro_torch.serve.sched.telemetry import ServeTelemetry

__all__ = [
    "AdmissionPolicy",
    "BucketTable",
    "Clock",
    "Request",
    "RequestQueue",
    "Scheduler",
    "ServeTelemetry",
    "assert_covered",
    "build_tuned_cache",
    "capture_gemm_specs",
    "min_full_batch",
    "modeled_step_seconds",
    "scripted_trace",
    "slot_underfill",
    "slot_utilization",
]
