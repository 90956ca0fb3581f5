"""repro_torch.obs — structured tracing, unified metrics, drift attribution.

The JAX package's `repro.obs`, ported term for term.  Three pieces, one
package:

- **Span tree** (`spans`): thread-local `trace_scope()` arms tracing;
  hot paths emit `span()` / `event()` / `annotate()`.  Disarmed, every
  emit is one integer check — no spans, no counters, no allocations, and
  nothing inside a CUDA graph capture or replay.  While a
  `torch.profiler` records, `span()` and `phase()` also open profiler
  ranges `repro_torch.<kind>`, on the clock of the device events.
- **Metrics registry** (`metrics`): typed counters / gauges /
  histograms under one lock.  `guard.health` writes here.
- **Attribution** (`clock`, `attribution`): an injectable clock stamps
  `measured_us` on dispatch spans next to the planner's `modeled_us`
  (the wall clock by CUDA events on the card, read when the scope closes);
  per-shape-class drift histograms feed `drift_report()`, judged
  against the calibration gate's `MAX_LOG_SPREAD`.

Exporters (`export`): `trace.digest()` (span-kind counts, folded into
`bench.Provenance`), `trace.render()` (deterministic text tree),
`trace.export_chrome(path)` (Chrome-tracing / Perfetto JSON).
"""

from repro_torch.obs.attribution import (
    dispatch,
    drift_report,
    measured,
    record_drift,
    shape_class_token,
)
from repro_torch.obs.clock import SimClock, WallClock, make_clock
from repro_torch.obs.export import (
    digest,
    export_chrome,
    render_text,
    to_chrome,
    validate_chrome,
)
from repro_torch.obs.metrics import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
    percentile_nearest_rank,
)
from repro_torch.obs.spans import (
    NULL_SPAN,
    Span,
    Trace,
    annotate,
    current_span,
    current_trace,
    event,
    span,
    trace_scope,
    tracing,
)

__all__ = [
    "NULL_SPAN",
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "SimClock",
    "Span",
    "Trace",
    "WallClock",
    "annotate",
    "current_span",
    "current_trace",
    "digest",
    "dispatch",
    "drift_report",
    "event",
    "export_chrome",
    "make_clock",
    "measured",
    "percentile_nearest_rank",
    "record_drift",
    "render_text",
    "shape_class_token",
    "span",
    "to_chrome",
    "trace_scope",
    "tracing",
    "validate_chrome",
]
