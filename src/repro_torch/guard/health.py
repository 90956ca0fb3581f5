"""Process-wide health telemetry for guarded execution.

A thin facade over the typed metrics registry
(`repro_torch.obs.metrics.REGISTRY`), as in the JAX package — the same
verbs, counter names and snapshot contract, one backing store shared
with the span tracer.  Every layer that injects, catches or degrades
reports here, and two consumers read it back:

  * bench provenance — `provenance_fields()` is attached to every
    benchmark record produced while any counter is non-zero, so a
    record shows whether its numbers were taken on a degraded process;
  * the serving layer and the smoke run — `snapshot()` for log lines and
    assertions (a disarmed process shows no guard or obs counter).

Counters (monotonic within a process, `reset()` is test/suite-only):

  faults_injected / faults_caught   the chaos ledger; equal counts mean
                                    every injected fault was neutralized
  injected_<kind>                   per-kind breakdown of the above
  retries                           transient-fault re-executions
  scrubbed_batches                  decode batches re-run on the
                                    reference backend after a NaN scrub
  scrub_substituted                 outputs replaced by the oracle inside
                                    a CUDA graph capture
  plans_rejected                    pre-dispatch validation failures
  fallbacks                         degradation-ladder trips
  fallback_level                    max-gauge: the deepest ladder floor
                                    reached (index into fallback.LEVELS)
  tuned_hits / tuned_misses         plan_mode="tuned" cache resolution
  tuned_hits_gemv                   hits whose cached winner is split-K
  cache_quarantined                 an unusable default tune cache was
                                    moved aside
  calibration_rejected              a calibration fit failed its gate
  moe_slots_total / _filled /       MoE capacity-slot accounting, opt-in
  moe_slots_underfilled             via moe.track_capacity_slots()
  obs_*                             tracer-side counters (armed only)
"""

from __future__ import annotations

from repro_torch.obs.metrics import REGISTRY


def record(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` (creating it at zero)."""
    REGISTRY.counter(name).inc(int(n))


def set_gauge(name: str, value: int) -> None:
    """Raise gauge `name` to `value` if it exceeds the current reading.

    Gauges are high-water marks (the ladder only descends), so a stale
    writer can never roll one back.
    """
    REGISTRY.gauge(name, mode="max").set(int(value))


def get(name: str) -> int:
    return int(REGISTRY.value(name))


def snapshot() -> dict[str, int]:
    """All non-zero counters and gauges, sorted by name (a stable copy)."""
    return REGISTRY.counts()


def reset() -> None:
    """Zero every metric — counters, gauges *and* histograms (unified
    reset).  Tests and bench suites only — production consumers treat
    the counters as monotonic."""
    REGISTRY.reset()


def provenance_fields() -> dict[str, int | float] | None:
    """Counters plus histogram percentiles as a bench-provenance
    fragment, or None when the process is clean (ordinary benchmark
    documents stay unchanged).

    Histograms contribute `<name>_p50/_p95/_p99` (ints when the
    underlying observations are integral, e.g. tick distributions) —
    this is where serve TTFT/latency percentiles reach `BENCH_*.json`.
    """
    out: dict[str, int | float] = dict(REGISTRY.counts())
    for name, hist in sorted(REGISTRY.histograms().items()):
        if name.startswith("drift/") or not hist.count():
            continue
        for p in (50, 95, 99):
            v = hist.percentile(p)
            out[f"{name}_p{p}"] = int(v) if float(v).is_integer() else float(v)
    return out or None
