"""Serving telemetry: latency percentiles + throughput counters.

All times are simulated-clock ticks (the scheduler is deterministic;
wall-clock belongs to the bench layer, modeled seconds to the cost
model).  `record_health()` mirrors the counters into the `guard.health`
registry under a `serve_` prefix so serving state rides the same
provenance surface as the guard ladder — a bench record taken while a
scheduler is live shows it.
"""

from __future__ import annotations

import math

_RAISE = object()


def percentile(
    values: list[int] | list[float], p: float, default: float | object = _RAISE
) -> float:
    """Nearest-rank percentile (deterministic, no interpolation).

    An empty distribution raises ValueError unless `default` is given —
    pass e.g. ``default=0.0`` for zero-request serve runs where "no
    observations" is a legitimate outcome, not a bug.
    """
    if not values:
        if default is _RAISE:
            raise ValueError("percentile of empty list")
        return float(default)  # type: ignore[arg-type]
    if not 0 < p <= 100:
        raise ValueError(f"percentile must be in (0, 100], got {p}")
    ordered = sorted(values)
    rank = math.ceil(p / 100 * len(ordered))
    return float(ordered[rank - 1])


class ServeTelemetry:
    """Per-run scheduler metrics.

    Counters: admitted / completed / prefill_batches / decode_steps /
    tokens_out / ticks.  Distributions (ticks): queue_wait (arrival ->
    admission), ttft (arrival -> first token), latency (arrival ->
    completion).
    """

    def __init__(self):
        self.admitted = 0
        self.completed = 0
        self.prefill_batches = 0
        self.decode_steps = 0
        self.tokens_out = 0
        self.ticks = 0
        self.queue_wait: list[int] = []
        self.ttft: list[int] = []
        self.latency: list[int] = []

    def observe_admission(self, wait_ticks: int) -> None:
        self.admitted += 1
        self.queue_wait.append(int(wait_ticks))

    def observe_first_token(self, ttft_ticks: int) -> None:
        self.ttft.append(int(ttft_ticks))

    def observe_completion(self, latency_ticks: int, n_tokens: int) -> None:
        self.completed += 1
        self.latency.append(int(latency_ticks))
        del n_tokens  # tokens are counted per-step, not per-completion

    def tokens_per_tick(self) -> float:
        return self.tokens_out / max(self.ticks, 1)

    def summary(self) -> dict[str, float]:
        out: dict[str, float] = {
            "admitted": float(self.admitted),
            "completed": float(self.completed),
            "prefill_batches": float(self.prefill_batches),
            "decode_steps": float(self.decode_steps),
            "tokens_out": float(self.tokens_out),
            "ticks": float(self.ticks),
            "tokens_per_tick": self.tokens_per_tick(),
        }
        for name, dist in (
            ("queue", self.queue_wait),
            ("ttft", self.ttft),
            ("latency", self.latency),
        ):
            if dist:
                out[f"{name}_p50"] = percentile(dist, 50)
                out[f"{name}_p90"] = percentile(dist, 90)
        return out

    def record_health(self) -> None:
        """Mirror counters *and* distributions into the unified registry.

        Scalars keep their `serve_` counter names (the chaos/serve
        baselines gate them).  The tick distributions — queue wait,
        TTFT, latency — land in histograms so their p50/p95/p99 reach
        bench provenance instead of being summarised once and lost.
        """
        from repro_torch.guard import health
        from repro_torch.obs.metrics import REGISTRY

        health.record("serve_admitted", self.admitted)
        health.record("serve_completed", self.completed)
        health.record("serve_prefills", self.prefill_batches)
        health.record("serve_decode_steps", self.decode_steps)
        health.record("serve_tokens", self.tokens_out)
        for name, dist in (
            ("serve_queue_wait", self.queue_wait),
            ("serve_ttft", self.ttft),
            ("serve_latency", self.latency),
        ):
            if dist:
                REGISTRY.histogram(name).observe_many(dist)
