"""Diff a benchmark run against committed baselines, with tolerances.

The JAX package's gate, rule for rule: the same name-based tolerance
policy, so a port record and a JAX record get the same verdict.

Two kinds of numbers flow through the harness and they need opposite
treatment:

* **Modeled quantities** (roofline fractions, vertex counts, skew
  spreads, AMP best sizes) are pure cost-model arithmetic — identical on
  every host — so they are *gated*: drift beyond a tight tolerance fails
  CI.  These are the paper's reproducible artifacts; changing them is a
  deliberate act recorded by committing a new baseline.
* **Wall-clock measurements** (us_per_call) are host-relative, so they
  are *informational*: reported in the diff, never failing the gate.

The tolerance policy is name-based (`metric_tolerance`): integer count
metrics must match exactly, fraction-like metrics get a small absolute
band (planner output is deterministic, but this keeps baselines robust
to benign float-formatting churn), byte/size metrics a tiny relative
band.  Unknown numeric metrics default to informational so a new metric
never bricks CI before a baseline exists for it.
"""

from __future__ import annotations

import dataclasses

from repro_torch.bench.record import BenchResult

_EXACT_NAMES = frozenset(
    {
        "vertices",
        "matmuls",
        "left",
        "right",
        "square",
        "grouped",
        "unplanned",
        "best_n",
        "grid_steps",
        "repeats",
        # Guard-suite health counters: seeded fault injection is exactly
        # reproducible, so the whole ledger is gated integer-exact.
        "faults_injected",
        "faults_caught",
        "ledger_balanced",
        "fallback_level",
        "retries",
        "outputs_ok",
        "plans_rejected",
        "quarantined",
        "quarantine_moved",
        "cache_entries",
        "scrubbed",
        "outliers",
        # Serve-suite counters: simulated clock + modeled tuning, so the
        # whole scheduler run is exactly reproducible — admissions,
        # tuned hit/miss ledger, tick percentiles and MoE slot counts
        # are all gated integer-exact.
        "admitted",
        "completed",
        "prefill_batches",
        "decode_steps",
        "tokens_out",
        "ticks",
        "shape_classes",
        "tuned_hits",
        "tuned_misses",
        "ttft_p50",
        "ttft_p90",
        "queue_p50",
        "queue_p90",
        "slots_total",
        "slots_filled",
        "underfilled",
        "min_full_batch",
        "verdict",
        # Decode/GEMV counters: family selection and tuned-class coverage
        # are pure cost-model arithmetic plus dictionary lookups, so the
        # planner's dense-vs-split-K switch is gated integer-exact.
        "family_switch",
        "decode_classes",
        "gemv_classes",
        "dense_classes",
        "tuned_hits_gemv",
        # Obs-suite span-kind counts: the sim-clock serve trace is fully
        # deterministic (eager scheduler, span emission outside the plan
        # caches), so the whole digest is gated integer-exact — a changed
        # count means an instrumentation site moved.
        "spans_total",
        "dispatch_spans",
        "plan_spans",
        "rung_spans",
        "tune_spans",
        "tick_spans",
        "decode_spans",
        "prefill_spans",
        "admit_spans",
        "drift_classes",
        "drift_accepted",
        "chrome_events",
        "disarmed_obs_counters",
        "ttft_p95",
        "ttft_p99",
        # Shard-suite gates: the per-row never-cheaper-than-local floor
        # invariant and the chosen device count are both pure cost-model
        # arithmetic over the committed ChipSpec link counts, so they are
        # gated integer-exact ("verdict" above already covers the
        # pod-scale gc200-vs-rtx spread comparison).
        "floor_ok",
        "devices",
    },
)
# "speedup" metrics are modeled time ratios (sparse-vs-dense, the tuned
# suite's synthetic-host selection) — deterministic arithmetic, gated
# with the same absolute band as fractions.  "gain" is the decode tail's
# dense-over-GEMV modeled ratio, same arithmetic.
_FRACTION_SUFFIXES = ("frac", "fraction", "util", "spread", "min", "max",
                      "speedup", "gain")


@dataclasses.dataclass(frozen=True)
class Tolerance:
    """|current - baseline| <= abs + rel * |baseline| passes."""

    abs: float = 0.0
    rel: float = 0.0
    gated: bool = True

    def allows(self, current: float, baseline: float) -> bool:
        return abs(current - baseline) <= self.abs + self.rel * abs(baseline)


EXACT = Tolerance()
FRACTION = Tolerance(abs=5e-3)
SIZE = Tolerance(rel=1e-6)
MODELED_RATE = Tolerance(rel=1e-3)
INFORMATIONAL = Tolerance(rel=0.5, gated=False)


def metric_tolerance(metric: str) -> Tolerance:
    """Tolerance class for a metric name (see module docstring)."""
    if metric in ("us_per_call", "us_iqr"):
        return INFORMATIONAL
    # XLA-derived measurements (costprobe's cost_analysis terms): these
    # move with jax/XLA versions, not with our cost model — never gate,
    # whatever suffix they happen to carry.
    if metric.startswith(("hlo_", "collective_")) or metric == "useful_ratio":
        return INFORMATIONAL
    if metric in _EXACT_NAMES:
        return EXACT
    tail = metric.rsplit("_", 1)[-1]
    if tail in _FRACTION_SUFFIXES:
        return FRACTION
    # Modeled throughputs (cost-model arithmetic): tokens/sec from the
    # serve suite rides the same band as the modeled FLOP rates.
    if tail in ("tflops", "gflops", "flops") or metric.endswith("_per_s"):
        return MODELED_RATE
    if tail in ("bytes", "mib", "kib", "gib"):
        return SIZE
    return INFORMATIONAL


@dataclasses.dataclass(frozen=True)
class Entry:
    """One comparison outcome for (record, metric)."""

    record: str
    metric: str | None
    status: str  # ok | fail | drift | missing_record | new_record |
    #              missing_metric | new_metric | info_changed
    gated: bool
    current: float | None = None
    baseline: float | None = None
    detail: str = ""

    def line(self) -> str:
        tag = "GATED" if self.gated else "info"
        metric = self.metric or "-"
        vals = ""
        if self.baseline is not None or self.current is not None:
            vals = f" baseline={self.baseline} current={self.current}"
        detail = f" ({self.detail})" if self.detail else ""
        return f"[{tag}] {self.status:<14} {self.record}:{metric}{vals}{detail}"


@dataclasses.dataclass
class Report:
    """Comparison result: every (record, metric) pair accounted for."""

    entries: list[Entry]

    @property
    def failures(self) -> list[Entry]:
        return [e for e in self.entries if e.gated and e.status != "ok"]

    @property
    def ok(self) -> bool:
        return not self.failures

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.entries:
            out[e.status] = out.get(e.status, 0) + 1
        return out

    def summary(self, verbose: bool = False) -> str:
        counts = ", ".join(f"{k}={v}" for k, v in sorted(self.counts().items()))
        head = "bench-compare: " + ("OK" if self.ok else "FAIL") + f" ({counts})"
        lines = [head]
        shown = self.entries if verbose else self.failures
        lines.extend(e.line() for e in shown)
        if not verbose:
            notes = [
                e
                for e in self.entries
                if not e.gated and e.status not in ("ok", "fail")
            ]
            lines.extend(e.line() for e in notes)
        return "\n".join(lines)


def _compare_record(cur: BenchResult, base: BenchResult) -> list[Entry]:
    entries = []
    for metric, base_v in base.metrics.items():
        tol = metric_tolerance(metric)
        if metric not in cur.metrics:
            entries.append(
                Entry(cur.name, metric, "missing_metric", gated=tol.gated),
            )
            continue
        cur_v = cur.metrics[metric]
        if tol.allows(cur_v, base_v):
            status = "ok"
        else:
            status = "fail" if tol.gated else "drift"
        entries.append(
            Entry(
                cur.name,
                metric,
                status,
                gated=tol.gated,
                current=cur_v,
                baseline=base_v,
                detail=f"tol abs={tol.abs:g} rel={tol.rel:g}",
            ),
        )
    for metric in cur.metrics:
        if metric not in base.metrics:
            entries.append(
                Entry(cur.name, metric, "new_metric", gated=False),
            )
    for key, base_s in base.info.items():
        cur_s = cur.info.get(key)
        if cur_s != base_s:
            entries.append(
                Entry(
                    cur.name,
                    key,
                    "info_changed",
                    gated=True,
                    detail=f"baseline={base_s!r} current={cur_s!r}",
                ),
            )
    for key in cur.info:
        if key not in base.info:
            entries.append(
                Entry(cur.name, key, "new_metric", gated=False),
            )
    if base.us_per_call is not None and cur.us_per_call is not None:
        tol = metric_tolerance("us_per_call")
        if tol.allows(cur.us_per_call, base.us_per_call):
            status = "ok"
        else:
            status = "drift"
        entries.append(
            Entry(
                cur.name,
                "us_per_call",
                status,
                gated=False,
                current=cur.us_per_call,
                baseline=base.us_per_call,
            ),
        )
    return entries


def compare(
    current: list[BenchResult],
    baseline: list[BenchResult],
) -> Report:
    """Diff `current` records against `baseline` records by name.

    A baseline record absent from the run is a gated failure (a suite
    silently dropped coverage); a run record absent from the baseline is
    informational (new coverage — commit an updated baseline to start
    gating it).
    """
    cur_by_name = {r.name: r for r in current}
    base_by_name = {r.name: r for r in baseline}
    entries: list[Entry] = []
    for name, base in base_by_name.items():
        if name not in cur_by_name:
            entries.append(Entry(name, None, "missing_record", gated=True))
            continue
        entries.extend(_compare_record(cur_by_name[name], base))
    for name in cur_by_name:
        if name not in base_by_name:
            entries.append(Entry(name, None, "new_record", gated=False))
    return Report(entries=entries)
