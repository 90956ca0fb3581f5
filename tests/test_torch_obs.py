"""The port's structured tracing (`repro_torch.obs`) against the JAX
package's `repro.obs`, on the CPU.

* Every test of `tests/test_obs.py` but `test_serve_telemetry_histograms`
  (it drives the serving scheduler's telemetry, not ported yet: ROADMAP
  queue 1, item 6), ported: the span tree, the registry, the health
  facade, attribution, the exporters, provenance and concurrency.
* The trace launcher's matmul workload (`--size 64 --skew 4`) under the
  sim clock on tpu_v5e, in both packages: the JAX package's "xla" backend
  against the port's "torch" (both the reference rung) and its "pallas"
  (Pallas in interpret mode) against the port's "cuda" (the plain
  versions on the CPU).  Digests equal; the text trees and the Chrome
  documents equal once the attribute values that name a backend are
  mapped to the port's names (`backend` "xla" / "pallas" -> "torch" /
  "cuda", `kernel` "xla_dot" -> "torch_matmul"), and nothing else is
  mapped; drift reports equal (all 0).
* The `obs_disarmed` row of `benchmarks/baselines/obs.json` rebuilt by
  the port passes `bench.compare`.  Its `obs_serve_trace` and `obs_drift`
  rows drive the serving scheduler and wait for it (ROADMAP queue 1,
  item 6).
"""

import argparse
import json
import math
import threading
from pathlib import Path

import pytest
import torch

from repro import guard as jguard
from repro.core.config import mm_config as jmm_config
from repro.launch import trace as jtrace
from repro.obs import drift_report as jdrift_report
from repro.obs import render_text as jrender_text
from repro.obs import to_chrome as jto_chrome
from repro_torch import guard
from repro_torch.bench import compare, io as bench_io
from repro_torch.bench.record import BenchResult, Provenance
from repro_torch.bench.suite import Recorder
from repro_torch.core import skewmm
from repro_torch.core.config import mm_config
from repro_torch.guard import health
from repro_torch.kernels import ops
from repro_torch.launch import trace
from repro_torch.obs import (
    NULL_SPAN,
    REGISTRY,
    Registry,
    SimClock,
    WallClock,
    annotate,
    current_span,
    current_trace,
    drift_report,
    event,
    export_chrome,
    make_clock,
    percentile_nearest_rank,
    render_text,
    span,
    to_chrome,
    trace_scope,
    tracing,
    validate_chrome,
)
from repro_torch.obs import spans as obs_spans
from repro_torch.tune.calibrate import MAX_LOG_SPREAD

BASELINES = Path(__file__).resolve().parents[1] / "benchmarks" / "baselines"


@pytest.fixture(autouse=True)
def _clean_state():
    guard.reset()
    jguard.reset()
    yield
    guard.reset()
    jguard.reset()


def _mats(m=8, k=256, n=512):
    return torch.ones((m, k)), torch.ones((k, n))


# ------------------------------------------------------------ span tree
class TestSpans:
    def test_disarmed_is_null(self):
        assert not tracing()
        assert current_trace() is None
        assert current_span() is None
        with span("dispatch", "x") as sp:
            assert sp is NULL_SPAN
        assert event("plan", "y") is NULL_SPAN
        assert annotate("dispatch", foo=1) is False
        assert NULL_SPAN.set(a=1) is NULL_SPAN

    def test_tree_structure_and_restore(self):
        with trace_scope() as tr:
            assert tracing()
            with span("tick", "t0") as t:
                event("plan", "p", m=4)
                with span("decode") as d:
                    assert current_span() is d
                assert current_span() is t
        assert not tracing()
        assert len(tr.roots) == 1
        root = tr.roots[0]
        assert [c.kind for c in root.children] == ["plan", "decode"]
        assert tr.digest() == {"decode": 1, "plan": 1, "tick": 1, "total": 3}

    def test_nested_scopes_innermost_wins(self):
        with trace_scope() as outer:
            event("plan", "outer")
            with trace_scope() as inner:
                event("plan", "inner")
                assert current_trace() is inner
            assert current_trace() is outer
            event("plan", "outer2")
        assert [s.name for s in outer.spans()] == ["outer", "outer2"]
        assert [s.name for s in inner.spans()] == ["inner"]

    def test_annotate_targets_nearest_kind(self):
        with trace_scope() as tr:
            with span("dispatch", "outer"):
                with span("rung", "tuned"):
                    assert annotate("dispatch", rung="tuned")
                    assert annotate(index=0)
        disp, rung = list(tr.spans())
        assert disp.attrs["rung"] == "tuned"
        assert rung.attrs["index"] == 0

    def test_set_routes_typed_fields(self):
        with trace_scope() as tr:
            with span("dispatch", "d") as sp:
                sp.set(modeled_us=2.0, measured_us=4.0, blocks=(8, 128, 128))
        (sp,) = tr.spans()
        assert sp.modeled_us == 2.0
        assert sp.measured_us == 4.0
        assert sp.attrs == {"blocks": (8, 128, 128)}
        assert sp.drift_log == pytest.approx(math.log(2.0))

    def test_exception_still_closes_span(self):
        with trace_scope() as tr:
            with pytest.raises(RuntimeError):
                with span("tick", "t0"):
                    raise RuntimeError("boom")
            event("plan", "after")
        assert [s.kind for s in tr.spans()] == ["tick", "plan"]

    def test_open_span_join(self):
        from repro_torch.obs import attribution

        with trace_scope() as tr:
            with attribution.dispatch("dense", m=1, k=2, n=3) as outer:
                with attribution.dispatch("dense", m=9, backend="x") as inner:
                    assert inner is outer
        assert tr.digest()["dispatch"] == 1
        (sp,) = [s for s in tr.spans() if s.kind == "dispatch"]
        assert sp.attrs["m"] == 1
        assert sp.attrs["backend"] == "x"


# ------------------------------------------------------ metrics registry
class TestRegistry:
    def test_counter_gauge_histogram(self):
        reg = Registry()
        reg.counter("c").inc()
        reg.counter("c").inc(4)
        assert reg.value("c") == 5
        reg.gauge("g_last", mode="last").set(3)
        reg.gauge("g_last", mode="last").set(1)
        assert reg.value("g_last") == 1
        reg.gauge("g_max", mode="max").set(3)
        reg.gauge("g_max", mode="max").set(1)
        assert reg.value("g_max") == 3
        h = reg.histogram("h")
        h.observe_many([1.0, 2.0, 3.0, 4.0])
        assert h.count() == 4
        assert h.percentile(50) == 2.0
        assert h.percentile(99) == 4.0

    def test_kind_conflicts_raise(self):
        reg = Registry()
        reg.counter("x")
        with pytest.raises(ValueError):
            reg.gauge("x")
        reg.gauge("g", mode="max")
        with pytest.raises(ValueError):
            reg.gauge("g", mode="last")
        with pytest.raises(ValueError):
            reg.histogram("x")

    def test_counts_merges_and_sorts(self):
        reg = Registry()
        reg.counter("b").inc(2)
        reg.counter("zero")
        reg.gauge("a", mode="max").set(7)
        reg.histogram("h").observe(1.0)
        assert reg.counts() == {"a": 7, "b": 2}

    def test_reset_clears_everything(self):
        reg = Registry()
        reg.counter("c").inc()
        reg.histogram("h").observe(1.0)
        reg.reset()
        assert reg.counts() == {}
        assert reg.histograms() == {}

    def test_percentile_nearest_rank(self):
        vals = [10.0, 20.0, 30.0, 40.0]
        assert percentile_nearest_rank(vals, 50) == 20.0
        assert percentile_nearest_rank(vals, 95) == 40.0
        assert percentile_nearest_rank([7.0], 1) == 7.0

    def test_snapshot_is_typed(self):
        reg = Registry()
        reg.counter("c").inc(2)
        reg.gauge("g", mode="max").set(3)
        reg.histogram("h").observe_many([1.0, 2.0])
        snap = reg.snapshot()
        assert snap["c"] == {"kind": "counter", "value": 2}
        assert snap["g"] == {"kind": "gauge", "mode": "max", "value": 3}
        assert snap["h"]["kind"] == "histogram" and snap["h"]["count"] == 2


# ----------------------------------------------------- health facade
class TestHealthFacade:
    def test_counters_route_through_registry(self):
        health.record("retries", 2)
        assert health.get("retries") == 2
        assert REGISTRY.value("retries") == 2
        assert health.snapshot() == {"retries": 2}

    def test_fallback_level_is_max_gauge(self):
        health.set_gauge("fallback_level", 2)
        health.set_gauge("fallback_level", 1)
        assert health.get("fallback_level") == 2

    def test_provenance_fields_percentiles(self):
        health.record("serve_admitted", 3)
        REGISTRY.histogram("serve_ttft").observe_many([1.0, 2.0, 9.0])
        REGISTRY.histogram("drift/m1k2n3b1").observe(0.5)
        fields = health.provenance_fields()
        assert fields["serve_admitted"] == 3
        assert fields["serve_ttft_p50"] == 2
        assert fields["serve_ttft_p99"] == 9
        assert not any(k.startswith("drift/") for k in fields)

    def test_percentile_default_vs_raise(self):
        with pytest.raises(ValueError):
            percentile_nearest_rank([], 50)
        assert REGISTRY.histogram("empty").percentile(50, default=0) == 0

    def test_port_counters_keep_their_names(self):
        for name in ("tuned_hits", "tuned_misses", "tuned_hits_gemv",
                     "calibration_rejected"):
            health.record(name)
        assert health.snapshot() == {
            "calibration_rejected": 1, "tuned_hits": 1,
            "tuned_hits_gemv": 1, "tuned_misses": 1}

    def test_reset_clears_histograms(self):
        REGISTRY.histogram("drift/m1k2n3b1").observe(0.5)
        health.record("retries")
        health.reset()
        assert REGISTRY.histograms() == {} and health.snapshot() == {}
        assert health.provenance_fields() is None


# --------------------------------------------------------- attribution
class TestAttribution:
    def test_disarmed_dispatch_costs_nothing(self):
        a, b = _mats()
        ops.skew_matmul(a, b)
        assert health.snapshot() == {}
        assert not REGISTRY.histograms()

    def test_armed_dispatch_full_quad(self):
        a, b = _mats()
        with trace_scope(clock=SimClock()) as tr:
            ops.skew_matmul(a, b)
        (sp,) = [s for s in tr.spans() if s.kind == "dispatch"]
        assert sp.attrs["rung"] in ("tuned", "modeled")
        assert sp.modeled_us is not None
        assert sp.measured_us == sp.modeled_us
        assert sp.attrs["shape_class"] == "m8k256n512b1"
        assert health.get("obs_dispatches") == 1
        rep = drift_report()
        assert rep["max_abs_log"] == 0.0
        assert rep["accepted"]
        assert rep["classes"]["m8k256n512b1"]["count"] == 1

    def test_skewmm_torch_reference_rung(self):
        a, b = _mats()
        with trace_scope(clock=SimClock()) as tr:
            skewmm.matmul(a, b, backend="torch")
        (sp,) = [s for s in tr.spans() if s.kind == "dispatch"]
        assert sp.attrs["rung"] == "reference"
        assert sp.attrs["kernel"] == "torch_matmul"
        assert sp.measured_us == sp.modeled_us

    def test_skewmm_cuda_joins_one_span(self):
        a, b = _mats()
        with trace_scope(clock=SimClock()) as tr:
            skewmm.matmul(a, b, backend="cuda")
        (sp,) = [s for s in tr.spans() if s.kind == "dispatch"]
        assert sp.attrs["rung"] == "explicit"
        assert sp.attrs["kernel"] == "k_inner"
        assert sp.measured_us == sp.modeled_us
        assert tr.digest() == {"dispatch": 1, "plan": 1, "total": 2}

    def test_tuned_path_annotates_tune_key(self):
        from repro_torch.tune import runtime as tune_runtime
        from repro_torch.tune.cache import TuneCache

        a, b = _mats()
        with tune_runtime.use_cache(TuneCache()), mm_config(
                plan_mode="tuned"):
            with trace_scope(clock=SimClock()) as tr:
                ops.skew_matmul(a, b)
        (sp,) = [s for s in tr.spans() if s.kind == "dispatch"]
        assert "tune_key" in sp.attrs
        assert sp.attrs["tune_hit"] is False
        tune_events = [s for s in tr.spans() if s.kind == "tune"]
        assert tune_events and tune_events[0].name == sp.attrs["tune_key"]

    def test_rung_spans_on_laddered_path(self):
        a, b = _mats()
        with trace_scope() as tr:
            ops.skew_matmul(a, b)
        rungs = [s for s in tr.spans() if s.kind == "rung"]
        assert rungs
        assert rungs[-1].name in ("tuned", "modeled")

    def test_sparse_and_grouped_sites_emit_plan_spans(self):
        from repro_torch.sparse.layout import BlockSparseLayout

        layout = BlockSparseLayout.dense(128, 128, (32, 64))
        with trace_scope(clock=SimClock()) as tr:
            ops.sparse_matmul(torch.ones(128, 128), torch.ones(128, 96),
                              layout)
            ops.grouped_matmul(torch.ones(4, 32, 48), torch.ones(4, 48, 64),
                               backend="cuda")
            ops.grouped_matmul(torch.ones(4, 32, 48), torch.ones(4, 48, 64),
                               backend="torch")
        names = [s.name for s in tr.spans() if s.kind == "plan"]
        assert names == ["sparse/skew_aware", "grouped/skew_aware",
                         "grouped/skew_aware"]
        disp = [s for s in tr.spans() if s.kind == "dispatch"]
        assert [s.name for s in disp] == ["sparse", "grouped", "grouped"]
        assert all(s.measured_us == s.modeled_us for s in disp)
        assert disp[-1].attrs["backend"] == "torch"

    def test_wall_clock_records_nonzero_measured(self):
        a, b = _mats()
        with trace_scope(clock=WallClock()) as tr:
            ops.skew_matmul(a, b)
        (sp,) = [s for s in tr.spans() if s.kind == "dispatch"]
        assert sp.measured_us is not None and sp.measured_us > 0
        assert sp.t0_us is not None and sp.t1_us is not None
        assert sp.t1_us >= sp.t0_us

    def test_make_clock(self):
        assert isinstance(make_clock("sim"), SimClock)
        assert isinstance(make_clock("wall"), WallClock)
        assert make_clock("none") is None
        assert make_clock(None) is None

    def test_drift_report_threshold(self):
        REGISTRY.histogram("drift/m1k2n3b1").observe(MAX_LOG_SPREAD * 2)
        REGISTRY.histogram("drift/m4k2n3b1").observe(MAX_LOG_SPREAD / 2)
        rep = drift_report()
        assert not rep["accepted"]
        assert rep["classes_total"] == 2
        assert rep["classes_accepted"] == 1
        assert not rep["classes"]["m1k2n3b1"]["accepted"]
        assert rep["classes"]["m4k2n3b1"]["accepted"]


# ----------------------------------------------------------- exporters
class TestExport:
    def _trace(self):
        with trace_scope(clock=SimClock()) as tr:
            with span("tick", "t0", tick=0):
                event("plan", "dense/modeled", m=4, modeled_us=1.5)
        return tr

    def test_render_text_deterministic(self):
        tr = self._trace()
        assert render_text(tr) == render_text(tr)
        text = render_text(tr)
        assert "tick:t0" in text
        assert "  plan:dense/modeled" in text
        assert "modeled=1.500us" in text

    def test_chrome_roundtrip(self, tmp_path):
        tr = self._trace()
        doc = to_chrome(tr)
        validate_chrome(doc)
        assert len(doc["traceEvents"]) == tr.digest()["total"]
        path = tmp_path / "t.json"
        export_chrome(tr, str(path))
        reread = json.loads(path.read_text())
        assert reread == doc
        validate_chrome(reread)

    def test_chrome_synthetic_layout_nests(self):
        tr = self._trace()
        evs = {e["cat"]: e for e in to_chrome(tr)["traceEvents"]}
        tick, plan = evs["tick"], evs["plan"]
        assert tick["ts"] <= plan["ts"]
        assert plan["ts"] + plan["dur"] <= tick["ts"] + tick["dur"]

    def test_validate_chrome_rejects_bad(self):
        with pytest.raises(ValueError):
            validate_chrome({"no_events": []})
        bad = {"traceEvents": [{"name": "x", "cat": "y", "ph": "B",
                                "ts": 0, "dur": 1, "pid": 0, "tid": 0,
                                "args": {}}]}
        with pytest.raises(ValueError):
            validate_chrome(bad)

    def test_wall_clock_real_timestamps(self):
        with trace_scope(clock=WallClock()) as tr:
            with span("tick", "t0"):
                pass
        (ev,) = to_chrome(tr)["traceEvents"]
        assert ev["ts"] >= 0


# ---------------------------------------------------------- provenance
class TestProvenance:
    def test_trace_digest_captured_when_armed(self):
        with trace_scope():
            event("plan", "p")
            prov = Provenance.capture()
        assert prov.trace_digest == {"plan": 1, "total": 1}
        rec = BenchResult(name="r", suite="s", axes={}, metrics={}, info={},
                          provenance=prov)
        back = BenchResult.from_json(json.loads(json.dumps(rec.to_json())))
        assert back.provenance.trace_digest == {"plan": 1, "total": 1}

    def test_clean_record_unchanged(self):
        prov = Provenance.capture()
        assert prov.trace_digest is None
        rec = BenchResult(name="r", suite="s", axes={}, metrics={}, info={},
                          provenance=prov)
        assert "trace_digest" not in rec.to_json()["provenance"]

    def test_empty_trace_elided(self):
        with trace_scope():
            prov = Provenance.capture()
        assert prov.trace_digest is None


# ---------------------------------------------------------- concurrency
class TestConcurrency:
    def test_registry_counts_exact_under_threads(self):
        reg = Registry()
        n_threads, n_inc = 8, 500

        def work():
            for _ in range(n_inc):
                reg.inc("c")
                reg.histogram("h").observe(1.0)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert reg.value("c") == n_threads * n_inc
        assert reg.histogram("h").count() == n_threads * n_inc

    def test_health_facade_threadsafe(self):
        def work():
            for _ in range(300):
                health.record("retries")

        threads = [threading.Thread(target=work) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert health.get("retries") == 1800

    def test_span_tree_thread_isolation(self):
        errs = []
        barrier = threading.Barrier(2)

        def traced():
            try:
                with trace_scope() as tr:
                    barrier.wait(timeout=5)
                    for i in range(50):
                        event("plan", f"p{i}")
                    barrier.wait(timeout=5)
                    assert len(tr.roots) == 50
            except Exception as e:  # pragma: no cover - diagnostic
                errs.append(e)

        def untraced():
            try:
                barrier.wait(timeout=5)
                assert not tracing()
                with span("tick") as sp:
                    assert sp is NULL_SPAN
                barrier.wait(timeout=5)
            except Exception as e:  # pragma: no cover - diagnostic
                errs.append(e)

        ts = [threading.Thread(target=traced),
              threading.Thread(target=untraced)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert errs == []
        assert not tracing()
        assert obs_spans._ARMED == 0

    def test_registry_reset_during_armed_trace(self):
        a, b = _mats()
        with trace_scope(clock=SimClock()) as tr:
            ops.skew_matmul(a, b)
            guard.reset()
            ops.skew_matmul(a, b)
        assert health.get("obs_dispatches") == 1
        assert len([s for s in tr.spans() if s.kind == "dispatch"]) == 2


# ------------------------------------- the trace launcher against JAX's
_BACKENDS = {"xla": "torch", "pallas": "cuda"}
_KERNELS = {"xla_dot": "torch_matmul"}


def _to_port_names(tr) -> None:
    """Rename, in place, the attribute values of a JAX trace that name a
    backend or a reference kernel; nothing else is touched."""
    for sp in tr.spans():
        if "backend" in sp.attrs:
            sp.attrs["backend"] = _BACKENDS[sp.attrs["backend"]]
        if sp.attrs.get("kernel") in _KERNELS:
            sp.attrs["kernel"] = _KERNELS[sp.attrs["kernel"]]


@pytest.mark.parametrize("jbackend", ["xla", "pallas"])
def test_trace_workload_equals_the_reference(jbackend):
    args = argparse.Namespace(size=64, skew=4, clock="sim", device="cpu")
    with jmm_config(chip="tpu_v5e", backend=jbackend):
        jtr = jtrace.run_matmul(args)
    jdrift = jdrift_report()
    with mm_config(chip="tpu_v5e", backend=_BACKENDS[jbackend]):
        tr = trace.run_matmul(args)
    assert tr.digest() == jtr.digest()
    assert tr.digest()["dispatch"] == 4
    _to_port_names(jtr)
    assert render_text(tr) == jrender_text(jtr)
    assert to_chrome(tr) == jto_chrome(jtr)
    assert drift_report() == jdrift
    assert drift_report()["max_abs_log"] == 0.0
    assert trace.check_trace(tr, tuned=False) == []


# --------------------------------------------- the obs_disarmed baseline
def test_obs_disarmed_row_passes_compare():
    """The JAX obs suite's `obs_disarmed` row, rebuilt: a dispatch with no
    trace scope armed adds no obs counter.  (`obs_serve_trace` and
    `obs_drift` drive the serving scheduler: ROADMAP queue 1, item 6.)"""
    records: list = []
    rec = Recorder("obs", records)
    guard.reset()
    try:
        assert not tracing()
        with mm_config(chip="tpu_v5e"):
            ops.skew_matmul(*_mats())
        disarmed = [k for k in health.snapshot() if k.startswith("obs_")]
    finally:
        guard.reset()
    rec("obs_disarmed", axes={"clock": "none"},
        metrics={"disarmed_obs_counters": len(disarmed)})
    _, base = bench_io.read_baselines(str(BASELINES))
    base = [r for r in base if r.name == "obs_disarmed"]
    assert len(base) == 1
    report = compare.compare(records, base)
    assert report.ok, report.summary(verbose=True)
    assert report.counts()["ok"] == 1
