"""The port's spans on the profiler's clock, the scheduler's work counters
and the wall clock's deferred CUDA-event times.  No JAX in this file: its
`cuda` tests run on the card's machine, which has none.

* With the profiler off and no trace scope armed, `span()` and `phase()`
  open no `record_function` and hand back the shared null context.
* With the profiler on, the scheduler's ranges `repro_torch.{tick, admit,
  prefill, decode, forward, sample, scatter, slab}` appear, nested as the
  tree, one a span; the tree itself holds no phase.
* While the profiler records, the scheduler counts its prefill tokens and
  slots, decode keys and KV slots and each request's queue wait, equal to
  counts taken from the trace entries and the tree; a decode graph replay
  adds none of them, and with the profiler off nothing is counted.
* `WallClock` times a dispatch on the card by a pair of CUDA events and
  reads them when the scope closes, with no synchronise inside the scope;
  off the card it keeps `perf_counter`.
"""

import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import guard
from repro_torch.configs.base import get_config
from repro_torch.guard import health
from repro_torch.models.model import build_model
from repro_torch.obs import SimClock, WallClock, drift_report, trace_scope
from repro_torch.obs import spans
from repro_torch.serve.sched import BucketTable, Scheduler, scripted_trace

ENTRIES = [(0, 3, 2), (0, 9, 4), (1, 16, 1), (2, 5, 3), (2, 12, 2),
           (4, 7, 4), (5, 2, 3)]
TABLE = dict(max_batch=4, max_prompt=16, max_new=4)
COUNTERS = ("serve_queue_wait_us", "serve_queue_waits",
            "serve_prefill_tokens", "serve_prefill_slots",
            "serve_decode_keys", "serve_kv_slots")
PHASES = {"forward", "sample", "scatter", "slab"}
PARENTS = {"tick": {None}, "admit": {"tick"}, "prefill": {"admit"},
           "decode": {"tick"}, "slab": {"admit"}, "scatter": {"prefill"},
           "forward": {"prefill", "decode"}, "sample": {"prefill", "decode"}}


@pytest.fixture(autouse=True)
def _clean_ledger():
    guard.reset()
    yield
    guard.reset()


def _model(device="cpu", dtype=None):
    cfg = get_config("phi4-mini-3.8b").reduced()
    if dtype is not None:
        import dataclasses
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return cfg, build_model(cfg, device).init(0)


def _serve(cfg, params, *, profiled, armed=False, **kw):
    """A scripted run of ENTRIES: (scheduler, trace or None, profiler's
    repro_torch ranges [(start, end, kind)] or None, the run's counters)."""
    table = BucketTable.for_workload(**TABLE)
    sched = Scheduler(params, cfg, table, **kw)
    reqs = scripted_trace(ENTRIES, vocab_size=cfg.vocab_size, seed=3)
    scope = trace_scope(clock=SimClock()) if armed else None
    prof = profile(activities=[ProfilerActivity.CPU]) if profiled else None
    if prof is not None:
        prof.__enter__()
    tr = scope.__enter__() if scope is not None else None
    try:
        sched.run(reqs, max_ticks=200)
    finally:
        if scope is not None:
            scope.__exit__(None, None, None)
        if prof is not None:
            prof.__exit__(None, None, None)
    ranges = None
    if prof is not None:
        ranges = sorted(
            ((e.start_ns(), e.end_ns(), e.name()[len(spans.RANGE_PREFIX):])
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(spans.RANGE_PREFIX)),
            key=lambda r: (r[0], -r[1]))
    snap = health.snapshot()
    return sched, tr, ranges, {k: snap.get(k, 0) for k in COUNTERS}


def _parents(ranges):
    """Each range's innermost enclosing range's kind (None at the top)."""
    out, stack = [], []
    for s, t, kind in ranges:
        while stack and stack[-1][1] <= s:
            stack.pop()
        out.append((kind, stack[-1][2] if stack else None))
        stack.append((s, t, kind))
    return out


def test_disarmed_span_opens_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened")

    monkeypatch.setattr(spans._profiler, "record_function", refuse)
    assert not spans._profiler._is_profiler_enabled
    assert spans.span("tick", "t0", tick=0) is spans._NULL_SPAN_CTX
    assert spans.phase("forward") is spans._NULL_SPAN_CTX
    assert not spans.profiling()
    with spans.span("prefill") as sp:
        assert sp is spans.NULL_SPAN and sp.set(n=1) is sp
    with trace_scope() as tr:
        with spans.span("tick", "t0"):
            with spans.phase("forward"):
                pass
    assert tr.digest() == {"tick": 1, "total": 1}


@pytest.mark.parametrize("armed", [False, True])
def test_profiler_ranges_nest_as_the_tree(armed):
    cfg, params = _model()
    sched, tr, ranges, _ = _serve(cfg, params, profiled=True, armed=armed)
    # an armed scope's dispatch spans are ranges too, inside `forward`
    ranges = [r for r in ranges if r[2] in PARENTS]
    kinds = [k for _, _, k in ranges]
    assert set(kinds) == set(PARENTS)
    for kind, parent in _parents(ranges):
        assert parent in PARENTS[kind], (kind, parent)
    tel = sched.telemetry
    assert kinds.count("tick") == tel.ticks
    assert kinds.count("prefill") == tel.prefill_batches
    assert kinds.count("decode") == tel.decode_steps
    assert kinds.count("slab") == len(sched.slab_history)
    if armed:
        # the tree holds the spans alone, as an unprofiled scope's does
        guard.reset()
        _, plain, _, _ = _serve(cfg, params, profiled=False, armed=True)
        assert tr.digest() == plain.digest()
        assert not PHASES & set(tr.digest())
        assert [sp.attrs["rids"] for sp in tr.spans()
                if sp.kind == "prefill"] == \
            [sp.attrs["rids"] for sp in plain.spans() if sp.kind == "prefill"]


def test_no_range_while_a_graph_is_captured(monkeypatch):
    monkeypatch.setattr(spans, "capturing", lambda: True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert not spans.profiling()
        assert spans.phase("forward") is spans._NULL_SPAN_CTX
        assert spans.span("decode") is spans._NULL_SPAN_CTX
        with trace_scope() as tr:
            with spans.span("tick", "t0"):
                pass
    assert tr.digest() == {"tick": 1, "total": 1}
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith(spans.RANGE_PREFIX)]


def _expected(sched, tr):
    """The counters as the trace entries and the tree give them."""
    max_len = sched.table.max_len
    prefills = [sp for sp in tr.spans() if sp.kind == "prefill"]
    decodes = [sp for sp in tr.spans() if sp.kind == "decode"]
    return {
        "serve_queue_waits": len(ENTRIES),
        "serve_prefill_tokens": sum(p for _, p, _ in ENTRIES),
        "serve_prefill_slots": sum(sp.attrs["batch"] * sp.attrs["bucket"]
                                   for sp in prefills),
        # token j >= 1 of a request comes from a decode step over P + j keys
        "serve_decode_keys": sum(p + j for _, p, m in ENTRIES
                                 for j in range(1, m)),
        "serve_kv_slots": sum(sp.attrs["batch"] * max_len for sp in decodes),
    }


@pytest.mark.parametrize("graphed", [False, True])
def test_counters_count_the_work_while_profiled(graphed):
    cfg, params = _model()
    sched, tr, _, got = _serve(cfg, params, profiled=True, armed=True,
                               decode_graphs=graphed)
    assert got["serve_queue_wait_us"] >= 0
    want = _expected(sched, tr)
    assert {k: got[k] for k in want} == want
    assert all(want.values())
    assert not sched._submitted_ns
    if graphed:
        assert sched.captures
        guard.reset()
        _, _, _, eager = _serve(cfg, params, profiled=True,
                                decode_graphs=False)
        got.pop("serve_queue_wait_us")
        eager.pop("serve_queue_wait_us")
        assert got == eager


def test_nothing_counted_with_the_profiler_off():
    cfg, params = _model()
    sched, _, _, got = _serve(cfg, params, profiled=False)
    assert sched.results and not any(got.values())
    assert not sched._submitted_ns


def test_wall_clock_times_cpu_dispatches_at_once():
    from repro_torch.core import skewmm

    a, b = torch.ones(8, 16), torch.ones(16, 4)
    with trace_scope(clock=WallClock()) as tr:
        skewmm.matmul(a, b)
        (sp,) = [s for s in tr.spans() if s.kind == "dispatch"]
        assert sp.measured_us is not None and sp.measured_us > 0
    assert sp.attrs["shape_class"] in drift_report()["classes"]


# ------------------------------------------------------------- the card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        if os.environ.get("REPRO_TORCH_REQUIRE_CUDA") == "1":
            pytest.fail("REPRO_TORCH_REQUIRE_CUDA=1 but no CUDA device")
        pytest.skip("no CUDA device")
    yield torch.device("cuda")


@pytest.mark.cuda
def test_wall_clock_defers_card_dispatches_to_the_scope_close(dev,
                                                              monkeypatch):
    from repro_torch.core import skewmm

    a = torch.randn(64, 256, device=dev, dtype=torch.bfloat16)
    b = torch.randn(256, 512, device=dev, dtype=torch.bfloat16)
    skewmm.matmul(a, b)
    torch.cuda.synchronize()
    syncs = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *x: syncs.append(x) or real(*x))
    with trace_scope(clock=WallClock()) as tr:
        for _ in range(3):
            skewmm.matmul(a, b)
        inside = [s.measured_us for s in tr.spans() if s.kind == "dispatch"]
        assert inside == [None] * 3 and not syncs
        assert drift_report()["classes_total"] == 0
    assert len(syncs) == 1
    got = [s for s in tr.spans() if s.kind == "dispatch"]
    assert all(s.measured_us > 0 and "shape_class" in s.attrs for s in got)
    (cls,) = drift_report()["classes"].values()
    assert cls["count"] == 3


@pytest.mark.cuda
def test_graph_replays_add_no_counter_on_the_card(dev):
    cfg, params = _model(dev, "bfloat16")
    counts = {}
    for graphed in (True, False):
        guard.reset()
        sched, _, ranges, got = _serve(cfg, params, profiled=True,
                                       decode_graphs=graphed)
        torch.cuda.synchronize()
        got.pop("serve_queue_wait_us")
        counts[graphed] = got
        if graphed:
            assert sched.captures and sched._graph is not None
            assert not [k for k in sched._graph.host_per_step
                        if k in COUNTERS]
            assert {"forward", "sample"} <= {k for _, _, k in ranges}
    assert counts[True] == counts[False] and all(counts[True].values())
