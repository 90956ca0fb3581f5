"""The port's continuous-batching scheduler (`repro_torch.serve.sched`)
against the JAX package's `repro.serve.sched`, on the CPU.

The JAX side runs with its "xla" backend; the port's scheduler with its
"cuda" backend (the kernels' plain versions on CPU tensors) unless a case
says otherwise.  Weights are made by the JAX initializer and carried over
with `convert` (numpy); traces are `scripted_trace` of the same entries and
seed in both packages.

* The pure-Python pieces — `Clock`, `Request`, `RequestQueue`,
  `AdmissionPolicy`, `SlotFreeList`, `pad_axis`, `bucket_up`,
  `BucketTable` and `percentile` — equal the JAX package's on seeded
  draws: the same values and the same exceptions.
* `moebatch` equals the JAX package's arithmetic on dbrx-132b (published
  and reduced) and the JAX suite's dbrx variant (4 experts, top-2,
  capacity factor 1.0: `min_full_batch` 16).
* `capture_gemm_specs` / `decode_gemm_specs` (the port traces on the meta
  device, the JAX package with `jax.eval_shape`) give equal lists, in
  order: the 63-class phi4 table of the `serve_sched_trace` baseline, the
  51-class decode-scale table on ipu_gc200 and the dbrx variant.  The
  modeled `build_tuned_cache` equals the JAX package's entry for entry
  (every field but `provenance`), and `modeled_step_seconds` is `==` on
  the four reference chips: the port records each stage site once per
  call, as the JAX engine's `lax.scan` does (`core.stage_trace`).
* The scheduler: tokens, results and telemetry equal the JAX scheduler's
  on the same trace and weights; logits (fp32) within 1e-5 of the
  largest logit — both packages sum each contraction in fp32 in their own
  order (observed ~1e-6).  The JAX scheduler tests (admission bound,
  tuned zero misses, chaos without eviction, MoE slots full when batched)
  run in both packages with equal ledgers.
* Join / leave on the port's own CPU route, against a teacher-forced
  solo run (batch 1, fed the scheduler's tokens): rows the scheduler
  computed at batch 1 are bitwise equal to the solo rows (the same calls
  on the same shapes); rows computed at a larger batch are held within
  1e-5 of the largest logit, not bitwise, because the CPU route is not
  row-independent: the BLAS behind the plain kernels and `torch.einsum`
  in decode attention sum a row in an order that depends on how many rows
  the call has (observed ~1e-6; the card's bitwise rule is phase 6h's).
* Every record of `benchmarks/baselines/serve.json` and
  `benchmarks/baselines/decode_gemv.json`, rebuilt by the port as the JAX
  suites build them, passes `bench.compare` with no gated failure.
* `launch.serve_bench --device cpu` (`--tiny`, and `--decode-scale
  --expect-gemv --chip ipu_gc200`) exits 0 and prints the JAX launcher's
  lines.
* The decode graph's host-counter bookkeeping: a graphed scheduler run
  (the graph object's CPU form) leaves the tuned ledger of the eager run.
"""

import contextlib
import dataclasses
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import guard as jguard
from repro.configs.base import get_config as jget_config
from repro.core.config import mm_config as jmm_config
from repro.guard import faults as jfaults
from repro.guard import health as jhealth
from repro.launch import serve_bench as jserve_bench
from repro.models.model import build_model as jbuild_model
from repro.serve import kvcache as jkvcache
from repro.serve import sched as jsched
from repro.serve.sched import buckets as jbuckets
from repro.serve.sched import moebatch as jmoebatch
from repro.serve.sched import queue as jqueue
from repro.serve.sched import telemetry as jtelemetry
from repro_torch import guard
from repro_torch.bench import compare, io as bench_io
from repro_torch.bench.suite import Recorder
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import hw
from repro_torch.core.config import mm_config
from repro_torch.core.planner import plan_matmul
from repro_torch.guard import faults, health
from repro_torch.guard.fallback import NumericFault
from repro_torch.launch import serve_bench
from repro_torch.models.model import build_model
from repro_torch.serve import engine, kvcache
from repro_torch.serve import sched
from repro_torch.serve.sched import buckets, moebatch, queue, telemetry
from repro_torch.tune import runtime as tune_runtime
from repro_torch.tune.shapeclass import GEMV_M_CLASSES
from repro_torch.tune.tuner import modeled_measurer, tune_decode

BASELINES = Path(__file__).resolve().parents[1] / "benchmarks" / "baselines"
REF_CHIPS = ["tpu_v5e", "ipu_gc200", "gpu_a30", "gpu_rtx2080ti"]
LOGIT_RTOL = 1e-5
SEEDS = range(6)


@pytest.fixture(autouse=True)
def _clean_state():
    guard.reset()
    jguard.reset()
    yield
    guard.reset()
    jguard.reset()


def _outcome(fn):
    """(value, None) or (None, exception type) of one call."""
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return None, type(e)


# ------------------------------------------------------------ models
_WEIGHTS: dict = {}


def _variant(cfg):
    return dataclasses.replace(cfg, n_experts=4, n_experts_per_tok=2,
                               capacity_factor=1.0)


def _configs(arch="phi4-mini-3.8b", variant=None):
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    if variant == "decode_scale":
        jcfg, cfg = jcfg.decode_scale(), cfg.decode_scale()
    elif variant == "moe4":
        jcfg, cfg = _variant(jcfg), _variant(cfg)
    assert jcfg.__dict__ == cfg.__dict__
    return jcfg, cfg


def _model(arch="phi4-mini-3.8b", variant=None):
    """JAX weights (PRNGKey 0, as the JAX suites) and the port's copy."""
    key = (arch, variant)
    if key not in _WEIGHTS:
        jcfg, cfg = _configs(arch, variant)
        jp = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _WEIGHTS[key] = (jcfg, cfg, jp, tp)
    return _WEIGHTS[key]


# ------------------------------------------------ pure-Python pieces
@pytest.mark.parametrize("seed", SEEDS)
def test_clock_and_request_equal_jax(seed):
    rng = np.random.default_rng(seed)
    jc, c = jqueue.Clock(int(rng.integers(0, 5))), queue.Clock(0)
    c = queue.Clock(jc.now)
    for _ in range(20):
        t = int(rng.integers(-1, 4))
        assert _outcome(lambda: c.advance(t)) == _outcome(
            lambda: jc.advance(t))
        assert c.now == jc.now
    for _ in range(20):
        toks = tuple(int(x) for x in rng.integers(0, 9,
                                                  int(rng.integers(0, 4))))
        max_new, arrival = int(rng.integers(-1, 3)), int(rng.integers(-1, 3))
        got, err = _outcome(lambda: queue.Request(0, toks, max_new, arrival))
        want, jerr = _outcome(lambda: jqueue.Request(0, toks, max_new,
                                                     arrival))
        assert err == jerr
        if got is not None:
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
            assert got.prompt_len == want.prompt_len


@pytest.mark.parametrize("seed", SEEDS)
def test_request_queue_and_admission_equal_jax(seed):
    rng = np.random.default_rng(seed)
    q, jq = queue.RequestQueue(), jqueue.RequestQueue()
    for rid in rng.permutation(24):
        arrival, n = int(rng.integers(0, 8)), int(rng.integers(1, 5))
        q.push(queue.Request(int(rid), (1,) * n, 1, arrival))
        jq.push(jqueue.Request(int(rid), (1,) * n, 1, arrival))
    for now in range(10):
        assert q.ready(now) == jq.ready(now) and len(q) == len(jq)
        limit = int(rng.integers(0, 5))
        assert [r.rid for r in q.pop_ready(now, limit)] == [
            r.rid for r in jq.pop_ready(now, limit)]
    for _ in range(30):
        args = [int(x) for x in rng.integers(0, 6, 3)]
        got = _outcome(lambda: queue.AdmissionPolicy(*args[:2]))
        want = _outcome(lambda: jqueue.AdmissionPolicy(*args[:2]))
        assert got[1] == want[1]
        if got[0] is not None:
            assert got[0].admit_budget(args[2]) == want[0].admit_budget(
                args[2])


@pytest.mark.parametrize("seed", SEEDS)
def test_slot_free_list_equals_jax(seed):
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(1, 5))
    fl, jfl = kvcache.SlotFreeList(cap), jkvcache.SlotFreeList(cap)
    for _ in range(60):
        op = rng.integers(0, 3)
        if op == 0:
            pair = (_outcome(fl.alloc), _outcome(jfl.alloc))
        elif op == 1:
            slot = int(rng.integers(-1, fl.capacity + 1))
            pair = (_outcome(lambda: fl.release(slot)),
                    _outcome(lambda: jfl.release(slot)))
        else:
            new = int(rng.integers(0, 10))
            pair = (_outcome(lambda: fl.grow(new)),
                    _outcome(lambda: jfl.grow(new)))
        assert pair[0] == pair[1]
        assert len(fl) == len(jfl) and fl.capacity == jfl.capacity


@pytest.mark.parametrize("seed", SEEDS)
def test_pad_axis_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        shape = tuple(int(x) for x in rng.integers(1, 5, rng.integers(1, 5)))
        axis = int(rng.integers(0, len(shape)))
        length = shape[axis] + int(rng.integers(-1, 4))
        x = rng.normal(size=shape).astype(np.float32)
        got, err = _outcome(lambda: kvcache.pad_axis(torch.tensor(x), axis,
                                                     length))
        want, jerr = _outcome(lambda: jkvcache.pad_axis(jnp.asarray(x), axis,
                                                        length))
        assert err == jerr
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pad_axis_returns_a_new_tensor_and_leaves_the_old():
    t = torch.arange(6.0).reshape(2, 3)
    padded = kvcache.pad_axis(t, 1, 5)
    assert tuple(padded.shape) == (2, 5) and padded.dtype == t.dtype
    assert torch.equal(padded[:, :3], t) and not padded[:, 3:].any()
    padded[0, 0] = 9.0
    assert t[0, 0] == 0.0
    assert kvcache.pad_axis(t, 1, 3) is t
    with pytest.raises(ValueError):
        kvcache.pad_axis(t, 1, 2)


@pytest.mark.parametrize("seed", SEEDS)
def test_bucket_table_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for d in range(0, 70):
        assert _outcome(lambda: buckets.bucket_up(d)) == _outcome(
            lambda: jbuckets.bucket_up(d))
    for _ in range(12):
        kw = dict(max_batch=int(rng.integers(1, 20)),
                  max_prompt=int(rng.integers(1, 300)),
                  max_new=int(rng.integers(0, 20)),
                  min_batch=int(rng.integers(1, 4)),
                  min_prompt=int(rng.integers(1, 40)))
        got, err = _outcome(lambda: buckets.BucketTable.for_workload(**kw))
        want, jerr = _outcome(lambda: jbuckets.BucketTable.for_workload(**kw))
        assert err == jerr
        if got is None:
            continue
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        for n in range(0, 24):
            assert _outcome(lambda: got.batch_bucket(n)) == _outcome(
                lambda: want.batch_bucket(n))
        for s in range(0, 320, 7):
            assert _outcome(lambda: got.prompt_bucket(s)) == _outcome(
                lambda: want.prompt_bucket(s))
    for bad in (dict(batch_buckets=(3,), prompt_buckets=(8,), max_new=1,
                     max_len=16),
                dict(batch_buckets=(2, 1), prompt_buckets=(8,), max_new=1,
                     max_len=16),
                dict(batch_buckets=(), prompt_buckets=(8,), max_new=1,
                     max_len=16),
                dict(batch_buckets=(1,), prompt_buckets=(8,), max_new=9,
                     max_len=16)):
        assert _outcome(lambda: buckets.BucketTable(**bad))[1] is ValueError
        assert _outcome(lambda: jbuckets.BucketTable(**bad))[1] is ValueError


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gemma2-27b",
                                  "recurrentgemma-9b", "mamba2-2.7b",
                                  "dbrx-132b"])
@pytest.mark.parametrize("max_prompt", [8, 64, 128])
def test_validate_for_equals_jax(arch, max_prompt):
    """Attention-only caches pass; recurrent and SSM caches are rejected;
    a local ring shorter than the largest prompt bucket is rejected."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    kw = dict(max_batch=2, max_prompt=max_prompt, max_new=2)
    t, jt = (buckets.BucketTable.for_workload(**kw),
             jbuckets.BucketTable.for_workload(**kw))
    got, want = (_outcome(lambda: t.validate_for(cfg)),
                 _outcome(lambda: jt.validate_for(jcfg)))
    assert got == want
    if arch in ("recurrentgemma-9b", "mamba2-2.7b"):
        assert got[1] is ValueError


@pytest.mark.parametrize("seed", SEEDS)
def test_percentile_and_telemetry_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(30):
        vals = [int(x) for x in rng.integers(0, 50, rng.integers(0, 12))]
        p = float(rng.choice([-1, 0, 1, 25, 50, 90, 99.5, 100, 101]))
        assert _outcome(lambda: telemetry.percentile(vals, p)) == _outcome(
            lambda: jtelemetry.percentile(vals, p))
        assert telemetry.percentile(vals, 50, default=0.0) == \
            jtelemetry.percentile(vals, 50, default=0.0)
    t, jt = telemetry.ServeTelemetry(), jtelemetry.ServeTelemetry()
    for _ in range(10):
        a, b, n = (int(x) for x in rng.integers(0, 9, 3))
        for tel in (t, jt):
            tel.observe_admission(a)
            tel.observe_first_token(b)
            tel.observe_completion(a + b, n)
            tel.tokens_out += n
            tel.ticks += 1
    assert t.summary() == jt.summary()
    t.record_health()
    jt.record_health()
    assert health.snapshot() == jhealth.snapshot()
    assert health.provenance_fields() == jhealth.provenance_fields()


# ---------------------------------------------------------- moebatch
@pytest.mark.parametrize("which", ["published", "reduced", "moe4"])
def test_moebatch_equals_jax(which):
    if which == "published":
        jcfg, cfg = jget_config("dbrx-132b"), get_config("dbrx-132b")
    else:
        jcfg, cfg = _configs("dbrx-132b",
                             "moe4" if which == "moe4" else None)
    assert moebatch.has_moe(cfg) == jmoebatch.has_moe(jcfg) is True
    for t in list(range(1, 70)) + [128, 1000, 4096]:
        for name in ("capacity", "total_slots", "slot_utilization",
                     "slot_underfill"):
            assert getattr(moebatch, name)(t, cfg) == \
                getattr(jmoebatch, name)(t, jcfg)
    got = _outcome(lambda: moebatch.min_full_batch(cfg, limit=4096))
    assert got == _outcome(lambda: jmoebatch.min_full_batch(jcfg,
                                                            limit=4096))
    if which == "moe4":
        assert got[0] == 16
    assert not moebatch.has_moe(get_config("phi4-mini-3.8b"))


# ----------------------------------------------------------- capture
# (arch, variant, table kwargs, chip): the `serve_sched_trace` table (63
# classes), the decode-scale table on ipu_gc200 (51) and the dbrx variant
# at its min_full_batch
CAPTURES = {
    "phi4": ("phi4-mini-3.8b", None,
             dict(max_batch=4, max_prompt=16, max_new=4), "tpu_v5e", 63),
    "decode_scale": ("phi4-mini-3.8b", "decode_scale",
                     dict(max_batch=4, max_prompt=8, max_new=2),
                     "ipu_gc200", 51),
    "dbrx_moe4": ("dbrx-132b", "moe4",
                  dict(max_batch=16, max_prompt=8, max_new=3, min_batch=16),
                  "tpu_v5e", None),
}


def _tables(kw):
    return (buckets.BucketTable.for_workload(**kw),
            jbuckets.BucketTable.for_workload(**kw))


@pytest.mark.parametrize("case", list(CAPTURES))
def test_capture_specs_equal_jax(case):
    arch, variant, kw, chip, n = CAPTURES[case]
    jcfg, cfg, jp, tp = _model(arch, variant)
    table, jtable = _tables(kw)
    with mm_config(chip=chip), jmm_config(chip=chip):
        specs = buckets.capture_gemm_specs(tp, cfg, table)
        jspecs = jbuckets.capture_gemm_specs(jp, jcfg, jtable)
        dspecs = buckets.decode_gemm_specs(tp, cfg, table)
        jdspecs = jbuckets.decode_gemm_specs(jp, jcfg, jtable)
    assert specs == jspecs and dspecs == jdspecs
    assert set(dspecs) <= set(specs)
    if n is not None:
        assert len(specs) == n
    if variant == "moe4":
        assert any(s[0] == "grouped" for s in specs)


def test_capture_runs_on_the_meta_device_and_records_nothing_else():
    """The capture computes nothing: no parameter or cache leaves the meta
    device, the caller's weights are untouched, and no health counter,
    launch or device allocation is made."""
    from repro_torch.kernels import ops

    jcfg, cfg, jp, tp = _model()
    table, _ = _tables(dict(max_batch=2, max_prompt=8, max_new=2))
    before = {k: v.clone() for k, v in tp.items() if torch.is_tensor(v)}
    ops.reset_launch_counts()
    specs = buckets.capture_gemm_specs(tp, cfg, table)
    assert specs and health.snapshot() == {}
    assert not any(ops.launch_counts().values())
    for k, v in before.items():
        assert torch.equal(tp[k], v) and tp[k].device.type == "cpu"
    meta = buckets._to_meta(tp)
    assert meta["embed"].is_meta and meta["stage0"][0]["b0"]["attn"][
        "wq"].is_meta


@pytest.mark.parametrize("case", list(CAPTURES))
def test_modeled_tuned_cache_equals_jax(case):
    arch, variant, kw, chip, _ = CAPTURES[case]
    jcfg, cfg, jp, tp = _model(arch, variant)
    table, jtable = _tables(kw)
    with mm_config(chip=chip), jmm_config(chip=chip):
        cache = buckets.build_tuned_cache(tp, cfg, table)
        jcache = jbuckets.build_tuned_cache(jp, jcfg, jtable)
        specs = buckets.capture_gemm_specs(tp, cfg, table)
        buckets.assert_covered(cache, specs)
        cov = buckets.gemv_decode_coverage(
            cache, buckets.decode_gemm_specs(tp, cfg, table))
        jcov = jbuckets.gemv_decode_coverage(
            jcache, jbuckets.decode_gemm_specs(jp, jcfg, jtable))
    assert list(cache.entries) == list(jcache.entries)
    for key, e in cache.entries.items():
        want = dict(jcache.entries[key].to_json())
        got = dict(e.to_json())
        want.pop("provenance")
        got.pop("provenance")
        assert got == want
    assert cov == jcov
    with pytest.raises(AssertionError, match="does not cover"):
        with mm_config(chip=chip):
            buckets.assert_covered(type(cache)(), specs)


@pytest.mark.parametrize("chip", REF_CHIPS)
@pytest.mark.parametrize("batch", [1, 4, 8])
def test_modeled_step_seconds_equal_jax(chip, batch):
    jcfg, cfg, jp, tp = _model()
    got = buckets.modeled_step_seconds(tp, cfg, batch, 20, chip=chip)
    want = jbuckets.modeled_step_seconds(jp, jcfg, batch, 20, chip=chip)
    assert got == want and got > 0


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gemma2-27b",
                                  "dbrx-132b", "recurrentgemma-9b",
                                  "mamba2-2.7b"])
def test_plan_log_per_call_equals_jax(arch):
    """A prefill and a decode step record each stage site once, as the JAX
    engine's `lax.scan` traces its body once: the same plans, in order."""
    from repro.core import skewmm as jskewmm
    from repro.serve import engine as jengine
    from repro_torch.core import skewmm

    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.zeros((2, 8), np.int32)
    with jmm_config(backend="xla"), jskewmm.plan_capture() as jlog:
        jcache, _ = jengine.prefill(jp, jcfg, jnp.asarray(toks), max_len=12)
        jengine.decode_step(jp, jcfg, jcache, jnp.zeros((2,), jnp.int32),
                            jnp.asarray([8, 8], jnp.int32))
    with mm_config(chip="tpu_v5e"), skewmm.plan_capture() as log:
        cache, _ = engine.prefill(tp, cfg,
                                  torch.tensor(toks, dtype=torch.long),
                                  max_len=12)
        engine.decode_step(tp, cfg, cache,
                           torch.zeros((2,), dtype=torch.long),
                           torch.tensor([8, 8], dtype=torch.int32))
    assert [buckets._spec_of(c) for c in log] == [
        jbuckets._spec_of(c) for c in jlog]
    assert sum(c.total_s for c in log if hasattr(c, "total_s")) == sum(
        c.total_s for c in jlog if hasattr(c, "total_s"))


# --------------------------------------------------------- scheduler
SCHED_ENTRIES = [(0, 3, 2), (0, 9, 4), (1, 16, 1), (2, 5, 3), (2, 12, 2),
                 (4, 7, 4), (5, 2, 3)]


def _both_runs(arch="phi4-mini-3.8b", variant=None, entries=SCHED_ENTRIES,
               kw=None, seed=3, jmm=None, mm=None, ctx=None, port_kw=None,
               **sched_kw):
    """The JAX scheduler and the port's on the same trace and weights:
    (port scheduler, its health snapshot, JAX scheduler, its snapshot).
    `port_kw` goes to the port's scheduler alone."""
    jcfg, cfg, jp, tp = _model(arch, variant)
    table, jtable = _tables(kw or dict(max_batch=4, max_prompt=16,
                                       max_new=4))
    ctx = ctx or (lambda pkg: contextlib.nullcontext())
    out = []
    for pkg in ("jax", "port"):
        guard.reset()
        jguard.reset()
        if pkg == "jax":
            trace = jsched.scripted_trace(entries, vocab_size=cfg.vocab_size,
                                          seed=seed)
            with jmm_config(backend="xla", **(jmm or {})), ctx(pkg):
                s = jsched.Scheduler(jp, jcfg, jtable, trace_logits=True,
                                     **sched_kw)
                s.run(trace, max_ticks=200)
            out += [s, jhealth.snapshot()]
        else:
            trace = sched.scripted_trace(entries, vocab_size=cfg.vocab_size,
                                         seed=seed)
            with mm_config(**(mm or {})), ctx(pkg):
                s = sched.Scheduler(tp, cfg, table, trace_logits=True,
                                    **sched_kw, **(port_kw or {}))
                s.run(trace, max_ticks=200)
            out += [s, health.snapshot()]
    return out[2], out[3], out[0], out[1]


def _logits_close(s, js):
    assert sorted(s.logit_trace) == sorted(js.logit_trace)
    for rid, rows in s.logit_trace.items():
        jrows = js.logit_trace[rid]
        assert len(rows) == len(jrows)
        for got, want in zip(rows, jrows):
            want = np.asarray(want, np.float32)
            scale = np.abs(want).max()
            assert np.abs(got - want).max() <= LOGIT_RTOL * scale


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("guard_on", [True, False])
def test_scheduler_equals_jax(backend, guard_on):
    s, snap, js, jsnap = _both_runs(mm=dict(backend=backend),
                                    guard=guard_on)
    assert s.results == js.results and len(s.results) == len(SCHED_ENTRIES)
    assert s.telemetry.summary() == js.telemetry.summary()
    assert snap == jsnap
    assert s.slab_batch == js.slab_batch
    _logits_close(s, js)


def test_scheduler_equals_jax_on_dbrx():
    s, snap, js, jsnap = _both_runs(
        "dbrx-132b", entries=[(0, 5, 3), (0, 8, 2), (1, 3, 3), (2, 7, 2)])
    assert s.results == js.results
    assert s.telemetry.summary() == js.telemetry.summary()
    assert snap == jsnap and snap["moe_slots_total"] > 0
    _logits_close(s, js)


# The JAX package's scheduler tests (tests/test_serve.py), in both
# packages with equal outcomes and ledgers.
def _tuned_ctx(arch="phi4-mini-3.8b", variant=None,
               kw=dict(max_batch=2, max_prompt=8, max_new=2)):
    """Each package under plan_mode="tuned" with its modeled covering
    cache."""
    from repro.tune import runtime as jtune_runtime

    jcfg, cfg, jp, tp = _model(arch, variant)
    table, jtable = _tables(kw)
    cache = buckets.build_tuned_cache(tp, cfg, table)
    jcache = jbuckets.build_tuned_cache(jp, jcfg, jtable)

    @contextlib.contextmanager
    def ctx(pkg):
        if pkg == "jax":
            with jtune_runtime.use_cache(jcache), \
                    jmm_config(plan_mode="tuned"):
                yield
        else:
            with tune_runtime.use_cache(cache), mm_config(plan_mode="tuned"):
                yield
    return ctx


@contextlib.contextmanager
def _chaos(pkg):
    scope = jfaults if pkg == "jax" else faults
    with scope.fault_scope(seed=5, kinds=("nan_output", "inf_output")):
        yield


JAX_SCHED_TESTS = {
    "tuned_zero_misses": lambda: dict(
        entries=[(0, 3, 2), (0, 6, 2), (1, 8, 1)], seed=5,
        kw=dict(max_batch=2, max_prompt=8, max_new=2), ctx=_tuned_ctx()),
    # the JAX package's default "xla" backend has no guarded kernel inside
    # the step; its counterpart is the port's "torch" backend, so the
    # faults land at the decode site alone in both
    "chaos_no_eviction": lambda: dict(
        entries=[(0, 3, 3), (1, 6, 3)], seed=9, mm=dict(backend="torch"),
        kw=dict(max_batch=2, max_prompt=8, max_new=3), ctx=_chaos),
    "moe_slots_full_when_batched": lambda: dict(
        arch="dbrx-132b", variant="moe4", entries=[(0, 4, 2)] * 16, seed=3,
        kw=dict(max_batch=16, max_prompt=4, max_new=2, min_batch=16),
        guard=False),
}


@pytest.mark.parametrize("case", list(JAX_SCHED_TESTS))
def test_jax_scheduler_tests_in_both_packages(case):
    kw = JAX_SCHED_TESTS[case]()
    s, snap, js, jsnap = _both_runs(**kw)
    assert s.results == js.results
    assert s.telemetry.summary() == js.telemetry.summary()
    assert snap == jsnap
    entries = kw["entries"]
    assert sorted(s.results) == list(range(len(entries)))
    for rid, (_, _, max_new) in enumerate(entries):
        assert len(s.results[rid]["tokens"]) == max_new
    if case == "tuned_zero_misses":
        assert snap.get("tuned_misses", 0) == 0 and snap["tuned_hits"] > 0
    elif case == "chaos_no_eviction":
        assert snap["faults_injected"] == snap["faults_caught"] > 0
        assert snap["scrubbed_batches"] > 0
    else:
        assert snap["moe_slots_total"] == snap["moe_slots_filled"] > 0
        assert snap.get("moe_slots_underfilled", 0) == 0
    _logits_close(s, js)


def test_admission_bound_in_both_packages():
    """At most `max_live` requests are live after every tick."""
    jcfg, cfg, jp, tp = _model()
    table, jtable = _tables(dict(max_batch=4, max_prompt=16, max_new=4))
    entries = [(0, 3, 2), (0, 9, 2), (0, 5, 2), (1, 12, 1), (3, 2, 2)]
    runs = []
    for mod, s in (
            (jsched, jsched.Scheduler(
                jp, jcfg, jtable, guard=False, trace_logits=True,
                policy=jsched.AdmissionPolicy(max_live=2,
                                              max_admit_per_tick=2))),
            (sched, sched.Scheduler(
                tp, cfg, table, guard=False, trace_logits=True,
                policy=sched.AdmissionPolicy(max_live=2,
                                             max_admit_per_tick=2)))):
        for r in mod.scripted_trace(entries, vocab_size=cfg.vocab_size,
                                    seed=11):
            s.submit(r)
        live = []
        with jmm_config(backend="xla"):
            for _ in range(50):
                if not s.queue and not s.live:
                    break
                s.step()
                live.append(s.n_live)
        assert max(live) <= 2
        runs.append((s, live))
    (js, jlive), (s, live) = runs
    assert live == jlive and s.results == js.results
    assert sorted(s.results) == list(range(len(entries)))
    assert s.telemetry.completed == len(entries)
    _logits_close(s, js)


def test_scheduler_rejects_what_it_cannot_serve():
    jcfg, cfg, jp, tp = _model()
    table, _ = _tables(dict(max_batch=2, max_prompt=8, max_new=2))
    s = sched.Scheduler(tp, cfg, table)
    with pytest.raises(ValueError):
        s.submit(sched.Request(0, (1,) * 9, 1))
    with pytest.raises(ValueError):
        s.submit(sched.Request(0, (1,) * 3, 3))
    with pytest.raises(ValueError):
        sched.Scheduler(tp, cfg, table, policy=sched.AdmissionPolicy(3))
    with pytest.raises(ValueError, match="attention-only"):
        sched.Scheduler(tp, get_config("mamba2-2.7b").reduced(), table)


@pytest.mark.parametrize("stage", ["prefill", "decode"])
def test_a_nan_with_nothing_armed_raises(stage, monkeypatch):
    """With the guard on and no fault scope armed, non-finite logits at a
    prefill or at a decode step raise `NumericFault`: nothing is scrubbed
    and no request completes with a token read off them."""
    jcfg, cfg, jp, tp = _model()
    table, _ = _tables(dict(max_batch=2, max_prompt=8, max_new=2))
    if stage == "prefill":
        prefill = engine.prefill

        def poisoned(*args, **kwargs):
            cache, logits = prefill(*args, **kwargs)
            return cache, logits * float("nan")

        monkeypatch.setattr(engine, "prefill", poisoned)
    else:
        decode_step = engine.decode_step

        def poisoned(*args, **kwargs):
            logits, cache = decode_step(*args, **kwargs)
            return logits * float("nan"), cache

        monkeypatch.setattr(engine, "decode_step", poisoned)
    s = sched.Scheduler(tp, cfg, table)
    with pytest.raises(NumericFault, match=stage):
        s.run(sched.scripted_trace([(0, 3, 2), (0, 5, 2)],
                                   vocab_size=cfg.vocab_size, seed=1),
              max_ticks=20)
    snap = health.snapshot()
    assert not snap.get("scrubbed_batches") and not snap.get("faults_caught")
    assert not s.results


def test_join_leave_rows_against_a_teacher_forced_solo_run():
    """Bitwise where the scheduler computed the row at batch 1 (the solo
    call's shapes); elsewhere within 1e-5 of the largest logit (the CPU
    route is not row-independent: see the module docstring)."""
    jcfg, cfg, jp, tp = _model()
    table, _ = _tables(dict(max_batch=4, max_prompt=16, max_new=4))
    trace = sched.scripted_trace([(0, 3, 4), (0, 5, 3), (1, 9, 4),
                                  (2, 2, 3)], vocab_size=cfg.vocab_size,
                                 seed=7)
    s = sched.Scheduler(tp, cfg, table, guard=False, trace_logits=True)
    results = s.run(trace, max_ticks=50)
    assert len(results) == len(trace) and s.slab_history == [2, 4]
    n_exact = n_close = 0
    for req in trace:
        pb = table.prompt_bucket(req.prompt_len)
        toks = torch.zeros((1, pb), dtype=torch.long)
        toks[0, :req.prompt_len] = torch.tensor(req.tokens)
        cache, logits = engine.prefill(
            tp, cfg, toks, max_len=table.max_len,
            last_index=torch.tensor([req.prompt_len - 1]))
        want = [logits[0].numpy().copy()]
        for j, tok in enumerate(results[req.rid]["tokens"][:-1]):
            logits, cache = engine.decode_step(
                tp, cfg, cache, torch.tensor([tok]),
                torch.tensor([req.prompt_len + j], dtype=torch.int32))
            want.append(logits[0].numpy().copy())
        got = s.logit_trace[req.rid]
        assert len(got) == len(want) == req.max_new
        for g, w, b in zip(got, want, s.logit_batches[req.rid]):
            if b == 1:
                np.testing.assert_array_equal(g, w)
                n_exact += 1
            else:
                assert np.abs(g - w).max() <= LOGIT_RTOL * np.abs(w).max()
                n_close += 1
    assert n_exact and n_close


def test_graphed_scheduler_leaves_the_eager_ledger():
    """The decode graph's CPU form (warm-up on a scratch cache, then
    `decode_step` on its static buffers) under plan_mode="tuned": equal
    results, logits and health ledger to the eager route and to the JAX
    scheduler's (the warm-up records nothing)."""
    run = dict(entries=[(0, 3, 2), (0, 6, 2), (1, 8, 2), (1, 2, 2)], seed=5,
               kw=dict(max_batch=2, max_prompt=8, max_new=2),
               ctx=_tuned_ctx())
    s, snap, js, jsnap = _both_runs(**run,
                                    port_kw=dict(decode_graphs=True))
    e, esnap, _, _ = _both_runs(**run, port_kw=dict(decode_graphs=False))
    assert s.decode_graphs and not e.decode_graphs
    assert [c["batch"] for c in s.captures] == s.slab_history
    assert not e.captures
    assert snap == esnap == jsnap and snap["tuned_hits"] > 0
    assert s.results == e.results == js.results
    for rid, rows in s.logit_trace.items():
        for g, w in zip(rows, e.logit_trace[rid]):
            np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------- baselines
def _serve_records() -> list:
    """The JAX `serve` suite, rebuilt with the port (the suite ran with its
    default chip, tpu_v5e, and modeled tuning)."""
    records: list = []
    rec = Recorder("serve", records)

    def run_trace(cfg, table, entries, *, policy=None, seed=3):
        params = build_model(cfg, "cpu").init(0)
        specs = sched.capture_gemm_specs(params, cfg, table)
        cache = sched.build_tuned_cache(params, cfg, table)
        sched.assert_covered(cache, specs)
        trace = sched.scripted_trace(entries, vocab_size=cfg.vocab_size,
                                     seed=seed)
        guard.reset()
        try:
            with tune_runtime.use_cache(cache), \
                    mm_config(plan_mode="tuned"):
                s = sched.Scheduler(params, cfg, table, policy=policy)
                results = s.run(trace, max_ticks=200)
            snap = health.snapshot()
        finally:
            guard.reset()
        assert len(results) == len(trace)
        return s, snap, len(specs)

    with mm_config(chip="tpu_v5e"):
        cfg = get_config("phi4-mini-3.8b").reduced()
        table = sched.BucketTable.for_workload(max_batch=4, max_prompt=16,
                                               max_new=4)
        s, snap, n_specs = run_trace(cfg, table, SCHED_ENTRIES)
        summary = s.telemetry.summary()
        rec("serve_sched_trace", axes={"arch": "phi4-mini-3.8b"},
            metrics={
                "admitted": s.telemetry.admitted,
                "completed": s.telemetry.completed,
                "prefill_batches": s.telemetry.prefill_batches,
                "decode_steps": s.telemetry.decode_steps,
                "tokens_out": s.telemetry.tokens_out,
                "ticks": s.telemetry.ticks,
                "shape_classes": n_specs,
                "tuned_hits": snap.get("tuned_hits", 0),
                "tuned_misses": snap.get("tuned_misses", 0),
                "ttft_p50": summary["ttft_p50"],
                "ttft_p90": summary["ttft_p90"],
                "queue_p50": summary["queue_p50"],
                "queue_p90": summary["queue_p90"],
            },
            info={"counters": "/".join(f"{k}:{v}"
                                       for k, v in sorted(snap.items()))})

        dcfg = cfg.decode_scale()
        dtable = sched.BucketTable.for_workload(max_batch=4, max_prompt=8,
                                                max_new=2)
        with mm_config(chip="ipu_gc200"):
            ds, dsnap, dn = run_trace(dcfg, dtable, [(0, 3, 2), (0, 6, 1),
                                                     (1, 5, 2), (2, 7, 2)])
        rec("serve_gemv_decode", axes={"arch": dcfg.name,
                                       "chip": "ipu_gc200"},
            metrics={
                "completed": ds.telemetry.completed,
                "decode_steps": ds.telemetry.decode_steps,
                "tokens_out": ds.telemetry.tokens_out,
                "shape_classes": dn,
                "tuned_hits": dsnap.get("tuned_hits", 0),
                "tuned_misses": dsnap.get("tuned_misses", 0),
                "tuned_hits_gemv": dsnap.get("tuned_hits_gemv", 0),
            },
            info={"counters": "/".join(f"{k}:{v}"
                                       for k, v in sorted(dsnap.items()))})

        mcfg = _variant(get_config("dbrx-132b").reduced())
        mfb = sched.min_full_batch(mcfg)

        def moe_util(table, entries, *, policy=None):
            _, snap, _ = run_trace(mcfg, table, entries, policy=policy)
            total = snap.get("moe_slots_total", 0)
            filled = snap.get("moe_slots_filled", 0)
            return {"slots_total": total, "slots_filled": filled,
                    "underfilled": snap.get("moe_slots_underfilled", 0),
                    "slot_util": filled / max(total, 1)}

        batched = moe_util(sched.BucketTable.for_workload(
            max_batch=mfb, max_prompt=8, max_new=3, min_batch=mfb),
            [(0, 8, 3)] * mfb)
        sequential = moe_util(
            sched.BucketTable.for_workload(max_batch=1, max_prompt=8,
                                           max_new=3),
            [(0, 8, 3)] * 4,
            policy=sched.AdmissionPolicy(max_live=1, max_admit_per_tick=1))
        rec("serve_moe_slots_batched", axes={"arch": "dbrx-132b",
                                             "mode": "batched"},
            metrics={"min_full_batch": mfb, **batched})
        rec("serve_moe_slots_sequential", axes={"arch": "dbrx-132b",
                                                "mode": "sequential"},
            metrics=sequential)

        batch = table.batch_buckets[-1]
        params = build_model(cfg, "cpu").init(0)
        tps = {chip: batch / sched.modeled_step_seconds(
                   params, cfg, batch, table.max_len, chip=chip)
               for chip in ("ipu_gc200", "gpu_rtx2080ti")}
        ratio_decode = tps["ipu_gc200"] / tps["gpu_rtx2080ti"]
        square = {chip: plan_matmul(4096, 4096, 4096, chip=chip).total_s
                  for chip in tps}
        ratio_square = square["gpu_rtx2080ti"] / square["ipu_gc200"]
        for chip, rate in tps.items():
            rec(f"serve_decode_{chip}",
                axes={"arch": "phi4-mini-3.8b", "chip": chip},
                metrics={"tokens_per_s": rate})
        rec("serve_verdict", axes={"arch": "phi4-mini-3.8b"},
            metrics={"decode_rate_spread": ratio_decode,
                     "square_rate_spread": ratio_square,
                     "skew_speedup": ratio_decode / ratio_square,
                     "verdict": int(ratio_decode > ratio_square)})
    return records


def _decode_gemv_records() -> list:
    """The JAX `decode_gemv` suite, rebuilt with the port."""
    records: list = []
    rec = Recorder("decode_gemv", records)
    k_dec, n_dec = 4096, 32768
    for chip_name in ("tpu_v5e", "ipu_gc200", "gpu_rtx2080ti"):
        chip = hw.get_chip(chip_name)
        with mm_config(chip=chip):
            entries = tune_decode(k_dec, n_dec, dtype_bytes=2,
                                  measurer=modeled_measurer())
            for m_dec, e in zip(GEMV_M_CLASSES, entries):
                rec(f"decode_gemv_{chip.name}_m{m_dec}",
                    axes={"chip": chip.name, "m": m_dec, "k": k_dec,
                          "n": n_dec},
                    metrics={"family_switch": int(e.schedule == "splitk"),
                             "agreement_frac": float(e.agreement),
                             "speedup": e.speedup},
                    info={"tuned": f"{e.schedule}:"
                                   f"{'x'.join(str(b) for b in e.blocks)}",
                          "key": e.key})
    cfg = get_config("phi4-mini-3.8b").reduced().decode_scale()
    with mm_config(chip="ipu_gc200"):
        params = build_model(cfg, "cpu").init(0)
        table = sched.BucketTable.for_workload(max_batch=4, max_prompt=8,
                                               max_new=2)
        cache = sched.build_tuned_cache(params, cfg, table)
        cov = buckets.gemv_decode_coverage(
            cache, buckets.decode_gemm_specs(params, cfg, table))
    assert cov["gemv_classes"]
    rec("decode_gemv_serve_coverage",
        axes={"arch": cfg.name, "chip": "ipu_gc200"}, metrics=dict(cov))
    return records


@pytest.mark.parametrize("suite", ["serve", "decode_gemv"])
def test_baseline_rows_pass_compare(suite):
    records = _serve_records() if suite == "serve" else \
        _decode_gemv_records()
    _, base = bench_io.read_baselines(str(BASELINES))
    base = [r for r in base if r.suite == suite]
    assert sorted(r.name for r in records) == sorted(r.name for r in base)
    report = compare.compare(records, base)
    assert report.ok, report.summary(verbose=True)
    assert report.counts()["ok"] == sum(len(r.metrics) for r in base)
    got = {r.name: r for r in records}
    if suite == "serve":
        m = got["serve_sched_trace"].metrics
        assert (m["completed"], m["tuned_hits"], m["tuned_misses"]) == \
            (7, 112, 0)
        assert got["serve_gemv_decode"].metrics["tuned_hits_gemv"] == 35


# ------------------------------------------------------------ launcher
SERVE_BENCH_ARGS = {
    "tiny": ["--tiny"],
    "decode_scale_gemv": ["--tiny", "--decode-scale", "--expect-gemv",
                          "--chip", "ipu_gc200"],
}


@pytest.mark.parametrize("case", list(SERVE_BENCH_ARGS))
def test_serve_bench_prints_the_jax_lines(case, capsys):
    """The launcher exits 0 and prints the JAX launcher's lines: weights
    differ (each package's seed-0 init) but no printed number depends on
    them."""
    argv = SERVE_BENCH_ARGS[case]
    assert serve_bench.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    health.reset()
    jhealth.reset()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jserve_bench.main(argv) == 0
    assert out.splitlines() == buf.getvalue().splitlines()
    assert "0 misses" in out
    if case == "decode_scale_gemv":
        assert "(0 split-K)" not in out


def test_serve_bench_traces_a_serve_run(tmp_path, capsys):
    """`--trace` writes a valid Chrome document of the serve run, with a
    dispatch span for every tuned lookup (decode runs eagerly)."""
    import json

    from repro_torch.obs import validate_chrome

    path = tmp_path / "serve.json"
    assert serve_bench.main(["--tiny", "--device", "cpu", "--trace",
                             str(path)]) == 0
    out = capsys.readouterr().out
    (line,) = [x for x in out.splitlines()
               if x.startswith(f"[serve_bench] trace {path}")]
    digest = dict(kv.split(":") for kv in line.split()[-1].split("/"))
    assert int(digest["dispatch"]) == int(digest["tune"]) == 104
    assert int(digest["decode"]) == 6
    validate_chrome(json.loads(path.read_text()))
