"""The port's guard subsystem (`repro_torch.guard`) against the JAX
package's, on the CPU.

* Every test of `tests/test_guard.py` that needs neither the serving
  scheduler nor the distributed package, ported: fault scopes, the hooks,
  validation, the scrub (its CUDA-graph-capture branch on the card, and
  its logic on the CPU with the capture flag forced), retry / backoff, the
  ladder, guarded dispatch at the four matmul sites, the timing outlier
  hook, tune-cache quarantine, the decode scrub and provenance.
* Fault firing equals the JAX package's draw for draw; `Backoff.delay`
  equals it exactly.
* The five chaos scenarios of the JAX guard suite run through both
  packages on `tpu_v5e`: the same health snapshot dict for dict, the same
  ladder floor, outputs within 1e-4 (fp32; the JAX side runs its Pallas
  kernels in interpret mode, the port its plain versions).  The port's
  rows pass `bench.compare` against `benchmarks/baselines/guard.json`.
* Every plan the port's planner returns (4000 seeded draws a chip, tuned
  and modeled modes, split-K plans on gpu_h100) passes `validate_dense`
  on every registered chip; every sparse and grouped plan (2000 draws a
  chip each) passes `validate_sparse` / `validate_grouped`.
* Under `strict` (the dispatch sites' rule for CUDA tensors) a fault no
  scope injected raises out of the ladder and the explicit envelope
  without moving a rung; `guarded_decode_step` raises on non-finite
  logits that no scope injected and copies no cache with nothing armed.
* The scenarios on `gpu_h100` at the shapes `chip_smoke.py` phase 6g
  drives on the card, with their ledgers pinned (`GPU_H100_LEDGERS`; the
  smoke holds the card's ledgers to the same constants).

The guard's card tests are in `tests/test_torch_guard_cuda.py`.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import guard as jguard
from repro.configs.base import get_config as jget_config
from repro.core.config import mm_config as jmm_config
from repro.guard import fallback as jfallback
from repro.guard import faults as jfaults
from repro.guard import health as jhealth
from repro.kernels import ops as jops
from repro.models.model import build_model as jbuild_model
from repro.serve import engine as jengine
from repro.tune import runtime as jtune_runtime
from repro.tune.cache import TuneCache as JTuneCache
from repro_torch import guard
from repro_torch.bench import compare, io as bench_io, timing
from repro_torch.bench.suite import Recorder
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import hw, skewmm
from repro_torch.core.config import mm_config
from repro_torch.core.costmodel import ALL_SCHEDULES, BlockPlan
from repro_torch.core.planner import gemv_applicable, plan_matmul
from repro_torch.guard import chaos, fallback, faults, health, validate
from repro_torch.kernels import ops, ref
from repro_torch.models.model import build_model
from repro_torch.serve import engine, graphs
from repro_torch.sparse.layout import BlockSparseLayout, LayoutSummary
from repro_torch.sparse.planner import plan_grouped_matmul, plan_sparse_matmul
from repro_torch.tune import runtime as tune_runtime
from repro_torch.tune.cache import (TuneCache, TuneEntry, dense_key,
                                    grouped_key, load_or_quarantine,
                                    sparse_key)
from repro_torch.tune.shapeclass import ShapeClass

BASELINES = Path(__file__).resolve().parents[1] / "benchmarks" / "baselines"
CHIPS = ["tpu_v5e", "ipu_gc200", "gpu_a30", "gpu_rtx2080ti", "gpu_h100"]
TOL = 1e-4


@pytest.fixture(autouse=True)
def _clean_guard_state():
    guard.reset()
    jguard.reset()
    yield
    guard.reset()
    jguard.reset()


def _mats(m=96, k=80, n=112, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.tensor(rng.normal(size=(m, k)) * 0.5, dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(k, n)) * 0.5, dtype=torch.float32)
    return a, b


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=5e-3, atol=5e-4)


# ===================================================================
# fault_scope semantics
# ===================================================================
def test_fault_scope_layering_and_merge():
    assert faults.active() is None
    with faults.fault_scope(seed=3, rate=0.5) as outer:
        assert outer.seed == 3 and outer.rate == 0.5
        assert outer.kinds == faults.FAULT_KINDS
        with faults.fault_scope(kinds=("nan_output",)) as inner:
            assert inner.kinds == ("nan_output",)
            assert inner.seed == 3 and inner.rate == 0.5
            assert faults.active() is inner
        assert faults.active() is outer
    assert faults.active() is None


def test_fault_scope_rejects_unknown_fields_and_kinds():
    with pytest.raises(TypeError, match="unknown fault_scope fields"):
        with faults.fault_scope(bogus=1):
            pass
    with pytest.raises(ValueError, match="unknown fault kinds"):
        with faults.fault_scope(kinds=("not_a_fault",)):
            pass
    with pytest.raises(ValueError, match="rate"):
        with faults.fault_scope(rate=1.5):
            pass


def test_fault_draws_are_deterministic_and_scope_local():
    def pattern():
        out = torch.ones((4, 4))
        with faults.fault_scope(kinds=("nan_output",), seed=5, rate=0.4):
            return [faults.maybe_poison(out, "s")[1] for _ in range(12)]

    first = pattern()
    assert pattern() == first
    assert 0 < sum(first) < 12


def test_fire_equals_the_reference_draw_for_draw():
    """10,000 seeded draws: seeds, rates, kinds and sites drawn with numpy,
    each draw's firing equal to the JAX package's."""
    rng = np.random.default_rng(2024)
    kinds = list(faults.FAULT_KINDS)
    sites = ["dense", "sparse", "grouped", "decode", "measure",
             "lookup_dense"]
    total = 0
    for _ in range(20):
        seed = int(rng.integers(0, 2**31))
        rate = float(rng.uniform(0.05, 0.95))
        picks = [(kinds[int(rng.integers(len(kinds)))],
                  sites[int(rng.integers(len(sites)))]) for _ in range(500)]
        with faults.fault_scope(seed=seed, rate=rate):
            got = [faults._fire(k, s) for k, s in picks]
        with jfaults.fault_scope(seed=seed, rate=rate):
            want = [jfaults._fire(k, s) for k, s in picks]
        assert got == want
        assert 0 < sum(got) < len(got)
        total += len(got)
    assert total == 10_000


def test_poison_marks_first_and_last_on_a_copy():
    out = torch.zeros((3, 5))
    with faults.fault_scope(kinds=("nan_output", "inf_output")):
        got, injected = faults.maybe_poison(out, "s")
    assert injected == 2 and got.shape == out.shape
    assert torch.isnan(got.reshape(-1)[0]) and torch.isinf(got.reshape(-1)[-1])
    assert torch.count_nonzero(out) == 0  # the kernel's buffer untouched


def test_hooks_noop_without_scope():
    out = torch.ones((4, 4))
    poisoned, injected = faults.maybe_poison(out, "s")
    assert injected == 0 and poisoned is out
    faults.maybe_raise_transient("s")
    assert faults.squeeze_budget(1000, "s") == (1000, False)
    assert faults.maybe_corrupt_lookup(None, "s") is None
    assert faults.outlier_scale("s") is None
    assert health.snapshot() == {}


def test_transient_capped_per_site():
    with faults.fault_scope(kinds=("transient_raise",), max_transient=2):
        for _ in range(2):
            with pytest.raises(fallback.TransientFault):
                faults.maybe_raise_transient("s")
        faults.maybe_raise_transient("s")
        with pytest.raises(fallback.TransientFault):
            faults.maybe_raise_transient("other_site")


# ===================================================================
# validation
# ===================================================================
def test_validate_dense_rejects_oversized_plan():
    plan = BlockPlan(4096, 4096, 4096, schedule="k_inner")
    with pytest.raises(fallback.PlanValidationError, match="exceeds AMP"):
        validate.validate_dense(plan, 4096, 4096, 4096, dtype_bytes=4,
                                amp=0.45, chip=hw.TPU_V5E)
    assert health.get("plans_rejected") == 1
    assert health.get("faults_injected") == 0


def test_validate_admits_min_granule_floor_under_any_budget():
    for name in CHIPS:
        chip = hw.get_chip(name)
        plan = BlockPlan(chip.mxu_sublanes, chip.mxu_lanes, chip.mxu_lanes,
                         schedule="k_inner")
        with faults.fault_scope(kinds=("amp_overflow",), amp_squeeze=1e9):
            validate.validate_dense(plan, 8192, 8192, 8192, dtype_bytes=4,
                                    amp=0.01, chip=chip)
    assert health.get("plans_rejected") == 0


def test_validate_flags_injected_amp_overflow():
    plan = BlockPlan(256, 512, 512, schedule="k_inner")
    with faults.fault_scope(kinds=("amp_overflow",), amp_squeeze=1e6):
        with pytest.raises(fallback.PlanValidationError) as ei:
            validate.validate_dense(plan, 1024, 1024, 1024, dtype_bytes=4,
                                    amp=0.45, chip=hw.TPU_V5E)
    assert ei.value.injected
    assert health.get("faults_injected") == 1
    assert health.get("injected_amp_overflow") == 1


def test_validate_rejects_corrupt_plan():
    with pytest.raises(fallback.CacheFault, match="corrupt"):
        validate.validate_dense(faults.corrupt_plan(), 64, 64, 64,
                                dtype_bytes=4, amp=0.45, chip=hw.TPU_V5E)
    assert faults.is_corrupt_plan(faults.corrupt_plan())
    assert not faults.is_corrupt_plan(None)
    assert not faults.is_corrupt_plan(BlockPlan(8, 128, 128))


def test_validate_dense_prices_splitk_with_the_chip():
    """gpu_h100's split-K plans count the strip K4 stages, not the whole
    partial slab: the validator takes the chip, as the planner does, so
    the planner's split-K plan at phi4's decode down projection passes."""
    chip = hw.get_chip("gpu_h100")
    from repro_torch.core import planner
    from repro_torch.core.costmodel import MatmulDims
    d = MatmulDims(m=4, k=8192, n=3072, dtype_bytes=2)
    plan = planner._search_gemv(d, chip, int(0.45 * chip.vmem_bytes)).plan
    assert plan.schedule == "splitk"
    assert plan.vmem_bytes(d) > int(0.45 * chip.vmem_bytes)
    validate.validate_dense(plan, 4, 8192, 3072, dtype_bytes=2, amp=0.45,
                            chip=chip)
    assert health.snapshot() == {}


def test_scrub_concrete_raises_and_ledgers_once():
    bad = torch.tensor([[1.0, float("nan")]])
    with faults.fault_scope():
        with pytest.raises(fallback.NumericFault) as ei:
            validate.scrub(bad, "s", injected=1)
    assert ei.value.injected
    assert health.get("faults_caught") == 1
    fallback.count_caught(ei.value)
    assert health.get("faults_caught") == 1


def test_scrub_passthrough_when_disengaged():
    bad = torch.tensor([float("inf")])
    assert validate.scrub(bad, "s") is bad


def test_scrub_capture_branch_substitutes_oracle(monkeypatch):
    """The capture branch's logic with the capture flag forced (the card
    test below captures for real): with a scope armed it records a
    `torch.where` onto the oracle and reads nothing on the host; with
    none it returns the output untouched."""
    a, b = _mats(16, 16, 16)
    want = ref.matmul_epilogue_ref(a, b)
    poisoned = torch.matmul(a, b)
    poisoned[0, 0] = float("nan")
    monkeypatch.setattr(validate, "capturing", lambda: True)
    with faults.fault_scope():
        got = validate.scrub(poisoned, "s", injected=1,
                             ref_fn=lambda: ref.matmul_epilogue_ref(a, b))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    assert health.get("scrub_substituted") == 1
    assert validate.scrub(poisoned, "s", injected=1,
                          ref_fn=lambda: want) is poisoned


# ===================================================================
# retry / backoff
# ===================================================================
def test_retry_call_recovers_and_counts():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise fallback.TransientFault("blip", injected=True)
        return "ok"

    assert fallback.retry_call(flaky, max_retries=3,
                               sleep=lambda s: None) == "ok"
    assert len(calls) == 3
    assert health.get("retries") == 2
    assert health.get("faults_caught") == 2


def test_retry_call_exhaustion_reraises():
    def always():
        raise fallback.TransientFault("down")

    with pytest.raises(fallback.TransientFault):
        fallback.retry_call(always, max_retries=2, sleep=lambda s: None)
    assert health.get("retries") == 2


def test_retry_call_does_not_catch_other_errors():
    def boom():
        raise ValueError("real bug")

    with pytest.raises(ValueError):
        fallback.retry_call(boom, sleep=lambda s: None)
    assert health.get("retries") == 0


def test_backoff_deterministic_jitter_within_bounds():
    bo = fallback.Backoff(base_s=0.01, factor=2.0, max_s=0.05,
                          jitter_frac=0.5, seed=4)
    delays = [bo.delay(i) for i in range(6)]
    assert delays == [bo.delay(i) for i in range(6)]
    for i, d in enumerate(delays):
        raw = min(0.01 * 2.0 ** i, 0.05)
        assert raw * 0.5 <= d <= raw * 1.5
    assert fallback.Backoff(jitter_frac=0.0, base_s=0.01).delay(0) == 0.01


def test_backoff_delay_equals_the_reference():
    rng = np.random.default_rng(7)
    for _ in range(200):
        kw = dict(base_s=float(rng.uniform(0, 0.1)),
                  factor=float(rng.uniform(1, 4)),
                  max_s=float(rng.uniform(0, 1)),
                  jitter_frac=float(rng.uniform(0, 1)),
                  seed=int(rng.integers(0, 2**31)))
        bo, jbo = fallback.Backoff(**kw), jfallback.Backoff(**kw)
        for attempt in range(8):
            assert bo.delay(attempt) == jbo.delay(attempt)


# ===================================================================
# ladder
# ===================================================================
def test_ladder_one_way_latch():
    lad = fallback.ladder("t_site")
    assert lad.floor == 0 and lad.level == "tuned"
    assert lad.start("modeled") == 1
    lad.trip("modeled", "poisoned")
    assert lad.floor == 2 and lad.level == "conservative"
    assert lad.start("tuned") == 2
    lad.trip("tuned", "stale")
    assert lad.floor == 2
    assert fallback.ladder("t_site") is lad
    assert fallback.max_floor() == 2
    assert health.get("fallbacks") == 1
    assert health.get("fallback_level") == 2


def test_ladder_reference_is_terminal():
    lad = fallback.ladder("t_site2")
    lad.trip("reference", "cannot go lower")
    assert lad.level == "reference"
    assert lad.floor == len(fallback.LEVELS) - 1


def test_non_guard_errors_propagate_and_move_no_rung():
    """A kernel's build, load or launch error is not a GuardError: it
    propagates out of the ladder and out of the explicit envelope, and no
    rung moves (the oracle never hides a broken kernel)."""
    def broken(plan, level):
        raise OSError("cannot load the kernel library")

    with faults.fault_scope(kinds=("nan_output",)):
        with pytest.raises(OSError):
            fallback.run_laddered(
                "t_site3", "modeled", lambda level: BlockPlan(8, 128, 128),
                lambda p, level: None, broken, lambda: "oracle")
        with pytest.raises(RuntimeError, match="launch failed"):
            ops._run_guarded_explicit(
                "t_site4", lambda: (_ for _ in ()).throw(
                    RuntimeError("launch failed")), lambda: "oracle")
    assert fallback.max_floor() == 0
    assert "fallbacks" not in health.snapshot()


def _real_fault(kind):
    """A fault no scope injected (a kernel's own NaN, a validator's own
    rejection), or its injected twin."""
    if kind == "numeric":
        return fallback.NumericFault("nan", injected=False)
    if kind == "validation":
        return fallback.PlanValidationError("over", injected=False)
    return fallback.NumericFault("nan", injected=True)


@pytest.mark.parametrize("kind", ["numeric", "validation", "injected"])
def test_strict_ladder_moves_only_on_an_injected_fault(kind):
    """Under `strict` (the operands on the card) a GuardError no scope
    injected raises out of the ladder before it trips anything, and the
    oracle is not run; an injected one still moves the rung."""
    oracle = []

    def validate_plan(p, level):
        if kind == "validation":
            raise _real_fault(kind)

    def run_kernel(p, level):
        if level == "modeled":
            raise _real_fault(kind)
        return torch.full((1,), float(fallback.LEVELS.index(level)))

    args = ("t_strict", "modeled", lambda level: BlockPlan(8, 128, 128),
            validate_plan, run_kernel,
            lambda: oracle.append(1) or torch.full((1,), 3.0))
    if kind == "injected":
        assert fallback.run_laddered(*args, strict=True).item() == 2.0
        assert fallback.max_floor() == 2
        return
    with pytest.raises(fallback.GuardError) as ei:
        fallback.run_laddered(*args, strict=True)
    assert not ei.value.injected
    assert oracle == [] and fallback.max_floor() == 0
    assert "fallbacks" not in health.snapshot()
    # the CPU (not strict) degrades as the JAX package does
    assert fallback.run_laddered(*args).item() >= 2.0
    assert fallback.max_floor() >= 2


@pytest.mark.parametrize("strict", [True, False])
def test_explicit_envelope_real_nan(strict):
    """A non-finite output no scope injected, under an armed scope (so
    the scrub is engaged): strict raises `NumericFault` without running
    the oracle; not strict falls back to it as the JAX package does."""
    oracle = []
    nan = torch.full((4, 4), float("nan"))
    with faults.fault_scope(kinds=("tuner_outlier",)):
        call = (lambda: ops._run_guarded_explicit(
            "t_env", lambda: nan, lambda: oracle.append(1) or "oracle",
            strict))
        if strict:
            with pytest.raises(fallback.NumericFault):
                call()
            assert oracle == []
        else:
            assert call() == "oracle"
    assert fallback.max_floor() == 0
    assert "faults_caught" not in health.snapshot()


# ===================================================================
# guarded dispatch end to end
# ===================================================================
def test_skew_matmul_full_chaos_matches_oracle():
    a, b = _mats()
    want = ref.matmul_epilogue_ref(a, b)
    with tune_runtime.use_cache(TuneCache()), mm_config(plan_mode="tuned"), \
            faults.fault_scope(seed=7):
        got = ops.skew_matmul(a, b)
    _close(got, want)
    snap = health.snapshot()
    assert snap["faults_injected"] > 0
    assert snap["faults_caught"] == snap["faults_injected"]
    assert fallback.ladder("dense").level == "reference"


def test_latch_holds_without_rearming():
    a, b = _mats()
    want = ref.matmul_epilogue_ref(a, b)
    with faults.fault_scope(seed=7, kinds=("nan_output", "inf_output")):
        ops.skew_matmul(a, b)
    assert fallback.ladder("dense").level == "reference"
    before = health.snapshot()
    got = ops.skew_matmul(a, b)
    _close(got, want)
    assert health.snapshot() == before


def test_skew_matmul_transient_recovers_without_degrading():
    a, b = _mats()
    want = ref.matmul_epilogue_ref(a, b)
    with faults.fault_scope(seed=11, kinds=("transient_raise",)):
        got = ops.skew_matmul(a, b)
    _close(got, want)
    assert health.get("retries") == 1
    assert fallback.max_floor() == 0


def test_sparse_and_grouped_chaos_match_oracle():
    rng = np.random.default_rng(1)
    m = k = 128
    n = 96
    layout = BlockSparseLayout.dense(m, k, (32, 64))
    a = torch.tensor(rng.normal(size=(m, k)) * 0.4, dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(k, n)) * 0.4, dtype=torch.float32)
    with faults.fault_scope(seed=13):
        got = ops.sparse_matmul(a, b, layout)
    _close(got, ref.matmul_epilogue_ref(a, b))
    ga = torch.tensor(rng.normal(size=(4, 32, 48)) * 0.4, dtype=torch.float32)
    gb = torch.tensor(rng.normal(size=(4, 48, 64)) * 0.4, dtype=torch.float32)
    with mm_config(backend="cuda"), faults.fault_scope(seed=17):
        gout = ops.grouped_matmul(ga, gb)
    _close(gout, ref.grouped_matmul_ref(ga, gb))
    snap = health.snapshot()
    assert snap["faults_caught"] == snap["faults_injected"] > 0


def test_explicit_plan_poison_falls_back_to_oracle():
    a, b = _mats(64, 64, 64)
    want = ref.matmul_epilogue_ref(a, b)
    plan = BlockPlan(32, 64, 64, schedule="k_inner")
    with faults.fault_scope(seed=5, kinds=("nan_output",)):
        got = ops.skew_matmul(a, b, plan=plan)
    _close(got, want)
    snap = health.snapshot()
    assert snap["faults_caught"] == snap["faults_injected"] == 1


def test_corrupt_cache_entry_is_caught_at_plan_time():
    a, b = _mats()
    want = ref.matmul_epilogue_ref(a, b)
    with tune_runtime.use_cache(TuneCache()), mm_config(plan_mode="tuned"), \
            faults.fault_scope(seed=3, kinds=("cache_corrupt",)):
        got = ops.skew_matmul(a, b)
    _close(got, want)
    snap = health.snapshot()
    assert snap["injected_cache_corrupt"] >= 1
    assert snap["faults_caught"] == snap["faults_injected"]
    assert fallback.max_floor() == 0


@pytest.mark.parametrize("kind", ["sparse", "grouped"])
def test_corrupt_sparse_and_grouped_lookups_are_caught(kind):
    with tune_runtime.use_cache(TuneCache()), mm_config(plan_mode="tuned"), \
            faults.fault_scope(seed=3, kinds=("cache_corrupt",)):
        if kind == "sparse":
            layout = BlockSparseLayout.dense(128, 128, (32, 64))
            from repro_torch.sparse.planner import plan_sparse_matmul
            cost = plan_sparse_matmul(layout, 96)
        else:
            cost = plan_grouped_matmul(4, 32, 48, 64)
    assert not faults.is_corrupt_plan(cost.plan)
    snap = health.snapshot()
    assert snap["injected_cache_corrupt"] == snap["faults_caught"] == 1


def test_disarmed_dispatch_is_the_unguarded_kernel_call():
    """No scope and no trip: the explicit envelope returns the kernel
    wrapper's own result, and nothing is counted."""
    from repro_torch.kernels import skew_matmul as mm

    a, b = _mats(8, 256, 512)
    got = ops.skew_matmul(a, b, plan=BlockPlan(64, 64, 128))
    assert torch.equal(got, mm.skew_matmul(a, b, bm=64, bk=64, bn=128))
    assert health.snapshot() == {}


# ===================================================================
# timing: MAD outlier rejection
# ===================================================================
def test_reject_outliers_one_sided():
    base = [100.0, 101.0, 99.0, 100.5, 100.2, 98.9, 100.1]
    assert timing.reject_outliers(base + [5000.0]) == list(range(7))
    assert len(timing.reject_outliers(base + [1.0])) == 8
    assert timing.reject_outliers([1.0, 500.0, 2.0]) == [0, 1, 2]


def test_measure_rejects_injected_outliers():
    x = torch.ones(64)
    # seed 0 / rate 0.25: fires on repeats 1 and 5 of 8, as in the JAX test
    with faults.fault_scope(seed=0, kinds=("tuner_outlier",), rate=0.25,
                            outlier_x=1000.0):
        t = timing.measure(lambda v: v * 2.0, x, iters=2, repeats=8)
    assert t.outliers >= 2
    assert health.get("injected_tuner_outlier") == 2
    assert health.get("faults_caught") == health.get("faults_injected") == 2
    assert t.median_us < 1e5


def test_measure_reports_zero_outliers_when_clean():
    t = timing.measure(lambda v: v + 1.0, torch.ones(8), iters=1, repeats=2)
    assert t.outliers == 0 and t.repeats == 2
    assert health.snapshot() == {}


# ===================================================================
# tune-cache quarantine
# ===================================================================
def test_load_or_quarantine_truncated_file(tmp_path):
    path = str(tmp_path / "tune_cache.json")
    with open(path, "w") as fh:
        fh.write('{"schema_version": 1, "entr')
    cache, problem = load_or_quarantine(path)
    assert cache.entries == {}
    assert problem is not None and "quarantined" in problem
    assert not os.path.exists(path)
    assert os.path.exists(path + ".corrupt")


def test_load_or_quarantine_stale_schema(tmp_path):
    path = str(tmp_path / "tune_cache.json")
    with open(path, "w") as fh:
        json.dump({"schema_version": 999, "entries": {}}, fh)
    cache, problem = load_or_quarantine(path)
    assert cache.entries == {} and "schema_version" in problem
    assert os.path.exists(path + ".corrupt")


def test_load_or_quarantine_clean_file(tmp_path):
    path = str(tmp_path / "tune_cache.json")
    TuneCache().save(path)
    cache, problem = load_or_quarantine(path)
    assert problem is None
    assert os.path.exists(path) and not os.path.exists(path + ".corrupt")


def test_ambient_default_cache_quarantines_and_degrades(tmp_path,
                                                       monkeypatch):
    path = str(tmp_path / "tune_cache.json")
    with open(path, "w") as fh:
        fh.write("not json at all")
    monkeypatch.setenv(tune_runtime.ENV_CACHE, path)
    tune_runtime.reset_default_cache()
    try:
        with pytest.warns(UserWarning, match="unusable tune cache"):
            cache = tune_runtime.get_active_cache()
        assert cache.entries == {}
        assert os.path.exists(path + ".corrupt")
        assert health.get("cache_quarantined") == 1
        assert tune_runtime.get_active_cache() is cache
    finally:
        tune_runtime.reset_default_cache()


def test_explicit_cache_load_stays_loud(tmp_path):
    from repro_torch.bench.record import SchemaError

    path = str(tmp_path / "tune_cache.json")
    with open(path, "w") as fh:
        fh.write("{")
    with pytest.raises(SchemaError):
        tune_runtime.set_active_cache(path)


# ===================================================================
# serving-boundary decode scrub
# ===================================================================
def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _mamba(device="cpu"):
    cfg = get_config("mamba2-2.7b").reduced()
    return cfg, build_model(cfg, device).init(0)


def test_guarded_decode_step_scrubs_poisoned_logits():
    cfg, params = _mamba()
    cache, _ = engine.prefill(params, cfg, torch.zeros((2, 8),
                                                       dtype=torch.long),
                              max_len=16)
    tok = torch.zeros((2,), dtype=torch.long)
    want, want_cache = engine.decode_step(params, cfg,
                                          graphs.clone_cache(cache), tok, 8)
    armed = graphs.clone_cache(cache)
    with faults.fault_scope(seed=5, kinds=("nan_output", "inf_output")):
        got, got_cache = engine.guarded_decode_step(params, cfg, armed, tok, 8)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    # the re-run started from the cache as it was before the step
    for x, y in zip(_leaves(got_cache), _leaves(want_cache)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4,
                                   atol=1e-5)
    assert health.get("scrubbed_batches") == 1
    snap = health.snapshot()
    assert snap["faults_caught"] == snap["faults_injected"]
    clean, _ = engine.guarded_decode_step(params, cfg,
                                          graphs.clone_cache(cache), tok, 8)
    assert health.get("scrubbed_batches") == 1
    np.testing.assert_allclose(clean.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_guarded_decode_step_raises_on_a_real_nan(monkeypatch):
    """Non-finite logits that no scope injected raise `NumericFault`: no
    re-run on the reference backend, nothing counted.  With no scope
    armed the cache is not copied."""
    cfg, params = _mamba()
    cache, _ = engine.prefill(params, cfg, torch.zeros((2, 8),
                                                       dtype=torch.long),
                              max_len=16)
    tok = torch.zeros((2,), dtype=torch.long)

    def no_copy(_):
        raise AssertionError("the cache was copied with nothing armed")

    monkeypatch.setattr(graphs, "clone_cache", no_copy)
    clean, _ = engine.guarded_decode_step(params, cfg, cache, tok, 8)
    assert bool(torch.isfinite(clean).all())
    params = dict(params, final_norm=torch.full_like(params["final_norm"],
                                                     float("nan")))
    with pytest.raises(fallback.NumericFault, match="no fault injected"):
        engine.guarded_decode_step(params, cfg, cache, tok, 9)
    assert health.snapshot() == {}


def test_track_capacity_slots_counts_static_slots():
    from repro_torch.models import moe

    cfg = get_config("dbrx-132b").reduced()
    params = build_model(cfg, "cpu").init(0)
    toks = torch.zeros((2, 8), dtype=torch.long)
    with moe.routing_capture() as log:
        engine.prefill(params, cfg, toks, max_len=16)
    assert health.snapshot() == {}
    with moe.track_capacity_slots():
        engine.prefill(params, cfg, toks, max_len=16)
    snap = health.snapshot()
    t, k = 16, cfg.n_experts_per_tok
    cap = moe._capacity(t, cfg)
    # every MoE layer routes, but the slot counts are recorded once per
    # stage site, as under the JAX engine's lax.scan (core.stage_trace)
    assert len(log) == cfg.n_layers
    layers = sum(kind.endswith("_moe") for unit, _ in cfg.stage_list()
                 for kind in unit)
    assert 0 < layers < len(log)
    assert snap["moe_slots_total"] == layers * cfg.n_experts * cap
    assert snap["moe_slots_filled"] == layers * min(t * k,
                                                    cfg.n_experts * cap)
    assert (snap["moe_slots_underfilled"]
            == snap["moe_slots_total"] - snap["moe_slots_filled"])


# ===================================================================
# bench provenance surfacing
# ===================================================================
def test_provenance_carries_guard_counters_only_when_dirty():
    from repro_torch.bench.record import BenchResult, Provenance

    clean = Provenance.capture()
    assert clean.guard is None
    assert "guard" not in clean.to_json()
    health.record("faults_injected", 2)
    dirty = Provenance.capture()
    assert dirty.guard == {"faults_injected": 2}
    r = BenchResult(suite="s", name="r", axes={}, metrics={}, info={},
                    provenance=dirty)
    back = BenchResult.from_json(json.loads(json.dumps(r.to_json())))
    assert back.provenance.guard == {"faults_injected": 2}


def test_bench_result_outliers_roundtrip_and_default():
    from repro_torch.bench.record import BenchResult, Provenance

    r = BenchResult(suite="s", name="r", axes={}, metrics={}, info={},
                    provenance=Provenance.capture(), outliers=3)
    d = r.to_json()
    assert d["outliers"] == 3
    assert BenchResult.from_json(d).outliers == 3
    del d["outliers"]
    assert BenchResult.from_json(d).outliers == 0


# ===================================================================
# the guard suite's five scenarios through both packages (tpu_v5e)
# ===================================================================
def _baseline_mats():
    a = np.linspace(-1.0, 1.0, 256 * 192, dtype=np.float32).reshape(256, 192)
    b = np.linspace(1.0, -1.0, 192 * 320, dtype=np.float32).reshape(192, 320)
    return a, b


def _jax_runs():
    """The JAX suite's scenario bodies (benchmarks/run.py tab_guard_chaos):
    (snapshot, floor, output) per scenario, and the decode weights."""
    an, bn = _baseline_mats()
    a, b = jnp.asarray(an), jnp.asarray(bn)
    jcfg = jget_config("mamba2-2.7b").reduced()
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))

    def all_faults():
        with jtune_runtime.use_cache(JTuneCache()), \
                jmm_config(plan_mode="tuned"), jfaults.fault_scope(seed=7):
            return jops.skew_matmul(a, b)

    def transient_recovers():
        with jfaults.fault_scope(seed=11, kinds=("transient_raise",),
                                 max_transient=2):
            return jops.skew_matmul(a, b)

    def amp_overflow():
        with jfaults.fault_scope(seed=23, kinds=("amp_overflow",),
                                 amp_squeeze=1e6):
            return jops.skew_matmul(a, b)

    def cache_quarantine():
        return None

    def decode_scrub():
        cache, _ = jengine.prefill(jparams, jcfg,
                                   jnp.zeros((2, 8), jnp.int32), max_len=16)
        with jfaults.fault_scope(seed=5, kinds=("nan_output", "inf_output")):
            logits, _ = jengine.guarded_decode_step(
                jparams, jcfg, cache, jnp.zeros((2,), jnp.int32),
                jnp.asarray(8, jnp.int32))
        return logits

    out = {}
    for name, body in (("all_faults", all_faults),
                       ("transient_recovers", transient_recovers),
                       ("amp_overflow", amp_overflow),
                       ("cache_quarantine", cache_quarantine),
                       ("decode_scrub", decode_scrub)):
        jguard.reset()
        with jmm_config(chip="tpu_v5e"):
            res = body()
        out[name] = (jhealth.snapshot(), jfallback.max_floor(),
                     None if res is None else np.asarray(res, np.float32))
        jguard.reset()
    return out, jparams


@pytest.fixture(scope="module")
def scenarios():
    """Both packages' runs of the five scenarios on tpu_v5e; the port's
    decode scrub on the JAX weights, under the "torch" backend (the JAX
    package's default "xla": no guarded kernel inside the step)."""
    jruns, jparams = _jax_runs()
    an, bn = _baseline_mats()
    cfg = get_config("mamba2-2.7b").reduced()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")

    def decode():
        cache, _ = engine.prefill(params, cfg,
                                  torch.zeros((2, 8), dtype=torch.long),
                                  max_len=16)
        return params, cfg, cache, torch.zeros((2,), dtype=torch.long), 8

    records: list = []
    with mm_config(chip="tpu_v5e", backend="torch"):
        runs = chaos.guard_runs(torch.tensor(an), torch.tensor(bn), decode,
                                rec=Recorder("guard", records))
    return jruns, runs, records


@pytest.mark.parametrize("name", chaos.SCENARIOS)
def test_chaos_scenario_equals_the_reference(scenarios, name):
    jruns, runs, _ = scenarios
    jsnap, jfloor, jout = jruns[name]
    r = runs[name]
    assert r.snapshot == jsnap
    assert r.floor == jfloor
    assert r.balanced
    if jout is None:
        assert r.out is None
    else:
        np.testing.assert_allclose(r.out.numpy(), jout, rtol=TOL, atol=TOL)


def test_chaos_rows_pass_compare_against_the_baseline(scenarios):
    _, _, records = scenarios
    _, base = bench_io.read_baselines(str(BASELINES))
    base = [r for r in base if r.suite == "guard"]
    assert sorted(r.name for r in base) == sorted(r.name for r in records)
    report = compare.compare(records, base)
    assert report.ok, report.summary(verbose=True)
    assert report.counts()["ok"] == sum(len(r.metrics) for r in base)
    for r in records:   # info is gated equal: no entry when it matches
        assert r.info == {x.name: x for x in base}[r.name].info
    for r in records:
        if r.metrics["faults_injected"]:
            assert r.provenance.guard is not None


# ===================================================================
# every plan the planner returns passes its own validator
# ===================================================================
def _random_entry(rng, chip, m, k, n, batch, dtype_bytes):
    """A tuned entry for (m, k, n)'s shape class holding a random plan
    (granule-aligned blocks, any schedule; it may not fit — the planner
    then falls back to the modeled plan)."""
    sub, lane = chip.mxu_sublanes, chip.mxu_lanes
    schedules = [s for s in ALL_SCHEDULES
                 if s != "splitk" or gemv_applicable(m, batch, chip)]
    schedule = schedules[int(rng.integers(len(schedules)))]
    blocks = (sub * int(rng.integers(1, 17)), lane * int(rng.integers(1, 17)),
              lane * int(rng.integers(1, 17)))
    key = dense_key(chip.name, dtype_bytes, 0.45,
                    ShapeClass.of(m, k, n, batch))
    return TuneEntry(
        key=key, kind="dense", chip=chip.name, dtype_bytes=dtype_bytes,
        amp=0.45, schedule=schedule, blocks=blocks, batch_grid=False,
        measured_us=1.0, modeled_us=1.0, modeled_best_schedule=schedule,
        modeled_best_blocks=blocks, modeled_best_measured_us=1.0,
        agreement=True, speedup=1.0,
        provenance={"git_sha": "x", "torch_version": "0", "iters": 1,
                    "repeats": 1, "created_utc": "t"})


@pytest.mark.parametrize("chip_name", CHIPS)
def test_every_planned_plan_passes_the_validator(chip_name):
    """4000 seeded draws (m, k, n log-uniform in 1..65536, bf16 / fp32,
    batch 1-8): even draws plan tuned over a cache holding a random entry
    for the draw's class, odd draws plan skew_aware; every plan is
    admitted by `validate_dense` on its chip (split-K on gpu_h100)."""
    chip = hw.get_chip(chip_name)
    rng = np.random.default_rng(CHIPS.index(chip_name))
    schedules = set()
    for i in range(4000):
        m, k, n = (int(v) for v in np.exp(rng.uniform(
            0, np.log(65536), 3)).round().clip(1, 65536))
        batch = int(rng.integers(1, 9))
        db = int(rng.choice([2, 4]))
        if i % 2 == 0:
            cache = TuneCache()
            cache.put(_random_entry(rng, chip, m, k, n, batch, db))
            with tune_runtime.use_cache(cache):
                plan = plan_matmul(m, k, n, dtype_bytes=db, amp=0.45,
                                   chip=chip, batch=batch, mode="tuned").plan
        else:
            plan = plan_matmul(m, k, n, dtype_bytes=db, amp=0.45, chip=chip,
                               batch=batch, mode="skew_aware").plan
        validate.validate_dense(plan, m, k, n, batch=batch, dtype_bytes=db,
                                amp=0.45, chip=chip)
        schedules.add(plan.schedule)
    snap = health.snapshot()
    assert "plans_rejected" not in snap
    assert snap.get("tuned_hits", 0) == 2000
    if chip_name == "gpu_h100":
        assert "splitk" in schedules


def _random_sparse_entry(rng, chip, key, kind, bm, bk):
    """A tuned sparse / grouped entry holding a random plan (it may not
    fit: the planner then falls back to the modeled plan)."""
    sched = ("k_inner" if kind == "grouped"
             else str(rng.choice(["k_inner", "a_resident", "b_resident"])))
    blocks = (bm, bk, chip.mxu_lanes * int(rng.integers(1, 33)))
    return TuneEntry(
        key=key, kind=kind, chip=chip.name, dtype_bytes=2, amp=0.45,
        schedule=sched, blocks=blocks, batch_grid=False, measured_us=1.0,
        modeled_us=1.0, modeled_best_schedule=sched,
        modeled_best_blocks=blocks, modeled_best_measured_us=1.0,
        agreement=True, speedup=1.0,
        provenance={"git_sha": "x", "torch_version": "0", "iters": 1,
                    "repeats": 1, "created_utc": "t"})


@pytest.mark.parametrize("kind", ["sparse", "grouped"])
@pytest.mark.parametrize("chip_name", CHIPS)
def test_every_planned_sparse_and_grouped_plan_passes_the_validator(
        chip_name, kind):
    """2000 seeded draws a chip (dims log-uniform in 1..16384, bf16 /
    fp32; sparse: granule-multiple blocks, density in (0, 1]; grouped:
    1-32 groups): even draws plan tuned over a cache holding a random
    entry for the draw's key, odd draws plan skew_aware; every plan is
    admitted by `validate_sparse` / `validate_grouped` on its chip."""
    chip = hw.get_chip(chip_name)
    sub, lane = chip.mxu_sublanes, chip.mxu_lanes
    rng = np.random.default_rng(100 + CHIPS.index(chip_name))
    for i in range(2000):
        m, k, n = (int(v) for v in np.exp(rng.uniform(
            0, np.log(16384), 3)).round().clip(1, 16384))
        db = int(rng.choice([2, 4]))
        cache = TuneCache()
        if kind == "sparse":
            bm, bk = sub * int(rng.integers(1, 5)), lane * int(
                rng.integers(1, 5))
            summary = LayoutSummary.balanced(m, k, (bm, bk),
                                             float(rng.uniform(0.01, 1.0)))
            key = sparse_key(chip.name, db, 0.45, summary, n)
            plan_fn = (lambda mode: plan_sparse_matmul(
                summary, n, dtype_bytes=db, amp=0.45, chip=chip, mode=mode))
        else:
            g = int(rng.integers(1, 33))
            bm, bk = sub * int(rng.integers(1, 9)), lane * int(
                rng.integers(1, 9))
            key = grouped_key(chip.name, db, 0.45, g, ShapeClass.of(m, k, n))
            plan_fn = (lambda mode: plan_grouped_matmul(
                g, m, k, n, dtype_bytes=db, amp=0.45, chip=chip, mode=mode))
        if i % 2 == 0:
            cache.put(_random_sparse_entry(rng, chip, key, kind, bm, bk))
            with tune_runtime.use_cache(cache):
                plan = plan_fn("tuned").plan
        else:
            plan = plan_fn("skew_aware").plan
        if kind == "sparse":
            validate.validate_sparse(plan, summary, n, dtype_bytes=db,
                                     amp=0.45, chip=chip)
        else:
            validate.validate_grouped(plan, g, m, k, dtype_bytes=db,
                                      amp=0.45, chip=chip)
    snap = health.snapshot()
    assert "plans_rejected" not in snap
    assert snap.get("tuned_hits", 0) == 1000


# ===================================================================
# the scenarios on gpu_h100 at phase 6g's shapes: the pinned ledgers
# ===================================================================
# health.snapshot() and the ladder floor of each scenario on gpu_h100 with
# the port's default "cuda" backend; `chip_smoke.py` holds the card's runs
# to these constants.  At 256 x 192 x 320 fp32 the modeled plan is the
# minimum-granule (64, 64, 64) itself, so the squeeze rejects nothing.
_ALL_FAULTS_H100 = {
    "fallback_level": 3, "fallbacks": 3, "faults_caught": 8,
    "faults_injected": 8, "injected_cache_corrupt": 1,
    "injected_inf_output": 3, "injected_nan_output": 3,
    "injected_transient_raise": 1, "retries": 1, "tuned_misses": 1}
# The modeled plan at 4 x 3072 x 16384 bf16 is (64, 64, 128): the squeeze
# rejects it at the tuned and modeled rungs, as on tpu_v5e at 256 x 192 x
# 320 (the JAX baseline's ledger).
_ALL_FAULTS_TRIPPED = {
    "fallback_level": 3, "fallbacks": 3, "faults_caught": 6,
    "faults_injected": 6, "injected_amp_overflow": 2,
    "injected_cache_corrupt": 1, "injected_inf_output": 1,
    "injected_nan_output": 1, "injected_transient_raise": 1,
    "plans_rejected": 2, "retries": 1, "tuned_misses": 1}
_TRANSIENT = {"faults_caught": 2, "faults_injected": 2,
              "injected_transient_raise": 2, "retries": 2}
_AMP_TRIPPED = {"fallback_level": 2, "fallbacks": 1, "faults_caught": 1,
                "faults_injected": 1, "injected_amp_overflow": 1,
                "plans_rejected": 1}
_DECODE_MAMBA = {"faults_caught": 28, "faults_injected": 28,
                 "injected_inf_output": 14, "injected_nan_output": 14,
                 "scrubbed_batches": 1}
GPU_H100_LEDGERS = {
    ("all_faults", "256x192x320"): (_ALL_FAULTS_H100, 3),
    ("transient_recovers", "256x192x320"): (_TRANSIENT, 0),
    ("amp_overflow", "256x192x320"): ({}, 0),
    ("cache_quarantine", ""): ({}, 0),
    ("decode_scrub", "mamba2-2.7b reduced"): (_DECODE_MAMBA, 0),
    ("all_faults", "4x3072x16384"): (_ALL_FAULTS_TRIPPED, 3),
    ("transient_recovers", "4x3072x16384"): (_TRANSIENT, 0),
    ("amp_overflow", "4x3072x16384"): (_AMP_TRIPPED, 2),
    ("amp_overflow", "sparse"): (_AMP_TRIPPED, 2),
    ("amp_overflow", "grouped"): (_AMP_TRIPPED, 2),
}


def _h100_dense(name, a, b):
    with mm_config(chip="gpu_h100"):
        return chaos.run(lambda: (getattr(chaos, name)(
            lambda: ops.skew_matmul(a, b)), {}))


@pytest.mark.parametrize("shape", ["256x192x320", "4x3072x16384"])
@pytest.mark.parametrize("name", ["all_faults", "transient_recovers",
                                  "amp_overflow"])
def test_gpu_h100_dense_ledgers(name, shape):
    m, k, n = (int(v) for v in shape.split("x"))
    if shape == "256x192x320":
        an, bn = _baseline_mats()
        a, b = torch.tensor(an), torch.tensor(bn)
    else:
        g = torch.Generator().manual_seed(0)
        a = torch.randn((m, k), generator=g).to(torch.bfloat16)
        b = torch.randn((k, n), generator=g).to(torch.bfloat16)
    r = _h100_dense(name, a, b)
    assert (r.snapshot, r.floor) == GPU_H100_LEDGERS[(name, shape)]
    want = ref.matmul_epilogue_ref(a, b)
    rel = (r.out.float() - want.float()).abs().max() / want.abs().max()
    assert rel <= (TOL if a.dtype == torch.float32 else 2.0 ** -7)


def test_gpu_h100_cache_quarantine_and_decode_ledgers():
    cfg, params = _mamba()

    def decode():
        cache, _ = engine.prefill(params, cfg,
                                  torch.zeros((2, 8), dtype=torch.long),
                                  max_len=16)
        return params, cfg, cache, torch.zeros((2,), dtype=torch.long), 8

    with mm_config(chip="gpu_h100"):
        rq = chaos.run(lambda: (None, chaos.cache_quarantine()))
        rd = chaos.run(lambda: (chaos.decode_scrub(*decode()), {}))
    assert (rq.snapshot, rq.floor) == GPU_H100_LEDGERS[("cache_quarantine",
                                                        "")]
    assert (rd.snapshot, rd.floor) == GPU_H100_LEDGERS[
        ("decode_scrub", "mamba2-2.7b reduced")]
    assert bool(torch.isfinite(rd.out).all())


def test_gpu_h100_sparse_amp_overflow_ledger():
    """The tuner's 4096^2 (32, 128) layouts, n 4096, at d 0.1: the modeled
    bn 128 plan is rejected, K9 runs the conservative (32, 128, 64).  (At
    d 0.25 / 0.5 the modeled plan is already bn 64, the floor the
    validator always admits.)"""
    layout = BlockSparseLayout.random(4096, 4096, (32, 128), 0.1, seed=0)
    g = torch.Generator().manual_seed(1)
    a = torch.randn((4096, 4096), generator=g).to(torch.bfloat16)
    b = torch.randn((4096, 4096), generator=g).to(torch.bfloat16)
    with mm_config(chip="gpu_h100"), skewmm.plan_capture() as log:
        r = chaos.run(lambda: (chaos.amp_overflow(
            lambda: ops.sparse_matmul(a, b, layout)), {}))
    assert (r.snapshot, r.floor) == GPU_H100_LEDGERS[("amp_overflow",
                                                      "sparse")]
    assert [c.plan.bn for c in log] == [128, 64]
    want = ref.block_sparse_matmul_ref(a, b, layout)
    rel = (r.out.float() - want.float()).abs().max() / want.abs().max()
    assert rel <= 2.0 ** -7


def test_gpu_h100_grouped_amp_overflow_ledger():
    """dbrx's decode expert GEMM (16 x 8 x 6144 x 10752) is planned
    (64, 64, 128) on gpu_h100, and the squeeze rejects it while the
    conservative (64, 64, 64) passes; the same ledger is run at a grouped
    shape of the same plan small enough for the CPU."""
    chip = hw.get_chip("gpu_h100")
    for g, m, k, n in ((16, 8, 6144, 10752), (16, 8, 512, 1024)):
        plan = plan_grouped_matmul(g, m, k, n, dtype_bytes=2,
                                   chip=chip).plan
        assert (plan.bm, plan.bk, plan.bn) == (64, 64, 128)
    with faults.fault_scope(seed=23, kinds=("amp_overflow",),
                            amp_squeeze=1e6):
        with pytest.raises(fallback.PlanValidationError) as ei:
            validate.validate_grouped(plan, 16, 8, 6144, dtype_bytes=2,
                                      amp=0.45, chip=chip)
        assert ei.value.injected
        validate.validate_grouped(ops._conservative_plan(chip), 16, 8, 6144,
                                  dtype_bytes=2, amp=0.45, chip=chip)
    guard.reset()
    gen = torch.Generator().manual_seed(2)
    a = torch.randn((16, 8, 512), generator=gen).to(torch.bfloat16)
    b = torch.randn((16, 512, 1024), generator=gen).to(torch.bfloat16)
    with mm_config(chip="gpu_h100"):
        r = chaos.run(lambda: (chaos.amp_overflow(
            lambda: ops.grouped_matmul(a, b)), {}))
    assert (r.snapshot, r.floor) == GPU_H100_LEDGERS[("amp_overflow",
                                                      "grouped")]
    want = ref.grouped_matmul_ref(a, b)
    rel = (r.out.float() - want.float()).abs().max() / want.abs().max()
    assert rel <= 2.0 ** -7
