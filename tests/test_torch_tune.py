"""The port's measured autotuner against the JAX package's, on the CPU.

* With the deterministic `modeled_measurer`, `tune_dense`, `tune_decode`,
  `tune_sparse` and `tune_grouped` give the JAX package's entries field
  for field (all but `provenance`), and recomputing the JAX `tuned` bench
  suite (a synthetic host: 1/4 bandwidth, 4x grid-step overhead + 0.2 us,
  squared gather fraction) reproduces every record of
  `benchmarks/baselines/tuned.json` exactly.
* A cache the port writes loads in the JAX package's `TuneCache.load`,
  and the reverse.
* `plan_mode="tuned"`: hits return the measured winner for the whole
  bucket, misses and no-longer-feasible entries fall back to the modeled
  plan, and swapping the active cache is never served a stale plan.
* `python -m repro_torch.launch.tune --device cpu` writes a schema-valid
  cache; the calibration fit, the timing helper and the shape-class
  partition behave as the JAX package's.
"""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import hw as jhw
from repro.sparse.layout import LayoutSummary as JSummary
from repro.tune import cache as jcache
from repro.tune import tuner as jtuner
from repro_torch.bench import timing
from repro_torch.bench.record import SchemaError
from repro_torch.core import hw
from repro_torch.core.config import mm_config, resolve
from repro_torch.core.planner import enumerate_plans, plan_matmul
from repro_torch.guard import health
from repro_torch.sparse.layout import BlockSparseLayout, LayoutSummary
from repro_torch.sparse.planner import (enumerate_grouped_plans,
                                        enumerate_sparse_plans,
                                        plan_grouped_matmul,
                                        plan_sparse_matmul)
from repro_torch.tune import calibrate, tuner
from repro_torch.tune.cache import (TuneCache, TuneEntry, dense_key,
                                    grouped_key, sparse_key)
from repro_torch.tune.runtime import use_cache
from repro_torch.tune.shapeclass import ShapeClass, bucket_dim

REF_CHIPS = ["tpu_v5e", "ipu_gc200", "gpu_a30", "gpu_rtx2080ti"]
BASELINE = Path(__file__).resolve().parents[1] / "benchmarks" / \
    "baselines" / "tuned.json"
CHIP = hw.get_chip("tpu_v5e")


def _synth(chip, dc_hw):
    """The JAX `tuned` suite's synthetic host for `chip`."""
    spec = dc_hw.get_chip(chip)
    return dataclasses.replace(
        spec, hbm_bw=spec.hbm_bw / 4,
        grid_step_overhead_s=4 * spec.grid_step_overhead_s + 2e-7,
        sparse_gather_frac=spec.sparse_gather_frac ** 2)


def _fields(entry):
    d = dict(entry.to_json())
    d.pop("provenance")
    return d


def _plan_id(plan):
    return (plan.schedule, plan.bm, plan.bk, plan.bn, plan.batch_grid)


def fake_measurer(times_by_plan, default=1e6):
    """Deterministic fake timer: microseconds per plan identity."""
    def measurer(candidate, make_bench, *, iters, repeats):
        us = times_by_plan.get(_plan_id(candidate.plan), default)
        return timing.Timing(median_us=us, iqr_us=0.0, repeats=repeats,
                             iters=iters)
    return measurer


def _entry(key="dense/tpu_v5e/dt2/amp0.45/m256k256n256b1", kind="dense",
           blocks=(256, 256, 256), schedule="k_inner", measured=10.0,
           modeled=12.0):
    return TuneEntry(
        key=key, kind=kind, chip="tpu_v5e", dtype_bytes=2, amp=0.45,
        schedule=schedule, blocks=blocks, batch_grid=False,
        measured_us=measured, modeled_us=modeled,
        modeled_best_schedule="k_inner", modeled_best_blocks=blocks,
        modeled_best_measured_us=measured, agreement=True, speedup=1.0,
        provenance={"git_sha": "abc", "torch_version": "0", "iters": 1,
                    "repeats": 1, "created_utc": "t"})


# ------------------------------------------------- entries equal the JAX's
@pytest.mark.parametrize("chip", REF_CHIPS)
def test_modeled_dense_and_decode_entries_equal_reference(chip):
    mine = tuner.modeled_measurer(_synth(chip, hw))
    theirs = jtuner.modeled_measurer(_synth(chip, jhw))
    for m, k, n, batch in [(256, 65536, 4096, 1), (4096, 4096, 4096, 1),
                           (300, 5000, 4096, 1), (64, 512, 256, 4)]:
        for dtype_bytes in (2, 4):
            kw = dict(batch=batch, dtype_bytes=dtype_bytes, chip=chip, top=6)
            got = tuner.tune_dense(m, k, n, measurer=mine, **kw)
            want = jtuner.tune_dense(m, k, n, measurer=theirs, **kw)
            assert _fields(got) == _fields(want)
    got = tuner.tune_decode(4096, 32768, chip=chip, measurer=mine)
    want = jtuner.tune_decode(4096, 32768, chip=chip, measurer=theirs)
    assert [_fields(e) for e in got] == [_fields(e) for e in want]


@pytest.mark.parametrize("chip", REF_CHIPS)
def test_modeled_sparse_and_grouped_entries_equal_reference(chip):
    mine = tuner.modeled_measurer(_synth(chip, hw))
    theirs = jtuner.modeled_measurer(_synth(chip, jhw))
    for m, k, block, d in [(4096, 4096, (128, 128), 0.1),
                           (4096, 4096, (32, 128), 0.25),
                           (1024, 1024, (128, 128), 0.3)]:
        got = tuner.tune_sparse(LayoutSummary.balanced(m, k, block, d), 4096,
                                chip=chip, measurer=mine)
        want = jtuner.tune_sparse(JSummary.balanced(m, k, block, d), 4096,
                                  chip=chip, measurer=theirs)
        assert _fields(got) == _fields(want)
    for g, m, k, n in [(4, 64, 512, 1024), (16, 8, 6144, 10752)]:
        got = tuner.tune_grouped(g, m, k, n, chip=chip, measurer=mine)
        want = jtuner.tune_grouped(g, m, k, n, chip=chip, measurer=theirs)
        assert _fields(got) == _fields(want)


def _tuned_suite_rows(chip_name):
    """The JAX `tuned` suite (benchmarks/run.py), recomputed with the
    port: five skews and two sparse densities per chip, then a summary."""
    chip = hw.get_chip(chip_name)
    measurer = tuner.modeled_measurer(_synth(chip_name, hw))
    total = 4096 * 4096
    rows, agrees, speedups = {}, [], []
    with mm_config(chip=chip):
        for r in (2.0 ** -8, 2.0 ** -4, 1.0, 2.0 ** 4, 2.0 ** 8):
            m = max(1, int(round((total * r) ** 0.5)))
            k = max(1, int(round((total / r) ** 0.5)))
            e = tuner.tune_dense(m, k, 4096, measurer=measurer)
            rows[f"tuned_{chip.name}_skew_{r:g}"] = e
            agrees.append(e.agreement)
            speedups.append(e.speedup)
        for d in (0.1, 0.4):
            summary = LayoutSummary.balanced(4096, 4096, (128, 128), d)
            e = tuner.tune_sparse(summary, 4096, measurer=measurer)
            rows[f"tuned_{chip.name}_sparse_d{d:g}"] = e
            agrees.append(e.agreement)
            speedups.append(e.speedup)
    summary = {"agreement_frac": sum(agrees) / len(agrees),
               "mean_speedup": sum(speedups) / len(speedups)}
    return rows, summary


def _blocks(schedule, blocks):
    return f"{schedule}:{'x'.join(str(b) for b in blocks)}"


def test_tuned_suite_reproduces_baseline():
    records = json.loads(BASELINE.read_text())["records"]
    assert len(records) == 24
    chips = sorted({r["axes"]["chip"] for r in records})
    seen = 0
    for chip in chips:
        rows, summary = _tuned_suite_rows(chip)
        for rec in records:
            if rec["axes"]["chip"] != chip:
                continue
            seen += 1
            if rec["name"].endswith("_summary"):
                assert rec["metrics"] == summary
                continue
            e = rows[rec["name"]]
            assert rec["metrics"] == {"agreement_frac": float(e.agreement),
                                      "speedup": e.speedup}
            assert rec["info"] == {
                "tuned": _blocks(e.schedule, e.blocks),
                "modeled": _blocks(e.modeled_best_schedule,
                                   e.modeled_best_blocks)}
    assert seen == 24
    tpu = next(r for r in records if r["name"] == "tuned_tpu_v5e_summary")
    assert tpu["metrics"]["agreement_frac"] == pytest.approx(0.5714285714)
    assert tpu["metrics"]["mean_speedup"] == pytest.approx(1.33314818)


# ------------------------------------------------------- cache interchange
def test_port_cache_loads_in_reference_and_back(tmp_path):
    measurer = tuner.modeled_measurer()
    cache = TuneCache()
    cache.put(tuner.tune_dense(256, 4096, 4096, chip="tpu_v5e",
                               measurer=measurer))
    cache.put(tuner.tune_sparse(LayoutSummary.balanced(1024, 1024,
                                                       (128, 128), 0.3),
                                1024, chip="tpu_v5e", measurer=measurer))
    cache.put(tuner.tune_grouped(4, 64, 512, 1024, chip="tpu_v5e",
                                 measurer=measurer))
    cache.corrections["tpu_v5e"] = calibrate.fit_corrections(
        cache.entries.values(), "tpu_v5e").to_json()
    path = str(tmp_path / "port.json")
    cache.save(path)
    theirs = jcache.TuneCache.load(path)
    assert set(theirs.entries) == set(cache.entries)
    for key, e in cache.entries.items():
        assert theirs.entries[key].to_json() == e.to_json()
        assert "torch_version" in e.provenance
    assert theirs.corrections == cache.corrections
    # and the reverse: a JAX-written cache loads in the port
    jpath = str(tmp_path / "jax.json")
    jc = jcache.TuneCache()
    jc.put(jtuner.tune_dense(256, 4096, 4096, chip="tpu_v5e",
                             measurer=jtuner.modeled_measurer()))
    jc.save(jpath)
    back = TuneCache.load(jpath)
    (key, want), = jc.entries.items()
    assert back.get(key).to_json() == want.to_json()
    assert _fields(back.get(key)) == _fields(cache.get(key))


def test_cache_rejects_wrong_schema_and_malformed_entries(tmp_path):
    path = str(tmp_path / "bad.json")
    with open(path, "w") as fh:
        json.dump({"schema_version": 99, "entries": {}}, fh)
    with pytest.raises(SchemaError, match="schema_version"):
        TuneCache.load(path)
    with open(path, "w") as fh:
        json.dump({"schema_version": 1,
                   "entries": {"some/key": {"kind": "dense"}}}, fh)
    with pytest.raises(SchemaError, match="missing fields"):
        TuneCache.load(path)
    with open(path, "w") as fh:
        json.dump({"schema_version": 1,
                   "entries": {"other/key": _entry().to_json()}}, fh)
    with pytest.raises(SchemaError, match="names itself"):
        TuneCache.load(path)


def test_keys_equal_reference():
    cls = ShapeClass.of(300, 5000, 4096)
    assert dense_key("tpu_v5e", 2, 0.45, cls) == \
        "dense/tpu_v5e/dt2/amp0.45/m256k4096n4096b1"
    summary = LayoutSummary.balanced(4096, 4096, (128, 128), 0.1)
    assert sparse_key("tpu_v5e", 2, 0.45, summary, 5000) == \
        "sparse/tpu_v5e/dt2/amp0.45/bsr32x32blk128x128nnz102s4/n4096"
    assert grouped_key("tpu_v5e", 2, 0.45, 8,
                       ShapeClass.of(32, 1024, 4096)) == \
        "grouped/tpu_v5e/dt2/amp0.45/g8/m32k1024n4096b1"
    jsum = JSummary.balanced(4096, 4096, (32, 128), 0.25)
    tsum = LayoutSummary.balanced(4096, 4096, (32, 128), 0.25)
    assert sparse_key("gpu_h100", 4, 0.3, tsum, 4096) == \
        jcache.sparse_key("gpu_h100", 4, 0.3, jsum, 4096)


# ---------------------------------------------------- tuned plan resolution
def test_measured_winner_and_ties():
    m, k, n = 256, 65536, 4096
    cands = enumerate_plans(m, k, n, chip="tpu_v5e")
    target = cands[-1]
    times = {_plan_id(c.plan): 100.0 for c in cands}
    times[_plan_id(target.plan)] = 1.0
    e = tuner.tune_dense(m, k, n, chip="tpu_v5e",
                         measurer=fake_measurer(times))
    assert e.blocks == (target.plan.bm, target.plan.bk, target.plan.bn)
    assert not e.agreement and e.speedup == pytest.approx(100.0)
    assert e.provenance["iters"] == 1 and e.provenance["repeats"] == 3
    tie = tuner.tune_dense(m, k, n, chip="tpu_v5e",
                           measurer=fake_measurer({}, default=7.0))
    assert tie.agreement and tie.speedup == 1.0


def test_tuned_hit_miss_and_infeasible_entries():
    m, k, n = 256, 65536, 4096
    cands = enumerate_plans(m, k, n, chip="tpu_v5e")
    target = cands[-1]
    times = {_plan_id(c.plan): 50.0 for c in cands}
    times[_plan_id(target.plan)] = 1.0
    cache = TuneCache()
    cache.put(tuner.tune_dense(m, k, n, chip="tpu_v5e",
                               measurer=fake_measurer(times)))
    health.reset()
    with use_cache(cache), mm_config(chip="tpu_v5e"):
        hit = plan_matmul(m, k, n, mode="tuned")
        assert hit.plan == target.plan
        neighbor = plan_matmul(m + 3, k + 100, n + 1, mode="tuned")
        assert neighbor.plan == target.plan and neighbor.dims.m == m + 3
        miss = plan_matmul(2 * m, k, n, mode="tuned")
        assert miss.plan == plan_matmul(2 * m, k, n, mode="skew_aware").plan
    assert health.get("tuned_hits") == 2 and health.get("tuned_misses") == 1
    # a cached winner that no longer fits the budget is not served
    big = TuneCache()
    big.put(_entry(key=dense_key("tpu_v5e", 2, 0.45,
                                 ShapeClass.of(4096, 4096, 4096)),
                   blocks=(4096, 4096, 4096)))
    with use_cache(big), mm_config(chip="tpu_v5e"):
        assert plan_matmul(4096, 4096, 4096, mode="tuned").plan == \
            plan_matmul(4096, 4096, 4096, mode="skew_aware").plan


def test_tuned_mode_resolves_through_config_and_cache_swaps():
    m, k, n = 256, 65536, 4096
    cands = enumerate_plans(m, k, n, chip="tpu_v5e")
    caches = []
    for idx in (-1, 1):
        t = {_plan_id(c.plan): 50.0 for c in cands}
        t[_plan_id(cands[idx].plan)] = 1.0
        c = TuneCache()
        c.put(tuner.tune_dense(m, k, n, chip="tpu_v5e",
                               measurer=fake_measurer(t)))
        caches.append(c)
    with mm_config(plan_mode="tuned", chip="tpu_v5e"):
        assert resolve().plan_mode == "tuned"
        with use_cache(caches[0]):
            assert plan_matmul(m, k, n).plan == cands[-1].plan
            with mm_config(plan_mode="skew_aware"):
                assert plan_matmul(m, k, n).plan == cands[0].plan
        with use_cache(caches[1]):
            assert plan_matmul(m, k, n).plan == cands[1].plan
        with use_cache(TuneCache()):
            assert plan_matmul(m, k, n).plan == cands[0].plan


def test_tuned_sparse_and_grouped_resolution():
    summary = LayoutSummary.balanced(1024, 1024, (128, 128), 0.3)
    cands = enumerate_sparse_plans(summary, 1024, chip="tpu_v5e")
    assert len(cands) > 1
    times = {_plan_id(c.plan): 50.0 for c in cands}
    times[_plan_id(cands[-1].plan)] = 1.0
    cache = TuneCache()
    cache.put(tuner.tune_sparse(summary, 1024, chip="tpu_v5e",
                                measurer=fake_measurer(times)))
    g_cands = enumerate_grouped_plans(4, 64, 512, 1024, chip="tpu_v5e")
    gtimes = {_plan_id(c.plan): 50.0 for c in g_cands}
    gtimes[_plan_id(g_cands[-1].plan)] = 1.0
    cache.put(tuner.tune_grouped(4, 64, 512, 1024, chip="tpu_v5e",
                                 measurer=fake_measurer(gtimes)))
    other = LayoutSummary.balanced(1024, 1024, (128, 128), 0.9)
    with use_cache(cache), mm_config(chip="tpu_v5e", plan_mode="tuned"):
        assert plan_sparse_matmul(summary, 1024).plan == cands[-1].plan
        assert plan_sparse_matmul(other, 1024).plan == plan_sparse_matmul(
            other, 1024, mode="skew_aware").plan
        assert plan_grouped_matmul(4, 64, 512, 1024).plan == \
            g_cands[-1].plan
    with use_cache(TuneCache()), mm_config(chip="tpu_v5e"):
        assert plan_sparse_matmul(summary, 1024, mode="tuned").plan == \
            cands[0].plan
        assert plan_grouped_matmul(4, 64, 512, 1024, mode="tuned").plan == \
            g_cands[0].plan


def test_tuned_ops_on_cpu_tensors_run_the_cached_winners():
    """ops.sparse_matmul / ops.skew_matmul under plan_mode="tuned" plan
    from the cache (two hits, no miss) and run the plain versions."""
    from repro_torch.core import skewmm
    from repro_torch.kernels import ops, ref
    lay = BlockSparseLayout.random(256, 512, (32, 128), 0.5)
    measurer = tuner.modeled_measurer()
    cache = TuneCache()
    cache.put(tuner.tune_sparse(lay, 128, dtype_bytes=4, top=2,
                                measurer=measurer))
    cache.put(tuner.tune_dense(64, 256, 128, dtype_bytes=4,
                               measurer=measurer))
    a = torch.ones((256, 512))
    b = torch.ones((512, 128))
    health.reset()
    with use_cache(cache), mm_config(plan_mode="tuned"), \
            skewmm.plan_capture() as log:
        y = ops.sparse_matmul(a, b, lay)
        z = ops.skew_matmul(a[:64, :256], b[:256])
    assert health.get("tuned_hits") == 2 and health.get("tuned_misses") == 0
    assert log[0].plan == cache.get(next(
        k for k in cache.entries if k.startswith("sparse"))).plan
    assert torch.equal(y, ref.block_sparse_matmul_ref(a, b, lay))
    assert torch.equal(z, a[:64, :256] @ b[:256])


# -------------------------------------------------------------- calibration
def test_calibration_fit_and_absorb():
    entries = [_entry(key=f"dense/tpu_v5e/dt2/amp0.45/m{s}k{s}n{s}b1",
                      measured=2.0 * s, modeled=float(s))
               for s in (64, 128, 256)] + [
        _entry(key=f"sparse/tpu_v5e/dt2/amp0.45/bsr{s}/n256", kind="sparse",
               blocks=(128, 128, 256), measured=4.0 * s, modeled=float(s))
        for s in (64, 128)]
    corr = calibrate.fit_corrections(entries, "tpu_v5e")
    assert corr.time_frac == pytest.approx(0.5)
    assert corr.sparse_gather_frac == pytest.approx(
        CHIP.sparse_gather_frac * 0.5)
    fixed = calibrate.apply_corrections(CHIP, corr)
    assert fixed.peak_bf16_flops == pytest.approx(CHIP.peak_bf16_flops / 2)
    health.reset()
    spread = [_entry(key=f"dense/tpu_v5e/dt2/amp0.45/m{s}k{s}n{s}b1",
                     measured=float(r), modeled=1.0)
              for s, r in ((64, 1), (128, 100))]
    with pytest.warns(UserWarning, match="rejected"):
        bad = calibrate.fit_corrections(spread, "tpu_v5e")
    assert not bad.accepted and health.get("calibration_rejected") == 1
    with pytest.raises(ValueError, match="rejected"):
        calibrate.apply_corrections(CHIP, bad)


@pytest.mark.parametrize("x", [float("nan"), float("inf"), float("-inf"),
                               -1.0, 0.0, 1e-300, 0.3, 1.0, 7.5, 1e300])
def test_unit_clamp_lands_in_unit_interval(x):
    y = calibrate.unit_clamp(x)
    assert 0.0 < y <= 1.0


def test_fitted_gather_fraction_lands_in_unit_interval():
    rng = np.random.default_rng(5)
    for _ in range(200):
        base = float(10.0 ** rng.uniform(-6, 0))
        ratios = list(10.0 ** rng.uniform(-9, 9, size=rng.integers(0, 7)))
        assert 0.0 < calibrate.fit_gather_frac(base, ratios) <= 1.0


def test_bucketing_is_a_partition():
    rng = np.random.default_rng(6)
    for d in list(range(1, 4097)) + [int(x) for x in
                                     rng.integers(1, 1 << 40, size=500)]:
        rep = bucket_dim(d)
        assert rep <= d < 2 * rep and bucket_dim(rep) == rep


# ------------------------------------------------------- timing and health
def test_measure_times_cpu_calls_with_the_host_clock():
    calls = []
    t = timing.measure(lambda x: calls.append(x.sum()), torch.ones(4),
                       iters=2, repeats=5)
    assert len(calls) == 1 + 2 * 5          # one warm-up call
    assert t.median_us > 0 and t.repeats == 5 and t.iters == 2
    with pytest.raises(ValueError):
        timing.measure(lambda: None, iters=0)


def test_reject_outliers_drops_slow_repeats_only():
    assert timing.reject_outliers([1.0, 1.0, 50.0]) == [0, 1, 2]
    assert timing.reject_outliers([1.0, 1.01, 0.99, 1.0, 9.0]) == [0, 1, 2, 3]
    assert timing.reject_outliers([1.0, 1.01, 0.2, 1.0]) == [0, 1, 2, 3]


def test_health_counters():
    health.reset()
    health.record("tuned_hits")
    health.record("tuned_hits", 2)
    health.set_gauge("level", 3)
    health.set_gauge("level", 1)
    assert health.get("tuned_hits") == 3 and health.get("level") == 3
    assert health.snapshot() == {"level": 3, "tuned_hits": 3}
    health.reset()
    assert health.snapshot() == {} and health.get("tuned_misses") == 0


# ---------------------------------------------------------------------- CLI
@pytest.mark.parametrize("suite", ["fig5", "sparse", "decode"])
def test_tune_cli_writes_a_valid_cache_on_the_cpu(tmp_path, capsys, suite):
    from repro_torch.launch import tune as tune_cli
    path = str(tmp_path / "cache.json")
    rc = tune_cli.main(["--suite", suite, "--device", "cpu", "--total", "64",
                        "--top", "2", "--iters", "1", "--repeats", "1",
                        "--update-cache", "--cache", path])
    assert rc == 0
    cache = TuneCache.load(path)
    kinds = {e.kind for e in cache.entries.values()}
    assert kinds == ({"sparse"} if suite == "sparse" else {"dense"})
    assert "gpu_h100" in cache.corrections
    corr = calibrate.Corrections.from_json(cache.corrections["gpu_h100"])
    assert 0.0 < corr.time_frac <= 1.0 and math.isfinite(corr.log_spread)
    assert jcache.TuneCache.load(path).entries.keys() == cache.entries.keys()
    assert "schema ok" in capsys.readouterr().out
