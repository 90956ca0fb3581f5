"""The port's bench library and einsum path against the JAX package's:
`skewmm.einsum_mm` and its `UnplannedContraction` marker, `BenchResult`
/ `Provenance` records, `validate_records`, the `bench.io` documents, the
`bench.compare` gate (the name-based tolerance policy rule for rule, and
equal verdicts on the same records) and the `bench.suite` registry.  The
JAX-written baselines under `benchmarks/baselines/` read as they are."""

import dataclasses
import json
import math
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench import compare as jcompare
from repro.bench import io as jio
from repro.bench import record as jrecord
from repro.bench import suite as jsuite
from repro.core import skewmm as jskewmm
from repro_torch import bench
from repro_torch.bench import compare, io as bench_io, record, suite
from repro_torch.core import config, planner, skewmm
from repro_torch.guard import health

BASELINES = os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks",
                         "baselines")

EINSUM_CASES = [
    ("ij,jk->ik", (5, 7), (7, 3)),
    ("bhqd,bhkd->bhqk", (2, 3, 5, 8), (2, 3, 6, 8)),
    ("bsd,hd->bsh", (2, 4, 16), (6, 16)),
    ("bth,th->bt", (3, 9, 4), (9, 4)),
]


@pytest.mark.parametrize("spec,a_shape,b_shape", EINSUM_CASES)
def test_einsum_mm_matches_jnp_einsum(spec, a_shape, b_shape):
    rng = np.random.default_rng(len(spec))
    a = rng.standard_normal(a_shape).astype(np.float32)
    b = rng.standard_normal(b_shape).astype(np.float32)
    with skewmm.plan_capture() as log:
        got = skewmm.einsum_mm(spec, torch.from_numpy(a), torch.from_numpy(b))
    with jskewmm.plan_capture() as jlog:
        want = jskewmm.einsum_mm(spec, jnp.asarray(a), jnp.asarray(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert len(log) == len(jlog) == 1
    assert isinstance(log[0], skewmm.UnplannedContraction)
    assert dataclasses.asdict(log[0]) == dataclasses.asdict(jlog[0])


def test_einsum_mm_keeps_the_input_dtype():
    """bf16 inputs: fp32 sums, one cast back to bf16 (the marker names
    2-byte operands, as the reference's does)."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    with skewmm.plan_capture() as log:
        got = skewmm.einsum_mm("ik,kn->in", a.bfloat16(), b.bfloat16())
    want = (a.bfloat16().float() @ b.bfloat16().float()).bfloat16()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert log[0].dtype_bytes == 2
    assert log[0] == skewmm.UnplannedContraction(
        spec="ik,kn->in", a_shape=(4, 64), b_shape=(64, 8), dtype_bytes=2)


def test_plan_log_shim_matches_reference():
    """enable_plan_log / plan_log: a process-global capture that sees
    planned matmuls and einsum markers, cleared on enable, nested with
    plan_capture, and deregistered by identity."""
    a = torch.ones(3, 128)
    b = torch.ones(128, 64)
    for pkg, mk in ((skewmm, torch.ones), (jskewmm, jnp.ones)):
        pkg.enable_plan_log()
        with pkg.plan_capture() as inner:
            pkg.einsum_mm("ij,jk->ik", mk((2, 3)), mk((3, 4)))
        pkg.enable_plan_log()        # clears
        pkg.einsum_mm("ij,jk->ik", mk((2, 3)), mk((3, 4)))
        first = pkg.plan_log()
        pkg.enable_plan_log(False)
        pkg.einsum_mm("ij,jk->ik", mk((2, 3)), mk((3, 4)))
        assert len(inner) == 1 and len(first) == 1
        assert pkg.plan_log() == first
    skewmm.enable_plan_log()
    skewmm.matmul(a, b, backend="torch")
    assert [type(c).__name__ for c in skewmm.plan_log()] == ["MatmulCost"]
    skewmm.enable_plan_log(False)


def _records(tag: str = "a", n: int = 3):
    out = []
    rec = suite.Recorder("fig5", out)
    with config.mm_config(chip="tpu_v5e"):
        rows = planner.sweep_aspect_ratios(4096 * 4096, [1 / 16, 1, 16])
    for r in rows[:n]:
        rec(f"row_{tag}_{r['ratio']:g}",
            axes={"ratio": r["ratio"], "m": r["m"]},
            metrics={"planned_frac": r["planned_fraction"], "grid_steps":
                     r["planned_grid"], "planned_us": 12.5},
            info={"schedule": r["schedule"]},
            timing=bench.Timing(median_us=3.25, iqr_us=0.5, repeats=5,
                                iters=3, outliers=1),
            plan=r["planned_cost"])
    return out


def test_bench_result_round_trips_through_io(tmp_path):
    records = _records() + [
        dataclasses.replace(r, suite="vertex", name=r.name + "_v")
        for r in _records("b", 2)]
    path = tmp_path / "runs" / "BENCH_test.json"
    written = bench_io.write_run(str(path), records, "full")
    assert written == [str(path), str(tmp_path / "runs/BENCH_test.fig5.json"),
                       str(tmp_path / "runs/BENCH_test.vertex.json")]
    meta, back = bench_io.read_run(written[0])
    assert back == records
    assert meta["fidelity"] == "full" and meta["schema_version"] == 1
    assert meta["git_sha"] == record.git_sha()
    _, fig5 = bench_io.read_run(written[1])
    assert [r.name for r in fig5] == [r.name for r in records[:3]]
    r0 = back[0]
    assert r0.us_per_call == 3.25 and r0.us_iqr == 0.5
    assert (r0.repeats, r0.outliers) == (5, 1)
    assert r0.provenance.torch_version == torch.__version__
    assert r0.provenance.jax_version is None
    assert r0.provenance.blocks == (512, 1024, 4096)
    bdir = tmp_path / "baselines"
    assert len(bench_io.write_baselines(str(bdir), records, "tiny")) == 2
    fid, base = bench_io.read_baselines(str(bdir))
    assert fid == "tiny" and sorted(r.name for r in base) == sorted(
        r.name for r in records)
    doc = json.loads(path.read_text())
    for r in doc["records"]:
        assert r["provenance"]["torch_version"] == torch.__version__
        assert "jax_version" not in r["provenance"]


def test_io_rejects_what_the_reference_rejects(tmp_path):
    records = _records()
    (tmp_path / "x").mkdir()
    bench_io.write_baselines(str(tmp_path / "x"), records, "full")
    bench_io.write_baselines(str(tmp_path / "x"), [
        dataclasses.replace(records[0], suite="other", name="o")], "tiny")
    with pytest.raises(record.SchemaError, match="fidelity"):
        bench_io.read_baselines(str(tmp_path / "x"))
    with pytest.raises(record.SchemaError, match="does not exist"):
        bench_io.read_baselines(str(tmp_path / "none"))
    with pytest.raises(ValueError, match="fidelity"):
        bench_io.write_run(str(tmp_path / "r.json"), records, "huge")
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(record.SchemaError, match="not valid JSON"):
        bench_io.read_run(str(bad))
    bad.write_text(json.dumps({"schema_version": 2, "fidelity": "full",
                               "records": []}))
    with pytest.raises(record.SchemaError, match="schema_version"):
        bench_io.read_run(str(bad))
    assert os.path.basename(bench_io.default_run_path("d")).startswith(
        "BENCH_")


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_validate_records_rejects_non_finite(bad):
    r = _records(n=1)[0]
    broken = dataclasses.replace(r, metrics={**r.metrics, "x_frac": bad})
    with pytest.raises(record.SchemaError, match="not finite"):
        record.validate_records([broken])
    with pytest.raises(record.SchemaError, match="not finite"):
        bench_io.write_run("/nonexistent/never_written.json", [broken],
                           "full")


def test_validate_records_rejects_duplicates():
    rs = _records(n=2)
    record.validate_records(rs)
    with pytest.raises(record.SchemaError, match="duplicate"):
        record.validate_records(rs + rs[:1])


def test_read_baselines_reads_the_jax_files():
    """Every JAX-written baseline reads in the port, record for record
    equal in JSON to the JAX package's own reading (jax_version kept)."""
    fid, got = bench_io.read_baselines(BASELINES)
    jfid, want = jio.read_baselines(BASELINES)
    assert fid == jfid == "tiny"
    assert len(got) == len(want) > 100
    for g, w in zip(got, want):
        assert g.to_json() == w.to_json()
        assert g.provenance.jax_version == w.provenance.jax_version
        assert g.provenance.torch_version is None
        assert g.csv_row() == w.csv_row()


def test_provenance_capture_and_schema():
    health.reset()
    with config.mm_config(chip="ipu_gc200", amp=0.3, mesh_shape=(4, 2)):
        cost = planner.plan_matmul(256, 65536, 4096)
        p = record.Provenance.capture(plan=cost)
    assert (p.chip, p.amp, p.backend, p.mesh) == ("ipu_gc200", 0.3, "cuda",
                                                  "4x2")
    assert p.sharding == cost.sharding.describe() and p.guard is None
    assert p.torch_version == torch.__version__ and p.jax_version is None
    assert p.trace_digest is None
    d = p.to_json()
    assert "jax_version" not in d and "guard" not in d
    assert record.Provenance.from_json(d) == p
    health.record("tuned_misses", 2)
    try:
        q = record.Provenance.capture(config=config.resolve(),
                                      plan={"schedule": "k_inner",
                                            "blocks": [64, 64, 128]})
    finally:
        health.reset()
    assert q.guard == {"tuned_misses": 2} and q.blocks == (64, 64, 128)
    assert q.mesh is None and "mesh" not in q.to_json()
    with pytest.raises(TypeError):
        record.Provenance.capture(plan=42)
    no_version = {k: v for k, v in d.items() if k != "torch_version"}
    with pytest.raises(record.SchemaError, match="torch_version"):
        record.Provenance.from_json(no_version)
    with pytest.raises(record.SchemaError, match="unknown"):
        record.Provenance.from_json({**d, "extra": 1})
    with pytest.raises(record.SchemaError, match="missing"):
        record.Provenance.from_json({"chip": "x", "torch_version": "t"})
    with pytest.raises(record.SchemaError, match="guard"):
        record.Provenance.from_json({**d, "guard": [1]})


def _all_metric_names():
    names = set()
    for fn in os.listdir(BASELINES):
        doc = json.load(open(os.path.join(BASELINES, fn)))
        for r in doc["records"]:
            names |= set(r["metrics"]) | set(r["info"])
    return sorted(names | {
        "us_per_call", "us_iqr", "hlo_flops", "collective_bytes",
        "useful_ratio", "x_frac", "tok_per_s", "model_tflops", "w_gflops",
        "mem_mib", "cache_kib", "arena_gib", "cache_bytes", "unknown",
        "speedup", "gemv_gain", "planned_us", "naive_share", "spread"})


def test_metric_tolerance_policy_is_the_reference_rule_for_rule():
    for name in _all_metric_names():
        assert dataclasses.asdict(compare.metric_tolerance(name)) == \
            dataclasses.asdict(jcompare.metric_tolerance(name)), name
    assert compare._EXACT_NAMES == jcompare._EXACT_NAMES
    assert compare._FRACTION_SUFFIXES == jcompare._FRACTION_SUFFIXES
    for tol in ("EXACT", "FRACTION", "SIZE", "MODELED_RATE",
                "INFORMATIONAL"):
        assert dataclasses.asdict(getattr(compare, tol)) == \
            dataclasses.asdict(getattr(jcompare, tol))


def _perturb(records, rng):
    """The same seeded edits on either package's records: metrics moved
    inside or outside their band, an info string changed, a metric and a
    record dropped, a new record and metric added."""
    out = []
    for r in records:
        roll = rng.random()
        if roll < 0.05:
            continue                                   # missing_record
        metrics = dict(r.metrics)
        info = dict(r.info)
        for k in sorted(metrics):
            step = rng.choice([0.0, 0.0, 1e-9, 1e-3, 0.1, 1.0])
            metrics[k] = metrics[k] + step
        if metrics and rng.random() < 0.1:
            metrics.pop(sorted(metrics)[0])            # missing_metric
        if rng.random() < 0.1:
            metrics["brand_new_frac"] = 0.5            # new_metric
        if info and rng.random() < 0.1:
            info[sorted(info)[0]] = "changed"          # info_changed
        us = None if rng.random() < 0.5 else rng.choice([1.0, 100.0])
        out.append(dataclasses.replace(r, metrics=metrics, info=info,
                                       us_per_call=us))
    out.append(dataclasses.replace(records[0], name="new_row"))
    return out


def test_compare_verdicts_equal_the_reference():
    """The port's gate and the JAX gate give the same entries, in order,
    and the same summary on the same seeded edits of every baseline."""
    _, base = bench_io.read_baselines(BASELINES)
    _, jbase = jio.read_baselines(BASELINES)
    for seed in range(3):
        cur = _perturb(base, random.Random(seed))
        jcur = _perturb(jbase, random.Random(seed))
        got = compare.compare(cur, base)
        want = jcompare.compare(jcur, jbase)
        assert [dataclasses.asdict(e) for e in got.entries] == [
            dataclasses.asdict(e) for e in want.entries]
        assert got.ok == want.ok is False
        assert got.counts() == want.counts()
        assert got.summary() == want.summary()
        assert got.summary(verbose=True) == want.summary(verbose=True)
    same = compare.compare(base, base)
    assert same.ok and same.counts() == jcompare.compare(jbase,
                                                         jbase).counts()


def test_suite_registry_matches_reference():
    lines, jlines = [], []
    for pkg, echo in ((suite, lines.append), (jsuite, jlines.append)):
        reg = pkg.BenchSuite()

        @reg.register("decode")
        def decode(rec, ctx):
            """Decode rows."""
            rec("d1", axes={"m": 1}, metrics={"x_frac": 0.25,
                                              "vertices": 3}, info={"s": "a"})

        @reg.register("decode_gemv")
        def gemv(rec, ctx):
            rec("g1", metrics={"gemv_gain": 1.5})

        with pytest.raises(ValueError, match="already registered"):
            reg.register("decode")(decode)
        assert reg.names() == ["decode", "decode_gemv"]
        assert [s.name for s in reg.select("decode")] == ["decode"]
        assert [s.name for s in reg.select("gemv")] == ["decode_gemv"]
        assert reg.select("decode")[0].doc == "Decode rows."
        recs = reg.run(echo=echo)
        assert pkg.suites_of(recs) == {"decode", "decode_gemv"}
    assert lines == jlines
    ctx = suite.RunContext()
    assert ctx.chips == ("gpu_h100",)
    for tiny in (False, True):
        a, b = suite.RunContext(tiny=tiny), jsuite.RunContext(tiny=tiny)
        assert (a.fidelity, a.iters, a.repeats) == (b.fidelity, b.iters,
                                                    b.repeats)


def test_csv_row_formats_as_the_reference():
    vals = [0, 7, 1.0, 0.5, 1234.5678, 1e-5, 3e7, float("nan"), True, -2.5,
            1e16]
    for v in vals:
        assert record._fmt(v) == jrecord._fmt(v), v
    r = _records(n=1)[0]
    assert r.csv_row().startswith(f"{r.name},3.2,planned_frac=")
    assert bench.__all__ and all(hasattr(bench, n) for n in bench.__all__)
    assert math.isnan(float(dataclasses.replace(r, us_per_call=None)
                            .csv_row().split(",")[1]))
