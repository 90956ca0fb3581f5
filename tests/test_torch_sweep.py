"""The paper's sweeps in the port against the JAX package's:
`sweep_aspect_ratios` (both families) and `paper_vertex_table` give equal
rows on the four reference chips, and the port's modeled fig5 and vertex
rows pass `compare` against the JAX package's committed baselines.  Also
the gpu_h100 side of the card phase that times them (chip_smoke.py phase
6f): every plan of the 21 fig5 shapes is one the CUDA kernels take."""

import dataclasses
import os

import pytest
import torch

from repro.core import planner as jplanner
from repro.core import vertexstats as jvertex
from repro.core.config import mm_config as jmm_config
from repro_torch.bench import compare, io as bench_io
from repro_torch.bench.suite import Recorder
from repro_torch.core import hw, planner, vertexstats
from repro_torch.core.config import mm_config
from repro_torch.kernels import ops
from repro_torch.kernels.skew_matmul import check_blocks

REF_CHIPS = ["tpu_v5e", "ipu_gc200", "gpu_a30", "gpu_rtx2080ti"]
RATIOS = [2.0 ** i for i in range(-8, 9, 2)]
TOTAL = 4096 * 4096
BASELINES = os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks",
                         "baselines")


def _row_fields(row):
    return {k: v for k, v in row.items() if k != "planned_cost"}


def _same_cost(got, want):
    p, q = got.plan, want.plan
    assert (p.bm, p.bk, p.bn, p.schedule, p.batch_grid) == (
        q.bm, q.bk, q.bn, q.schedule, q.batch_grid)
    assert got.total_s == want.total_s
    assert got.grid_steps == want.grid_steps
    assert got.plan_provenance() == {**want.plan_provenance(),
                                     "blocks": (p.bm, p.bk, p.bn)}


@pytest.mark.parametrize("vary", ["a_aspect", "output"])
@pytest.mark.parametrize("chip", REF_CHIPS)
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_sweep_rows_equal_reference(chip, vary, dtype_bytes):
    got = planner.sweep_aspect_ratios(TOTAL, RATIOS, chip=chip, vary=vary,
                                      dtype_bytes=dtype_bytes)
    want = jplanner.sweep_aspect_ratios(TOTAL, RATIOS, chip=chip, vary=vary,
                                        dtype_bytes=dtype_bytes)
    assert [_row_fields(r) for r in got] == [_row_fields(r) for r in want]
    for g, w in zip(got, want):
        _same_cost(g["planned_cost"], w["planned_cost"])


@pytest.mark.parametrize("chip", REF_CHIPS)
def test_sweep_resolves_chip_and_amp_from_the_context(chip):
    """amp / chip left as None resolve through mm_config, as in JAX, and
    off-grid ratios and sizes round the same way."""
    ratios = [0.3, 1.0, 3.7, 100.0]
    with mm_config(chip=chip, amp=0.3):
        got = planner.sweep_aspect_ratios(1000 * 777, ratios, n_out=1000)
    with jmm_config(chip=chip, amp=0.3):
        want = jplanner.sweep_aspect_ratios(1000 * 777, ratios, n_out=1000)
    assert [_row_fields(r) for r in got] == [_row_fields(r) for r in want]
    assert {r["chip"] for r in got} == {chip}


@pytest.mark.parametrize("mode", ["naive", "skew_aware", "k_inner", "dense"])
@pytest.mark.parametrize("chip", REF_CHIPS)
def test_vertex_table_equals_reference(chip, mode):
    with mm_config(chip=chip):
        got = vertexstats.paper_vertex_table(mode=mode)
    with jmm_config(chip=chip):
        want = jvertex.paper_vertex_table(mode=mode)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
        assert g.plan_provenance() == w.plan_provenance()
    one = vertexstats.stats_for(300, 70000, 129, chip=chip, mode=mode,
                                amp=0.2, dtype_bytes=4)
    ref = jvertex.stats_for(300, 70000, 129, chip=chip, mode=mode, amp=0.2,
                            dtype_bytes=4)
    assert dataclasses.asdict(one) == dataclasses.asdict(ref)


def _fig5_rows(rec, chips) -> None:
    """The JAX fig5 suite's modeled rows (benchmarks/run.py
    `fig5_skewed_mm`, no timing), built from the port."""
    for name in chips:
        chip = hw.get_chip(name)
        with mm_config(chip=chip):
            for vary, tag in (("a_aspect", "skew"), ("output", "oskew")):
                rows = planner.sweep_aspect_ratios(TOTAL, RATIOS, vary=vary)
                for r in rows:
                    rec(f"fig5_{name}_{tag}_{r['ratio']:g}",
                        axes={"chip": name, "vary": vary,
                              "ratio": r["ratio"], "m": r["m"],
                              "k": r["k"], "n": r["n"]},
                        metrics={"planned_frac": r["planned_fraction"],
                                 "single_frac": r["single_fraction"],
                                 "naive_frac": r["naive_fraction"]},
                        info={"schedule": r["schedule"],
                              "plan": "x".join(str(b) for b in r["plan"])},
                        plan=r["planned_cost"])
                if vary == "a_aspect":
                    planned = [r["planned_fraction"] for r in rows]
                    naive = [r["naive_fraction"] for r in rows]
                    rec(f"fig5_{name}_skew_spread", axes={"chip": name},
                        metrics={"planned_min": min(planned),
                                 "planned_spread": max(planned)
                                 - min(planned),
                                 "naive_min": min(naive),
                                 "naive_spread": max(naive) - min(naive)})
            for m in (1, 4, 8):
                planned_c = planner.plan_matmul(m, 4096, 32768)
                dense_c = planner.plan_matmul(m, 4096, 32768, mode="dense")
                p = planned_c.plan
                rec(f"fig5_{name}_decode_m{m}",
                    axes={"chip": name, "m": m, "k": 4096, "n": 32768},
                    metrics={"planned_frac": planned_c.roofline_fraction(chip),
                             "dense_frac": dense_c.roofline_fraction(chip),
                             "gemv_gain": dense_c.total_s / planned_c.total_s,
                             "family_switch": int(p.schedule == "splitk")},
                    info={"schedule": p.schedule,
                          "plan": f"{p.bm}x{p.bk}x{p.bn}",
                          "bound": planned_c.bound},
                    plan=planned_c)


def _vertex_rows(rec) -> None:
    """The JAX vertex suite's rows, under its default chip (tpu_v5e)."""
    with mm_config(chip="tpu_v5e"):
        for mode in ("naive", "skew_aware"):
            rows = vertexstats.paper_vertex_table(mode=mode)
            for label, r in zip(("left", "square", "right"), rows):
                rec(f"vertex_{mode}_{label}",
                    axes={"mode": mode, "skew": label},
                    metrics={"vertices": r.vertex_count,
                             "util": r.tile_utilization,
                             "frac": r.roofline_fraction},
                    plan=r.plan_provenance())


@pytest.mark.parametrize("suite", ["fig5", "vertex"])
def test_rows_pass_the_committed_baseline(suite):
    records = []
    rec = Recorder(suite, records)
    if suite == "fig5":
        _fig5_rows(rec, ("tpu_v5e", "ipu_gc200", "gpu_rtx2080ti"))
    else:
        _vertex_rows(rec)
    _, base = bench_io.read_baselines(BASELINES)
    base = [r for r in base if r.suite == suite]
    assert len(records) == len(base) == {"fig5": 66, "vertex": 6}[suite]
    report = compare.compare(records, base)
    assert report.ok, report.summary()
    assert report.counts() == {"ok": len(report.entries)}
    by_name = {r.name: r for r in base}
    for r in records:
        want = by_name[r.name].provenance
        for f in ("schedule", "blocks", "grid_steps"):
            assert getattr(r.provenance, f) == getattr(want, f), (r.name, f)


def fig5_shapes():
    """chip_smoke.py phase 6f's 21 shapes: (vary, ratio, m, k, n)."""
    out = []
    for vary in ("a_aspect", "output"):
        for r in planner.sweep_aspect_ratios(TOTAL, RATIOS, vary=vary,
                                             chip="gpu_h100"):
            out.append((vary, r["ratio"], r["m"], r["k"], r["n"]))
    out += [("decode", None, m, 4096, 32768) for m in (1, 4, 8)]
    return out


def test_h100_fig5_plans_are_launchable():
    """On gpu_h100 every naive, K-inner-only and skew-aware plan of the 21
    fig5 shapes fits the budget (naive after `_clip_plan`'s halving),
    passes the kernels' block check after `ops.clip_blocks`, and keeps
    every operand and output below 2**31 elements."""
    chip = hw.get_chip("gpu_h100")
    budget = int(0.45 * chip.vmem_bytes)
    shapes = fig5_shapes()
    assert len(shapes) == 21
    for _, _, m, k, n in shapes:
        assert max(m * k, k * n, m * n) < 2 ** 31
        for mode in ("naive", "k_inner", "skew_aware"):
            c = planner.plan_matmul(m, k, n, mode=mode, chip="gpu_h100")
            assert c.vmem_bytes <= budget, (m, k, n, mode)
            bm, bk, bn = ops.clip_blocks(c.plan, m, k, n, chip)
            if c.plan.schedule == "splitk":
                bm = -(-m // chip.mxu_sublanes) * chip.mxu_sublanes
            for dt in (torch.bfloat16, torch.float32):
                check_blocks(dt, bm, bk, bn)


def test_h100_sweep_runs_through_ops_on_the_cpu():
    """The card phase's call, at a small size on the CPU: each plan of a
    gpu_h100 sweep row through `ops.skew_matmul(plan=...)` (the plain
    versions here) matches an fp32 matmul."""
    gen = torch.Generator().manual_seed(0)
    rows = planner.sweep_aspect_ratios(256 * 256, [1 / 16, 1.0, 16.0],
                                       n_out=192, chip="gpu_h100")
    for r in rows:
        a = torch.randn(r["m"], r["k"], generator=gen).to(torch.bfloat16)
        b = torch.randn(r["k"], r["n"], generator=gen).to(torch.bfloat16)
        want = a.float() @ b.float()
        for mode in ("naive", "k_inner", "skew_aware"):
            plan = planner.plan_matmul(r["m"], r["k"], r["n"], mode=mode,
                                       chip="gpu_h100").plan
            got = ops.skew_matmul(a, b, plan=plan, chip="gpu_h100",
                                  out_dtype=torch.float32)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
