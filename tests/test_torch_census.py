"""The paper's census, fig4 and memory_amp tables from the port, through
the port's `bench.compare` against the JAX package's committed rows.

Census: every matmul a reduced-config forward plus logits issues, captured
by the port's `skewmm.plan_capture()` under `mm_config(chip="tpu_v5e")`
and classified by skew, with the planner's roofline fraction on tpu_v5e
(the JAX suite's `census` rows, computed as `benchmarks/run.py` does).  The
full-fidelity rows of gemma2-27b, deepseek-v3-671b and mamba2-2.7b are in
`BENCH_20260808_231500.census.json`; the tiny baseline
(`benchmarks/baselines/census.json`) holds mamba2-2.7b's.  fig4 (6 rows)
and memory_amp (5 rows) are pure cost-model arithmetic on tpu_v5e, held
against `benchmarks/baselines/`.  `compare`'s own tolerances apply: counts
exact, fractions within its absolute band; wall-clock times are not
recorded here (informational in the JAX rows).
"""

import os

import pytest
import torch

from repro_torch.bench import compare, io as bench_io
from repro_torch.bench.suite import Recorder
from repro_torch.configs.base import get_config
from repro_torch.core import hw, skewmm
from repro_torch.core.config import mm_config
from repro_torch.core.costmodel import MatmulCost
from repro_torch.core.planner import plan_matmul
from repro_torch.models.model import build_model
from repro_torch.sparse.costmodel import SparseMatmulCost

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
BASELINES = os.path.join(ROOT, "benchmarks", "baselines")
FULL_CENSUS = os.path.join(ROOT, "BENCH_20260808_231500.census.json")
CENSUS_ARCHS = ("gemma2-27b", "deepseek-v3-671b", "mamba2-2.7b")


def _census_row(rec, arch: str) -> None:
    cfg = get_config(arch).reduced()
    bundle = build_model(cfg, "cpu")
    params = bundle.init(0)
    tokens = torch.zeros((2, 32), dtype=torch.long)
    with mm_config(chip="tpu_v5e"), skewmm.plan_capture() as log, \
            torch.no_grad():
        h, _ = bundle.hidden_fn(params, {"tokens": tokens})
        bundle.logits_fn(params, h)
    n_grouped = sum(1 for c in log if isinstance(c, SparseMatmulCost))
    n_unplanned = sum(1 for c in log
                      if not isinstance(c, (MatmulCost, SparseMatmulCost)))
    log = [c for c in log if isinstance(c, MatmulCost)]
    n_left = sum(1 for c in log if c.dims.skew > 1)
    n_right = sum(1 for c in log if c.dims.skew < -1)
    worst = min((c.roofline_fraction(hw.TPU_V5E) for c in log), default=0.0)
    scheds: dict[str, int] = {}
    for c in log:
        scheds[c.plan.schedule] = scheds.get(c.plan.schedule, 0) + 1
    rec(f"census_{arch}", axes={"arch": arch},
        metrics={"matmuls": len(log), "left": n_left,
                 "square": len(log) - n_left - n_right, "right": n_right,
                 "grouped": n_grouped, "unplanned": n_unplanned,
                 "worst_frac": worst},
        info={"scheds": "/".join(f"{s}:{c}"
                                 for s, c in sorted(scheds.items()))})


def _fig4_rows(rec) -> None:
    with mm_config(chip="tpu_v5e"):
        for n in (512, 1024, 2048, 3584, 4096, 8192):
            planned = plan_matmul(n, n, n)
            naive = plan_matmul(n, n, n, mode="naive")
            rec(f"fig4_squared_{n}", axes={"n": n},
                metrics={"planned_frac": planned.roofline_fraction(
                    hw.TPU_V5E),
                    "naive_frac": naive.roofline_fraction(hw.TPU_V5E),
                    "modeled_tflops": planned.achieved_flops / 1e12},
                plan=planned)


def _memory_amp_rows(rec) -> None:
    with mm_config(chip="tpu_v5e"):
        for amp in (0.1, 0.2, 0.45, 0.6, 0.9):
            best_n, best_frac = 0, 0.0
            for n in (1024, 2048, 3584, 4096, 6144, 8192, 12288, 16384):
                frac = plan_matmul(n, n, n, amp=amp).roofline_fraction(
                    hw.TPU_V5E)
                if frac >= best_frac - 1e-9:
                    best_n, best_frac = n, max(best_frac, frac)
            c = plan_matmul(best_n, best_n, best_n, amp=amp)
            rec(f"memory_amp_{amp:g}", axes={"amp": amp},
                metrics={"best_n": best_n, "frac": best_frac,
                         "vmem_mib": c.vmem_bytes / 2**20},
                plan=c)


@pytest.fixture(scope="module")
def census_records():
    records = []
    rec = Recorder("census", records)
    for arch in CENSUS_ARCHS:
        _census_row(rec, arch)
    return records


def _assert_passes(records, base, n: int) -> None:
    assert len(base) == n
    report = compare.compare(records, base)
    assert report.ok, report.summary()
    gated = [e for e in report.entries if e.status != "new_record"]
    assert gated and all(e.status == "ok" for e in gated), report.summary()


def test_census_rows_equal_the_full_fidelity_run(census_records):
    _, base = bench_io.read_run(FULL_CENSUS)
    _assert_passes(census_records, base, 3)


def test_census_rows_pass_the_committed_baseline(census_records):
    _, base = bench_io.read_baselines(BASELINES)
    _assert_passes(census_records,
                   [r for r in base if r.suite == "census"], 1)


def test_deepseek_census_row(census_records):
    """deepseek-v3-671b's reduced forward (one dense and one MoE layer; the
    MTP head is not on the forward): MLA's five projections a layer (10),
    the dense MLP and the shared expert (3 each) and the LM head, plus the
    three grouped expert GEMMs of the MoE layer."""
    row = {r.name: r for r in census_records}["census_deepseek-v3-671b"]
    assert row.metrics == {"matmuls": 17, "left": 0, "square": 10,
                           "right": 7, "grouped": 3, "unplanned": 0,
                           "worst_frac": pytest.approx(0.0733, abs=1e-4)}
    assert row.info == {"scheds": "k_inner:17"}


@pytest.mark.parametrize("suite", ["fig4", "memory_amp"])
def test_modeled_rows_pass_the_committed_baseline(suite):
    records = []
    rec = Recorder(suite, records)
    (_fig4_rows if suite == "fig4" else _memory_amp_rows)(rec)
    _, base = bench_io.read_baselines(BASELINES)
    base = [r for r in base if r.suite == suite]
    assert len(records) == {"fig4": 6, "memory_amp": 5}[suite]
    _assert_passes(records, base, len(records))
    by_name = {r.name: r for r in base}
    for r in records:
        want = by_name[r.name].provenance
        for f in ("schedule", "blocks", "grid_steps"):
            assert getattr(r.provenance, f) == getattr(want, f), (r.name, f)
