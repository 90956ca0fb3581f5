"""The port's block-sparse matmul path against the JAX package's, on the CPU.

* `BlockSparseLayout`: the same constructors give the same `cols` / `nnz`.
* `ops.sparse_matmul` on CPU tensors (K9's plain version) against JAX's
  `ops.sparse_matmul` (the Pallas kernel in interpret mode) on the same
  numpy inputs, every schedule, densities 0.05-1.0 and the bias / silu /
  residual epilogues, fp32 within 1e-5 (both sum fp32 products, in another
  order); empty rows are epilogue(0); density 1.0 equals the port's dense
  `skew_matmul`.
* `plan_sparse_matmul`, `enumerate_sparse_plans`,
  `enumerate_grouped_plans` and `crossover_density` equal the JAX
  package's exactly on the four reference chips (pure Python arithmetic in
  the same order), and the committed `benchmarks/baselines/sparse.json`
  rows are reproduced.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.costmodel import BlockPlan as JPlan
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.sparse import layout as jlayout
from repro.sparse import planner as jplanner
from repro_torch.core import hw, skewmm
from repro_torch.core.config import mm_config
from repro_torch.core.costmodel import BlockPlan
from repro_torch.core.planner import plan_matmul
from repro_torch.kernels import block_sparse_matmul as bsr_mod
from repro_torch.kernels import ops, ref
from repro_torch.sparse import layout, planner

REF_CHIPS = ["tpu_v5e", "ipu_gc200", "gpu_a30", "gpu_rtx2080ti"]
BASELINE = Path(__file__).resolve().parents[1] / "benchmarks" / \
    "baselines" / "sparse.json"
RNG = np.random.default_rng(17)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(shape, scale=0.3):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _same_layout(got, want):
    np.testing.assert_array_equal(got.cols, want.cols)
    np.testing.assert_array_equal(got.nnz, want.nnz)
    assert got.shape == tuple(want.shape)
    assert got.block_shape == tuple(want.block_shape)
    assert got.summary().__dict__ == want.summary().__dict__


# ------------------------------------------------------------------ layouts
@pytest.mark.parametrize("m,k,block,density,seed", [
    (100, 300, (32, 128), 0.25, 0), (512, 512, (64, 128), 0.37, 11),
    (4096, 4096, (32, 128), 0.5, 0), (4096, 4096, (128, 128), 0.1, 3),
    (96, 256, (32, 128), 1.0, 5), (64, 64, (32, 32), 0.01, 2)])
def test_random_layout_equals_reference(m, k, block, density, seed):
    _same_layout(layout.BlockSparseLayout.random(m, k, block, density, seed),
                 jlayout.BlockSparseLayout.random(m, k, block, density, seed))


@pytest.mark.parametrize("shape,block", [((100, 300), (32, 128)),
                                         ((96, 256), (16, 64)),
                                         ((33, 129), (32, 128))])
def test_mask_constructors_equal_reference(shape, block):
    mask = RNG.random(shape) < 0.05
    _same_layout(layout.BlockSparseLayout.from_mask(mask, block),
                 jlayout.BlockSparseLayout.from_mask(mask, block))
    bmask = RNG.random((-(-shape[0] // block[0]),
                        -(-shape[1] // block[1]))) < 0.5
    _same_layout(
        layout.BlockSparseLayout.from_block_mask(bmask, block, shape=shape),
        jlayout.BlockSparseLayout.from_block_mask(bmask, block, shape=shape))
    _same_layout(layout.BlockSparseLayout.dense(*shape, block),
                 jlayout.BlockSparseLayout.dense(*shape, block))
    lay = layout.BlockSparseLayout.from_mask(mask, block)
    np.testing.assert_array_equal(
        lay.element_mask(),
        jlayout.BlockSparseLayout.from_mask(mask, block).element_mask())


def test_layout_validation_errors():
    with pytest.raises(ValueError):
        layout.BlockSparseLayout.random(64, 64, (32, 32), 0.0)
    with pytest.raises(ValueError):
        layout.BlockSparseLayout.from_mask(np.ones(8, bool), (8, 128))
    with pytest.raises(ValueError, match="sorted"):
        layout.BlockSparseLayout(shape=(64, 256), block_shape=(32, 128),
                                 cols=np.array([[1, 0], [0, 9]]),
                                 nnz=np.array([2, 2]))
    with pytest.raises(ValueError, match="nnz"):
        layout.BlockSparseLayout(shape=(64, 256), block_shape=(32, 128),
                                 cols=np.array([[0], [1]]),
                                 nnz=np.array([2, 1]))


def test_device_tensors_are_cached_per_device():
    lay = layout.BlockSparseLayout.random(256, 512, (32, 128), 0.5, seed=1)
    cols, nnz = lay.device_tensors("cpu")
    assert lay.device_tensors(torch.device("cpu"))[0] is cols
    assert cols.dtype == torch.int32 and nnz.dtype == torch.int32
    np.testing.assert_array_equal(cols.numpy(), lay.cols)
    np.testing.assert_array_equal(nnz.numpy(), lay.nnz)


# ------------------------------------------------------------ sparse_matmul
def _both(m, k, n, block, density, seed=3):
    return (layout.BlockSparseLayout.random(m, k, block, density, seed),
            jlayout.BlockSparseLayout.random(m, k, block, density, seed))


@pytest.mark.parametrize("schedule", ["k_inner", "a_resident", "b_resident"])
@pytest.mark.parametrize("density", [0.05, 0.25, 0.7, 1.0])
def test_sparse_matmul_equals_reference(schedule, density):
    m, k, n = 100, 700, 200
    lay, jlay = _both(m, k, n, (32, 128), density)
    a, b = _np((m, k)), _np((k, n))
    got = ops.sparse_matmul(torch.from_numpy(a), torch.from_numpy(b), lay,
                            plan=BlockPlan(32, 128, 128, schedule=schedule))
    want = jops.sparse_matmul(jnp.asarray(a), jnp.asarray(b), jlay,
                              plan=JPlan(32, 128, 128, schedule=schedule))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("schedule", ["k_inner", "a_resident", "b_resident"])
@pytest.mark.parametrize("epilogue", ["bias", "silu", "residual",
                                      "bias_silu_residual"])
def test_sparse_epilogues_equal_reference(schedule, epilogue):
    m, k, n = 96, 300, 130
    lay, jlay = _both(m, k, n, (32, 128), 0.5, seed=5)
    a, b = _np((m, k)), _np((k, n))
    bias, res = _np((n,), 1.0), _np((m, n), 1.0)
    got = ops.sparse_matmul(torch.from_numpy(a), torch.from_numpy(b), lay,
                            plan=BlockPlan(32, 128, 128, schedule=schedule),
                            epilogue=epilogue, bias=torch.from_numpy(bias),
                            residual=torch.from_numpy(res))
    want = jops.sparse_matmul(jnp.asarray(a), jnp.asarray(b), jlay,
                              plan=JPlan(32, 128, 128, schedule=schedule),
                              epilogue=epilogue, bias=jnp.asarray(bias),
                              residual=jnp.asarray(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    oracle = jref.block_sparse_matmul_ref(
        jnp.asarray(a), jnp.asarray(b), jlay, bias=jnp.asarray(bias),
        residual=jnp.asarray(res), epilogue=epilogue)
    mine = ref.block_sparse_matmul_ref(
        torch.from_numpy(a), torch.from_numpy(b), lay,
        bias=torch.from_numpy(bias), residual=torch.from_numpy(res),
        epilogue=epilogue)
    np.testing.assert_allclose(mine.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("schedule", ["k_inner", "a_resident", "b_resident"])
def test_empty_rows_are_epilogue_of_zero(schedule):
    m, k, n = 96, 256, 64
    mask = np.ones((3, 2), bool)
    mask[1] = False
    lay = layout.BlockSparseLayout.from_block_mask(mask, (32, 128))
    assert lay.nnz.tolist() == [2, 0, 2]
    a = torch.from_numpy(_np((m, k)))
    b = torch.from_numpy(_np((k, n)))
    bias = torch.from_numpy(_np((n,), 1.0))
    res = torch.from_numpy(_np((m, n), 1.0))
    got = ops.sparse_matmul(a, b, lay, epilogue="bias_silu_residual",
                            bias=bias, residual=res,
                            plan=BlockPlan(32, 128, 64, schedule=schedule))
    empty = torch.nn.functional.silu(bias).expand(32, n) + res[32:64]
    torch.testing.assert_close(got[32:64], empty, rtol=0, atol=0)


@pytest.mark.parametrize("schedule", ["k_inner", "a_resident", "b_resident"])
@pytest.mark.parametrize("mkn", [(96, 256, 128), (100, 300, 200),
                                 (8, 384, 520)])
def test_density_one_equals_dense_skew_matmul(schedule, mkn):
    m, k, n = mkn
    lay = layout.BlockSparseLayout.dense(m, k, (32, 128))
    a = torch.from_numpy(_np((m, k)))
    b = torch.from_numpy(_np((k, n)))
    plan = BlockPlan(32, 128, 128, schedule=schedule)
    got = ops.sparse_matmul(a, b, lay, plan=plan, epilogue="gelu")
    want = ops.skew_matmul(a, b, plan=plan, epilogue="gelu")
    assert torch.equal(got, want)


def test_planned_path_records_the_plan_and_launches_nothing_on_cpu():
    lay = layout.BlockSparseLayout.random(128, 512, (32, 128), 0.3, seed=2)
    a = torch.from_numpy(_np((128, 512)))
    b = torch.from_numpy(_np((512, 256)))
    ops.reset_launch_counts()
    with skewmm.plan_capture() as log:
        ops.sparse_matmul(a, b, lay)
    assert len(log) == 1
    assert log[0].plan == planner.plan_sparse_matmul(lay, 256,
                                                     dtype_bytes=4).plan
    assert all(v == 0 for v in ops.launch_counts().values())
    assert "block_sparse_matmul_k_inner" in ops.launch_counts()


def test_sparse_matmul_validates_layout_and_plan():
    lay = layout.BlockSparseLayout.random(64, 256, (32, 128), 0.5)
    a, b = torch.zeros(64, 256), torch.zeros(256, 64)
    with pytest.raises(ValueError, match="layout shape"):
        ops.sparse_matmul(a[:32], b, lay)
    with pytest.raises(ValueError, match="layout block shape"):
        ops.sparse_matmul(a, b, lay, plan=BlockPlan(64, 128, 64))
    with pytest.raises(ValueError, match="schedule"):
        bsr_mod.block_sparse_matmul(a, b, lay, bn=64, schedule="splitk")


# ------------------------------------------------------------------ planner
def _same_cost(got, want):
    gp, wp = got.plan, want.plan
    assert (gp.bm, gp.bk, gp.bn, gp.schedule) == \
        (wp.bm, wp.bk, wp.bn, wp.schedule)
    assert got.total_s == want.total_s
    assert got.grid_steps == want.grid_steps
    assert got.vmem_bytes == want.vmem_bytes
    assert got.layout.__dict__ == want.layout.__dict__


SUMMARIES = [(4096, 4096, (128, 128), 0.1), (4096, 4096, (32, 128), 0.25),
             (256, 65536, (128, 128), 0.4), (65536, 256, (64, 256), 0.7),
             (300, 700, (8, 128), 1.0)]


@pytest.mark.parametrize("chip", REF_CHIPS)
@pytest.mark.parametrize("mode", ["skew_aware", "k_inner", "naive"])
def test_plan_sparse_matmul_equals_reference(chip, mode):
    for m, k, block, d in SUMMARIES:
        ts = layout.LayoutSummary.balanced(m, k, block, d)
        js = jlayout.LayoutSummary.balanced(m, k, block, d)
        for n in (64, 4096):
            for dtype_bytes in (2, 4):
                kw = dict(dtype_bytes=dtype_bytes, chip=chip, mode=mode)
                _same_cost(planner.plan_sparse_matmul(ts, n, **kw),
                           jplanner.plan_sparse_matmul(js, n, **kw))


@pytest.mark.parametrize("chip", REF_CHIPS)
def test_enumerate_sparse_plans_equal_reference(chip):
    for m, k, block, d in SUMMARIES:
        ts = layout.LayoutSummary.balanced(m, k, block, d)
        js = jlayout.LayoutSummary.balanced(m, k, block, d)
        for amp in (0.45, 0.1):
            got = planner.enumerate_sparse_plans(ts, 4096, chip=chip,
                                                 amp=amp, top=8)
            want = jplanner.enumerate_sparse_plans(js, 4096, chip=chip,
                                                   amp=amp, top=8)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                _same_cost(g, w)


@pytest.mark.parametrize("chip", REF_CHIPS)
def test_enumerate_grouped_plans_equal_reference(chip):
    for groups, m, k, n in [(16, 8, 6144, 10752), (8, 32, 1024, 4096),
                            (256, 160, 2048, 7168)]:
        got = planner.enumerate_grouped_plans(groups, m, k, n, chip=chip)
        want = jplanner.enumerate_grouped_plans(groups, m, k, n, chip=chip)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_cost(g, w)


def test_gpu_h100_plans_fit_the_kernel():
    """On gpu_h100 the tune suite's (32, 128) layouts fit only bn = 64 for
    both planned schedules; at (128, 128) nothing fits and the planner
    fails over to the minimum-granule k_inner plan, which K9 launches
    anyway (under the 227 KB a CTA may use)."""
    from repro_torch.kernels.skew_matmul import SMEM_MAX, smem_bytes
    for d in (0.25, 0.5):
        s = layout.BlockSparseLayout.random(4096, 4096, (32, 128), d)
        cands = planner.enumerate_sparse_plans(s, 4096, chip="gpu_h100")
        assert sorted((c.plan.schedule, c.plan.bn) for c in cands) == \
            [("a_resident", 64), ("k_inner", 64)]
    for d in (0.1, 0.4):
        s = layout.LayoutSummary.balanced(4096, 4096, (128, 128), d)
        cost = planner.plan_sparse_matmul(s, 4096, chip="gpu_h100")
        p = cost.plan
        assert (p.bm, p.bk, p.bn, p.schedule) == (128, 128, 64, "k_inner")
        for dtype in (torch.bfloat16, torch.float32):
            assert smem_bytes(dtype, p.bm, p.bk, p.bn) <= SMEM_MAX


# ---------------------------------------------------------------- baselines
def _baseline_rows():
    return json.loads(BASELINE.read_text())["records"]


@pytest.mark.parametrize("name", [r["name"] for r in _baseline_rows()
                                  if r["name"].endswith("_crossover")])
def test_crossover_density_reproduces_baseline(name):
    row = next(r for r in _baseline_rows() if r["name"] == name)
    ax = row["axes"]
    got = planner.crossover_density(ax["m"], ax["k"], ax["n"],
                                    block=(128, 128), chip=ax["chip"])
    assert got == row["metrics"]["crossover_frac"]
    assert got == jplanner.crossover_density(ax["m"], ax["k"], ax["n"],
                                             block=(128, 128),
                                             chip=ax["chip"])


def test_density_rows_reproduce_baseline():
    """Every sparse-vs-dense row of the `sparse` suite: the same speedup
    and roofline fractions, bit for bit."""
    rows = [r for r in _baseline_rows() if "density" in r["axes"]]
    assert len(rows) == 3 * 3 * 6       # three chips x three skews x six d
    for row in rows:
        ax = row["axes"]
        with mm_config(chip=ax["chip"]):
            dense = plan_matmul(ax["m"], ax["k"], ax["n"])
            summary = layout.LayoutSummary.balanced(ax["m"], ax["k"],
                                                    (128, 128), ax["density"])
            sp = planner.plan_sparse_matmul(summary, ax["n"])
        met = row["metrics"]
        assert dense.total_s / sp.total_s == met["speedup"], row["name"]
        assert sp.roofline_fraction(ax["chip"]) == met["sparse_frac"]
        dense_frac = dense.dims.flops / dense.total_s / hw.peak_flops(
            ax["chip"], dense.dims.dtype_bytes)
        assert dense_frac == met["dense_frac"]
        assert sp.plan.schedule == row["info"]["schedule"]
        assert sp.bound == row["info"]["bound"]
