"""The port's grouped-matmul planner and sparse cost model against the JAX
package's: identical plans and identical modeled seconds on the four
reference chips (exact equality — both are pure Python float arithmetic
in the same order), plus the gpu_h100 grouped plans' invariants."""

import pytest

from repro.core.costmodel import BlockPlan as JPlan
from repro.sparse import costmodel as jcost
from repro.sparse import layout as jlayout
from repro.sparse import planner as jplanner
from repro_torch.core.costmodel import BlockPlan
from repro_torch.kernels.skew_matmul import SMEM_MAX, smem_bytes
from repro_torch.sparse import costmodel, layout, planner

REF_CHIPS = ["tpu_v5e", "ipu_gc200", "gpu_a30", "gpu_rtx2080ti"]
# (groups, k, n) of the expert GEMMs: dbrx-132b gate/up and down
# (16 experts, d 6144, ff 10752), deepseek-v3-671b (256 experts, d 7168,
# ff 2048).
EXPERT_SHAPES = [(16, 6144, 10752), (16, 10752, 6144),
                 (256, 7168, 2048), (256, 2048, 7168)]


def _key(cost):
    p = cost.plan
    return (p.bm, p.bk, p.bn, p.schedule)


def _same_cost(got, want):
    assert _key(got) == _key(want)
    # exact, not approximate: same arithmetic, same order
    assert got.total_s == want.total_s
    assert got.compute_s == want.compute_s
    assert got.memory_s == want.memory_s
    assert got.grid_steps == want.grid_steps
    assert got.hbm_bytes == want.hbm_bytes
    assert got.vmem_bytes == want.vmem_bytes
    assert got.mxu_utilization == want.mxu_utilization
    assert got.layout.__dict__ == want.layout.__dict__


@pytest.mark.parametrize("chip", REF_CHIPS)
@pytest.mark.parametrize("mode", ["skew_aware", "naive"])
def test_grouped_plan_equals_reference(chip, mode):
    for groups, k, n in EXPERT_SHAPES:
        for m in (8, 160):
            for dtype_bytes in (2, 4):
                kw = dict(dtype_bytes=dtype_bytes, chip=chip, mode=mode)
                want = jplanner.plan_grouped_matmul(groups, m, k, n, **kw)
                got = planner.plan_grouped_matmul(groups, m, k, n, **kw)
                _same_cost(got, want)


@pytest.mark.parametrize("chip", REF_CHIPS)
def test_cost_sparse_matmul_equals_reference(chip):
    from repro.core import hw as jhw
    from repro_torch.core import hw
    for m, k, n, block, density in [(4096, 4096, 4096, (128, 128), 0.25),
                                    (512, 8192, 1024, (64, 256), 0.1),
                                    (300, 700, 900, (8, 128), 1.0),
                                    (1024, 1024, 512, (128, 128), 0.01)]:
        jsum = jlayout.LayoutSummary.balanced(m, k, block, density)
        tsum = layout.LayoutSummary.balanced(m, k, block, density)
        assert tsum.__dict__ == jsum.__dict__
        for schedule in ("k_inner", "a_resident", "b_resident"):
            for bn in (128, 512):
                for dtype_bytes in (2, 4):
                    want = jcost.cost_sparse_matmul(
                        jsum, n, JPlan(*block, bn, schedule=schedule),
                        jhw.get_chip(chip), dtype_bytes=dtype_bytes)
                    got = costmodel.cost_sparse_matmul(
                        tsum, n, BlockPlan(*block, bn, schedule=schedule),
                        hw.get_chip(chip), dtype_bytes=dtype_bytes)
                    _same_cost(got, want)
                    assert got.gathered == want.gathered


def test_block_diag_summary_equals_reference():
    for groups, m, k, block in [(16, 8, 6144, (64, 64)),
                                (256, 160, 2048, (128, 512)),
                                (3, 20, 200, (8, 128))]:
        want = jlayout.LayoutSummary.block_diag(groups, m, k, block)
        got = layout.LayoutSummary.block_diag(groups, m, k, block)
        assert got.__dict__ == want.__dict__
        assert got.density == want.density
        assert got.nnz_elems == want.nnz_elems


def test_layout_and_cost_validation():
    with pytest.raises(ValueError):
        layout.LayoutSummary.balanced(64, 64, (8, 8), 0.0)
    s = layout.LayoutSummary.block_diag(2, 8, 64, (8, 64))
    with pytest.raises(ValueError, match="block shape"):
        costmodel.cost_sparse_matmul(s, 64, BlockPlan(16, 64, 64))
    with pytest.raises(ValueError, match="schedule"):
        costmodel.cost_sparse_matmul(s, 64, BlockPlan(8, 64, 64, "splitk"))


@pytest.mark.parametrize("groups,k,n", EXPERT_SHAPES)
@pytest.mark.parametrize("m", [8, 160])
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_h100_grouped_plans_are_launchable(groups, k, n, m, dtype_bytes):
    """Every gpu_h100 grouped plan, clipped as `ops` clips it, fits the
    shared memory K5 may use and has blocks that are multiples of 16."""
    import torch

    from repro_torch.core import hw
    from repro_torch.kernels.ops import clip_blocks
    chip = hw.get_chip("gpu_h100")
    cost = planner.plan_grouped_matmul(groups, m, k, n,
                                       dtype_bytes=dtype_bytes, chip=chip)
    bm, bk, bn = clip_blocks(cost.plan, m, k, n, chip)
    assert bm % 16 == 0 and bk % 16 == 0 and bn % 16 == 0
    dtype = torch.bfloat16 if dtype_bytes == 2 else torch.float32
    assert smem_bytes(dtype, bm, bk, bn) <= SMEM_MAX


def test_h100_dbrx_decode_plan():
    """At the dbrx decode shape the planner takes k_inner (64, 64, 128):
    84 n-tiles x 16 groups = 1344 CTAs, memory-bound in the model."""
    cost = planner.plan_grouped_matmul(16, 8, 6144, 10752, chip="gpu_h100")
    assert _key(cost) == (64, 64, 128, "k_inner")
    assert cost.bound == "memory"
    assert planner.plan_grouped_matmul(
        16, 8, 6144, 10752, chip="gpu_h100") is cost      # lru-cached
