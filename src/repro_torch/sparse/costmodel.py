"""Sparsity-aware analytic cost model: the dense model, density-scaled.

The JAX package's model, term for term, so the reference chips price
identically in both packages::

    time(plan) = max(compute_term, memory_term) + grid_overhead_term

with the per-schedule block re-visit traffic and MAC volume scaled by the
layout's nonzero-block count.  Block-gathered execution (index maps
chasing the structure's column indices) runs at
``ChipSpec.sparse_gather_frac`` of the chip's peak compute and streamed
bandwidth.

Per-schedule traffic (NNZ = nonzero blocks, S = padded row width; counts
are valid block visits):

  k_inner     A x gn, B per valid visit x gn, C written once.
  a_resident  A x 1, B per valid visit, C revisited per s (fp32
              read-modify-write while S > 1).
  b_resident  B re-streams per valid visit under row-major structure;
              kept for parity, excluded from the planner's search.

The "block_diag" (grouped / MoE) kind uses regular index maps — no
gather — so it is costed at full peaks: the grouped expert GEMM models as
`groups` dense matmuls, which is what the grouped kernel executes.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import hw
from repro_torch.core.costmodel import BlockPlan, _ceil_div, _round_up
from repro_torch.sparse.layout import LayoutSummary

# Schedules the sparse kernel implements; the planner searches only the
# first two (b_resident is dominated under CSR structure).
SPARSE_SCHEDULES = ("k_inner", "a_resident", "b_resident")
PLANNED_SPARSE_SCHEDULES = ("k_inner", "a_resident")


@dataclasses.dataclass(frozen=True)
class SparseMatmulCost:
    """Evaluated cost of a block-sparse or grouped plan.

    `layout` is the summary the numbers were derived from, `n` the dense
    rhs / output columns, `plan` the chosen (schedule, blocks).
    """

    layout: LayoutSummary
    n: int
    plan: BlockPlan
    dtype_bytes: int
    compute_s: float
    memory_s: float
    overhead_s: float
    hbm_bytes: int
    vmem_bytes: int
    grid_steps: int
    mxu_utilization: float
    gathered: bool = True

    @property
    def density(self) -> float:
        return self.layout.density

    @property
    def flops(self) -> int:
        """Useful FLOPs: only the nonzero blocks contract."""
        return 2 * self.layout.nnz_elems * self.n

    @property
    def total_s(self) -> float:
        return max(self.compute_s, self.memory_s) + self.overhead_s

    @property
    def achieved_flops(self) -> float:
        return self.flops / self.total_s

    def roofline_fraction(self, chip: hw.ChipSpec) -> float:
        """Useful-FLOP throughput against the chip's dense peak."""
        return self.achieved_flops / hw.peak_flops(chip, self.dtype_bytes)

    @property
    def bound(self) -> str:
        if self.overhead_s > max(self.compute_s, self.memory_s):
            return "grid-overhead"
        return "compute" if self.compute_s >= self.memory_s else "memory"

    def explain(self) -> str:
        s, p = self.layout, self.plan
        kind = f"grouped[{s.groups}]" if s.kind == "block_diag" else "bsr"
        return (
            f"sparse-mm {s.m}x{s.k}x{self.n} {kind} d={self.density:.3f} "
            f"plan ({p.bm},{p.bk},{p.bn}) sched={p.schedule} "
            f"grid={self.grid_steps} vmem={self.vmem_bytes / 2**10:.1f}KiB "
            f"compute={self.compute_s * 1e6:.1f}us "
            f"memory={self.memory_s * 1e6:.1f}us "
            f"overhead={self.overhead_s * 1e6:.1f}us bound={self.bound} "
            f"mxu_util={self.mxu_utilization:.3f}"
        )


def sparse_vmem_bytes(summary: LayoutSummary, plan: BlockPlan,
                      dtype_bytes: int, acc_bytes: int = 4) -> int:
    """Working set per grid step, including the index tables.

    Double-buffered streamed operands; k_inner holds a single fp32
    accumulator, the resident schedules accumulate through the revisited
    output block.  Gathered layouts keep their (cols, nnz) tables on-chip
    for the run; block-diagonal (grouped) layouts store none.
    """
    a = plan.bm * plan.bk * dtype_bytes
    b = plan.bk * plan.bn * dtype_bytes
    if plan.schedule == "k_inner":
        c = plan.bm * plan.bn * acc_bytes
    else:
        c_width = acc_bytes if summary.s_max > 1 else dtype_bytes
        c = 2 * plan.bm * plan.bn * c_width
    if summary.kind == "block_diag":
        tables = 0
    else:
        tables = 4 * summary.gm * (summary.s_max + 1)
    return 2 * (a + b) + c + tables


def cost_sparse_matmul(summary: LayoutSummary, n: int, plan: BlockPlan,
                       chip: hw.ChipSpec = hw.TPU_V5E, *,
                       dtype_bytes: int = 2,
                       acc_bytes: int = 4) -> SparseMatmulCost:
    """Evaluate a (schedule, bn) plan for ``sparse(A) @ B`` on `chip`.
    `plan.bm` / `plan.bk` must equal the layout's block shape."""
    if (plan.bm, plan.bk) != (summary.bm, summary.bk):
        raise ValueError(
            f"plan blocks ({plan.bm}, {plan.bk}) must match the layout "
            f"block shape ({summary.bm}, {summary.bk})")
    if plan.schedule not in SPARSE_SCHEDULES:
        raise ValueError(f"unknown sparse schedule {plan.schedule!r}; "
                         f"must be one of {SPARSE_SCHEDULES}")
    gathered = summary.kind != "block_diag"
    gm, s_max = summary.gm, summary.s_max
    gn = _ceil_div(n, plan.bn)
    nnz = summary.nnz_blocks
    valid_visits = nnz * gn

    # compute: passes over granule-padded blocks, valid visits only;
    # gathered execution runs at a discounted effective peak.
    pbm = _round_up(plan.bm, chip.mxu_sublanes)
    pbk = _round_up(plan.bk, chip.mxu_lanes)
    pbn = _round_up(plan.bn, chip.mxu_lanes)
    padded_flops = 2 * valid_visits * pbm * pbk * pbn
    row_fill = min(1.0, pbm / chip.mxu_lanes)
    eff_peak = hw.peak_flops(chip, dtype_bytes) * max(
        row_fill, 1.0 / chip.mxu_lanes * 8)
    if gathered:
        eff_peak *= chip.sparse_gather_frac
    compute_s = padded_flops / eff_peak
    useful = 2 * summary.nnz_elems * n
    mxu_utilization = useful / padded_flops if padded_flops else 0.0

    # memory: density-scaled A/B streams (gather-discounted), dense C.
    dt = dtype_bytes
    block_a = plan.bm * plan.bk
    block_b = plan.bk * plan.bn
    if plan.schedule == "a_resident":
        a_bytes = nnz * block_a * dt
    else:
        a_bytes = nnz * block_a * gn * dt
    b_bytes = valid_visits * block_b * dt
    c_elems = summary.m * n
    if plan.schedule == "k_inner" or s_max == 1:
        c_bytes = c_elems * dt
    else:
        c_bytes = 2 * s_max * c_elems * acc_bytes + c_elems * dt
    ab_bw = chip.hbm_bw * (chip.sparse_gather_frac if gathered else 1.0)
    memory_s = (a_bytes + b_bytes) / ab_bw + c_bytes / chip.hbm_bw

    # grid overhead: every step schedules, valid or not.
    steps = gm * gn * s_max
    overhead_s = steps * chip.grid_step_overhead_s

    return SparseMatmulCost(
        layout=summary, n=n, plan=plan, dtype_bytes=dtype_bytes,
        compute_s=compute_s, memory_s=memory_s, overhead_s=overhead_s,
        hbm_bytes=a_bytes + b_bytes + c_bytes,
        vmem_bytes=sparse_vmem_bytes(summary, plan, dtype_bytes, acc_bytes),
        grid_steps=steps, mxu_utilization=mxu_utilization,
        gathered=gathered)
