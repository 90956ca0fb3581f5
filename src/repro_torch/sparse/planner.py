"""Grouped-matmul planner: the per-group (bm, bk, bn) search under the
AMP budget.

`plan_grouped_matmul` plans `groups` independent A[m, k] @ B[k, n]
expert GEMMs, modeled as a block-diagonal layout at density 1/groups with
regular (gather-free) index maps.  Candidate blocks are granule-aligned
as in the dense planner; candidates must fit ``amp * vmem_bytes``; the
argmin under the sparse cost model wins (total time, then grid steps).
Plans are cached per (groups, dims, chip, amp, mode).

Modes: "naive" fixes 512 blocks clipped to the problem; every other mode
runs the full search, as in the JAX package.  The tuned mode, the obs
span and the BSR planner (`plan_sparse_matmul`) are not ported yet.
"""

from __future__ import annotations

import functools

from repro_torch.core import config, hw
from repro_torch.core.costmodel import BlockPlan, _ceil_div
from repro_torch.core.planner import _aligned_candidates
from repro_torch.sparse.costmodel import (SparseMatmulCost,
                                          cost_sparse_matmul,
                                          sparse_vmem_bytes)
from repro_torch.sparse.layout import LayoutSummary


def _better(c: SparseMatmulCost, best: SparseMatmulCost | None) -> bool:
    """Planner argmin order: total time, grid steps as the tie-break."""
    if best is None or c.total_s < best.total_s:
        return True
    return c.total_s == best.total_s and c.grid_steps < best.grid_steps


def plan_grouped_matmul(groups: int, m: int, k: int, n: int, *,
                        dtype_bytes: int = 2, amp: float | None = None,
                        chip: hw.ChipSpec | str | None = None,
                        mode: str | None = None) -> SparseMatmulCost:
    """Plan `groups` independent A[m, k] @ B[k, n] expert GEMMs.

    The grouped kernel is K-inner with the group index as a leading
    parallel grid dim; the search covers the per-group (bm, bk, bn).
    amp / chip / mode left as None resolve through the `mm_config` stack.
    """
    cfg = config.resolve(amp=amp, chip=chip, plan_mode=mode)
    return _plan_grouped_cached(groups, m, k, n, dtype_bytes=dtype_bytes,
                                amp=cfg.amp, chip=cfg.chip_spec,
                                mode=cfg.plan_mode)


@functools.lru_cache(maxsize=4096)
def _plan_grouped_cached(groups: int, m: int, k: int, n: int, *,
                         dtype_bytes: int, amp: float, chip: hw.ChipSpec,
                         mode: str) -> SparseMatmulCost:
    budget = int(amp * chip.vmem_bytes)
    sub, lane = chip.mxu_sublanes, chip.mxu_lanes
    if mode == "naive":
        bm_cands = [min(512, _ceil_div(m, sub) * sub)]
        bk_cands = [min(512, _ceil_div(k, lane) * lane)]
        bn_cands = [min(512, _ceil_div(n, lane) * lane)]
    else:
        bm_cands = _aligned_candidates(m, sub if m < lane else lane, 4096)
        bk_cands = _aligned_candidates(k, lane, 4096)
        bn_cands = _aligned_candidates(n, lane, 4096)
    best: SparseMatmulCost | None = None
    for bm in bm_cands:
        for bk in bk_cands:
            summary = LayoutSummary.block_diag(groups, m, k, (bm, bk))
            for bn in bn_cands:
                p = BlockPlan(bm, bk, bn, schedule="k_inner")
                if sparse_vmem_bytes(summary, p, dtype_bytes) > budget:
                    continue
                c = cost_sparse_matmul(summary, n, p, chip,
                                       dtype_bytes=dtype_bytes)
                if _better(c, best):
                    best = c
    if best is None:
        # Budget too small for any aligned block: the minimum-granule plan.
        summary = LayoutSummary.block_diag(groups, m, k, (sub, lane))
        best = cost_sparse_matmul(summary, n, BlockPlan(sub, lane, lane),
                                  chip, dtype_bytes=dtype_bytes)
    return best
