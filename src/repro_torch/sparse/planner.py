"""Sparsity-aware planner: (schedule x bn) search under the AMP budget.

The dense planner's mechanism extended to block-sparse layouts, as in the
JAX package and exact in its arithmetic:

* `plan_sparse_matmul` — the layout fixes the lhs tiling (kernel blocks ==
  structure blocks), so the search space is (schedule, bn); candidates
  must fit ``amp * vmem_bytes`` including the index tables, and the
  argmin under the sparse cost model wins (total time, then grid steps).
  When no candidate fits, the minimum-granule plan is returned.
* `plan_grouped_matmul` — `groups` independent A[m, k] @ B[k, n] expert
  GEMMs, modeled as a block-diagonal layout at density 1/groups with
  regular (gather-free) index maps; the per-group (bm, bk, bn) is
  searched.
* `enumerate_sparse_plans` / `enumerate_grouped_plans` — the modeled
  top-K candidates, best first: the measured autotuner's candidate sets.
* `crossover_density` — the modeled break-even density below which the
  best sparse plan beats the best dense plan.

Modes: "naive" fixes 512 blocks clipped to the problem; "k_inner"
restricts the sparse search to that schedule; "tuned" consults the
active tune cache (`repro_torch.tune.runtime`), outside the lru cache,
and falls back to the modeled "skew_aware" search on a miss or on a
cached plan that no longer fits; a corrupt cache entry
(`guard.faults.is_corrupt_plan`) is counted as caught and replaced by
the modeled plan.  Modeled plans are cached per (summary or dims, n,
chip, amp, mode).  With a `trace_scope` armed every resolution emits
one "plan" span (feasible candidate count, chosen plan, modeled_us),
outside the caches, as in the JAX package.
"""

from __future__ import annotations

import functools

from repro_torch.core import config, hw
from repro_torch.core.costmodel import BlockPlan, _ceil_div
from repro_torch.core.planner import _aligned_candidates, plan_matmul
from repro_torch.sparse.costmodel import (PLANNED_SPARSE_SCHEDULES,
                                          SparseMatmulCost,
                                          cost_sparse_matmul,
                                          sparse_vmem_bytes)
from repro_torch.obs import spans as _obs
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
    if cfg.plan_mode == "tuned":
        # Tuned plans read the mutable active cache: never lru-cached.
        cost = _plan_grouped_tuned(groups, m, k, n, dtype_bytes=dtype_bytes,
                                   amp=cfg.amp, chip=cfg.chip_spec)
    else:
        cost = _plan_grouped_cached(groups, m, k, n, dtype_bytes=dtype_bytes,
                                    amp=cfg.amp, chip=cfg.chip_spec,
                                    mode=cfg.plan_mode)
    if _obs.tracing():
        _emit_grouped_plan_span(groups, m, k, n, cfg=cfg, cost=cost,
                                dtype_bytes=dtype_bytes)
    return cost


def _emit_grouped_plan_span(groups: int, m: int, k: int, n: int, *, cfg,
                            cost: SparseMatmulCost, dtype_bytes: int) -> None:
    """The plan span of a grouped (MoE expert) plan resolution."""
    chip = cfg.chip_spec
    budget = int(cfg.amp * chip.vmem_bytes)
    sub, lane = chip.mxu_sublanes, chip.mxu_lanes
    mode = cfg.plan_mode
    if mode == "naive":
        candidates = 1
    else:
        candidates = 0
        for bm in _aligned_candidates(m, sub if m < lane else lane, 4096):
            for bk in _aligned_candidates(k, lane, 4096):
                summary = LayoutSummary.block_diag(groups, m, k, (bm, bk))
                for bn in _aligned_candidates(n, lane, 4096):
                    p = BlockPlan(bm, bk, bn, schedule="k_inner")
                    if sparse_vmem_bytes(summary, p, dtype_bytes) <= budget:
                        candidates += 1
    modeled_us = cost.total_s * 1e6
    p = cost.plan
    _obs.event(
        "plan", f"grouped/{mode}",
        groups=groups, m=m, k=k, n=n, chip=chip.name,
        candidates=candidates, schedule=p.schedule,
        blocks=(p.bm, p.bk, p.bn), grid_steps=cost.grid_steps,
        modeled_us=modeled_us,
    )
    _obs.annotate("dispatch", modeled_us=modeled_us, schedule=p.schedule,
                  grid_steps=cost.grid_steps)


def _plan_grouped_tuned(groups: int, m: int, k: int, n: int, *,
                        dtype_bytes: int, amp: float,
                        chip: hw.ChipSpec) -> SparseMatmulCost:
    from repro_torch.guard import faults as guard_faults  # planner <- guard
    from repro_torch.guard import health as guard_health
    from repro_torch.tune import runtime as tune_runtime  # planner <- tune

    plan = tune_runtime.lookup_grouped(groups, m, k, n,
                                       dtype_bytes=dtype_bytes, amp=amp,
                                       chip=chip)
    if guard_faults.is_corrupt_plan(plan):
        guard_health.record("faults_caught")
        plan = None
    if plan is not None:
        summary = LayoutSummary.block_diag(groups, m, k, (plan.bm, plan.bk))
        if sparse_vmem_bytes(summary, plan, dtype_bytes) <= int(
                amp * chip.vmem_bytes):
            return cost_sparse_matmul(summary, n, plan, chip,
                                      dtype_bytes=dtype_bytes)
    return _plan_grouped_cached(groups, m, k, n, dtype_bytes=dtype_bytes,
                                amp=amp, chip=chip, mode="skew_aware")


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


def enumerate_grouped_plans(groups: int, m: int, k: int, n: int, *,
                            dtype_bytes: int = 2, amp: float | None = None,
                            chip: hw.ChipSpec | str | None = None,
                            top: int = 8) -> list[SparseMatmulCost]:
    """The modeled top-`top` per-group (bm, bk, bn) candidates, best
    first: the measured autotuner's grouped candidate set."""
    cfg = config.resolve(amp=amp, chip=chip)
    chip = cfg.chip_spec
    budget = int(cfg.amp * chip.vmem_bytes)
    sub, lane = chip.mxu_sublanes, chip.mxu_lanes
    costs: list[SparseMatmulCost] = []
    for bm in _aligned_candidates(m, sub if m < lane else lane, 4096):
        for bk in _aligned_candidates(k, lane, 4096):
            summary = LayoutSummary.block_diag(groups, m, k, (bm, bk))
            for bn in _aligned_candidates(n, lane, 4096):
                p = BlockPlan(bm, bk, bn, schedule="k_inner")
                if sparse_vmem_bytes(summary, p, dtype_bytes) > budget:
                    continue
                costs.append(cost_sparse_matmul(summary, n, p, chip,
                                                dtype_bytes=dtype_bytes))
    if not costs:
        summary = LayoutSummary.block_diag(groups, m, k, (sub, lane))
        costs = [cost_sparse_matmul(summary, n, BlockPlan(sub, lane, lane),
                                    chip, dtype_bytes=dtype_bytes)]
    costs.sort(key=_grouped_plan_order)
    return costs[:top]


def _grouped_plan_order(c: SparseMatmulCost) -> tuple:
    """Deterministic ranking matching `_better`'s encounter order (blocks
    ascending, bm outermost)."""
    return (c.total_s, c.grid_steps, c.plan.bm, c.plan.bk, c.plan.bn)


# --------------------------------------------------------------- sparse
def plan_sparse_matmul(layout, n: int, *, dtype_bytes: int = 2,
                       amp: float | None = None,
                       chip: hw.ChipSpec | str | None = None,
                       mode: str | None = None) -> SparseMatmulCost:
    """Choose a (schedule, bn) plan for ``sparse(A[m, k]) @ B[k, n]``.

    `layout` is a `BlockSparseLayout` or its `LayoutSummary`.  amp / chip
    / mode resolve through the active `mm_config` stack; "k_inner" /
    "naive" restrict the search as in the dense planner (naive fixes a
    512-wide rhs block); "tuned" consults the tune cache keyed on the
    exact summary, falling back to the modeled "skew_aware" search.
    """
    summary = layout.summary() if hasattr(layout, "summary") else layout
    if not isinstance(summary, LayoutSummary):
        raise TypeError(f"layout must be a BlockSparseLayout or "
                        f"LayoutSummary, got {type(layout).__name__}")
    cfg = config.resolve(amp=amp, chip=chip, plan_mode=mode)
    if cfg.plan_mode == "tuned":
        # Tuned plans read the mutable active cache: never lru-cached, so a
        # cache swap is never served a stale plan.
        cost = _plan_sparse_tuned(summary, n, dtype_bytes=dtype_bytes,
                                  amp=cfg.amp, chip=cfg.chip_spec)
    else:
        cost = _plan_sparse_cached(summary, n, dtype_bytes=dtype_bytes,
                                   amp=cfg.amp, chip=cfg.chip_spec,
                                   mode=cfg.plan_mode)
    if _obs.tracing():
        # Outside the lru cache: every resolution emits exactly one span.
        _emit_sparse_plan_span(summary, n, cfg=cfg, cost=cost,
                               dtype_bytes=dtype_bytes)
    return cost


def _emit_sparse_plan_span(summary: LayoutSummary, n: int, *, cfg,
                           cost: SparseMatmulCost, dtype_bytes: int) -> None:
    """The plan span of a sparse plan resolution (feasibility-only
    candidate count over the (schedule x bn) space)."""
    chip = cfg.chip_spec
    budget = int(cfg.amp * chip.vmem_bytes)
    lane = chip.mxu_lanes
    mode = cfg.plan_mode
    if mode == "naive":
        candidates = 1
    else:
        schedules = (("k_inner",) if mode == "k_inner"
                     else PLANNED_SPARSE_SCHEDULES)
        candidates = 0
        for schedule in schedules:
            for bn in _aligned_candidates(n, lane, 4096):
                p = BlockPlan(summary.bm, summary.bk, bn, schedule=schedule)
                if sparse_vmem_bytes(summary, p, dtype_bytes) <= budget:
                    candidates += 1
    modeled_us = cost.total_s * 1e6
    p = cost.plan
    _obs.event(
        "plan", f"sparse/{mode}",
        m=summary.m, k=summary.k, n=n, chip=chip.name,
        density=summary.density, candidates=candidates,
        schedule=p.schedule, blocks=(p.bm, p.bk, p.bn),
        grid_steps=cost.grid_steps, modeled_us=modeled_us,
    )
    _obs.annotate("dispatch", modeled_us=modeled_us, schedule=p.schedule,
                  grid_steps=cost.grid_steps)


def _plan_sparse_tuned(summary: LayoutSummary, n: int, *, dtype_bytes: int,
                       amp: float, chip: hw.ChipSpec) -> SparseMatmulCost:
    from repro_torch.guard import faults as guard_faults  # planner <- guard
    from repro_torch.guard import health as guard_health
    from repro_torch.tune import runtime as tune_runtime  # planner <- tune

    plan = tune_runtime.lookup_sparse(summary, n, dtype_bytes=dtype_bytes,
                                      amp=amp, chip=chip)
    if guard_faults.is_corrupt_plan(plan):
        guard_health.record("faults_caught")
        plan = None
    if (plan is not None and (plan.bm, plan.bk) == (summary.bm, summary.bk)
            and sparse_vmem_bytes(summary, plan, dtype_bytes)
            <= int(amp * chip.vmem_bytes)):
        return cost_sparse_matmul(summary, n, plan, chip,
                                  dtype_bytes=dtype_bytes)
    return _plan_sparse_cached(summary, n, dtype_bytes=dtype_bytes, amp=amp,
                               chip=chip, mode="skew_aware")


@functools.lru_cache(maxsize=4096)
def _plan_sparse_cached(summary: LayoutSummary, n: int, *, dtype_bytes: int,
                        amp: float, chip: hw.ChipSpec,
                        mode: str) -> SparseMatmulCost:
    budget = int(amp * chip.vmem_bytes)
    lane = chip.mxu_lanes
    if mode == "naive":
        bn_cands = [min(512, _ceil_div(n, lane) * lane)]
        schedules = ("k_inner",)
    else:
        bn_cands = _aligned_candidates(n, lane, 4096)
        schedules = (("k_inner",) if mode == "k_inner"
                     else PLANNED_SPARSE_SCHEDULES)
    best: SparseMatmulCost | None = None
    for schedule in schedules:
        for bn in bn_cands:
            p = BlockPlan(summary.bm, summary.bk, bn, schedule=schedule)
            if sparse_vmem_bytes(summary, p, dtype_bytes) > budget:
                continue
            c = cost_sparse_matmul(summary, n, p, chip,
                                   dtype_bytes=dtype_bytes)
            if _better(c, best):
                best = c
    if best is None:
        # Budget too small for any aligned rhs block: the minimum-granule
        # plan (mirrors the dense planner).
        p = BlockPlan(summary.bm, summary.bk, lane)
        best = cost_sparse_matmul(summary, n, p, chip,
                                  dtype_bytes=dtype_bytes)
    return best


def enumerate_sparse_plans(layout, n: int, *, dtype_bytes: int = 2,
                           amp: float | None = None,
                           chip: hw.ChipSpec | str | None = None,
                           top: int = 8) -> list[SparseMatmulCost]:
    """The modeled top-`top` (schedule, bn) candidates, best first: the
    measured autotuner's sparse candidate set.  The first element is the
    ``plan_sparse_matmul(mode="skew_aware")`` argmin; the minimum-granule
    plan keeps the list non-empty at any budget."""
    summary = layout.summary() if hasattr(layout, "summary") else layout
    cfg = config.resolve(amp=amp, chip=chip)
    chip = cfg.chip_spec
    budget = int(cfg.amp * chip.vmem_bytes)
    lane = chip.mxu_lanes
    costs: list[SparseMatmulCost] = []
    for schedule in PLANNED_SPARSE_SCHEDULES:
        for bn in _aligned_candidates(n, lane, 4096):
            p = BlockPlan(summary.bm, summary.bk, bn, schedule=schedule)
            if sparse_vmem_bytes(summary, p, dtype_bytes) > budget:
                continue
            costs.append(cost_sparse_matmul(summary, n, p, chip,
                                            dtype_bytes=dtype_bytes))
    if not costs:
        p = BlockPlan(summary.bm, summary.bk, lane)
        costs = [cost_sparse_matmul(summary, n, p, chip,
                                    dtype_bytes=dtype_bytes)]
    costs.sort(key=_sparse_plan_order)
    return costs[:top]


def _sparse_plan_order(c: SparseMatmulCost) -> tuple:
    """Deterministic ranking matching `_better`'s encounter order
    (schedule position in the planned family, then bn ascending)."""
    return (c.total_s, c.grid_steps,
            PLANNED_SPARSE_SCHEDULES.index(c.plan.schedule), c.plan.bn)


def crossover_density(m: int, k: int, n: int, *,
                      block: tuple[int, int] = (128, 128),
                      dtype_bytes: int = 2, amp: float | None = None,
                      chip: hw.ChipSpec | str | None = None) -> float:
    """Modeled sparse-vs-dense break-even density d* for one shape: the
    largest density at which the best balanced block-sparse plan is
    strictly faster than the best dense plan (0.0: sparse never wins; 1.0:
    it always does).  Both sides use the full "skew_aware" search whatever
    the ambient plan_mode; a 50-step bisection, as in the JAX package."""
    cfg = config.resolve(amp=amp, chip=chip)
    kw = dict(dtype_bytes=dtype_bytes, amp=cfg.amp, chip=cfg.chip_spec)

    dense_t = plan_matmul(m, k, n, mode="skew_aware", **kw).total_s

    def sparse_t(d: float) -> float:
        summary = LayoutSummary.balanced(m, k, block, d)
        return plan_sparse_matmul(summary, n, mode="skew_aware",
                                  **kw).total_s

    if sparse_t(1.0) < dense_t:
        return 1.0
    lo_d = 1.0 / (_ceil_div(m, block[0]) * _ceil_div(k, block[1]))
    if sparse_t(lo_d) >= dense_t:
        return 0.0
    lo, hi = lo_d, 1.0
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        if sparse_t(mid) < dense_t:
            lo = mid
        else:
            hi = mid
    return lo
