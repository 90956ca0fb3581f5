"""Skew-aware matmul (schedule x block-shape) planner under an AMP budget.

The port of the JAX package's planner:

  * candidate blocks are granule-aligned (`chip.mxu_sublanes` on m below
    the lane width, `chip.mxu_lanes` otherwise and on k/n),
  * the working set must fit `amp * vmem_bytes` (on `gpu_h100`: the CTA's
    shared memory, so every plan is launchable),
  * the search covers the dense schedule family, the batch-grid variant
    when a leading batch dim is present, and at decode shapes the split-K
    GEMV family; the modeled argmin wins,
  * under a `mesh_shape` of more than one chip the search runs jointly
    over (schedule x blocks x ShardSpec), each candidate priced with its
    collective terms,
  * `sweep_aspect_ratios` is the paper's Fig. 5 sweep: naive,
    K-inner-only and skew-aware plans per aspect ratio.

Plans are memoized per (dims, chip, amp, mode[, mesh]): PyTorch runs
eagerly and plans on every call of every step, so the cache is what keeps
host time down.  The "tuned" mode reads the measured autotuner's active
cache (`repro_torch.tune.runtime`) outside that memo, and a corrupt
cache entry (`guard.faults.is_corrupt_plan`) is counted as caught and
replaced by the modeled plan.  With a `trace_scope` armed every
resolution emits one "plan" span (mode, dims, feasible candidate count,
chosen schedule and blocks, modeled_us) and stamps the modeled time on
the enclosing dispatch span, outside the memo, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Iterable

from repro_torch.core import config, hw
from repro_torch.core.costmodel import (ALL_SCHEDULES, SCHEDULES, BlockPlan,
                                        MatmulCost, MatmulDims, ShardSpec,
                                        cost_matmul, cost_sharded_matmul)
from repro_torch.obs import spans as _obs


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _aligned_candidates(dim: int, granule: int, cap: int) -> list[int]:
    """Aligned block-size candidates for one dimension: the full (rounded)
    dim when it fits the cap, power-of-two granule multiples, and a 1.5x
    companion for each power of two (rounded down to a granule multiple)."""
    full = _round_up(dim, granule)
    hi = min(full, cap)
    out = {hi}
    b = granule
    while b <= hi:
        out.add(b)
        threehalves = (b + b // 2) // granule * granule
        if granule <= threehalves <= hi:
            out.add(threehalves)
        b *= 2
    return sorted(out)


def _feasible_costs(d: MatmulDims, chip: hw.ChipSpec, budget: int,
                    schedules: tuple[str, ...],
                    batch_grid: bool = False) -> Iterable[MatmulCost]:
    """Every (schedule x aligned blocks) plan that fits the AMP budget."""
    sub, lane = chip.mxu_sublanes, chip.mxu_lanes
    m_eff = d.m if batch_grid else d.m * d.batch
    bm_cands = _aligned_candidates(m_eff, sub if m_eff < lane else lane, 4096)
    bk_cands = _aligned_candidates(d.k, lane, 4096)
    bn_cands = _aligned_candidates(d.n, lane, 4096)
    for schedule in schedules:
        for bm in bm_cands:
            for bk in bk_cands:
                for bn in bn_cands:
                    p = BlockPlan(bm, bk, bn, schedule=schedule,
                                  batch_grid=batch_grid)
                    if p.vmem_bytes(d, chip) > budget:
                        continue
                    yield cost_matmul(d, p, chip)


def _search(d: MatmulDims, chip: hw.ChipSpec, budget: int,
            schedules: tuple[str, ...],
            batch_grid: bool = False) -> MatmulCost | None:
    best: MatmulCost | None = None
    for c in _feasible_costs(d, chip, budget, schedules, batch_grid):
        if best is None or c.total_s < best.total_s or (
                c.total_s == best.total_s
                and c.grid_steps < best.grid_steps):
            best = c
    return best


def gemv_applicable(m: int, batch: int, chip: hw.ChipSpec) -> bool:
    """Whether the split-K GEMV family joins the search: plain 2-D
    contractions whose row count is below the lane width (decode)."""
    return batch == 1 and m < chip.mxu_lanes


def _gemv_costs(d: MatmulDims, chip: hw.ChipSpec,
                budget: int) -> Iterable[MatmulCost]:
    """Split-K candidates: one sublane-padded m block, (bk, bn) aligned."""
    sub, lane = chip.mxu_sublanes, chip.mxu_lanes
    bm = _round_up(d.m, sub)
    for bk in _aligned_candidates(d.k, lane, 4096):
        for bn in _aligned_candidates(d.n, lane, 4096):
            p = BlockPlan(bm, bk, bn, schedule="splitk")
            if p.vmem_bytes(d, chip) > budget:
                continue
            yield cost_matmul(d, p, chip)


def _search_gemv(d: MatmulDims, chip: hw.ChipSpec,
                 budget: int) -> MatmulCost | None:
    best: MatmulCost | None = None
    for c in _gemv_costs(d, chip, budget):
        if best is None or _plan_order(c) < _plan_order(best):
            best = c
    return best


def _plan_order(c: MatmulCost) -> tuple:
    """Deterministic ranking: modeled time, grid steps, then encounter
    order (schedule-family position, blocks ascending, folded first)."""
    p = c.plan
    return (c.total_s, c.grid_steps, p.batch_grid,
            ALL_SCHEDULES.index(p.schedule), p.bm, p.bk, p.bn)


def enumerate_plans(m: int, k: int, n: int, *, dtype_bytes: int = 2,
                    amp: float | None = None,
                    chip: hw.ChipSpec | str | None = None,
                    batch: int = 1, top: int = 8) -> list[MatmulCost]:
    """The modeled top-`top` candidate plans, best first: the measured
    autotuner's candidate set.  Covers the skew-aware search space (the
    schedule family, the batch-grid variant when batch > 1, split-K at
    decode shapes); the first element is the ``plan_matmul(mode=
    "skew_aware")`` plan.  Falls back to the minimum-granule plan when no
    aligned candidate fits, so the list is never empty."""
    cfg = config.resolve(amp=amp, chip=chip)
    chip = cfg.chip_spec
    d = MatmulDims(m=m, k=k, n=n, dtype_bytes=dtype_bytes, batch=batch)
    budget = int(cfg.amp * chip.vmem_bytes)
    costs = list(_feasible_costs(d, chip, budget, SCHEDULES))
    if batch > 1:
        costs.extend(
            _feasible_costs(d, chip, budget, ("k_inner",), batch_grid=True))
    if gemv_applicable(m, batch, chip):
        costs.extend(_gemv_costs(d, chip, budget))
    if not costs:
        costs = [cost_matmul(d, BlockPlan(chip.mxu_sublanes, chip.mxu_lanes,
                                          chip.mxu_lanes), chip)]
    costs.sort(key=_plan_order)
    return costs[:top]


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


@functools.lru_cache(maxsize=1024)
def shard_candidates(devices: int, m: int, k: int, n: int,
                     batch: int = 1) -> tuple[ShardSpec, ...]:
    """Every way to factor `devices` chips over the four matmul dims:
    ordered factorizations (batch, m, k, n), no shard count above its dim.
    k-splits carry partials="all_reduce"; weights stay resident (no
    zero3).  A problem too small for any factorization replicates."""
    specs = []
    for sb in _divisors(devices):
        if sb > batch:
            continue
        rem_b = devices // sb
        for sm in _divisors(rem_b):
            if sm > m:
                continue
            rem_m = rem_b // sm
            for sk in _divisors(rem_m):
                sn = rem_m // sk
                if sk > k or sn > n:
                    continue
                specs.append(ShardSpec(m=sm, k=sk, n=sn, batch=sb))
    if not specs:
        specs.append(ShardSpec())
    return tuple(specs)


def _sharded_order(c: MatmulCost) -> tuple:
    """Deterministic ranking across (ShardSpec x schedule x blocks):
    modeled time, then less exposed collective, then the local plan
    order, then the spec's shard counts (batch, m, k, n)."""
    s = c.sharding or ShardSpec()
    return (c.total_s, c.collective_s) + _plan_order(c) + (
        s.batch, s.m, s.k, s.n)


def plan_matmul(m: int, k: int, n: int, *, dtype_bytes: int = 2,
                amp: float | None = None, chip: hw.ChipSpec | str | None = None,
                mode: str | None = None, batch: int = 1,
                mesh_shape: tuple | None = None,
                sharding: ShardSpec | str | None = None) -> MatmulCost:
    """Choose a (schedule, block shape) plan for A[batch, m, k] @ B[k, n].

    amp / chip / mode left as None resolve through the active `mm_config`
    context stack (defaults: 0.45 / gpu_h100 / "skew_aware").

    mode:
      "skew_aware" — full (schedule x block) search; with batch > 1 it
                     also weighs a batch-grid plan, and at decode shapes
                     (2-D, m below the lane width) the split-K family joins
                     and wins exactly when its modeled cost does.
      "dense"      — the search without the GEMV family.
      "k_inner"    — the search restricted to the K-innermost schedule.
      "naive"      — fixed 512^3 blocks clipped to the problem.
      "tuned"      — the measured autotuner's cache for this shape class:
                     a hit returns the measured winner costed on the actual
                     dims; a miss, or a cached plan that no longer fits the
                     budget, falls back to "skew_aware".

    Sharded planning: when the resolved config's `mesh_shape` holds more
    than one chip, every candidate ShardSpec's per-device dims are
    block-searched and priced with their collective terms
    (`cost_sharded_matmul`), and the global argmin wins.  An explicit
    `ShardSpec` (kwarg or `mm_config` field) pins the split; "auto" / None
    searches them all.  "tuned" falls back to the modeled sharded search.
    """
    cfg = config.resolve(amp=amp, chip=chip, plan_mode=mode,
                         mesh_shape=mesh_shape, sharding=sharding)
    if cfg.mesh_devices > 1:
        spec = cfg.sharding if isinstance(cfg.sharding, ShardSpec) else None
        smode = cfg.plan_mode if cfg.plan_mode != "tuned" else "skew_aware"
        cost = _plan_matmul_sharded_cached(
            m, k, n, dtype_bytes=dtype_bytes, amp=cfg.amp,
            chip=cfg.chip_spec, mode=smode, batch=batch,
            devices=cfg.mesh_devices, spec=spec)
    elif cfg.plan_mode == "tuned":
        # The active tune cache is mutable state: resolved outside the lru
        # cache, which memoizes only the modeled fallback.
        cost = _plan_matmul_tuned(m, k, n, dtype_bytes=dtype_bytes,
                                  amp=cfg.amp, chip=cfg.chip_spec,
                                  batch=batch)
    else:
        cost = _plan_matmul_cached(m, k, n, dtype_bytes=dtype_bytes,
                                   amp=cfg.amp, chip=cfg.chip_spec,
                                   mode=cfg.plan_mode, batch=batch)
    if _obs.tracing():
        # Outside the lru caches: every resolution, memoized or not, emits
        # exactly one plan span.
        _emit_plan_span(m, k, n, batch=batch, dtype_bytes=dtype_bytes,
                        cfg=cfg, cost=cost)
    return cost


def _count_candidates(m: int, k: int, n: int, *, dtype_bytes: int,
                      amp: float, chip: hw.ChipSpec, mode: str,
                      batch: int, devices: int = 1,
                      spec: ShardSpec | None = None) -> int:
    """Feasible candidate count for the plan span — mirrors the search
    space (`_feasible_costs` / `_gemv_costs` / batch-grid / the sharded
    joint search) but checks only the budget, never pricing a candidate.
    Traced runs only."""
    d = MatmulDims(m=m, k=k, n=n, dtype_bytes=dtype_bytes, batch=batch)
    budget = int(amp * chip.vmem_bytes)
    if devices > 1 and mode != "naive":
        # The joint search runs the local block search once per candidate
        # ShardSpec: the span's candidate count sums the per-spec counts.
        specs = (spec,) if spec is not None else shard_candidates(
            devices, m, k, n, batch)
        return sum(
            _count_candidates(ld.m, ld.k, ld.n, dtype_bytes=dtype_bytes,
                              amp=amp, chip=chip, mode=mode, batch=ld.batch)
            for ld in (s.local_dims(d) for s in specs))
    if mode == "naive":
        return 1

    def feasible(schedules: tuple[str, ...], batch_grid: bool) -> int:
        sub, lane = chip.mxu_sublanes, chip.mxu_lanes
        m_eff = d.m if batch_grid else d.m * d.batch
        bm = _aligned_candidates(m_eff, sub if m_eff < lane else lane, 4096)
        bk = _aligned_candidates(d.k, lane, 4096)
        bn = _aligned_candidates(d.n, lane, 4096)
        total = 0
        for schedule in schedules:
            for cand in ((a, b, c) for a in bm for b in bk for c in bn):
                p = BlockPlan(*cand, schedule=schedule, batch_grid=batch_grid)
                if p.vmem_bytes(d, chip) <= budget:
                    total += 1
        return total

    schedules = ("k_inner",) if mode == "k_inner" else SCHEDULES
    count = feasible(schedules, batch_grid=False)
    if mode in ("skew_aware", "tuned") and gemv_applicable(m, batch, chip):
        sub, lane = chip.mxu_sublanes, chip.mxu_lanes
        bm = _round_up(d.m, sub)
        for bk in _aligned_candidates(d.k, lane, 4096):
            for bn in _aligned_candidates(d.n, lane, 4096):
                p = BlockPlan(bm, bk, bn, schedule="splitk")
                if p.vmem_bytes(d, chip) <= budget:
                    count += 1
    if batch > 1 and mode != "k_inner":
        count += feasible(("k_inner",), batch_grid=True)
    return count


def _emit_plan_span(m: int, k: int, n: int, *, batch: int, dtype_bytes: int,
                    cfg, cost: MatmulCost) -> None:
    """One "plan" span per resolution, stamped with the search outcome;
    also annotates the enclosing dispatch span with the modeled time.
    Sharded plans carry the chosen ShardSpec and their collective
    attribution (exposed + hidden wire microseconds)."""
    p = cost.plan
    modeled_us = cost.total_s * 1e6
    devices = cfg.mesh_devices
    pinned = cfg.sharding if isinstance(cfg.sharding, ShardSpec) else None
    extra: dict = {}
    if cost.sharding is not None:
        extra = dict(
            sharding=cost.sharding.describe(), devices=devices,
            collective_us=cost.collective_s * 1e6,
            hidden_collective_us=cost.hidden_collective_s * 1e6,
        )
    _obs.event(
        "plan", f"dense/{cfg.plan_mode}",
        m=m, k=k, n=n, batch=batch, chip=cfg.chip_spec.name,
        candidates=_count_candidates(m, k, n, dtype_bytes=dtype_bytes,
                                     amp=cfg.amp, chip=cfg.chip_spec,
                                     mode=cfg.plan_mode, batch=batch,
                                     devices=devices, spec=pinned),
        schedule=p.schedule, blocks=(p.bm, p.bk, p.bn),
        batch_grid=p.batch_grid, grid_steps=cost.grid_steps,
        modeled_us=modeled_us, **extra,
    )
    _obs.annotate("dispatch", modeled_us=modeled_us, schedule=p.schedule,
                  grid_steps=cost.grid_steps, **extra)


def _plan_matmul_tuned(m: int, k: int, n: int, *, dtype_bytes: int,
                       amp: float, chip: hw.ChipSpec,
                       batch: int) -> MatmulCost:
    from repro_torch.guard import faults as guard_faults  # planner <- guard
    from repro_torch.guard import health as guard_health
    from repro_torch.tune import runtime as tune_runtime  # planner <- tune

    plan = tune_runtime.lookup_dense(m, k, n, batch=batch,
                                     dtype_bytes=dtype_bytes, amp=amp,
                                     chip=chip)
    if guard_faults.is_corrupt_plan(plan):
        # A corrupted or stale cache entry (injected or real): ledger the
        # catch and fall through to the modeled plan below.
        guard_health.record("faults_caught")
        plan = None
    if plan is not None:
        d = MatmulDims(m=m, k=k, n=n, dtype_bytes=dtype_bytes, batch=batch)
        # Measured on the bucket representative; the actual dims can be up
        # to 2x larger per axis, so the budget is checked again.
        if plan.vmem_bytes(d, chip) <= int(amp * chip.vmem_bytes):
            return cost_matmul(d, plan, chip)
    return _plan_matmul_cached(m, k, n, dtype_bytes=dtype_bytes, amp=amp,
                               chip=chip, mode="skew_aware", batch=batch)


@functools.lru_cache(maxsize=4096)
def _plan_matmul_cached(m: int, k: int, n: int, *, dtype_bytes: int,
                        amp: float, chip: hw.ChipSpec, mode: str,
                        batch: int) -> MatmulCost:
    d = MatmulDims(m=m, k=k, n=n, dtype_bytes=dtype_bytes, batch=batch)
    budget = int(amp * chip.vmem_bytes)

    if mode == "naive":
        folded = dataclasses.replace(d, m=m * batch, batch=1)
        p = _clip_plan(BlockPlan(512, 512, 512), folded, chip, budget)
        return cost_matmul(folded, p, chip)

    schedules = ("k_inner",) if mode == "k_inner" else SCHEDULES
    best = _search(d, chip, budget, schedules)
    if mode == "skew_aware" and gemv_applicable(m, batch, chip):
        # Family switch: split-K wins iff it out-ranks the dense argmin
        # (dense wins exact ties — GEMV sits after SCHEDULES in the order).
        gemv = _search_gemv(d, chip, budget)
        if gemv is not None and (
                best is None or _plan_order(gemv) < _plan_order(best)):
            best = gemv
    if batch > 1:
        # The batched-grid kernel is K-inner only; residency schedules fold.
        batched = _search(d, chip, budget, ("k_inner",), batch_grid=True)
        if batched is not None and (
                best is None or _plan_order(batched) < _plan_order(best)):
            best = batched
    if best is None:
        # Budget too small for any aligned plan: the minimum-granule plan.
        best = cost_matmul(d, BlockPlan(chip.mxu_sublanes, chip.mxu_lanes,
                                        chip.mxu_lanes), chip)
    return best


def _naive_shard(devices: int, d: MatmulDims) -> ShardSpec:
    """The naive baseline's sharding: pure data parallelism, rows (batch
    folded) split as far as the divisors allow, never k or n."""
    best = ShardSpec()
    for s in shard_candidates(devices, d.m, d.k, d.n, d.batch):
        if s.k == 1 and s.n == 1 and s.m * s.batch > best.m * best.batch:
            best = s
    return best


@functools.lru_cache(maxsize=4096)
def _plan_matmul_sharded_cached(m: int, k: int, n: int, *, dtype_bytes: int,
                                amp: float, chip: hw.ChipSpec, mode: str,
                                batch: int, devices: int,
                                spec: ShardSpec | None) -> MatmulCost:
    """Joint (schedule x blocks x ShardSpec) argmin over `devices` chips.

    Every candidate sharding's per-device dims get the full block search
    (the batch-grid variant, and split-K at decode-scale local rows), each
    candidate is priced with its collective terms, and `_sharded_order`
    picks the winner.  An explicit `spec` pins the sharding.
    """
    d = MatmulDims(m=m, k=k, n=n, dtype_bytes=dtype_bytes, batch=batch)
    budget = int(amp * chip.vmem_bytes)

    if mode == "naive":
        # Fixed square blocks on the per-device shard of a fixed DP split.
        d = dataclasses.replace(d, m=m * batch, batch=1)
        s = spec if spec is not None else _naive_shard(devices, d)
        p = _clip_plan(BlockPlan(512, 512, 512), s.local_dims(d), chip,
                       budget)
        return cost_sharded_matmul(d, p, chip, s)

    specs = (spec,) if spec is not None else shard_candidates(
        devices, m, k, n, batch)
    schedules = ("k_inner",) if mode == "k_inner" else SCHEDULES
    best: MatmulCost | None = None

    def consider(local: MatmulCost, s: ShardSpec) -> None:
        nonlocal best
        if best is not None and local.total_s > best.total_s:
            # Exposed collective time is never negative, so the local cost
            # lower-bounds the sharded one (ties are still priced).
            return
        c = cost_sharded_matmul(d, local.plan, chip, s, local=local)
        if best is None or _sharded_order(c) < _sharded_order(best):
            best = c

    for s in specs:
        ld = s.local_dims(d)
        for local in _feasible_costs(ld, chip, budget, schedules):
            consider(local, s)
        if mode == "skew_aware" and gemv_applicable(ld.m, ld.batch, chip):
            for local in _gemv_costs(ld, chip, budget):
                consider(local, s)
        if ld.batch > 1 and mode != "k_inner":
            for local in _feasible_costs(ld, chip, budget, ("k_inner",),
                                         batch_grid=True):
                consider(local, s)
    if best is None:
        s = spec if spec is not None else ShardSpec()
        p = BlockPlan(chip.mxu_sublanes, chip.mxu_lanes, chip.mxu_lanes)
        best = cost_sharded_matmul(d, p, chip, s)
    return best


def _clip_plan(p: BlockPlan, d: MatmulDims, chip: hw.ChipSpec,
               budget: int) -> BlockPlan:
    bm = min(p.bm, _round_up(d.m, chip.mxu_sublanes))
    bk = min(p.bk, _round_up(d.k, chip.mxu_lanes))
    bn = min(p.bn, _round_up(d.n, chip.mxu_lanes))
    p = BlockPlan(bm, bk, bn)
    # halve the largest dim until it fits the budget
    while p.vmem_bytes(d, chip) > budget:
        if p.bk >= max(p.bm, p.bn) and p.bk > chip.mxu_lanes:
            p = BlockPlan(p.bm, p.bk // 2, p.bn)
        elif p.bn >= p.bm and p.bn > chip.mxu_lanes:
            p = BlockPlan(p.bm, p.bk, p.bn // 2)
        elif p.bm > chip.mxu_sublanes:
            p = BlockPlan(p.bm // 2, p.bk, p.bn)
        else:
            break
    return p


def sweep_aspect_ratios(total_elems: int, ratios: Iterable[float],
                        n_out: int = 4096, *, dtype_bytes: int = 2,
                        amp: float | None = None,
                        chip: hw.ChipSpec | str | None = None,
                        vary: str = "a_aspect") -> list[dict]:
    """The paper's Fig. 5 sweep, in two families.

    vary="a_aspect" (the paper's): A's two dims varied at constant A size,
    the output width fixed at n_out; ratio = m / contraction (< 1 is
    right-skewed, wide A).  vary="output": the output's aspect m / n
    varied at constant C size, the contraction fixed at n_out.

    One record per ratio: naive, K-inner-only and skew-aware roofline
    fractions, grid steps, bounds, the chosen schedule and blocks, and
    the winning `MatmulCost` (`planned_cost`).  amp / chip left as None
    resolve through the `mm_config` stack.
    """
    cfg = config.resolve(amp=amp, chip=chip)
    amp, chip = cfg.amp, cfg.chip_spec
    out = []
    for r in ratios:
        m = max(1, int(round(math.sqrt(total_elems * r))))
        other = max(1, int(round(math.sqrt(total_elems / r))))
        k, n = (n_out, other) if vary == "output" else (other, n_out)
        kw = dict(dtype_bytes=dtype_bytes, amp=amp, chip=chip)
        naive = plan_matmul(m, k, n, mode="naive", **kw)
        single = plan_matmul(m, k, n, mode="k_inner", **kw)
        planned = plan_matmul(m, k, n, mode="skew_aware", **kw)
        out.append(dict(
            chip=chip.name, ratio=r, m=m, k=k, n=n,
            naive_fraction=naive.roofline_fraction(chip),
            single_fraction=single.roofline_fraction(chip),
            planned_fraction=planned.roofline_fraction(chip),
            naive_grid=naive.grid_steps, planned_grid=planned.grid_steps,
            naive_bound=naive.bound, planned_bound=planned.bound,
            schedule=planned.plan.schedule,
            plan=(planned.plan.bm, planned.plan.bk, planned.plan.bn),
            planned_cost=planned,
        ))
    return out
