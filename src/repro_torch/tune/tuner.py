"""Measured plan selection: time the modeled top-K candidates, keep the winner.

The cost model ranks candidate (schedule, blocks) plans; this module
*times* the best K of them and records the empirical winner as a
`TuneEntry`.  The modeled argmin is always among the timed candidates, so
the recorded ``speedup`` (measured time of the modeled plan over measured
time of the winner) is >= 1 by construction and ``agreement`` flags the
cases where measurement confirms the model.

Measurement is injected through the `Measurer` seam:

* `wallclock_measurer` — builds the operands, pins the candidate plan and
  times the call with `repro_torch.bench.timing.measure` (CUDA events on
  the card, every call waited for);
* `modeled_measurer(chip)` — the cost model's own prediction, optionally
  re-costed under another `ChipSpec` (a "synthetic host"): pure
  arithmetic, bit-deterministic, no operands built.

A measurer is called as ``measurer(candidate, make_bench, iters=...,
repeats=...)`` where `make_bench` is a zero-argument thunk producing
``(fn, args)``.  The benches run on the card unless the `tune_*` call is
given ``device="cpu"``; with no card they raise (`resolve_device`).
Inputs are ones, as in the JAX package: the products stay exact in bf16
and fp32.
"""

from __future__ import annotations

from typing import Any, Callable, Protocol, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.bench.timing import Timing, measure
from repro_torch.core import config, hw
from repro_torch.core.costmodel import MatmulCost, cost_matmul
from repro_torch.core.planner import enumerate_plans
from repro_torch.sparse.costmodel import SparseMatmulCost, cost_sparse_matmul
from repro_torch.sparse.layout import BlockSparseLayout, LayoutSummary
from repro_torch.sparse.planner import (enumerate_grouped_plans,
                                        enumerate_sparse_plans)
from repro_torch.tune import cache as tune_cache
from repro_torch.tune.shapeclass import ShapeClass, bucket_dim, decode_classes

Candidate = Any  # MatmulCost | SparseMatmulCost
MakeBench = Callable[[], tuple[Callable, tuple]]


class Measurer(Protocol):
    def __call__(self, candidate: Candidate, make_bench: MakeBench, *,
                 iters: int, repeats: int) -> Timing: ...


def remodel(candidate: Candidate, chip: hw.ChipSpec) -> Candidate:
    """Re-evaluate a candidate's cost under a different chip model."""
    if isinstance(candidate, MatmulCost):
        return cost_matmul(candidate.dims, candidate.plan, chip)
    if isinstance(candidate, SparseMatmulCost):
        return cost_sparse_matmul(candidate.layout, candidate.n,
                                  candidate.plan, chip,
                                  dtype_bytes=candidate.dtype_bytes)
    raise TypeError(f"cannot remodel {type(candidate).__name__}")


def wallclock_measurer(candidate: Candidate, make_bench: MakeBench, *,
                       iters: int, repeats: int) -> Timing:
    """Real timing through `bench.timing.measure`."""
    del candidate  # the bench thunk already has the plan pinned
    fn, args = make_bench()
    return measure(fn, *args, iters=iters, repeats=repeats)


def modeled_measurer(chip: hw.ChipSpec | str | None = None) -> Measurer:
    """Deterministic measurer: the cost model's prediction as the "host".
    With `chip` given, candidates are re-costed under that spec; with None
    the measurement *is* the model, so selection reproduces the modeled
    argmin exactly."""
    spec = None if chip is None else hw.get_chip(chip)

    def _measure(candidate: Candidate, make_bench: MakeBench, *, iters: int,
                 repeats: int) -> Timing:
        del make_bench  # never build operands on the modeled path
        c = candidate if spec is None else remodel(candidate, spec)
        return Timing(median_us=c.total_s * 1e6, iqr_us=0.0,
                      repeats=repeats, iters=iters)

    return _measure


# -------------------------------------------------------------- selection
def _select_entry(key: str, kind: str, chip: hw.ChipSpec, dtype_bytes: int,
                  amp: float, candidates: Sequence[Candidate],
                  bench_for: Callable[[Candidate], MakeBench],
                  measurer: Measurer, iters: int,
                  repeats: int) -> tune_cache.TuneEntry:
    """Time every candidate, return the winner as a cache entry.
    `candidates` are modeled-best-first; ties in measured time break
    toward the modeled order, so a measurement that cannot tell two plans
    apart never overrides the model."""
    if not candidates:
        raise ValueError("no candidate plans to tune over")
    measured = [measurer(c, bench_for(c), iters=iters,
                         repeats=repeats).us_per_call for c in candidates]
    win_i = min(range(len(candidates)), key=lambda i: (measured[i], i))
    winner = candidates[win_i]
    p, bp = winner.plan, candidates[0].plan
    return tune_cache.TuneEntry(
        key=key, kind=kind, chip=chip.name, dtype_bytes=dtype_bytes, amp=amp,
        schedule=p.schedule, blocks=(p.bm, p.bk, p.bn),
        batch_grid=p.batch_grid, measured_us=measured[win_i],
        modeled_us=winner.total_s * 1e6,
        modeled_best_schedule=bp.schedule,
        modeled_best_blocks=(bp.bm, bp.bk, bp.bn),
        modeled_best_measured_us=measured[0], agreement=win_i == 0,
        speedup=measured[0] / measured[win_i],
        provenance=tune_cache.entry_provenance(iters, repeats))


def _dtype(dtype_bytes: int) -> torch.dtype:
    return {2: torch.bfloat16, 4: torch.float32}.get(dtype_bytes,
                                                     torch.float32)


# ------------------------------------------------------------------ dense
def tune_dense(m: int, k: int, n: int, *, batch: int = 1,
               dtype_bytes: int = 2, amp: float | None = None,
               chip: hw.ChipSpec | str | None = None, top: int = 8,
               iters: int = 1, repeats: int = 3,
               measurer: Measurer = wallclock_measurer,
               device=None) -> tune_cache.TuneEntry:
    """Tune the shape class of A[batch, m, k] @ B[k, n], return the entry.
    The bucket representative (power-of-two floor per dim) is measured, so
    one entry answers every shape in the class."""
    cfg = config.resolve(amp=amp, chip=chip)
    chip, amp = cfg.chip_spec, cfg.amp
    cls = ShapeClass.of(m, k, n, batch)
    candidates = enumerate_plans(cls.m, cls.k, cls.n,
                                 dtype_bytes=dtype_bytes, amp=amp, chip=chip,
                                 batch=cls.batch, top=top)

    def bench_for(cost: MatmulCost) -> MakeBench:
        def make_bench():
            from repro_torch.kernels import ops

            dev = resolve_device(device)
            dtype = _dtype(dtype_bytes)
            plan = cost.plan
            b = torch.ones((cls.k, cls.n), dtype=dtype, device=dev)
            if cls.batch > 1 and plan.batch_grid:
                a = torch.ones((cls.batch, cls.m, cls.k), dtype=dtype,
                               device=dev)
                return (lambda x, y: ops.skew_matmul_batched(x, y, plan=plan),
                        (a, b))
            a = torch.ones((cls.batch * cls.m, cls.k), dtype=dtype,
                           device=dev)
            return (lambda x, y: ops.skew_matmul(x, y, plan=plan, chip=chip),
                    (a, b))

        return make_bench

    return _select_entry(tune_cache.dense_key(chip.name, dtype_bytes, amp,
                                              cls),
                         "dense", chip, dtype_bytes, amp, candidates,
                         bench_for, measurer, iters, repeats)


def tune_decode(k: int, n: int, *, dtype_bytes: int = 2,
                amp: float | None = None,
                chip: hw.ChipSpec | str | None = None, top: int = 8,
                iters: int = 1, repeats: int = 3,
                measurer: Measurer = wallclock_measurer,
                device=None) -> list[tune_cache.TuneEntry]:
    """Tune the decode-shape GEMV classes for one (K, N) weight: one
    `tune_dense` run per m in `shapeclass.GEMV_M_CLASSES`.  The candidate
    sets include the split-K family where it applies."""
    return [tune_dense(cls.m, cls.k, cls.n, dtype_bytes=dtype_bytes, amp=amp,
                       chip=chip, top=top, iters=iters, repeats=repeats,
                       measurer=measurer, device=device)
            for cls in decode_classes(k, n)]


# ----------------------------------------------------------------- sparse
def tune_sparse(layout: BlockSparseLayout | LayoutSummary, n: int, *,
                dtype_bytes: int = 2, amp: float | None = None,
                chip: hw.ChipSpec | str | None = None, top: int = 8,
                iters: int = 1, repeats: int = 3,
                measurer: Measurer = wallclock_measurer,
                device=None) -> tune_cache.TuneEntry:
    """Tune sparse(A) @ B for one exact layout structure.

    Entries are keyed on the full `LayoutSummary`; only the rhs width `n`
    is bucketed.  Timing needs a concrete `BlockSparseLayout`; given only a
    summary, a random structure at the summary's density is drawn for the
    bench (the candidate costs still use the exact summary).
    """
    summary = layout.summary() if hasattr(layout, "summary") else layout
    cfg = config.resolve(amp=amp, chip=chip)
    chip, amp = cfg.chip_spec, cfg.amp
    n_rep = bucket_dim(n)
    candidates = enumerate_sparse_plans(summary, n_rep,
                                        dtype_bytes=dtype_bytes, amp=amp,
                                        chip=chip, top=top)
    concrete = layout if isinstance(layout, BlockSparseLayout) else None

    def bench_for(cost: SparseMatmulCost) -> MakeBench:
        def make_bench():
            from repro_torch.kernels import ops

            nonlocal concrete
            dev = resolve_device(device)
            if concrete is None:
                concrete = BlockSparseLayout.random(
                    summary.m, summary.k, (summary.bm, summary.bk),
                    summary.density)
            dtype = _dtype(dtype_bytes)
            a = torch.ones((summary.m, summary.k), dtype=dtype, device=dev)
            b = torch.ones((summary.k, n_rep), dtype=dtype, device=dev)
            plan = cost.plan
            return (lambda x, y: ops.sparse_matmul(x, y, concrete, plan=plan,
                                                   chip=chip),
                    (a, b))

        return make_bench

    return _select_entry(tune_cache.sparse_key(chip.name, dtype_bytes, amp,
                                               summary, n),
                         "sparse", chip, dtype_bytes, amp, candidates,
                         bench_for, measurer, iters, repeats)


# ---------------------------------------------------------------- grouped
def tune_grouped(groups: int, m: int, k: int, n: int, *,
                 dtype_bytes: int = 2, amp: float | None = None,
                 chip: hw.ChipSpec | str | None = None, top: int = 8,
                 iters: int = 1, repeats: int = 3,
                 measurer: Measurer = wallclock_measurer,
                 device=None) -> tune_cache.TuneEntry:
    """Tune `groups` independent A[m, k] @ B[k, n] expert GEMMs."""
    cfg = config.resolve(amp=amp, chip=chip)
    chip, amp = cfg.chip_spec, cfg.amp
    cls = ShapeClass.of(m, k, n)
    candidates = enumerate_grouped_plans(groups, cls.m, cls.k, cls.n,
                                         dtype_bytes=dtype_bytes, amp=amp,
                                         chip=chip, top=top)

    def bench_for(cost: SparseMatmulCost) -> MakeBench:
        def make_bench():
            from repro_torch.kernels import ops

            dev = resolve_device(device)
            dtype = _dtype(dtype_bytes)
            a = torch.ones((groups, cls.m, cls.k), dtype=dtype, device=dev)
            b = torch.ones((groups, cls.k, cls.n), dtype=dtype, device=dev)
            plan = cost.plan
            return (lambda x, y: ops.grouped_matmul(x, y, plan=plan,
                                                    backend="cuda",
                                                    chip=chip),
                    (a, b))

        return make_bench

    return _select_entry(tune_cache.grouped_key(chip.name, dtype_bytes, amp,
                                                groups, cls),
                         "grouped", chip, dtype_bytes, amp, candidates,
                         bench_for, measurer, iters, repeats)
