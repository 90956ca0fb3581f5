"""Analytic cost model for a blocked matmul plan on a tiled accelerator.

The paper observes that achieved matmul throughput is governed by the
*work-decomposition plan* (its "vertex count") under a hard fast-memory
budget (the AMP knob).  This is the JAX package's model, term for term, so
the four reference chips price identically in both packages:

  time(plan) = max(compute_term, memory_term) + grid_overhead_term

  compute_term  — MAC throughput over *padded* block volumes (granules)
  memory_term   — device-memory traffic implied by the schedule's block
                  re-visit pattern
  grid_overhead — per-grid-step cost (the right-skew vertex blowup)

On `gpu_h100` one block is one CTA tile and the "VMEM" working set reads as
the CTA's shared memory (see `hw.GPU_H100`).

Schedules (the loop orders `kernels.skew_matmul` implements):

  "k_inner"    — K innermost, output-stationary fp32 accumulator.  A
                 re-streamed per n-block, B per m-block, C written once.
  "a_resident" — N innermost.  The A block stays resident across the n
                 sweep (streamed once); C is revisited per k-block at fp32
                 width when gk > 1.  Wins for right-skewed (m << n) shapes.
  "b_resident" — M innermost; the mirror image.  Wins for left-skewed
                 shapes.

The GEMV family (`GEMV_SCHEDULES`) covers the decode regime:

  "splitk"     — two-pass split-K: fp32 partial products over (k_splits,
                 n), then a tree reduce of the partials with the epilogue
                 applied once.  Compute runs at
                 `chip.gemv_splitk_frac * gs/(gs+1)` of peak.

A plan may put a leading batch dimension in the grid (`batch_grid=True`)
instead of folding it into m.  Sharded costing (`ShardSpec`, collective
terms) is not ported yet.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import hw

SCHEDULES = ("k_inner", "a_resident", "b_resident")
GEMV_SCHEDULES = ("splitk",)
ALL_SCHEDULES = SCHEDULES + GEMV_SCHEDULES


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _ceil_div(a, b) * b


@dataclasses.dataclass(frozen=True)
class MatmulDims:
    """Problem A[batch, m, k] @ B[k, n] = C[batch, m, n]."""

    m: int
    k: int
    n: int
    dtype_bytes: int = 2          # operand/output element width
    acc_bytes: int = 4            # accumulator width (fp32 accumulation)
    batch: int = 1

    @property
    def flops(self) -> int:
        return 2 * self.batch * self.m * self.k * self.n


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """A work-decomposition plan: block shape + loop order (schedule)."""

    bm: int
    bk: int
    bn: int
    schedule: str = "k_inner"
    batch_grid: bool = False

    def grid(self, d: MatmulDims) -> tuple[int, int, int]:
        m = d.m if self.batch_grid else d.m * d.batch
        return (_ceil_div(m, self.bm), _ceil_div(d.n, self.bn),
                _ceil_div(d.k, self.bk))

    def grid_steps(self, d: MatmulDims) -> int:
        gm, gn, gk = self.grid(d)
        steps = gm * gn * gk
        if self.schedule == "splitk":
            steps += gm * gn
        return steps * d.batch if self.batch_grid else steps

    def vmem_bytes(self, d: MatmulDims) -> int:
        """Working set per block, with double-buffered streamed blocks.

        k_inner holds the C block as an fp32 accumulator; the resident
        schedules accumulate through the revisited output block (fp32-wide
        while gk > 1, output width when the contraction fits one k block).
        """
        gk = _ceil_div(d.k, self.bk)
        a = self.bm * self.bk * d.dtype_bytes
        b = self.bk * self.bn * d.dtype_bytes
        if self.schedule == "splitk":
            pass1 = 2 * (a + b) + self.bm * self.bn * d.acc_bytes
            pass2 = (gk * self.bm * self.bn * d.acc_bytes
                     + 2 * self.bm * self.bn * d.dtype_bytes)
            return max(pass1, pass2)
        if self.schedule == "k_inner":
            c = self.bm * self.bn * d.acc_bytes
        else:
            c_width = d.acc_bytes if gk > 1 else d.dtype_bytes
            c = 2 * self.bm * self.bn * c_width
        return 2 * (a + b) + c


@dataclasses.dataclass(frozen=True)
class MatmulCost:
    dims: MatmulDims
    plan: BlockPlan
    compute_s: float
    memory_s: float
    overhead_s: float
    hbm_bytes: int
    vmem_bytes: int
    grid_steps: int
    mxu_utilization: float        # useful / padded FLOPs

    @property
    def total_s(self) -> float:
        return max(self.compute_s, self.memory_s) + self.overhead_s

    @property
    def bound(self) -> str:
        busy = max(self.compute_s, self.memory_s)
        if self.overhead_s > busy:
            return "grid-overhead"
        return "compute" if self.compute_s >= self.memory_s else "memory"

    def explain(self) -> str:
        d, p = self.dims, self.plan
        batch = f" batch={d.batch}{'(grid)' if p.batch_grid else '(fold)'}" \
            if d.batch > 1 else ""
        return (
            f"mm {d.m}x{d.k}x{d.n}{batch} plan ({p.bm},{p.bk},{p.bn}) "
            f"sched={p.schedule} "
            f"grid={self.grid_steps} vmem={self.vmem_bytes / 2**10:.1f}KiB "
            f"compute={self.compute_s * 1e6:.1f}us "
            f"memory={self.memory_s * 1e6:.1f}us "
            f"overhead={self.overhead_s * 1e6:.1f}us bound={self.bound} "
            f"mxu_util={self.mxu_utilization:.3f}"
        )


def _schedule_traffic(d: MatmulDims, p: BlockPlan,
                      gm: int, gn: int, gk: int) -> int:
    """Device-memory bytes implied by the schedule's block re-visit pattern.

      k_inner:    A x gn,  B x gm*nb,  C written once at output width.
      a_resident: A x 1,   B x gm*nb,  C revisited gk times (fp32
                  read-modify-write; single output-width write when gk == 1).
      b_resident: A x gn,  B x 1,      C as in a_resident.
      splitk:     A x gn,  B x 1,      fp32 partials written + read back,
                  C written once.
    """
    nb = d.batch
    a_elems = nb * d.m * d.k
    b_elems = d.k * d.n
    c_elems = nb * d.m * d.n
    dt = d.dtype_bytes
    if p.schedule == "splitk":
        a_bytes = a_elems * gn * dt
        b_bytes = b_elems * dt
        c_bytes = 2 * gk * c_elems * d.acc_bytes + c_elems * dt
        return a_bytes + b_bytes + c_bytes
    if p.schedule == "a_resident":
        a_bytes = a_elems * dt
        b_bytes = b_elems * gm * nb * dt
    elif p.schedule == "b_resident":
        a_bytes = a_elems * gn * dt
        b_bytes = b_elems * dt
    else:  # k_inner
        a_bytes = a_elems * gn * dt
        b_bytes = b_elems * gm * nb * dt
    if p.schedule == "k_inner" or gk == 1:
        c_bytes = c_elems * dt
    else:
        c_bytes = 2 * gk * c_elems * d.acc_bytes + c_elems * dt
    return a_bytes + b_bytes + c_bytes


def cost_matmul(d: MatmulDims, p: BlockPlan,
                chip: hw.ChipSpec = hw.GPU_H100) -> MatmulCost:
    """Evaluate a block plan against the chip model."""
    gm, gn, gk = p.grid(d)
    nb = d.batch if p.batch_grid else 1
    m_eff = d.m if p.batch_grid else d.m * d.batch

    # ---- compute term: padded blocks (sublane granule on m, lanes on k/n).
    pbm = _round_up(p.bm, chip.mxu_sublanes)
    pbk = _round_up(p.bk, chip.mxu_lanes)
    pbn = _round_up(p.bn, chip.mxu_lanes)
    padded_flops = 2 * nb * (gm * pbm) * (gk * pbk) * (gn * pbn)
    row_fill = min(1.0, pbm / chip.mxu_lanes)
    if p.schedule == "splitk":
        frac = min(1.0, chip.gemv_splitk_frac * gk / (gk + 1))
        eff_peak = hw.peak_flops(chip, d.dtype_bytes) * frac
    else:
        eff_peak = hw.peak_flops(chip, d.dtype_bytes) * max(
            row_fill, 1.0 / chip.mxu_lanes * 8)
    compute_s = padded_flops / eff_peak
    mxu_utilization = d.flops / padded_flops

    # ---- memory term: schedule-dependent block re-visit traffic.
    deff = dataclasses.replace(d, m=m_eff, batch=nb)
    hbm_bytes = _schedule_traffic(deff, p, gm, gn, gk)
    memory_s = hbm_bytes / chip.hbm_bw

    # ---- grid overhead: the "vertex count" term.
    steps = nb * gm * gn * gk
    if p.schedule == "splitk":
        steps += nb * gm * gn
    overhead_s = steps * chip.grid_step_overhead_s

    return MatmulCost(
        dims=d, plan=p,
        compute_s=compute_s, memory_s=memory_s, overhead_s=overhead_s,
        hbm_bytes=hbm_bytes, vmem_bytes=p.vmem_bytes(d), grid_steps=steps,
        mxu_utilization=mxu_utilization,
    )
