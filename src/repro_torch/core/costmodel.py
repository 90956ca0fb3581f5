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
instead of folding it into m.

Split-K's working set on `gpu_h100`: the reference charges pass 2 with
the whole (gk, bm, bn) fp32 partial slab.  The port's reduce kernel (K4,
`kernels/gemv_splitk.py`) stages only a strip of W output columns of
every split, W sized to the card's shared memory (`_reduce_stage_bytes`),
so on the chips of `SPLITK_STRIP_SMEM` pass 2 counts that strip.  The
four reference chips keep the reference's term, plans and seconds.

Sharded costing prices the per-device shard of a `ShardSpec` plus its
collective wire terms (`collective_terms`, `cost_sharded_matmul`).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import hw

SCHEDULES = ("k_inner", "a_resident", "b_resident")
GEMV_SCHEDULES = ("splitk",)
ALL_SCHEDULES = SCHEDULES + GEMV_SCHEDULES

# Chips whose split-K reduce stages a strip of the partial slab in shared
# memory instead of holding it whole: name -> the shared-memory bytes a
# block of the reduce may use (K4's `SMEM_MAX`).
SPLITK_STRIP_SMEM = {"gpu_h100": 232_448}
_STRIP_MAX_W = 256


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

    @property
    def skew(self) -> float:
        """Paper-style skew: log2(rows/n), rows including the batch dim.
        <0 right-skewed, >0 left-skewed."""
        return math.log2(self.batch * self.m / self.n)


def _reduce_stage_bytes(gk: int, acc_bytes: int, smem: int) -> int:
    """Shared memory K4 stages to fold a gk-deep slab: gk x W partials, W
    the largest multiple of 4 up to 256 whose strip fits `smem`.  Past
    the depth at which not even 4 columns fit, whole levels are first
    folded through device memory (halving the depth) until a strip does
    (mirrors `kernels.gemv_splitk.reduce_strip`)."""
    while True:
        w = min(_STRIP_MAX_W, smem // (acc_bytes * gk)) // 4 * 4
        if w:
            return gk * w * acc_bytes
        gk = (gk + 1) // 2


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

    def vmem_bytes(self, d: MatmulDims,
                   chip: hw.ChipSpec | None = None) -> int:
        """Working set per block, with double-buffered streamed blocks.

        k_inner holds the C block as an fp32 accumulator; the resident
        schedules accumulate through the revisited output block (fp32-wide
        while gk > 1, output width when the contraction fits one k block).
        Split-K takes the wider of its two passes; pass 2 is the whole
        partial slab, or on a chip of `SPLITK_STRIP_SMEM` the strip its
        reduce stages.
        """
        gk = _ceil_div(d.k, self.bk)
        a = self.bm * self.bk * d.dtype_bytes
        b = self.bk * self.bn * d.dtype_bytes
        if self.schedule == "splitk":
            pass1 = 2 * (a + b) + self.bm * self.bn * d.acc_bytes
            smem = SPLITK_STRIP_SMEM.get(chip.name) if chip else None
            if smem is not None:
                pass2 = _reduce_stage_bytes(gk, d.acc_bytes, smem)
            else:
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
class ShardSpec:
    """How one matmul's dims are split across a device mesh.

    `m`/`k`/`n`/`batch` are shard counts per logical dim; their product is
    the device count the spec occupies.  Per-device dims are the ceil-div
    shards (`local_dims`).  Collectives (the SPMD reading):

      n > 1   — A is stored sharded across the n-group and all-gathered
                before the column-parallel matmul.
      zero3   — B is stored sharded over the (m x batch) data group and
                all-gathered per use (off by default: weights resident).
      k > 1   — each device holds a partial C; `partials` picks
                "all_reduce" (2x wire, output replicated) or
                "reduce_scatter" (1x wire, output stays sharded).

    Frozen and hashable, so it rides in `mm_config` layers and the
    planner's cache keys.
    """

    m: int = 1
    k: int = 1
    n: int = 1
    batch: int = 1
    partials: str = "all_reduce"
    zero3: bool = False

    def __post_init__(self):
        for f in ("m", "k", "n", "batch"):
            v = getattr(self, f)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"ShardSpec.{f} must be a positive int, "
                                 f"got {v!r}")
        if self.partials not in ("all_reduce", "reduce_scatter"):
            raise ValueError(f"ShardSpec.partials must be 'all_reduce' or "
                             f"'reduce_scatter', got {self.partials!r}")

    @property
    def devices(self) -> int:
        return self.m * self.k * self.n * self.batch

    def local_dims(self, d: MatmulDims) -> MatmulDims:
        """The per-device shard of the problem (ceil-div per dim)."""
        return dataclasses.replace(
            d, m=_ceil_div(d.m, self.m), k=_ceil_div(d.k, self.k),
            n=_ceil_div(d.n, self.n), batch=_ceil_div(d.batch, self.batch))

    def describe(self) -> str:
        s = f"m{self.m}k{self.k}n{self.n}b{self.batch}"
        if self.k > 1:
            s += f"/{self.partials}"
        if self.zero3:
            s += "/zero3"
        return s


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
    # Sharded terms (defaults on a single chip).  `dims` is always the
    # per-device problem; `global_dims` the unsharded one under a spec.
    sharding: ShardSpec | None = None
    global_dims: MatmulDims | None = None
    collective_bytes: int = 0     # total wire bytes per device
    collective_s: float = 0.0     # exposed (un-hidden) collective seconds
    hidden_collective_s: float = 0.0  # wire time overlapped with compute

    @property
    def total_s(self) -> float:
        return (max(self.compute_s, self.memory_s) + self.overhead_s
                + self.collective_s)

    @property
    def achieved_flops(self) -> float:
        return self.dims.flops / self.total_s

    def roofline_fraction(self, chip: hw.ChipSpec) -> float:
        return self.achieved_flops / hw.peak_flops(chip, self.dims.dtype_bytes)

    @property
    def bound(self) -> str:
        busy = max(self.compute_s, self.memory_s)
        if self.collective_s > busy and self.collective_s > self.overhead_s:
            return "collective"
        if self.overhead_s > busy:
            return "grid-overhead"
        return "compute" if self.compute_s >= self.memory_s else "memory"

    def plan_provenance(self) -> dict:
        """The chosen plan as a flat record-friendly dict (the fields
        `bench.record.Provenance` carries); sharded plans also name their
        ShardSpec."""
        p = self.plan
        out = {"schedule": p.schedule, "blocks": (p.bm, p.bk, p.bn),
               "batch_grid": p.batch_grid, "grid_steps": self.grid_steps}
        if self.sharding is not None:
            out["sharding"] = self.sharding.describe()
        return out

    def explain(self) -> str:
        d, p = self.dims, self.plan
        batch = f" batch={d.batch}{'(grid)' if p.batch_grid else '(fold)'}" \
            if d.batch > 1 else ""
        shard = ""
        if self.sharding is not None:
            shard = (f" shard={self.sharding.describe()} "
                     f"coll={self.collective_s * 1e6:.1f}us"
                     f"(+{self.hidden_collective_s * 1e6:.1f}us hidden)")
        return (
            f"mm {d.m}x{d.k}x{d.n}{batch} plan ({p.bm},{p.bk},{p.bn}) "
            f"sched={p.schedule} "
            f"grid={self.grid_steps} vmem={self.vmem_bytes / 2**10:.1f}KiB "
            f"compute={self.compute_s * 1e6:.1f}us "
            f"memory={self.memory_s * 1e6:.1f}us "
            f"overhead={self.overhead_s * 1e6:.1f}us bound={self.bound} "
            f"mxu_util={self.mxu_utilization:.3f}{shard}"
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
        hbm_bytes=hbm_bytes, vmem_bytes=p.vmem_bytes(d, chip),
        grid_steps=steps,
        mxu_utilization=mxu_utilization,
    )


# ------------------------------------------------------- sharded execution
# Fraction of hideable wire time the async-collective pipeline hides (the
# first window's transfer and each window's issue cost stay exposed).
OVERLAP_EFFICIENCY = 0.8


@dataclasses.dataclass(frozen=True)
class CollectiveTerms:
    """Per-device wire traffic for one sharded matmul, term by term."""

    gather_a_bytes: int           # ring all-gather of A over the n-group
    gather_b_bytes: int           # ZeRO-3 all-gather of B over (m x batch)
    partials_bytes: int           # reduce-scatter / all-reduce of partial C
    hideable_s: float             # wire seconds the schedule can overlap
    total_s: float                # wire seconds before any overlap

    @property
    def total_bytes(self) -> int:
        return self.gather_a_bytes + self.gather_b_bytes + self.partials_bytes


def _ring_wire(local_bytes: int, group: int, factor: float = 1.0) -> int:
    """Per-device wire bytes of a ring collective over `group` devices:
    (group-1)/group of the local payload (factor 1: all-gather /
    reduce-scatter; factor 2: all-reduce)."""
    if group <= 1:
        return 0
    return int(factor * (group - 1) * local_bytes // group)


def collective_terms(d: MatmulDims, p: BlockPlan, chip: hw.ChipSpec,
                     spec: ShardSpec) -> CollectiveTerms:
    """Wire traffic + overlap potential for plan `p` under `spec`.

    `d` is the *global* problem; payloads are the per-device shards.  A
    transfer is hideable when the kernel's grid makes progress on chunks
    of the gathered operand as they arrive:

      gather A — hidden unless the schedule sweeps m innermost
        (b_resident) or does not block m (splitk, gm == 1);
      gather B — hidden unless n is innermost (a_resident) or gn == 1;
      partials — a reduce-scatter streams behind the next window; an
        all-reduce is a barrier and is never hidden.
    """
    ld = spec.local_dims(d)
    gm, gn, gk = p.grid(ld)
    dt, acc = d.dtype_bytes, d.acc_bytes
    ici_bw = chip.ici_bw_per_link * chip.ici_links

    a_local = ld.batch * ld.m * ld.k * dt
    gather_a = _ring_wire(a_local, spec.n)
    b_local = ld.k * ld.n * dt
    data_group = spec.m * spec.batch
    gather_b = _ring_wire(b_local, data_group) if spec.zero3 else 0
    c_partial = ld.batch * ld.m * ld.n * acc
    factor = 2.0 if spec.partials == "all_reduce" else 1.0
    partials = _ring_wire(c_partial, spec.k, factor)

    gather_a_s = gather_a / ici_bw
    gather_b_s = gather_b / ici_bw
    partials_s = partials / ici_bw
    hideable = 0.0
    if gm > 1 and p.schedule not in ("b_resident", "splitk"):
        hideable += gather_a_s
    if gn > 1 and p.schedule != "a_resident":
        hideable += gather_b_s
    if gk > 1 and spec.partials == "reduce_scatter":
        hideable += partials_s
    return CollectiveTerms(
        gather_a_bytes=gather_a, gather_b_bytes=gather_b,
        partials_bytes=partials, hideable_s=hideable,
        total_s=gather_a_s + gather_b_s + partials_s)


def cost_sharded_matmul(d: MatmulDims, p: BlockPlan, chip: hw.ChipSpec,
                        spec: ShardSpec, *,
                        local: MatmulCost | None = None) -> MatmulCost:
    """Evaluate plan `p` for the per-device shard of `d` under `spec`.

    The cost's `dims` are the local shard (so roofline fractions stay
    per-chip numbers), `global_dims` the unsharded problem.  Exposed
    collective time is the wire time minus the part the schedule hides
    behind its own busy time, so a sharded plan never prices below the
    same plan on its local shard.  `local` passes an already-priced local
    cost.
    """
    if local is None:
        local = cost_matmul(spec.local_dims(d), p, chip)
    coll = collective_terms(d, p, chip, spec)
    busy = max(local.compute_s, local.memory_s)
    hidden = min(coll.hideable_s, busy) * OVERLAP_EFFICIENCY
    return dataclasses.replace(
        local, sharding=spec, global_dims=d,
        collective_bytes=coll.total_bytes,
        collective_s=coll.total_s - hidden,
        hidden_collective_s=hidden)
