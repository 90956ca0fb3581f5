"""Hardware models + the chip registry.

The four reference chips (tpu_v5e, ipu_gc200, gpu_a30, gpu_rtx2080ti) are
copied unchanged from the JAX package, so the port's planner returns the
same plans and modeled seconds for them.  `gpu_h100` is the port's own
target and its default chip.

H100 planning decision: one plan block is one CTA tile.  `vmem_bytes` is
the shared memory a block may use (232,448 bytes), so with the default
AMP of 0.45 a plan claims at most ~104 KB of it, and the granules follow
the tensor-core tile (64 rows, 64-wide k/n).  Every plan the planner
returns for the H100 is then launchable by the hand-written kernels in
`repro_torch.kernels`, and the planner's schedule really is the kernel's
loop order.

Chips live in a name registry (`register_chip` / `get_chip` / `list_chips`)
so every API that takes a `ChipSpec` also takes a registered name string —
the cross-device comparison the paper runs (IPU GC200 vs RTX 2080 Ti) is
then a config/CLI axis (`mm_config(chip="ipu_gc200")`, `--chip gpu_a30`)
rather than an import.  Out-of-tree chips register the same way.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_bf16_flops: float      # FLOP/s per chip, bf16 matmul w/ fp32 accum
    peak_fp32_flops: float      # FLOP/s per chip for fp32 matmul (3-pass emulation)
    hbm_bw: float               # bytes/s
    ici_bw_per_link: float      # bytes/s per ICI link
    vmem_bytes: int             # usable VMEM per core (fast on-chip memory)
    # Number of inter-chip links per chip.  Aggregate interconnect
    # bandwidth is always `ici_bw_per_link * ici_links` — collective cost
    # terms (costmodel.ShardSpec, roofline.analyze, launch.costprobe)
    # price wire bytes against that product, never against a hardcoded
    # link count.  The GC200 has 10 IPU-Links, not the 4 the old
    # "per-link = aggregate/4" convention implied.
    ici_links: int = 4
    mxu_lanes: int = 128        # systolic array minor dim (lane granularity)
    mxu_sublanes: int = 8       # fp32 sublane granularity
    hbm_bytes: int = 16 * 1024**3
    # Per-grid-step scheduling/DMA-issue overhead.  This is the TPU analogue of
    # the paper's per-vertex overhead: plans with pathological grid sizes (the
    # "31743 vertices" right-skew blowup) pay this linearly.
    grid_step_overhead_s: float = 120e-9
    # Achieved fraction of peak compute and streamed bandwidth under
    # block-gathered (BSR) execution — index maps chasing a nonzero-block
    # table instead of a regular stride.  This is the knob behind the
    # PopSparse-style sparse-vs-dense crossover density: chips with
    # uniform-latency on-chip memory (the GC200) barely pay for gather,
    # cache-budgeted GPUs pay the most.  Regular-structure grouped
    # (block-diagonal) kernels do not pay it.
    sparse_gather_frac: float = 0.7
    # Achieved fraction of peak compute for the split-K GEMV family: tiny-m
    # GEMMs re-expressed as K-parallel partial products plus a tree
    # reduction.  The systolic array still runs a sublane-high operand, but
    # spreading K across the grid recovers the tile/vertex parallelism the
    # M dimension cannot feed (Jia et al. 2019's reduction-tree reading of
    # the IPU fabric).  Uniform-latency SRAM chips recover the most; HBM
    # chips are memory-bound at these shapes anyway, so the knob rarely
    # decides for them.
    gemv_splitk_frac: float = 0.25

    @property
    def ici_bw(self) -> float:
        """Aggregate interconnect bytes/s (per-link bandwidth x link count)."""
        return self.ici_bw_per_link * self.ici_links


# ----------------------------------------------------------------- registry
_CHIPS: dict[str, ChipSpec] = {}


def register_chip(spec: ChipSpec, *, aliases: tuple[str, ...] = ()
                  ) -> ChipSpec:
    """Register a chip under its name (+ optional aliases), return it.

    Re-registering a name replaces the entry (latest wins), so downstream
    users can shadow a built-in spec with corrected numbers.
    """
    for name in (spec.name, *aliases):
        _CHIPS[name.lower()] = spec
    return spec


def get_chip(chip: ChipSpec | str) -> ChipSpec:
    """Resolve a chip argument: ChipSpec passes through, str is looked up."""
    if isinstance(chip, ChipSpec):
        return chip
    if isinstance(chip, str):
        try:
            return _CHIPS[chip.lower()]
        except KeyError:
            raise KeyError(f"unknown chip {chip!r}; registered chips: "
                           f"{list_chips()}") from None
    raise TypeError(f"chip must be a ChipSpec or a registered name, "
                    f"got {type(chip).__name__}")


def list_chips() -> list[str]:
    return sorted(_CHIPS)


TPU_V5E = register_chip(ChipSpec(
    name="tpu_v5e",
    peak_bf16_flops=197e12,
    peak_fp32_flops=197e12 / 4,   # bf16x3-style emulation; fp32 is not MXU-native
    hbm_bw=819e9,
    ici_bw_per_link=50e9,
    ici_links=4,                 # 2-D torus: 4 ICI links per chip
    # Conservative usable VMEM figure; the planner only ever claims
    # amp * vmem_bytes of it (AMP = the paper's availableMemoryProportion knob).
    vmem_bytes=64 * 1024**2,
    sparse_gather_frac=0.7,
    gemv_splitk_frac=0.25,
), aliases=("v5e",))

# The paper's chips, kept for the comparison benchmarks (modeled numbers).
IPU_GC200 = register_chip(ChipSpec(
    name="ipu_gc200",
    peak_bf16_flops=62.5e12,     # GC200 quotes fp16.16 AMP peak ~250; fp32 62.5
    peak_fp32_flops=62.5e12,
    hbm_bw=47.5e12,              # aggregate In-Processor SRAM bandwidth
    # 10 IPU-Links at 32 GB/s each (320 GB/s aggregate).  The old entry
    # stored aggregate/4 under an implied 4-link convention; collective
    # terms now multiply by the honest link count instead.
    ici_bw_per_link=32e9,
    ici_links=10,
    vmem_bytes=918 * 1024**2,    # all memory is on-chip
    grid_step_overhead_s=600e-9, # vertex scheduling is costlier on Poplar
    # Uniform-latency In-Processor SRAM: block gather is nearly free —
    # PopSparse's observation that the IPU tolerates sparsity at much
    # higher density than cache-hierarchy devices.
    sparse_gather_frac=0.9,
    # 1472 tiles of uniform-latency SRAM: split-K partials land on-chip and
    # the AMP decomposition already expresses K-parallel vertex trees, so
    # the GEMV family recovers most of the fabric at m of a few rows.
    gemv_splitk_frac=0.6,
), aliases=("gc200",))

GPU_A30 = register_chip(ChipSpec(
    name="gpu_a30",
    peak_bf16_flops=165e12,
    peak_fp32_flops=10.3e12,
    hbm_bw=933e9,
    ici_bw_per_link=50e9,        # NVLink3: 4 links x 50 GB/s (200 GB/s agg)
    ici_links=4,
    # Planner-visible fast memory on a GPU is the L2 (24 MB on GA100-class
    # A30): blocks that fit amp * L2 stream from HBM once, like the
    # VMEM-resident blocks they model.
    vmem_bytes=24 * 1024**2,
    grid_step_overhead_s=0.0,
    sparse_gather_frac=0.6,
    gemv_splitk_frac=0.35,
), aliases=("a30",))

# The paper's GPU baseline for the skew comparison (Fig. 5): turing-class
# RTX 2080 Ti — 13.45 TFLOP/s fp32, 107 TFLOP/s fp16 tensor-core peak,
# 616 GB/s GDDR6, 5.5 MB L2, 11 GB device memory.
GPU_RTX2080TI = register_chip(ChipSpec(
    name="gpu_rtx2080ti",
    peak_bf16_flops=107e12,
    peak_fp32_flops=13.45e12,
    hbm_bw=616e9,
    ici_bw_per_link=50e9,        # NVLink2 bridge: 2 links x 50 GB/s
    ici_links=2,                 # (~100 GB/s aggregate)
    vmem_bytes=int(5.5 * 1024**2),
    hbm_bytes=11 * 1024**3,
    grid_step_overhead_s=0.0,
    # Turing-class GDDR6 + small L2: gathered block streams pay the
    # steepest per-chip discount here (lowest gather efficiency of the
    # zoo; the modeled crossover d* also depends on how memory-bound the
    # dense baseline is, so it is not ordered by this knob alone).
    sparse_gather_frac=0.55,
    gemv_splitk_frac=0.35,
), aliases=("rtx2080ti", "rtx_2080ti"))

# The port's target: NVIDIA H100 SXM5 (data-sheet figures, dense, no
# sparsity).  fp32 is the non-tensor-core rate: the port's fp32 kernels run
# true IEEE fp32, never TF32.  NVLink4: 18 links, 25 GB/s each way per link
# (450 GB/s each way in all).  Plan blocks are CTA tiles (see module
# docstring): budget = amp x per-block shared memory, 64-wide granules.
GPU_H100 = register_chip(ChipSpec(
    name="gpu_h100",
    peak_bf16_flops=989e12,
    peak_fp32_flops=67e12,
    hbm_bw=3.35e12,
    ici_bw_per_link=25e9,
    ici_links=18,
    vmem_bytes=232_448,
    mxu_lanes=64,
    mxu_sublanes=64,
    hbm_bytes=80 * 1024**3,
    grid_step_overhead_s=0.0,
    sparse_gather_frac=0.6,
    gemv_splitk_frac=0.35,
), aliases=("h100",))


def peak_flops(chip: ChipSpec | str, dtype_bytes: int) -> float:
    """Peak matmul FLOP/s for an element width (2 = bf16, 4 = fp32)."""
    chip = get_chip(chip)
    return chip.peak_bf16_flops if dtype_bytes <= 2 else chip.peak_fp32_flops
