"""Grid-statistics ("vertex count") analogue of the paper's PopVision metrics.

The paper diagnoses the right-skew collapse by the number of vertices the
Poplar compiler emits (5542 / 5762 / 31743 for left / square / right skew
at equal FLOPs).  The analogue for a plan is its grid-step count beside
its tile utilization (useful / padded FLOPs).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import config, hw
from repro_torch.core.costmodel import MatmulDims
from repro_torch.core.planner import plan_matmul


@dataclasses.dataclass(frozen=True)
class VertexStats:
    dims: tuple[int, int, int]
    skew: float                  # log2(m/n); <0 = right-skewed
    vertex_count: int            # grid steps (paper: Poplar vertex count)
    tile_utilization: float      # useful/padded FLOPs (paper: Tile Utilisation)
    vmem_bytes: int
    bound: str
    roofline_fraction: float
    schedule: str | None = None  # chosen plan, for record provenance
    blocks: tuple[int, int, int] | None = None

    def plan_provenance(self) -> dict:
        """Plan fields in the shape benchmark records expect."""
        return {"schedule": self.schedule, "blocks": self.blocks,
                "grid_steps": self.vertex_count}

    def row(self) -> str:
        m, k, n = self.dims
        return (f"{m:>7}x{k:>6}x{n:>7}  skew={self.skew:+5.1f}  "
                f"vertices={self.vertex_count:>7}  "
                f"util={self.tile_utilization:5.3f}  "
                f"vmem={self.vmem_bytes / 2**10:8.1f}KiB  {self.bound:<13}  "
                f"frac={self.roofline_fraction:5.3f}")


def stats_for(m: int, k: int, n: int, *, dtype_bytes: int = 2,
              amp: float | None = None, mode: str | None = None,
              chip: hw.ChipSpec | str | None = None) -> VertexStats:
    """amp / mode / chip left as None resolve through the mm_config stack;
    `chip` also takes a registered name."""
    cfg = config.resolve(amp=amp, chip=chip, plan_mode=mode)
    chip = cfg.chip_spec
    cost = plan_matmul(m, k, n, dtype_bytes=dtype_bytes, amp=cfg.amp,
                       chip=chip, mode=cfg.plan_mode)
    d = MatmulDims(m, k, n, dtype_bytes=dtype_bytes)
    return VertexStats(
        dims=(m, k, n), skew=d.skew,
        vertex_count=cost.grid_steps,
        tile_utilization=cost.mxu_utilization,
        vmem_bytes=cost.vmem_bytes,
        bound=cost.bound,
        roofline_fraction=cost.roofline_fraction(chip),
        schedule=cost.plan.schedule,
        blocks=(cost.plan.bm, cost.plan.bk, cost.plan.bn),
    )


def paper_vertex_table(n_out: int = 4096, total: int = 4096 * 4096,
                       skews: tuple[float, ...] = (16.0, 1.0, 1 / 16.0),
                       mode: str | None = "naive") -> list[VertexStats]:
    """The paper's three-way vertex comparison (L / S / R skew): A's
    aspect m / contraction varied at constant A size; skew > 1 is left
    (tall A), < 1 right (wide A)."""
    out = []
    for r in skews:
        m = max(1, int(round(math.sqrt(total * r))))
        k = max(1, int(round(math.sqrt(total / r))))
        out.append(stats_for(m, k, n_out, mode=mode))
    return out
