"""`LayoutSummary`: the hashable cost-model view of a block-sparse lhs.

`m`, `k` are the logical lhs dims; `gm`, `gk` the block-grid extents at
block shape (`bm`, `bk`); `nnz_blocks` the nonzero-block count; `s_max`
the padded per-row width (the grid extent along the sparse dimension).
`kind` is "bsr" for gather-indexed layouts or "block_diag" for the
grouped / MoE case (regular index maps, no gather penalty); `groups` is
the expert count for "block_diag".

A copy of the JAX package's `LayoutSummary`, field for field, so the cost
model and the planner price identically in both packages.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.costmodel import _ceil_div


@dataclasses.dataclass(frozen=True)
class LayoutSummary:
    """Hashable cost-model view of a block-sparse layout."""

    m: int
    k: int
    bm: int
    bk: int
    gm: int
    gk: int
    nnz_blocks: int
    s_max: int
    kind: str = "bsr"
    groups: int = 1

    def __post_init__(self):
        if self.kind not in ("bsr", "block_diag"):
            raise ValueError(f"unknown layout kind {self.kind!r}")
        if min(self.m, self.k, self.bm, self.bk, self.gm, self.gk) <= 0:
            raise ValueError(f"layout dims must be positive: {self}")
        if not 0 <= self.nnz_blocks <= self.gm * self.gk:
            raise ValueError(f"nnz_blocks {self.nnz_blocks} outside "
                             f"[0, {self.gm * self.gk}]")
        if not 1 <= self.s_max <= self.gk:
            raise ValueError(f"s_max {self.s_max} outside [1, {self.gk}]")

    @property
    def density(self) -> float:
        """Fraction of blocks present (1.0 = fully dense structure)."""
        return self.nnz_blocks / (self.gm * self.gk)

    @property
    def nnz_elems(self) -> int:
        """Upper bound on nonzero elements (edge blocks counted full)."""
        return min(self.nnz_blocks * self.bm * self.bk, self.m * self.k)

    @classmethod
    def balanced(cls, m: int, k: int, block: tuple[int, int],
                 density: float) -> "LayoutSummary":
        """Idealized uniform layout at a target density (for modeling):
        rows share the nonzero blocks evenly, s_max = ceil(nnz / gm)."""
        if not 0.0 < density <= 1.0:
            raise ValueError(f"density must be in (0, 1], got {density}")
        bm, bk = block
        gm, gk = _ceil_div(m, bm), _ceil_div(k, bk)
        nnz = min(gm * gk, max(1, round(density * gm * gk)))
        return cls(m=m, k=k, bm=bm, bk=bk, gm=gm, gk=gk, nnz_blocks=nnz,
                   s_max=min(gk, _ceil_div(nnz, gm)))

    @classmethod
    def block_diag(cls, groups: int, m_per: int, k_per: int,
                   block: tuple[int, int]) -> "LayoutSummary":
        """The grouped / MoE case: `groups` independent (m_per, k_per) lhs
        tiles on the diagonal of a conceptual (G*m_per, G*k_per) lhs.
        Density is 1/groups; every row block holds exactly its group's
        ceil(k_per / bk) column blocks (balanced, no gather)."""
        bm, bk = block
        gm_per, gk_per = _ceil_div(m_per, bm), _ceil_div(k_per, bk)
        return cls(m=groups * m_per, k=groups * k_per, bm=bm, bk=bk,
                   gm=groups * gm_per, gk=groups * gk_per,
                   nnz_blocks=groups * gm_per * gk_per, s_max=gk_per,
                   kind="block_diag", groups=groups)
