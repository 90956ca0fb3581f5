"""Block-sparse layouts: `LayoutSummary`, the hashable cost-model view of a
block-sparse lhs, and `BlockSparseLayout`, its BSR structure.

`m`, `k` are the logical lhs dims; `gm`, `gk` the block-grid extents at
block shape (`bm`, `bk`); `nnz_blocks` the nonzero-block count; `s_max`
the padded per-row width (the grid extent along the sparse dimension).
`kind` is "bsr" for gather-indexed layouts or "block_diag" for the
grouped / MoE case (regular index maps, no gather penalty); `groups` is
the expert count for "block_diag".

A copy of the JAX package's `LayoutSummary`, field for field, so the cost
model and the planner price identically in both packages.  The row
structure of `BlockSparseLayout` is CSR-flavoured but padded to a
rectangle: row block i owns ``cols[i, :nnz[i]]``; ``s_max`` is the padded
row width.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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


@dataclasses.dataclass(frozen=True, eq=False)
class BlockSparseLayout:
    """BSR-style block structure of an (m, k) lhs.

    ``cols[i, :nnz[i]]`` are the sorted, unique column-block indices of
    row block i; the tail of each padded row repeats 0 and is skipped by
    the kernel through the `nnz` validity test.  Rows with no nonzero
    blocks are legal (their output rows are epilogue(0)).  The operand
    itself stays dense; blocks absent from the layout are exact zeros to
    every consumer.  A copy of the JAX package's layout: the same
    validation, views and constructors, so the same arguments give the
    same `cols` / `nnz`.
    """

    shape: tuple[int, int]
    block_shape: tuple[int, int]
    cols: np.ndarray
    nnz: np.ndarray

    def __post_init__(self):
        m, k = self.shape
        bm, bk = self.block_shape
        if min(m, k, bm, bk) <= 0:
            raise ValueError(f"shape {self.shape} / block_shape "
                             f"{self.block_shape} must be positive")
        cols = np.ascontiguousarray(np.asarray(self.cols, np.int32))
        nnz = np.ascontiguousarray(np.asarray(self.nnz, np.int32))
        gm, gk = _ceil_div(m, bm), _ceil_div(k, bk)
        if cols.ndim != 2 or cols.shape[0] != gm:
            raise ValueError(f"cols must be (gm={gm}, s_max), got "
                             f"{cols.shape}")
        if cols.shape[1] < 1 or cols.shape[1] > gk:
            raise ValueError(f"padded row width {cols.shape[1]} outside "
                             f"[1, gk={gk}]")
        if nnz.shape != (gm,):
            raise ValueError(f"nnz must be ({gm},), got {nnz.shape}")
        if nnz.min(initial=0) < 0 or nnz.max(initial=0) > cols.shape[1]:
            raise ValueError("nnz entries outside [0, s_max]")
        for i in range(gm):
            row = cols[i, :nnz[i]]
            if row.size and (row.min() < 0 or row.max() >= gk
                             or np.any(np.diff(row) <= 0)):
                raise ValueError(f"row {i}: column blocks must be sorted, "
                                 f"unique and within [0, {gk})")
        object.__setattr__(self, "cols", cols)
        object.__setattr__(self, "nnz", nnz)
        object.__setattr__(self, "_on_device", {})

    # ------------------------------------------------------------- views
    @property
    def gm(self) -> int:
        return _ceil_div(self.shape[0], self.block_shape[0])

    @property
    def gk(self) -> int:
        return _ceil_div(self.shape[1], self.block_shape[1])

    @property
    def s_max(self) -> int:
        return int(self.cols.shape[1])

    @property
    def nnz_total(self) -> int:
        return int(self.nnz.sum())

    @property
    def density(self) -> float:
        return self.nnz_total / (self.gm * self.gk)

    def block_mask(self) -> np.ndarray:
        """(gm, gk) bool: which blocks are present."""
        mask = np.zeros((self.gm, self.gk), bool)
        for i in range(self.gm):
            mask[i, self.cols[i, :self.nnz[i]]] = True
        return mask

    def element_mask(self) -> np.ndarray:
        """(m, k) bool: the elementwise footprint (oracle mask)."""
        bm, bk = self.block_shape
        full = np.kron(self.block_mask(), np.ones((bm, bk), bool))
        return full[:self.shape[0], :self.shape[1]]

    def device_tensors(self, device) -> tuple:
        """(cols, nnz) as int32 tensors on `device`, uploaded once per
        device and kept on the layout, so a timing loop never measures a
        host-to-device copy of the index tables."""
        import torch

        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        found = self._on_device.get(dev)
        if found is None:
            found = (torch.from_numpy(self.cols).to(dev),
                     torch.from_numpy(self.nnz).to(dev))
            self._on_device[dev] = found
        return found

    def summary(self) -> LayoutSummary:
        return LayoutSummary(m=self.shape[0], k=self.shape[1],
                             bm=self.block_shape[0], bk=self.block_shape[1],
                             gm=self.gm, gk=self.gk,
                             nnz_blocks=self.nnz_total, s_max=self.s_max)

    # ------------------------------------------------------ constructors
    @classmethod
    def from_block_mask(cls, mask, block_shape: tuple[int, int],
                        shape: tuple[int, int] | None = None
                        ) -> "BlockSparseLayout":
        """Layout from a (gm, gk) boolean block mask.  `shape` defaults to
        the exact block multiple; pass the logical (m, k) when the last
        row / column blocks are partial."""
        mask = np.asarray(mask, bool)
        if mask.ndim != 2:
            raise ValueError(f"block mask must be 2-D, got {mask.shape}")
        gm, gk = mask.shape
        bm, bk = block_shape
        if shape is None:
            shape = (gm * bm, gk * bk)
        nnz = mask.sum(axis=1).astype(np.int32)
        s_max = max(1, int(nnz.max(initial=0)))
        cols = np.zeros((gm, s_max), np.int32)
        for i in range(gm):
            idx = np.nonzero(mask[i])[0]
            cols[i, :idx.size] = idx
        return cls(shape=tuple(shape), block_shape=tuple(block_shape),
                   cols=cols, nnz=nnz)

    @classmethod
    def from_mask(cls, mask, block_shape: tuple[int, int]
                  ) -> "BlockSparseLayout":
        """Layout from an elementwise (m, k) mask: a block is present iff
        any element in it is True."""
        mask = np.asarray(mask, bool)
        if mask.ndim != 2:
            raise ValueError(f"mask must be 2-D, got {mask.shape}")
        m, k = mask.shape
        bm, bk = block_shape
        gm, gk = _ceil_div(m, bm), _ceil_div(k, bk)
        padded = np.zeros((gm * bm, gk * bk), bool)
        padded[:m, :k] = mask
        blocks = padded.reshape(gm, bm, gk, bk).any(axis=(1, 3))
        return cls.from_block_mask(blocks, block_shape, shape=(m, k))

    @classmethod
    def dense(cls, m: int, k: int, block_shape: tuple[int, int]
              ) -> "BlockSparseLayout":
        """The fully-dense structure (density 1.0), the parity anchor."""
        bm, bk = block_shape
        gm, gk = _ceil_div(m, bm), _ceil_div(k, bk)
        return cls.from_block_mask(np.ones((gm, gk), bool), block_shape,
                                   shape=(m, k))

    @classmethod
    def random(cls, m: int, k: int, block_shape: tuple[int, int],
               density: float, seed: int = 0) -> "BlockSparseLayout":
        """Uniform random structure with an exact nonzero-block count
        (``round(density * gm * gk)``, min 1), the benchmarking
        generator: numpy's ``default_rng(seed)``, as in the JAX package."""
        if not 0.0 < density <= 1.0:
            raise ValueError(f"density must be in (0, 1], got {density}")
        bm, bk = block_shape
        gm, gk = _ceil_div(m, bm), _ceil_div(k, bk)
        n_cells = gm * gk
        n_pick = min(n_cells, max(1, round(density * n_cells)))
        rng = np.random.default_rng(seed)
        flat = rng.choice(n_cells, size=n_pick, replace=False)
        mask = np.zeros(n_cells, bool)
        mask[flat] = True
        return cls.from_block_mask(mask.reshape(gm, gk), block_shape,
                                   shape=(m, k))
