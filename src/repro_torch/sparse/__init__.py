"""Grouped (block-diagonal) matmul planning for the MoE expert GEMMs.

* `repro_torch.sparse.layout`    — `LayoutSummary`, the hashable
  cost-model view of a block structure (`balanced`, `block_diag`).
* `repro_torch.sparse.costmodel` — the dense cost model with traffic and
  FLOPs scaled by the structure's nonzero blocks (`cost_sparse_matmul`).
* `repro_torch.sparse.planner`   — `plan_grouped_matmul`, the per-group
  (bm, bk, bn) search under the AMP budget.

The grouped kernel itself lives in `repro_torch.kernels.grouped_matmul`
and its planned entry in `repro_torch.kernels.ops.grouped_matmul`.  The
BSR structure (`BlockSparseLayout`), its kernels and `plan_sparse_matmul`
are not ported yet.
"""

from repro_torch.sparse.costmodel import SparseMatmulCost, cost_sparse_matmul
from repro_torch.sparse.layout import LayoutSummary
from repro_torch.sparse.planner import plan_grouped_matmul

__all__ = ["LayoutSummary", "SparseMatmulCost", "cost_sparse_matmul",
           "plan_grouped_matmul"]
