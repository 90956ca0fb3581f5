"""Block-sparse and grouped matmul planning.

* `repro_torch.sparse.layout`    — `BlockSparseLayout`, the BSR structure
  of an lhs, and `LayoutSummary`, its hashable cost-model view
  (`balanced`, `block_diag`).
* `repro_torch.sparse.costmodel` — the dense cost model with traffic and
  FLOPs scaled by the structure's nonzero blocks (`cost_sparse_matmul`).
* `repro_torch.sparse.planner`   — `plan_sparse_matmul` (the (schedule, bn)
  search on a layout), `plan_grouped_matmul` (the per-group (bm, bk, bn)
  search), their top-K enumerators for the autotuner and
  `crossover_density`.

The kernels live in `repro_torch.kernels.block_sparse_matmul` (K9) and
`repro_torch.kernels.grouped_matmul` (K5); their planned entries are
`repro_torch.kernels.ops.sparse_matmul` / `ops.grouped_matmul`.
"""

from repro_torch.sparse.costmodel import SparseMatmulCost, cost_sparse_matmul
from repro_torch.sparse.layout import BlockSparseLayout, LayoutSummary
from repro_torch.sparse.planner import (crossover_density,
                                        enumerate_grouped_plans,
                                        enumerate_sparse_plans,
                                        plan_grouped_matmul,
                                        plan_sparse_matmul)

__all__ = ["BlockSparseLayout", "LayoutSummary", "SparseMatmulCost",
           "cost_sparse_matmul", "crossover_density",
           "enumerate_grouped_plans", "enumerate_sparse_plans",
           "plan_grouped_matmul", "plan_sparse_matmul"]
