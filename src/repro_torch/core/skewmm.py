"""Planned (skew-aware) matmul — the port's matmul primitive.

Every matmul in every model flows through `matmul()`.  It consults the
skew-aware planner and dispatches to one of two backends:

  * "cuda"  — the hand-written Hopper kernels in `repro_torch.kernels`
    (dense schedule family, batched grid, split-K GEMV), using the plan's
    blocks *and schedule*.  A CPU tensor runs the kernels' plain versions.
  * "torch" — fp32-accumulated ``torch.matmul`` plus the same epilogue:
    the reference rung, the counterpart of the JAX package's "xla".

Configuration resolves through the `mm_config` stack (repro_torch.core.
config).  Fused epilogues are structured (`Epilogue`) or legacy token
strings.  ``with plan_capture() as log:`` collects the `MatmulCost` of
every matmul issued inside the block, and the `SparseMatmulCost` of every
grouped expert GEMM (captures nest).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

from repro_torch.core import config, epilogue as epilogue_mod, hw
from repro_torch.core.epilogue import Epilogue
from repro_torch.core.planner import plan_matmul
from repro_torch.kernels import ops

_ACTIVE_LOGS: list[list] = []


@contextlib.contextmanager
def plan_capture() -> Iterator[list]:
    """Collect the plan of every matmul issued inside the block."""
    log: list = []
    _ACTIVE_LOGS.append(log)
    try:
        yield log
    finally:
        for i, entry in enumerate(_ACTIVE_LOGS):
            if entry is log:
                del _ACTIVE_LOGS[i]
                break


def record_plan(cost) -> None:
    """Append a plan to every active capture.  `ops.grouped_matmul` records
    its grouped plans here, so a capture sees the whole workload."""
    for log in _ACTIVE_LOGS:
        log.append(cost)


def matmul(a: torch.Tensor, b: torch.Tensor, *, backend: str | None = None,
           amp: float | None = None, plan_mode: str | None = None,
           chip: hw.ChipSpec | str | None = None,
           epilogue: Epilogue | str | None = None,
           bias: torch.Tensor | None = None,
           residual: torch.Tensor | None = None,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """C[..., m, n] = epilogue(A[..., m, k] @ B[k, n]), skew-planned.

    Leading batch dims of `a` either fold into m or ride in the grid as a
    batched-grid plan.  `b` may be any strided 2-D view (e.g. a transposed
    embedding): the kernels take its strides, so no copy is made.
    """
    if b.ndim != 2:
        raise ValueError(f"rhs must be 2-D (weights), got {tuple(b.shape)}")
    *lead, m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")

    cfg = config.resolve(backend=backend, amp=amp, plan_mode=plan_mode,
                         chip=chip, out_dtype=out_dtype)
    ep = Epilogue.parse(epilogue, bias=bias, residual=residual)

    batch = 1
    for s in lead:
        batch *= s
    cost = plan_matmul(m, k, n, dtype_bytes=a.element_size(), amp=cfg.amp,
                       chip=cfg.chip_spec, mode=cfg.plan_mode, batch=batch)
    record_plan(cost)
    odt = cfg.out_dtype or a.dtype

    if cfg.backend == "cuda":
        kw = dict(plan=cost.plan, out_dtype=odt, chip=cfg.chip_spec)
        res = ep.residual
        if cost.plan.batch_grid and lead:
            a3 = a.reshape(batch, m, k)
            if res is not None:
                res = res.expand(*lead, m, n).reshape(batch, m, n)
            out = ops.skew_matmul_batched(
                a3, b, epilogue=ep.replace(residual=res), **kw)
        else:
            a2 = a.reshape(batch * m, k)
            if res is not None:
                res = res.expand(*lead, m, n).reshape(batch * m, n)
            out = ops.skew_matmul(a2, b, epilogue=ep.replace(residual=res),
                                  **kw)
        return out.reshape(*lead, m, n)

    # "torch" backend: fp32 accumulation + fp32 epilogue, one cast.
    z = torch.matmul(a.float(), b.float())
    z = epilogue_mod.apply_spec(z, ep.spec, ep.operands())
    return z.to(odt)

