"""Planned (skew-aware) matmul — the port's matmul primitive.

Every matmul in every model flows through `matmul()`.  It consults the
skew-aware planner and dispatches to one of two backends:

  * "cuda"  — the hand-written Hopper kernels in `repro_torch.kernels`
    (dense schedule family, batched grid, split-K GEMV), using the plan's
    blocks *and schedule*.  A CPU tensor runs the kernels' plain versions.
  * "torch" — fp32-accumulated ``torch.matmul`` plus the same epilogue:
    the reference rung, the counterpart of the JAX package's "xla".

Each call opens an `obs` dispatch span before planning (a no-op unless a
`trace_scope` is armed), so the plan span, the tune lookup and the
kernel wrapper all land on one span.

Configuration resolves through the `mm_config` stack (repro_torch.core.
config).  Fused epilogues are structured (`Epilogue`) or legacy token
strings.  ``with plan_capture() as log:`` collects the `MatmulCost` of
every matmul issued inside the block, and the `SparseMatmulCost` of every
grouped expert GEMM (captures nest).  Contractions that are not
(..., m, k) @ (k, n) go through `einsum_mm`, which logs an
`UnplannedContraction` marker so the captured workload is complete.
`enable_plan_log` / `plan_log` are a process-global capture.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

import torch

from repro_torch.core import config, epilogue as epilogue_mod, hw
from repro_torch.core.epilogue import Epilogue
from repro_torch.core.planner import plan_matmul
from repro_torch.obs import attribution as _obs

_ACTIVE_LOGS: list[list] = []
_LEGACY_LOG: list = []


@dataclasses.dataclass(frozen=True)
class UnplannedContraction:
    """Plan-log marker for a contraction the planner did not decompose
    (one per `einsum_mm` call).  Consumers that aggregate `MatmulCost`
    entries filter on isinstance."""

    spec: str
    a_shape: tuple[int, ...]
    b_shape: tuple[int, ...]
    dtype_bytes: int


def _deregister_log(log: list) -> None:
    # identity, not equality: two empty captures compare equal
    for i, entry in enumerate(_ACTIVE_LOGS):
        if entry is log:
            del _ACTIVE_LOGS[i]
            return


@contextlib.contextmanager
def plan_capture() -> Iterator[list]:
    """Collect the plan of every matmul issued inside the block."""
    log: list = []
    _ACTIVE_LOGS.append(log)
    try:
        yield log
    finally:
        _deregister_log(log)


def enable_plan_log(enabled: bool = True) -> None:
    """Start (cleared) or stop the process-global capture `plan_log`
    reads."""
    if enabled:
        _LEGACY_LOG.clear()
        if not any(entry is _LEGACY_LOG for entry in _ACTIVE_LOGS):
            _ACTIVE_LOGS.append(_LEGACY_LOG)
    else:
        _deregister_log(_LEGACY_LOG)


def plan_log() -> list:
    return list(_LEGACY_LOG)


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
    # The dispatch span opens *before* planning, so the tune lookup and the
    # planner annotate it (cache key, modeled_us); the ops wrapper below
    # joins it rather than opening a second one.
    with (_obs.dispatch("dense", m=m, k=k, n=n, batch=batch,
                        backend=cfg.backend, epilogue=str(ep.spec))
          if _obs.tracing() else _obs.dispatch("dense")) as dsp:
        cost = plan_matmul(m, k, n, dtype_bytes=a.element_size(),
                           amp=cfg.amp, chip=cfg.chip_spec,
                           mode=cfg.plan_mode, batch=batch,
                           mesh_shape=cfg.mesh_shape, sharding=cfg.sharding)
        record_plan(cost)
        odt = cfg.out_dtype or a.dtype

        if cfg.backend == "cuda":
            # Imported here: kernels.ops -> sparse -> core would otherwise
            # make `import repro_torch.sparse` (before core) a cycle.
            from repro_torch.kernels import ops

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
                out = ops.skew_matmul(a2, b,
                                      epilogue=ep.replace(residual=res), **kw)
            return out.reshape(*lead, m, n)

        # "torch" backend: fp32 accumulation + fp32 epilogue, one cast.
        # This *is* the ladder's reference rung, selected by config rather
        # than by degradation — attributed as such.
        def ref_run() -> torch.Tensor:
            z = torch.matmul(a.float(), b.float())
            z = epilogue_mod.apply_spec(z, ep.spec, ep.operands())
            return z.to(odt)

        _obs.annotate("dispatch", rung="reference", rung_index=3,
                      kernel="torch_matmul")
        return _obs.measured(dsp, ref_run)


def einsum_mm(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum for the few contractions that are not (..., m, k) @ (k, n):
    fp32 sums (``torch.einsum`` on fp32 copies), cast back to a's dtype.
    Each call records an `UnplannedContraction` so `plan_capture()` sees
    the whole workload."""
    record_plan(UnplannedContraction(
        spec=spec, a_shape=tuple(a.shape), b_shape=tuple(b.shape),
        dtype_bytes=a.element_size()))
    return torch.einsum(spec, a.float(), b.float()).to(a.dtype)
