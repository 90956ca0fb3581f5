"""Public wrappers for the planned-matmul kernels, the block-sparse matmul,
the grouped expert GEMM, flash attention, the RG-LRU scan and the Mamba-2
SSD scan.

The wrappers take plans from the skew-aware planner when none is given
(amp / chip resolve through the `mm_config` stack), clip the plan's blocks
to the granule-rounded problem dims (granules read from the chip), and
dispatch to the kernel family the plan's schedule names.  Operands are
never padded: the kernels mask ragged edges themselves.

A CUDA tensor always reaches the hand-written kernel; a kernel error
raises — nothing falls back to the reference.  A CPU tensor runs the
kernels' plain versions.  The guard ladder and obs spans of the JAX
package's ops are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.core import config
from repro_torch.core import skewmm as _skewmm
from repro_torch.core.costmodel import BlockPlan
from repro_torch.core.epilogue import Epilogue
from repro_torch.core.planner import plan_matmul
from repro_torch.kernels import block_sparse_matmul as _bsr
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gemv_splitk as _gemv
from repro_torch.kernels import grouped_matmul as _gmm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rglru_scan as _rglru
from repro_torch.kernels import skew_matmul as _mm
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.sparse.costmodel import SparseMatmulCost
from repro_torch.sparse.planner import plan_grouped_matmul, plan_sparse_matmul


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def clip_blocks(p: BlockPlan, m: int, k: int, n: int,
                chip) -> tuple[int, int, int]:
    """The plan's blocks clipped to the granule-rounded problem dims."""
    sub, lane = chip.mxu_sublanes, chip.mxu_lanes
    return (min(p.bm, _round_up(m, sub)), min(p.bk, _round_up(k, lane)),
            min(p.bn, _round_up(n, lane)))


def skew_matmul(a: torch.Tensor, b: torch.Tensor, *,
                plan: BlockPlan | None = None, amp: float | None = None,
                chip=None, epilogue: Epilogue | str | None = None,
                bias: torch.Tensor | None = None,
                residual: torch.Tensor | None = None,
                out_dtype=None) -> torch.Tensor:
    """Planned blocked matmul.  a (m, k) @ b (k, n) -> (m, n).

    The plan's `schedule` selects the kernel: k_inner / a_resident /
    b_resident (the dense family) or splitk (the two-pass GEMV family).
    """
    m, k = a.shape
    n = b.shape[1]
    cfg = config.resolve(amp=amp, chip=chip)
    ep = Epilogue.parse(epilogue, bias=bias, residual=residual)
    odt = out_dtype or a.dtype
    if plan is None:
        plan = plan_matmul(m, k, n, dtype_bytes=a.element_size(),
                           amp=cfg.amp, chip=cfg.chip_spec).plan
    bm, bk, bn = clip_blocks(plan, m, k, n, cfg.chip_spec)
    if plan.schedule == "splitk":
        # m is never blocked: the whole granule-rounded row count rides in
        # every block.
        pbm = _round_up(m, cfg.chip_spec.mxu_sublanes)
        return _gemv.gemv_splitk(a, b, ep.bias, ep.residual, bm=pbm, bk=bk,
                                 bn=bn, epilogue=ep.spec, out_dtype=odt)
    return _mm.skew_matmul(a, b, ep.bias, ep.residual, bm=bm, bk=bk, bn=bn,
                           schedule=plan.schedule, epilogue=ep.spec,
                           out_dtype=odt)


def skew_matmul_batched(a: torch.Tensor, b: torch.Tensor, *,
                        plan: BlockPlan | None = None,
                        amp: float | None = None, chip=None,
                        epilogue: Epilogue | str | None = None,
                        bias: torch.Tensor | None = None,
                        residual: torch.Tensor | None = None,
                        out_dtype=None) -> torch.Tensor:
    """Batched-grid matmul.  a (nb, m, k) @ b (k, n) -> (nb, m, n)."""
    nb, m, k = a.shape
    n = b.shape[1]
    cfg = config.resolve(amp=amp, chip=chip)
    ep = Epilogue.parse(epilogue, bias=bias, residual=residual)
    odt = out_dtype or a.dtype
    if plan is None:
        plan = plan_matmul(m, k, n, dtype_bytes=a.element_size(),
                           amp=cfg.amp, chip=cfg.chip_spec, batch=nb).plan
    bm, bk, bn = clip_blocks(plan, m, k, n, cfg.chip_spec)
    return _mm.skew_matmul_batched(a, b, ep.bias, ep.residual, bm=bm, bk=bk,
                                   bn=bn, epilogue=ep.spec, out_dtype=odt)


def sparse_matmul(a: torch.Tensor, b: torch.Tensor, layout, *,
                  plan: BlockPlan | SparseMatmulCost | None = None,
                  amp: float | None = None, chip=None,
                  epilogue: Epilogue | str | None = None,
                  bias: torch.Tensor | None = None,
                  residual: torch.Tensor | None = None,
                  out_dtype=None) -> torch.Tensor:
    """Planned block-sparse matmul.  sparse(a (m, k)) @ b (k, n) -> (m, n).

    `layout` is a `BlockSparseLayout` over `a`: blocks absent from it are
    exact zeros (never read).  The kernel tiles on the layout's block
    shape; without a plan the sparsity-aware planner chooses (schedule,
    bn) under the `mm_config`-resolved budget and mode, and the plan is
    recorded into `plan_capture()`.  An explicit plan whose (bm, bk)
    differ from the layout block raises.  K9 on a CUDA tensor, its plain
    version on a CPU tensor.
    """
    m, k = a.shape
    n = b.shape[1]
    if tuple(layout.shape) != (m, k):
        raise ValueError(f"layout shape {layout.shape} != lhs shape "
                         f"{(m, k)}")
    cfg = config.resolve(amp=amp, chip=chip)
    ep = Epilogue.parse(epilogue, bias=bias, residual=residual)
    bm, bk = layout.block_shape
    odt = out_dtype or a.dtype
    if isinstance(plan, SparseMatmulCost):
        plan = plan.plan
    if plan is not None and (plan.bm, plan.bk) != (bm, bk):
        raise ValueError(f"plan blocks ({plan.bm}, {plan.bk}) must match "
                         f"the layout block shape ({bm}, {bk})")
    if plan is None:
        cost = plan_sparse_matmul(layout.summary(), n,
                                  dtype_bytes=a.element_size(), amp=cfg.amp,
                                  chip=cfg.chip_spec)
        _skewmm.record_plan(cost)
        plan = cost.plan
    bn = min(plan.bn, _round_up(n, cfg.chip_spec.mxu_lanes))
    return _bsr.block_sparse_matmul(a, b, layout, ep.bias, ep.residual,
                                    bn=bn, schedule=plan.schedule,
                                    epilogue=ep.spec, out_dtype=odt)


def grouped_matmul(a: torch.Tensor, b: torch.Tensor, *,
                   plan: BlockPlan | SparseMatmulCost | None = None,
                   backend: str | None = None, amp: float | None = None,
                   chip=None, epilogue: Epilogue | str | None = None,
                   residual: torch.Tensor | None = None,
                   out_dtype=None) -> torch.Tensor:
    """Grouped matmul with per-group rhs.  a (g, m, k) @ b (g, k, n).

    The MoE expert-GEMM entry.  Without an explicit plan it plans through
    `plan_grouped_matmul` and records the plan into `plan_capture()` on
    either backend, as the JAX package does.  Backend "torch" runs the
    oracle `grouped_matmul_ref`; "cuda" runs K5 on a CUDA tensor (its
    plain version on a CPU tensor) at the plan's blocks clipped to the
    granule-rounded dims.  The epilogue takes scale / act / residual; a
    bias raises.
    """
    g, m, k = a.shape
    g2, k2, n = b.shape
    if g != g2 or k != k2:
        raise ValueError(f"group/contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    cfg = config.resolve(backend=backend, amp=amp, chip=chip)
    ep = Epilogue.parse(epilogue, residual=residual)
    if ep.bias is not None:
        raise ValueError("grouped_matmul epilogue supports scale / act / "
                         "residual; bias is not plumbed per-group")
    odt = out_dtype or a.dtype
    if plan is None:
        cost = plan_grouped_matmul(g, m, k, n, dtype_bytes=a.element_size(),
                                   amp=cfg.amp, chip=cfg.chip_spec)
        _skewmm.record_plan(cost)
        plan = cost.plan
    elif isinstance(plan, SparseMatmulCost):
        plan = plan.plan
    if cfg.backend == "torch":
        return _ref.grouped_matmul_ref(a, b, epilogue=ep, out_dtype=odt)
    bm, bk, bn = clip_blocks(plan, m, k, n, cfg.chip_spec)
    return _gmm.grouped_matmul(a, b, ep.residual, bm=bm, bk=bk, bn=bn,
                               epilogue=ep.spec, out_dtype=odt)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float = 0.0, scale: float | None = None,
                    bq: int | None = None,
                    bkv: int | None = None) -> torch.Tensor:
    """Prefill attention.  q (B, Hq, S, D), k / v (B, Hkv, S, D) ->
    (B, Hq, S, D): K7 on a CUDA tensor, its plain version on a CPU tensor.
    Rows and columns are positions 0..S-1.  Tiles default to the kernel's
    choice for the head dim (`flash_attention.tiles`); S need not divide
    them."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale, bq=bq, bkv=bkv)


def rglru_scan(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
               a_param: torch.Tensor, *, c: float = 8.0,
               return_state: bool = False):
    """The RG-LRU scan.  x, r_gate, i_gate (B, L, D) pre-sigmoid logits,
    a_param (D,): K6 on a CUDA tensor, its plain version on a CPU tensor.
    With ``return_state`` also the fp32 state after the last step."""
    return _rglru.rglru_scan(x, r_gate, i_gate, a_param, c=c,
                             return_state=return_state)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor, *, chunk: int = 128,
             return_state: bool = False):
    """The Mamba-2 SSD scan.  x (B, L, H, P), dt (B, L, H) fp32, a_log
    (H,), B / C (B, L, G, S): K8 on a CUDA tensor, its plain version on a
    CPU tensor.  Any L; with ``return_state`` also the fp32 state after the
    last position, (B, H, S, P)."""
    return _ssd.ssd_scan(x, dt, a_log, b_mat, c_mat, chunk=chunk,
                         return_state=return_state)


def _counters() -> tuple:
    return (_mm.LAUNCHES, _gemv.LAUNCHES, _gmm.LAUNCHES, _fa.LAUNCHES,
            _rglru.LAUNCHES, _ssd.LAUNCHES, _bsr.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Launches of every kernel since the last reset."""
    out = {f"skew_matmul_{s}": 0 for s in _mm.SCHEDULE_IDS}
    out.update({f"block_sparse_matmul_{s}": 0 for s in _bsr.SCHEDULE_IDS})
    for name in ("skew_matmul_batched", "gemv_splitk_partial",
                 "gemv_splitk_reduce", "grouped_matmul", "flash_attention",
                 "rglru_scan", "ssd_scan"):
        out[name] = 0
    for counter in _counters():
        out.update(counter)
    return out


def reset_launch_counts() -> None:
    for counter in _counters():
        counter.clear()
