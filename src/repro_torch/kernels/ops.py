"""Public wrappers for the planned-matmul kernels.

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
from repro_torch.core.costmodel import BlockPlan
from repro_torch.core.epilogue import Epilogue
from repro_torch.core.planner import plan_matmul
from repro_torch.kernels import gemv_splitk as _gemv
from repro_torch.kernels import skew_matmul as _mm


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


def launch_counts() -> dict[str, int]:
    """Launches of every planned-matmul kernel since the last reset."""
    out = {f"skew_matmul_{s}": 0 for s in _mm.SCHEDULE_IDS}
    out["skew_matmul_batched"] = 0
    out["gemv_splitk_partial"] = 0
    out["gemv_splitk_reduce"] = 0
    out.update(_mm.LAUNCHES)
    out.update(_gemv.LAUNCHES)
    return out


def reset_launch_counts() -> None:
    _mm.LAUNCHES.clear()
    _gemv.LAUNCHES.clear()
