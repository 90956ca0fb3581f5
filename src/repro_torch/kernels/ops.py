"""Public wrappers for the planned-matmul kernels, the block-sparse matmul,
the grouped expert GEMM, flash attention, the RG-LRU scan and the Mamba-2
SSD scan.

The wrappers take plans from the skew-aware planner when none is given
(amp / chip resolve through the `mm_config` stack), clip the plan's blocks
to the granule-rounded problem dims (granules read from the chip), and
dispatch to the kernel family the plan's schedule names.  Operands are
never padded: the kernels mask ragged edges themselves.

Every matmul dispatch is *guarded* (`repro_torch.guard`), as in the JAX
package: auto-planned calls walk the degradation ladder tuned → modeled →
conservative k_inner → PyTorch reference (`kernels/ref.py`), each level
pre-validating its plan against the AMP budget and scrubbing the kernel
output for NaN/Inf; explicitly-planned calls (the `skewmm.matmul` path
every served model takes) run the transient-retry + scrub envelope and
fall back to the reference oracle on a caught `GuardError`.  With no
`fault_scope()` armed and no ladder tripped, `guarded_kernel` calls the
kernel directly.  Only a `GuardError` moves a rung: a kernel's build,
load or launch error raises.  Each matmul site opens an `obs` dispatch
span (no-op unless a `trace_scope` is armed) annotated with its blocks,
kernel and the rung that delivered.

A CUDA tensor always reaches the hand-written kernel on every rung above
the reference, and only an injected fault moves it off one: a real
non-finite output or a real plan rejection raises (`strict`).  A CPU
tensor runs the kernels' plain versions and degrades as the JAX package
does.  Flash attention, the RG-LRU scan and the SSD scan are unguarded,
as in the JAX package.

K1-K9 are forward-only, as the JAX package's Pallas kernels are (none has
a VJP): a kernel writes into a fresh tensor through ctypes, so its output
has no autograd history.  Every route below therefore refuses, on either
device, an input that requires grad while grad mode is on (`_forward_only`),
before the guard ladder, whose reference rung would otherwise catch the
refusal as a fault and train through the oracle.  Training runs under the
"torch" backend.
"""

from __future__ import annotations

import torch

from repro_torch.core import config
from repro_torch.core import skewmm as _skewmm
from repro_torch.core.costmodel import BlockPlan
from repro_torch.core.epilogue import Epilogue
from repro_torch.core.planner import plan_matmul
from repro_torch.guard import fallback as _guard
from repro_torch.guard import validate as _validate
from repro_torch.kernels import block_sparse_matmul as _bsr
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gemv_splitk as _gemv
from repro_torch.kernels import grouped_matmul as _gmm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rglru_scan as _rglru
from repro_torch.kernels import skew_matmul as _mm
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.obs import attribution as _obs
from repro_torch.sparse.costmodel import SparseMatmulCost, cost_sparse_matmul
from repro_torch.sparse.layout import LayoutSummary
from repro_torch.sparse.planner import plan_grouped_matmul, plan_sparse_matmul


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def clip_blocks(p: BlockPlan, m: int, k: int, n: int,
                chip) -> tuple[int, int, int]:
    """The plan's blocks clipped to the granule-rounded problem dims."""
    sub, lane = chip.mxu_sublanes, chip.mxu_lanes
    return (min(p.bm, _round_up(m, sub)), min(p.bk, _round_up(k, lane)),
            min(p.bn, _round_up(n, lane)))


def _preferred(cfg: config.MatmulConfig) -> str:
    """The ladder level the resolved plan_mode asks for."""
    return "tuned" if cfg.plan_mode == "tuned" else "modeled"


def _level_mode(level: str, cfg: config.MatmulConfig) -> str:
    """Planner mode for a ladder level ("modeled" keeps the ambient
    modeled mode; a tuned preference degrades to skew_aware)."""
    if level == "tuned":
        return "tuned"
    return cfg.plan_mode if cfg.plan_mode != "tuned" else "skew_aware"


def _conservative_plan(chip) -> BlockPlan:
    """The ladder's conservative rung: the minimum-granule K-inner plan
    (always budget-admissible — the floor the planners fail over to;
    (64, 64, 64) on gpu_h100)."""
    return BlockPlan(chip.mxu_sublanes, chip.mxu_lanes, chip.mxu_lanes,
                     schedule="k_inner")


def _dispatch(site: str, ep: Epilogue, **attrs):
    """The site's dispatch span: the shared no-op context unless a trace
    is armed (the epilogue is rendered for the span only then)."""
    if not _obs.tracing():
        return _obs.dispatch(site)
    return _obs.dispatch(site, epilogue=str(ep.spec), **attrs)


def _run_guarded_explicit(site, run, ref_fn, strict: bool = False):
    """Guard envelope for an explicitly-planned call: transient retry +
    scrub, degrading straight to the reference oracle on a caught
    `GuardError` (an explicit plan has no ladder of alternatives — its
    two rungs are "explicit" and "reference", attributed as such).
    `strict` (the operands are on the card) re-raises a `GuardError` no
    fault scope injected."""
    try:
        out = _guard.guarded_kernel(run, site, ref_fn)
        _obs.annotate("dispatch", rung="explicit", rung_index=0)
        return out
    except _guard.GuardError as e:
        if strict and not e.injected:
            raise
        _guard.count_caught(e)
        _obs.annotate("dispatch", rung="reference", rung_index=3,
                      error=type(e).__name__)
        return ref_fn()


def _forward_only(kernel: str, *tensors) -> None:
    """Raise when autograd would need a backward through `kernel`."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad; K1-K9 are forward-only; "
            f'train under the "torch" backend')


def skew_matmul(a: torch.Tensor, b: torch.Tensor, *,
                plan: BlockPlan | None = None, amp: float | None = None,
                chip=None, epilogue: Epilogue | str | None = None,
                bias: torch.Tensor | None = None,
                residual: torch.Tensor | None = None,
                out_dtype=None) -> torch.Tensor:
    """Planned blocked matmul.  a (m, k) @ b (k, n) -> (m, n).

    The plan's `schedule` selects the kernel: k_inner / a_resident /
    b_resident (the dense family) or splitk (the two-pass GEMV family).
    Without a plan the call walks the guard ladder (module docstring).
    """
    m, k = a.shape
    n = b.shape[1]
    cfg = config.resolve(amp=amp, chip=chip)
    ep = Epilogue.parse(epilogue, bias=bias, residual=residual)
    _forward_only("skew_matmul", a, b, ep.bias, ep.residual)
    odt = out_dtype or a.dtype
    chip_spec = cfg.chip_spec

    def run(p: BlockPlan) -> torch.Tensor:
        bm, bk, bn = clip_blocks(p, m, k, n, chip_spec)
        _obs.annotate("dispatch", blocks=(bm, bk, bn), kernel=p.schedule)
        if p.schedule == "splitk":
            # m is never blocked: the whole granule-rounded row count rides
            # in every block.
            pbm = _round_up(m, chip_spec.mxu_sublanes)
            return _gemv.gemv_splitk(a, b, ep.bias, ep.residual, bm=pbm,
                                     bk=bk, bn=bn, epilogue=ep.spec,
                                     out_dtype=odt)
        return _mm.skew_matmul(a, b, ep.bias, ep.residual, bm=bm, bk=bk,
                               bn=bn, schedule=p.schedule, epilogue=ep.spec,
                               out_dtype=odt)

    def ref_fn() -> torch.Tensor:
        return _ref.matmul_epilogue_ref(a, b, epilogue=ep, out_dtype=odt)

    with _dispatch("dense", ep, m=m, k=k, n=n, batch=1,
                   backend="cuda") as dsp:
        if plan is not None:
            return _run_guarded_explicit(
                "dense", lambda: _obs.measured(dsp, lambda: run(plan)), ref_fn,
                a.is_cuda)

        dtype_bytes = a.element_size()

        def plan_for(level: str) -> BlockPlan:
            if level == "conservative":
                return _conservative_plan(chip_spec)
            return plan_matmul(m, k, n, dtype_bytes=dtype_bytes, amp=cfg.amp,
                               chip=chip_spec, mode=_level_mode(level, cfg),
                               mesh_shape=cfg.mesh_shape,
                               sharding=cfg.sharding).plan

        def validate_plan(p: BlockPlan, level: str) -> None:
            _validate.validate_dense(p, m, k, n, dtype_bytes=dtype_bytes,
                                     amp=cfg.amp, chip=chip_spec)

        return _guard.run_laddered(
            "dense", _preferred(cfg), plan_for, validate_plan,
            lambda p, level: _obs.measured(dsp, lambda: run(p)), ref_fn,
            strict=a.is_cuda)


def skew_matmul_batched(a: torch.Tensor, b: torch.Tensor, *,
                        plan: BlockPlan | None = None,
                        amp: float | None = None, chip=None,
                        epilogue: Epilogue | str | None = None,
                        bias: torch.Tensor | None = None,
                        residual: torch.Tensor | None = None,
                        out_dtype=None) -> torch.Tensor:
    """Batched-grid matmul.  a (nb, m, k) @ b (k, n) -> (nb, m, n).

    The batch dim rides in the grid as an extra parallel dimension instead
    of being folded into m — the planner's `batch_grid` plans land here.
    """
    nb, m, k = a.shape
    n = b.shape[1]
    cfg = config.resolve(amp=amp, chip=chip)
    ep = Epilogue.parse(epilogue, bias=bias, residual=residual)
    _forward_only("skew_matmul_batched", a, b, ep.bias, ep.residual)
    odt = out_dtype or a.dtype
    chip_spec = cfg.chip_spec

    def run(p: BlockPlan) -> torch.Tensor:
        bm, bk, bn = clip_blocks(p, m, k, n, chip_spec)
        _obs.annotate("dispatch", blocks=(bm, bk, bn), kernel=p.schedule)
        return _mm.skew_matmul_batched(a, b, ep.bias, ep.residual, bm=bm,
                                       bk=bk, bn=bn, epilogue=ep.spec,
                                       out_dtype=odt)

    def ref_fn() -> torch.Tensor:
        return _ref.matmul_epilogue_ref(a, b, epilogue=ep, out_dtype=odt)

    with _dispatch("dense_batched", ep, m=m, k=k, n=n, batch=nb,
                   backend="cuda") as dsp:
        if plan is not None:
            return _run_guarded_explicit(
                "dense", lambda: _obs.measured(dsp, lambda: run(plan)), ref_fn,
                a.is_cuda)

        dtype_bytes = a.element_size()

        def plan_for(level: str) -> BlockPlan:
            if level == "conservative":
                return _conservative_plan(chip_spec)
            return plan_matmul(m, k, n, dtype_bytes=dtype_bytes, amp=cfg.amp,
                               chip=chip_spec, batch=nb,
                               mode=_level_mode(level, cfg),
                               mesh_shape=cfg.mesh_shape,
                               sharding=cfg.sharding).plan

        def validate_plan(p: BlockPlan, level: str) -> None:
            _validate.validate_dense(p, m, k, n, batch=nb,
                                     dtype_bytes=dtype_bytes, amp=cfg.amp,
                                     chip=chip_spec)

        return _guard.run_laddered(
            "dense", _preferred(cfg), plan_for, validate_plan,
            lambda p, level: _obs.measured(dsp, lambda: run(p)), ref_fn,
            strict=a.is_cuda)


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
    shape; without a plan the call walks the guard ladder, the
    sparsity-aware planner choosing (schedule, bn) under the
    `mm_config`-resolved budget and mode at the upper rungs, and each
    rung's plan is recorded into `plan_capture()`.  An explicit plan whose
    (bm, bk) differ from the layout block raises.  K9 on a CUDA tensor,
    its plain version on a CPU tensor.
    """
    m, k = a.shape
    n = b.shape[1]
    if tuple(layout.shape) != (m, k):
        raise ValueError(f"layout shape {layout.shape} != lhs shape "
                         f"{(m, k)}")
    cfg = config.resolve(amp=amp, chip=chip)
    ep = Epilogue.parse(epilogue, bias=bias, residual=residual)
    _forward_only("sparse_matmul", a, b, ep.bias, ep.residual)
    bm, bk = layout.block_shape
    odt = out_dtype or a.dtype
    chip_spec = cfg.chip_spec

    def run(p: BlockPlan) -> torch.Tensor:
        bn = min(p.bn, _round_up(n, chip_spec.mxu_lanes))
        _obs.annotate("dispatch", blocks=(bm, bk, bn), kernel=p.schedule)
        return _bsr.block_sparse_matmul(a, b, layout, ep.bias, ep.residual,
                                        bn=bn, schedule=p.schedule,
                                        epilogue=ep.spec, out_dtype=odt)

    def ref_fn() -> torch.Tensor:
        return _ref.block_sparse_matmul_ref(a, b, layout, epilogue=ep,
                                            out_dtype=odt)

    if isinstance(plan, SparseMatmulCost):
        plan = plan.plan
    if plan is not None and (plan.bm, plan.bk) != (bm, bk):
        raise ValueError(f"plan blocks ({plan.bm}, {plan.bk}) must match "
                         f"the layout block shape ({bm}, {bk})")
    with _dispatch("sparse", ep, m=m, k=k, n=n, batch=1,
                   backend="cuda") as dsp:
        if plan is not None:
            return _run_guarded_explicit(
                "sparse", lambda: _obs.measured(dsp, lambda: run(plan)),
                ref_fn, a.is_cuda)

        dtype_bytes = a.element_size()
        summary = layout.summary()

        def plan_for(level: str) -> BlockPlan:
            if level == "conservative":
                p = BlockPlan(bm, bk, chip_spec.mxu_lanes, schedule="k_inner")
                _skewmm.record_plan(cost_sparse_matmul(
                    summary, n, p, chip_spec, dtype_bytes=dtype_bytes))
                return p
            cost = plan_sparse_matmul(summary, n, dtype_bytes=dtype_bytes,
                                      amp=cfg.amp, chip=chip_spec,
                                      mode=_level_mode(level, cfg))
            _skewmm.record_plan(cost)
            return cost.plan

        def validate_plan(p: BlockPlan, level: str) -> None:
            _validate.validate_sparse(p, summary, n, dtype_bytes=dtype_bytes,
                                      amp=cfg.amp, chip=chip_spec)

        return _guard.run_laddered(
            "sparse", _preferred(cfg), plan_for, validate_plan,
            lambda p, level: _obs.measured(dsp, lambda: run(p)), ref_fn,
            strict=a.is_cuda)


def grouped_matmul(a: torch.Tensor, b: torch.Tensor, *,
                   plan: BlockPlan | SparseMatmulCost | None = None,
                   backend: str | None = None, amp: float | None = None,
                   chip=None, epilogue: Epilogue | str | None = None,
                   residual: torch.Tensor | None = None,
                   out_dtype=None) -> torch.Tensor:
    """Grouped matmul with per-group rhs.  a (g, m, k) @ b (g, k, n).

    The MoE expert-GEMM entry.  Backend "torch" plans through
    `plan_grouped_matmul` (recorded into `plan_capture()`) and runs the
    oracle `grouped_matmul_ref` — it doubles as the ladder's reference
    rung, as the JAX package's "xla" branch does.  Backend "cuda" runs K5
    on a CUDA tensor (its plain version on a CPU tensor): an explicit plan
    through the explicit envelope, else the guard ladder, each rung's plan
    recorded, its blocks clipped to the granule-rounded dims.  The
    epilogue takes scale / act / residual; a bias raises.
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
    dtype_bytes = a.element_size()
    chip_spec = cfg.chip_spec

    def ref_fn() -> torch.Tensor:
        return _ref.grouped_matmul_ref(a, b, epilogue=ep, out_dtype=odt)

    if cfg.backend == "torch":
        with _dispatch("grouped", ep, m=m, k=k, n=n, batch=1, groups=g,
                       backend=cfg.backend) as dsp:
            if plan is None:
                _skewmm.record_plan(plan_grouped_matmul(
                    g, m, k, n, dtype_bytes=dtype_bytes, amp=cfg.amp,
                    chip=chip_spec))
            return _obs.measured(dsp, ref_fn)

    _forward_only("grouped_matmul", a, b, ep.residual)

    def run(p: BlockPlan) -> torch.Tensor:
        bm, bk, bn = clip_blocks(p, m, k, n, chip_spec)
        _obs.annotate("dispatch", blocks=(bm, bk, bn), kernel=p.schedule)
        return _gmm.grouped_matmul(a, b, ep.residual, bm=bm, bk=bk, bn=bn,
                                   epilogue=ep.spec, out_dtype=odt)

    if isinstance(plan, SparseMatmulCost):
        plan = plan.plan
    with _dispatch("grouped", ep, m=m, k=k, n=n, batch=1, groups=g,
                   backend="cuda") as dsp:
        if plan is not None:
            return _run_guarded_explicit(
                "grouped", lambda: _obs.measured(dsp, lambda: run(plan)),
                ref_fn, a.is_cuda)

        def plan_for(level: str) -> BlockPlan:
            if level == "conservative":
                p = _conservative_plan(chip_spec)
                summary = LayoutSummary.block_diag(g, m, k, (p.bm, p.bk))
                _skewmm.record_plan(cost_sparse_matmul(
                    summary, n, p, chip_spec, dtype_bytes=dtype_bytes))
                return p
            cost = plan_grouped_matmul(g, m, k, n, dtype_bytes=dtype_bytes,
                                       amp=cfg.amp, chip=chip_spec,
                                       mode=_level_mode(level, cfg))
            _skewmm.record_plan(cost)
            return cost.plan

        def validate_plan(p: BlockPlan, level: str) -> None:
            _validate.validate_grouped(p, g, m, k, dtype_bytes=dtype_bytes,
                                       amp=cfg.amp, chip=chip_spec)

        return _guard.run_laddered(
            "grouped", _preferred(cfg), plan_for, validate_plan,
            lambda p, level: _obs.measured(dsp, lambda: run(p)), ref_fn,
            strict=a.is_cuda)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float = 0.0, scale: float | None = None,
                    bq: int | None = None,
                    bkv: int | None = None) -> torch.Tensor:
    """Prefill attention.  q (B, Hq, Sq, D), k (B, Hkv, Skv, D), v (B, Hkv,
    Skv, Dv), Dv <= D -> (B, Hq, Sq, Dv): K7 on a CUDA tensor, its plain
    version on a CPU tensor.
    Rows are positions 0..Sq-1 and columns 0..Skv-1, so a causal or
    windowed call needs Sq == Skv; with neither, Sq may differ from Skv
    (cross-attention).  Tiles default to the kernel's choice for the head
    dim (`flash_attention.tiles`); Sq and Skv need not divide them."""
    _forward_only("flash_attention", q, k, v)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale, bq=bq, bkv=bkv)


def rglru_scan(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
               a_param: torch.Tensor, *, c: float = 8.0,
               return_state: bool = False):
    """The RG-LRU scan.  x, r_gate, i_gate (B, L, D) pre-sigmoid logits,
    a_param (D,): K6 on a CUDA tensor, its plain version on a CPU tensor.
    With ``return_state`` also the fp32 state after the last step."""
    _forward_only("rglru_scan", x, r_gate, i_gate, a_param)
    return _rglru.rglru_scan(x, r_gate, i_gate, a_param, c=c,
                             return_state=return_state)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor, *, chunk: int = 128,
             return_state: bool = False):
    """The Mamba-2 SSD scan.  x (B, L, H, P), dt (B, L, H) fp32, a_log
    (H,), B / C (B, L, G, S): K8 on a CUDA tensor, its plain version on a
    CPU tensor.  Any L; with ``return_state`` also the fp32 state after the
    last position, (B, H, S, P)."""
    _forward_only("ssd_scan", x, dt, a_log, b_mat, c_mat)
    return _ssd.ssd_scan(x, dt, a_log, b_mat, c_mat, chunk=chunk,
                         return_state=return_state)


def launch_counters() -> tuple:
    """Each kernel module's `LAUNCHES` counter (a graph replay adds the
    launches it captured to them: `serve.graphs`)."""
    return (_mm.LAUNCHES, _gemv.LAUNCHES, _gmm.LAUNCHES, _fa.LAUNCHES,
            _rglru.LAUNCHES, _ssd.LAUNCHES, _bsr.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Launches of every kernel since the last reset."""
    out = {f"skew_matmul_{s}": 0 for s in _mm.SCHEDULE_IDS}
    out.update({f"block_sparse_matmul_{s}": 0 for s in _bsr.SCHEDULE_IDS})
    for name in ("skew_matmul_batched", "gemv_splitk_partial",
                 "gemv_splitk_reduce", "grouped_matmul", "flash_attention",
                 "rglru_scan", "ssd_scan", "ssd_chunk_state",
                 "ssd_state_pass"):
        out[name] = 0
    for counter in launch_counters():
        out.update(counter)
    return out


def reset_launch_counts() -> None:
    for counter in launch_counters():
        counter.clear()
