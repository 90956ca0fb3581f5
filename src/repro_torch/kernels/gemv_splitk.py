"""Split-K / tree-reduction GEMV for the decode regime: Hopper kernels +
plain versions.

Kernels (CUDA C++, `csrc/gemv_splitk.cu`), replacing
`repro/kernels/gemv_splitk.py::gemv_splitk_padded`:
  K3 — pass 1: fp32 partial products into a (gk, m, n) slab; m is never
       blocked.  K1's k_inner kernel (`csrc/k_inner.cuh`) with the split
       walk: a CTA walks the splits of its split group through k_inner's
       `cp.async` ring with its sums in registers, storing them raw to
       split s's plane at the split's end; `splitk_config` gives its tile,
       ring and grid (mirroring `sk_config` in the source).  Plane s equals
       K1 k_inner on the slice pair bit for bit;
  K4 — pass 2: stages a strip of W output elements of every split in
       shared memory (`reduce_strip`), folds each element's gk partials
       in place in the static pairwise order of `tree_sum`, applies the
       epilogue once, casts; with no epilogue it equals the plain reduce
       bit for bit.

`gemv_splitk` dispatches on the input's device: a CUDA tensor launches
both kernels (or raises); a CPU tensor runs the plain versions.  For
integer-valued inputs the result is bitwise identical across split counts
on either path.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch

from repro_torch.core import epilogue as epilogue_mod
from repro_torch.kernels import build
from repro_torch.kernels import skew_matmul as _mm
from repro_torch.kernels.skew_matmul import (_dtype_flag, check_blocks,
                                             epilogue_args)

LAUNCHES: collections.Counter = collections.Counter()
SMEM_MAX = 232_448
REDUCE_MAX_W = 256


def reduce_strip(gk: int) -> int:
    """K4's strip width: the largest multiple of 4 up to 256 output
    elements whose gk x W fp32 partials fit the 227 KB of shared memory a
    block may use; 0 when not even 4 fit (gk > 14528), where the slab is
    first folded level by level through a scratch in device memory
    (mirrors `reduce_strip` in csrc/gemv_splitk.cu)."""
    if gk < 1:
        raise ValueError(f"gk must be >= 1, got {gk}")
    return min(REDUCE_MAX_W, SMEM_MAX // (4 * gk)) // 4 * 4


# K3's ring budget: two CTAs an SM (its launch bound at 1 or 4 fragments).
SPLITK_BUDGET = (SMEM_MAX - 1024) // 2


@dataclasses.dataclass(frozen=True)
class SplitKConfig:
    """K3's shape on the card (mirrors `sk_config` in csrc/gemv_splitk.cu).
    rows / mr: k_inner's rule (bf16 8 when m fits in 8, the MMA's other 8
    rows reading a zero row, else min(bm, 64, the 16-row granules m fills)
    with mr 4; fp32 16 with mr 1).  tile_w: the widest power-of-two
    multiple of 16 within bn and 128, for a transposed B (`b_trans`)
    halved until a slice is 128 bytes deep.  A and B stream in `ks`-deep
    slices (a power of two dividing bk, so no slice straddles two splits)
    through `stages` >= 3 shared-memory stages within `SPLITK_BUDGET`.
    The grid is (gm, gn, groups): `groups` split groups of `per_group`
    consecutive splits each (the last may hold fewer), `per_group` the
    largest with which the grid still fills a wave of two CTAs an SM, 1
    where none does."""

    rows: int
    mr: int
    tile_w: int
    ks: int
    stages: int
    b_trans: bool
    gm: int
    gn: int
    per_group: int
    groups: int
    smem: int


@functools.lru_cache(maxsize=4096)
def splitk_config(m: int, k: int, n: int, bm: int, bk: int, bn: int,
                  dtype: torch.dtype, b_trans: bool, sms: int) -> SplitKConfig:
    """K3's CTA tile, ring and grid for an (m, k) @ (k, n) product split
    into ceil(k / bk) bk-deep partials at the plan's (bm, bk, bn) on a card
    with `sms` SMs."""
    size = 2 if dtype == torch.bfloat16 else 4
    if size == 4:
        rows = 16
    elif m <= 8:
        rows = 8
    else:
        rows = min(bm, 64, _mm._round_up(m, 16))
    mr = 1 if rows <= 16 else 4
    tw = 16
    while 2 * tw <= bn and 2 * tw <= 128:
        tw *= 2
    ks, stages, smem = _mm._ki_ring(size, rows, tw, bk, b_trans,
                                    SPLITK_BUDGET)
    while b_trans and tw > 16 and ks * size < 128:
        tw //= 2
        ks, stages, smem = _mm._ki_ring(size, rows, tw, bk, b_trans,
                                        SPLITK_BUDGET)
    gm, gn = -(-m // rows), -(-n // tw)
    gk = per = -(-k // bk)
    while per > 1 and gm * gn * -(-gk // per) < 2 * sms:
        per -= 1
    return SplitKConfig(rows, mr, tw, ks, stages, b_trans, gm, gn, per,
                        -(-gk // per), smem)


def tree_sum(parts: torch.Tensor) -> torch.Tensor:
    """Static pairwise fold over the leading axis: halves are added, an odd
    tail carries to the next level unchanged (the JAX `tree_sum` order)."""
    while parts.shape[0] > 1:
        half = parts.shape[0] // 2
        folded = parts[:half] + parts[half:2 * half]
        if parts.shape[0] % 2:
            folded = torch.cat([folded, parts[2 * half:]], dim=0)
        parts = folded
    return parts[0]


# ------------------------------------------------------------ plain versions
def gemv_splitk_partial_plain(a: torch.Tensor, b: torch.Tensor, *,
                              bk: int) -> torch.Tensor:
    """Pass 1: the (gk, m, n) fp32 slab of per-split partial products."""
    k = a.shape[1]
    return torch.stack([a[:, k0:k0 + bk].float() @ b[k0:k0 + bk].float()
                        for k0 in range(0, k, bk)])


def gemv_splitk_reduce_plain(slab: torch.Tensor, bias=None, residual=None,
                             *, epilogue=None,
                             out_dtype=torch.float32) -> torch.Tensor:
    """Pass 2: tree-reduce the slab, epilogue once, one cast."""
    z = tree_sum(slab)
    z = epilogue_mod.apply_spec(z, epilogue,
                                {"bias": bias, "residual": residual})
    return z.to(out_dtype)


# ------------------------------------------------------------ CUDA launches
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("gemv_splitk")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.rt_splitk_partial.argtypes = [i, p, ll, ll, p, ll, ll, p, i, i, i,
                                      i, i, i, i, p]
    lib.rt_splitk_partial.restype = i
    lib.rt_splitk_reduce.argtypes = [i, p, p, p, i, i, i, f, i, p, i, i, p,
                                     i, ll, ll, p]
    lib.rt_splitk_reduce.restype = i
    return lib


def gemv_splitk_partial_cuda(a: torch.Tensor, b: torch.Tensor, *, bm: int,
                             bk: int, bn: int) -> torch.Tensor:
    """K3 on the card: returns the contiguous fp32 (gk, m, n) slab."""
    m, k = a.shape
    k2, n = b.shape
    if not (a.is_cuda and b.is_cuda):
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    if k != k2 or a.dtype != b.dtype or b.device != a.device:
        raise ValueError(f"bad operands {tuple(a.shape)} {a.dtype} @ "
                         f"{tuple(b.shape)} {b.dtype}")
    if bm < m:
        raise ValueError(f"split-K never blocks m: bm={bm} < m={m}")
    in_bf16 = _dtype_flag(a, "A")
    check_blocks(a.dtype, bm, bk, bn)
    gk = -(-k // bk)
    if gk > 65535:
        raise ValueError(f"too many k splits: {gk}")
    sms = _mm._sm_count(a.device.index or 0)
    b_trans = b.stride(0) == 1 and b.stride(1) != 1
    cfg = splitk_config(m, k, n, bm, bk, bn, a.dtype, b_trans, sms)
    if cfg.gn > 65535:
        raise ValueError(f"grid too large: {cfg.gn} column tiles")
    slab = torch.empty((gk, m, n), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib().rt_splitk_partial(
        in_bf16, a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(),
        b.stride(0), b.stride(1), slab.data_ptr(), m, k, n, bm, bk, bn, sms,
        stream)
    build.check(err, "gemv_splitk_partial")
    LAUNCHES["gemv_splitk_partial"] += 1
    return slab


def gemv_splitk_reduce_cuda(slab: torch.Tensor, bias=None, residual=None, *,
                            epilogue=None,
                            out_dtype=torch.float32) -> torch.Tensor:
    """K4 on the card: tree-reduce the slab, epilogue once, one cast."""
    gk, m, n = slab.shape
    if not slab.is_cuda:
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    if slab.dtype != torch.float32 or not slab.is_contiguous():
        raise ValueError("the partial slab must be contiguous fp32")
    out_bf16 = {torch.bfloat16: 1, torch.float32: 0}.get(out_dtype)
    if out_bf16 is None:
        raise TypeError(f"out_dtype must be bfloat16 or float32, "
                        f"got {out_dtype}")
    if residual is not None and tuple(residual.shape) != (m, n):
        raise ValueError(f"residual {tuple(residual.shape)} does not match "
                         f"the output {(m, n)}")
    (scale, has_scale, bias_ptr, bias_bf16, act, res_ptr, res_bf16,
     rst, keep) = epilogue_args(epilogue, bias, residual, slab.device, n)
    out = torch.empty((m, n), dtype=out_dtype, device=slab.device)
    scratch = None
    if reduce_strip(gk) == 0:
        scratch = torch.empty(((gk + 1) // 2, m, n), dtype=torch.float32,
                              device=slab.device)
    stream = torch.cuda.current_stream(slab.device).cuda_stream
    err = _lib().rt_splitk_reduce(
        out_bf16, slab.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), gk, m, n, scale,
        has_scale, bias_ptr, bias_bf16, act, res_ptr, res_bf16, rst[1],
        rst[2], stream)
    build.check(err, "gemv_splitk_reduce")
    LAUNCHES["gemv_splitk_reduce"] += 1
    # `keep` (a contiguous bias copy) and the scratch may be freed once
    # the launch is enqueued: the caching allocator reuses them only for
    # later work on this stream.
    del keep, scratch
    return out


# ------------------------------------------------------------ dispatch
def gemv_splitk(a, b, bias=None, residual=None, *, bm: int, bk: int,
                bn: int, epilogue=None, out_dtype=torch.float32):
    """C = epilogue(A @ B) via split-K partials + one tree-reduce pass:
    the two kernels for a CUDA tensor, the plain versions for a CPU one."""
    if a.is_cuda:
        slab = gemv_splitk_partial_cuda(a, b, bm=bm, bk=bk, bn=bn)
        return gemv_splitk_reduce_cuda(slab, bias, residual,
                                       epilogue=epilogue, out_dtype=out_dtype)
    slab = gemv_splitk_partial_plain(a, b, bk=bk)
    return gemv_splitk_reduce_plain(slab, bias, residual, epilogue=epilogue,
                                    out_dtype=out_dtype)
