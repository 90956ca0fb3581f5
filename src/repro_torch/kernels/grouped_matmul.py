"""Grouped expert GEMM for the MoE layers: Hopper kernel + plain version.

Kernel (CUDA C++, `csrc/grouped_matmul.cu`):
  K5 — C[g] = act(scale * (A[g] @ B[g])) + residual[g], one rhs per group
       (replaces `repro/sparse/kernels.py::grouped_matmul_padded`): K1's
       k_inner kernel (`csrc/k_inner.cuh`) with the grouped walk,
       blockIdx = (row tile, column tile, group), the fp32 sums in
       registers, A and B on a `cp.async` ring, the epilogue once, one
       cast.  Decode rows (bf16 m <= 16, and every fp32 call) take
       k_inner's one-strip tile; bf16 prefill rows a tile of two rows of
       four warps, each holding 80 x 64 sums (160 x 256) or 32 x 32.
       `grouped_config` gives the tile, ring and grid (mirroring
       `grouped_config` in the source).  Group g equals K1 k_inner on
       A[g] @ B[g] bit for bit.

A (g, m, k) and B (g, k, n) need no padding: the kernel masks ragged m, k
and n and reads both operands through their strides.  The epilogue takes
scale / act / residual; a bias raises, as in the JAX package.

`grouped_matmul` dispatches on the device of its input: a CUDA tensor
always launches the kernel (or raises); a CPU tensor runs the plain
version, which repeats the kernel's arithmetic — fp32 sums over k blocks
of width bk, in order, per group, then the epilogue.

The wrapper counts its launches in `LAUNCHES["grouped_matmul"]` (one per
kernel launch, on the CUDA path only).
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


# K5's ring budgets: two CTAs an SM (the launch bound of up to 4
# accumulators a warp), or one (the prefill tile at mr 5).
GROUPED_BUDGET = (_mm.SMEM_MAX - 1024) // 2


@dataclasses.dataclass(frozen=True)
class GroupedConfig:
    """K5's shape on the card (mirrors `grouped_config` in
    csrc/grouped_matmul.cu).  `wide`: the prefill tile (bf16, m > 16 rows
    a group): two rows of four warps over a rows x tile_w tile, each warp
    holding mr 16-row fragments x tile_w / 64 16-column strips; rows = 32
    mr, mr 5 (160 x 256, one CTA an SM) or 2 (64 x 128, two), whichever
    pads fewer rows of m (ties to 160).
    Otherwise the decode tile: k_inner's one strip a warp over every row,
    rows bf16 8 when m fits in 8 (the MMA's other 8 rows read a zero row),
    else 16 (mr 1); tile_w the widest power-of-two multiple of 16 within bn
    and 128, narrowed as k_inner's where the grid (groups counted as row
    tiles) would leave SMs idle, and for a transposed B until a slice is
    128 bytes deep.  A and B stream in `ks`-deep slices (a power of two
    dividing round_up(k, bk)) through `stages` >= 3 stages within two CTAs
    an SM (`GROUPED_BUDGET`), or one at mr 5.  The grid is (gm, gn,
    groups)."""

    wide: bool
    rows: int
    mr: int
    tile_w: int
    ks: int
    stages: int
    b_trans: bool
    gm: int
    gn: int
    smem: int


@functools.lru_cache(maxsize=4096)
def grouped_config(g: int, m: int, k: int, n: int, bk: int, bn: int,
                   dtype: torch.dtype, b_trans: bool,
                   sms: int) -> GroupedConfig:
    """K5's tile, ring and grid for g groups of (m, k) @ (k, n) at the
    plan's bk and bn on a card with `sms` SMs (the plan's bm does not
    enter: the tile is the kernel's choice)."""
    size = 2 if dtype == torch.bfloat16 else 4
    kp = _mm._round_up(k, bk)
    if size == 2 and m > 16:
        pad2, pad5 = _mm._round_up(m, 64) - m, _mm._round_up(m, 160) - m
        mr = 5 if pad5 <= pad2 else 2
        rows = 32 * mr
        # mr 5: one CTA an SM, 80 x 64 a warp; mr 2: two, 32 x 32 a warp
        tw, budget = (256, _mm.SMEM_MAX) if mr == 5 else (128, GROUPED_BUDGET)
        ks, stages, smem = _mm._ki_ring(size, rows, tw, kp, b_trans, budget)
        return GroupedConfig(True, rows, mr, tw, ks, stages, b_trans,
                             -(-m // rows), -(-n // tw), smem)
    rows = 8 if size == 2 and m <= 8 else 16
    gm = -(-m // rows)
    tw = 16
    while 2 * tw <= bn and 2 * tw <= 128:
        tw *= 2
    if g * gm * -(-n // tw) < sms:
        tw = _mm._narrow_tile(g * gm, n, tw, sms)
    ks, stages, smem = _mm._ki_ring(size, rows, tw, kp, b_trans,
                                    GROUPED_BUDGET)
    while b_trans and tw > 16 and ks * size < 128:
        tw //= 2
        ks, stages, smem = _mm._ki_ring(size, rows, tw, kp, b_trans,
                                        GROUPED_BUDGET)
    return GroupedConfig(False, rows, 1, tw, ks, stages, b_trans, gm,
                         -(-n // tw), smem)


def _check_spec(epilogue) -> tuple:
    spec = epilogue_mod.normalize_spec(epilogue)
    if any(t == "bias" for t, _ in spec):
        raise ValueError("grouped_matmul epilogue supports scale / act / "
                         "residual; bias is not plumbed per-group")
    return spec


# ------------------------------------------------------------ plain version
def grouped_matmul_plain(a: torch.Tensor, b: torch.Tensor, residual=None, *,
                         bk: int, epilogue=None,
                         out_dtype=torch.float32) -> torch.Tensor:
    """C[g] = epilogue(A[g] @ B[g]) with fp32 sums over k blocks of width
    `bk`, in order; `residual` is (g, m, n)."""
    spec = _check_spec(epilogue)
    k = a.shape[-1]
    acc = None
    for k0 in range(0, k, bk):
        part = torch.bmm(a[..., k0:k0 + bk].float(),
                         b[:, k0:k0 + bk].float())
        acc = part if acc is None else acc + part
    z = epilogue_mod.apply_spec(acc, spec, {"residual": residual})
    return z.to(out_dtype)


# ------------------------------------------------------------ CUDA launch
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("grouped_matmul")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.rt_grouped_matmul.argtypes = [
        i, i, p, ll, ll, ll, p, ll, ll, ll, p, ll, ll, i, i, i, i, i, i, i,
        i, f, i, i, p, i, ll, ll, ll, p]
    lib.rt_grouped_matmul.restype = i
    return lib


def grouped_matmul_cuda(a: torch.Tensor, b: torch.Tensor, residual=None, *,
                        bm: int, bk: int, bn: int, epilogue=None,
                        out_dtype=torch.float32) -> torch.Tensor:
    """K5 on the card: a (g, m, k) @ b (g, k, n) -> (g, m, n), one launch."""
    if not (a.is_cuda and b.is_cuda):
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"grouped operands must be 3-D, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    g, m, k = a.shape
    g2, k2, n = b.shape
    if g != g2 or k != k2:
        raise ValueError(f"group/contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError("A and B must be on the same CUDA device")
    if a.dtype != b.dtype:
        raise TypeError(f"A and B dtypes differ: {a.dtype} vs {b.dtype}")
    in_bf16 = _dtype_flag(a, "A")
    out_bf16 = {torch.bfloat16: 1, torch.float32: 0}.get(out_dtype)
    if out_bf16 is None:
        raise TypeError(f"out_dtype must be bfloat16 or float32, "
                        f"got {out_dtype}")
    spec = _check_spec(epilogue)
    check_blocks(a.dtype, bm, bk, bn)
    if residual is not None and tuple(residual.shape) != (g, m, n):
        raise ValueError(f"residual {tuple(residual.shape)} does not match "
                         f"the output {(g, m, n)}")
    if g > 65535:
        raise ValueError(f"too many groups: {g}")
    (scale, has_scale, _, _, act, res_ptr, res_bf16, rst,
     _) = epilogue_args(spec, None, residual, a.device, n)
    sa, sb = a.stride(), b.stride()
    sms = _mm._sm_count(a.device.index or 0)
    b_trans = sb[1] == 1 and sb[2] != 1
    cfg = grouped_config(g, m, k, n, bk, bn, a.dtype, b_trans, sms)
    if cfg.gn > 65535:
        raise ValueError(f"grid too large: {cfg.gn} column tiles")
    out = torch.empty((g, m, n), dtype=out_dtype, device=a.device)
    so = out.stride()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib().rt_grouped_matmul(
        in_bf16, out_bf16, a.data_ptr(), sa[0], sa[1], sa[2], b.data_ptr(),
        sb[0], sb[1], sb[2], out.data_ptr(), so[0], so[1], g, m, k, n, bm,
        bk, bn, sms, scale, has_scale, act, res_ptr, res_bf16, rst[0], rst[1],
        rst[2], stream)
    build.check(err, "grouped_matmul")
    LAUNCHES["grouped_matmul"] += 1
    return out


# ------------------------------------------------------------ dispatch
def grouped_matmul(a, b, residual=None, *, bm: int, bk: int, bn: int,
                   epilogue=None, out_dtype=torch.float32) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if a.is_cuda:
        return grouped_matmul_cuda(a, b, residual, bm=bm, bk=bk, bn=bn,
                                   epilogue=epilogue, out_dtype=out_dtype)
    return grouped_matmul_plain(a, b, residual, bk=bk, epilogue=epilogue,
                                out_dtype=out_dtype)
