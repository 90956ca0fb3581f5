"""Block-sparse (BSR) matmul: the Hopper kernel K9 + its plain version.

Kernel (CUDA C++, one source and library a schedule, so nvcc builds them
side by side: `csrc/block_sparse_k_inner.cu`, `csrc/block_sparse_matmul.cu`
for a_resident, `csrc/block_sparse_b_resident.cu`): K9, one kernel per loop
order of the dense family (k_inner, a_resident, b_resident), replacing
`repro/sparse/kernels.py::block_sparse_matmul_padded`:

    C = act(scale * (sparse(A) @ B) + bias) + residual

over the nonzero (bm, bk) blocks of A named by a `BlockSparseLayout`
(blocks absent from it are never read), fp32 accumulation, the epilogue at
fp32 and one cast.  The kernel tiles on the layout's block shape; only bn
comes from the plan.  Operands need no padding: ragged last row and column
blocks are masked in the kernel.  At density 1.0 the output is bitwise
equal to K1's at the same blocks and schedule.

`block_sparse_matmul` dispatches on the device of its input: a CUDA tensor
always launches the kernel (or raises); a CPU tensor runs the plain
version, which loops over (row block, nonzero block) with fp32 products
in the layout's order and applies the epilogue once.

k_inner is K1's k_inner device code walking the slices of the CTA's row
block's nonzero blocks; `k_inner_config` gives its CTA tile (rows within
one row block, up to 256 columns), ring and grid.  a_resident keeps the
fp32 sums of its CTA's columns in registers (no workspace);
`a_resident_config` gives the kernel's warp layout and shared memory at a
block shape, `a_resident_chunk` the columns one CTA holds.  b_resident is
its mirror: the sums of a chunk of row blocks in registers, the chunk's
column blocks walked in ascending order so that each B slice is fetched
once per chunk; `b_resident_config` / `b_resident_chunk` give its layout
and chunk.

`LAUNCHES` counts kernel launches per schedule, on the CUDA path only.
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

SCHEDULE_IDS = {"k_inner": 0, "a_resident": 1, "b_resident": 2}
LAUNCHES: collections.Counter = collections.Counter()
# fp32 sums one lane of a_resident may hold for its CTA's columns (the
# same again holds the block being formed).
AR_SUMS_PER_LANE = 64


# k_inner's shared-memory budget: two CTAs an SM.
K_INNER_BUDGET = (_mm.SMEM_MAX - 1024) // 2


@functools.lru_cache(maxsize=4096)
def k_inner_config(m: int, n: int, bm: int, bk: int, dtype: torch.dtype,
                   b_trans: bool, sms: int) -> _mm.KInnerConfig:
    """K9 k_inner's CTA tile, ring and grid (mirrors `bki_config` in
    csrc/block_sparse_k_inner.cu) for an (m, k) A of (bm, bk) blocks
    against n columns on a card with `sms` SMs.  rows: bf16 the largest of
    64, 32 and 16 that divides bm, so that no CTA's rows cross a row block
    (mr = rows / 16); fp32 16.  tile_w: the widest power of two up to 256
    (bf16; fp32 128) whose grid still has `sms` CTAs, at least 16; a warp
    owns strips w and w + 8, so two at 256.  ks: the deepest power of two
    up to 256 dividing bk (no slice straddles two blocks) with >= 3
    stages (at most 8) within `K_INNER_BUDGET`; a transposed B narrows the
    tile until a slice is 128 bytes deep."""
    size = 2 if dtype == torch.bfloat16 else 4
    if size == 4:
        rows = 16
    else:
        rows = 64 if bm % 64 == 0 else 32 if bm % 32 == 0 else 16
    gm = -(-m // rows)
    tw = 256 if size == 2 else 128
    while tw > 16 and gm * -(-n // tw) < sms:
        tw //= 2
    ks, stages, smem = _mm._ki_ring(size, rows, tw, bk, b_trans,
                                    K_INNER_BUDGET)
    while b_trans and tw > 16 and ks * size < 128:
        tw //= 2
        ks, stages, smem = _mm._ki_ring(size, rows, tw, bk, b_trans,
                                        K_INNER_BUDGET)
    return _mm.KInnerConfig(rows, rows // 16, tw, ks, stages, b_trans, gm,
                            -(-n // tw), smem)


@dataclasses.dataclass(frozen=True)
class ARConfig:
    """a_resident's shape on the card (mirrors `ar_config` in
    csrc/block_sparse_matmul.cu).  The 8 warps form a wr x wc grid; a warp
    owns 16 * mr rows of the block and a 16-column strip of every
    tile_w = 16 * wc wide column tile; B streams in ks x tile_w slices
    (ks the deepest slice of bk that fits, up to 128) through two
    shared-memory slots, beside two A buffers; `smem` is -1 when no shape
    fits the 227 KB a block may use."""

    wr: int
    wc: int
    tile_w: int
    mr: int
    ks: int
    smem: int

    @property
    def max_tiles(self) -> int:
        """Column tiles a CTA may hold: 8 / mr, so a lane keeps
        `AR_SUMS_PER_LANE` sums (8 per 16 x 16 accumulator)."""
        return 8 // self.mr


def a_resident_config(bm: int, bk: int, dtype: torch.dtype) -> ARConfig:
    size = 2 if dtype == torch.bfloat16 else 4
    pad = 16 // size
    bm16 = -(-bm // 16)
    wr = 1
    while wr < 8 and -(-bm16 // wr) > 8:
        wr *= 2
    need = -(-bm16 // wr)
    mr = 1
    while mr < need:
        mr *= 2
    wc = 8 // wr
    tw = 16 * wc
    if mr > 8:
        return ARConfig(wr, wc, tw, mr, 0, -1)
    a = _mm._round_up(bm * (bk + pad) * size, 128)
    ks = 128
    while ks >= 16:
        if bk % ks == 0:
            b = _mm._round_up(ks * (tw + pad) * size, 128)
            total = 2 * a + 2 * b
            if total <= _mm.SMEM_MAX:
                return ARConfig(wr, wc, tw, mr, ks, total)
        ks //= 2
    return ARConfig(wr, wc, tw, mr, 0, -1)


def a_resident_chunk(gm: int, n: int, bm: int, bk: int, dtype: torch.dtype,
                     sms: int) -> int:
    """Column tiles (each `a_resident_config(...).tile_w` wide) one
    a_resident CTA holds: as many as its registers allow (`max_tiles`:
    512 columns at bm 32, 256 at bm 64, 128 at bm 128), fewer where that
    would leave under 2 x `sms` CTAs and more chunks can be had.  The
    chunks tile the columns [0, n) in order, the last one ragged."""
    cfg = a_resident_config(bm, bk, dtype)
    tiles = max(1, -(-n // cfg.tile_w))
    per = min(cfg.max_tiles, tiles)
    while per > 1 and gm * -(-tiles // per) < 2 * sms:
        per -= 1
    return per


# Shared memory of b_resident's control block (`BrCtl` in the source:
# 8 cursors, 8 heads, 3 ints and 16 descriptors of 4 ints), 128-aligned.
BR_CTL_BYTES = 384


@dataclasses.dataclass(frozen=True)
class BRConfig:
    """b_resident's shape on the card (mirrors `br_config` in
    csrc/block_sparse_b_resident.cu, on the pieces of csrc/b_resident.cuh
    that `skew_matmul` mirrors).  The CTA covers tile_w columns (bf16: the
    widest power-of-two multiple of 16 within bn and 128; fp32: 16; halved
    until mr fits) of a chunk of row blocks; the 8 warps form a wr x wc
    grid over a row block's bm x tile_w tile, a warp owning 16 * mr rows
    (mr at most 4 for bf16, 2 for fp32: the kernels built) and one
    16-column strip.  A blocks and row-major B slices (a transposed B is
    gathered into them) stream through `stages` (2-4) shared-memory stages,
    as many as leave room for two CTAs an SM, else as many as fit one;
    `smem` is -1 when no shape fits."""

    wr: int
    wc: int
    tile_w: int
    mr: int
    stages: int
    smem: int

    @property
    def max_rows(self) -> int:
        """Row blocks a CTA may hold: 8 / mr, so a lane keeps
        `AR_SUMS_PER_LANE` sums (8 per 16 x 16 accumulator)."""
        return 8 // self.mr


def b_resident_config(bm: int, bk: int, bn: int,
                      dtype: torch.dtype) -> BRConfig:
    size = 2 if dtype == torch.bfloat16 else 4
    wr, wc, tw, mr = _mm.br_layout(bm, _mm.br_width(bn, size), size)
    if mr > (4 if size == 2 else 2):
        return BRConfig(wr, wc, tw, mr, 0, -1)
    stages, smem = _mm.br_ring(
        _mm.br_stage_bytes(size, bm, bk, tw, False), BR_CTL_BYTES, 4)
    return BRConfig(wr, wc, tw, mr, stages, smem)


def b_resident_chunk(gm: int, n: int, bm: int, bk: int, bn: int,
                     dtype: torch.dtype, sms: int) -> int:
    """Row blocks one b_resident CTA holds: as many as its registers allow
    (`max_rows`: 8 at bm 32 with bn 64), fewer where that would leave under
    2 x `sms` CTAs and more chunks can be had.  The chunks tile the row
    blocks [0, gm) in order, the last one ragged."""
    cfg = b_resident_config(bm, bk, bn, dtype)
    tiles = max(1, -(-n // cfg.tile_w))
    per = min(cfg.max_rows, max(1, gm))
    while per > 1 and -(-gm // per) * tiles < 2 * sms:
        per -= 1
    return per


# ------------------------------------------------------------ plain version
def block_sparse_matmul_plain(a: torch.Tensor, b: torch.Tensor, layout,
                              bias=None, residual=None, *, epilogue=None,
                              out_dtype=torch.float32) -> torch.Tensor:
    """C = epilogue(sparse(A) @ B): for each row block, the fp32 products
    of its nonzero blocks summed in the layout's order, then the epilogue
    once over the whole output."""
    m, k = a.shape
    n = b.shape[1]
    if tuple(layout.shape) != (m, k):
        raise ValueError(f"layout shape {layout.shape} != lhs shape {(m, k)}")
    bm, bk = layout.block_shape
    acc = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    for i, (row, cnt) in enumerate(zip(layout.cols.tolist(),
                                       layout.nnz.tolist())):
        rows = slice(i * bm, min(m, (i + 1) * bm))
        for c in row[:cnt]:
            ks = slice(c * bk, min(k, (c + 1) * bk))
            acc[rows] += torch.matmul(a[rows, ks].float(), b[ks].float())
    ops = {"bias": bias, "residual": residual}
    z = epilogue_mod.apply_spec(acc, epilogue, ops)
    return z.to(out_dtype)


# ------------------------------------------------------------ CUDA launch
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("block_sparse_matmul")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.rt_block_sparse_matmul.argtypes = [
        i, i, i, p, p, i, p, ll, ll, p, ll, ll, p, i, i, i, i, i, i, i,
        f, i, p, i, i, p, i, ll, ll, p]
    lib.rt_block_sparse_matmul.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _lib_one(name: str) -> ctypes.CDLL:
    """The k_inner or b_resident library: one entry point, named after
    it, with the same arguments."""
    lib = build.load(f"block_sparse_{name}")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    fn = getattr(lib, f"rt_block_sparse_{name}")
    fn.argtypes = [i, i, p, p, i, p, ll, ll, p, ll, ll, p, i, i, i, i, i, i, i,
                   f, i, p, i, i, p, i, ll, ll, p]
    fn.restype = i
    return lib


def block_sparse_matmul_cuda(a, b, layout, bias=None, residual=None, *,
                             bn: int, schedule: str = "k_inner",
                             epilogue=None,
                             out_dtype=torch.float32) -> torch.Tensor:
    """K9 on the card: sparse(a (m, k)) @ b (k, n) -> (m, n), one launch.
    The index tables go to the card once per layout and device."""
    sid = SCHEDULE_IDS.get(schedule)
    if sid is None:
        raise ValueError(f"unknown schedule {schedule!r}")
    m, k = a.shape
    k2, n = b.shape
    if not (a.is_cuda and b.is_cuda):
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    if b.device != a.device:
        raise ValueError("A and B must be on the same CUDA device")
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if tuple(layout.shape) != (m, k):
        raise ValueError(f"layout shape {layout.shape} != lhs shape {(m, k)}")
    if a.dtype != b.dtype:
        raise TypeError(f"A and B dtypes differ: {a.dtype} vs {b.dtype}")
    in_bf16 = _mm._dtype_flag(a, "A")
    out_bf16 = {torch.bfloat16: 1, torch.float32: 0}.get(out_dtype)
    if out_bf16 is None:
        raise TypeError(f"out_dtype must be bfloat16 or float32, "
                        f"got {out_dtype}")
    bm, bk = layout.block_shape
    _mm.check_blocks(a.dtype, bm, bk, bn)
    gm = layout.gm
    if gm > 65535:
        raise ValueError(f"grid too large: gm={gm}")
    if residual is not None and tuple(residual.shape) != (m, n):
        raise ValueError(f"residual {tuple(residual.shape)} does not match "
                         f"the output {(m, n)}")
    (scale, has_scale, bias_ptr, bias_bf16, act, res_ptr, res_bf16,
     rst, keep) = _mm.epilogue_args(epilogue, bias, residual, a.device, n)
    cols, nnz = layout.device_tensors(a.device)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    sms = _mm._sm_count(a.device.index or 0)
    if sid == 0:
        b_trans = b.stride(0) == 1 and b.stride(1) != 1
        if k_inner_config(m, n, bm, bk, a.dtype, b_trans, sms).gn > 65535:
            raise ValueError(f"grid too large: n={n}")
        chunks = sms
    elif sid == 1:
        if a_resident_config(bm, bk, a.dtype).smem < 0:
            raise ValueError(f"a_resident cannot take blocks {(bm, bk)} of "
                             f"{a.dtype}: no pipeline fits the {_mm.SMEM_MAX}"
                             f" bytes of shared memory a CTA may use")
        chunks = a_resident_chunk(gm, n, bm, bk, a.dtype, sms)
    else:
        cfg = b_resident_config(bm, bk, bn, a.dtype)
        if cfg.smem < 0:
            raise ValueError(f"b_resident cannot take blocks {(bm, bk)} of "
                             f"{a.dtype}: no pipeline fits the {_mm.SMEM_MAX}"
                             f" bytes of shared memory a CTA may use")
        if -(-n // cfg.tile_w) > 65535:
            raise ValueError(f"grid too large: n={n}")
        chunks = b_resident_chunk(gm, n, bm, bk, bn, a.dtype, sms)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    args = (in_bf16, out_bf16, cols.data_ptr(), nnz.data_ptr(), layout.s_max,
            a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(),
            b.stride(0), b.stride(1), out.data_ptr(), m, k, n, bm, bk, bn,
            chunks, scale, has_scale, bias_ptr, bias_bf16, act, res_ptr,
            res_bf16, rst[1], rst[2], stream)
    if sid == 1:
        err = _lib().rt_block_sparse_matmul(sid, *args)
    else:
        err = getattr(_lib_one(schedule), f"rt_block_sparse_{schedule}")(
            *args)
    build.check(err, f"block_sparse_matmul[{schedule}]")
    del keep
    LAUNCHES[f"block_sparse_matmul_{schedule}"] += 1
    return out


# ------------------------------------------------------------ dispatch
def block_sparse_matmul(a, b, layout, bias=None, residual=None, *, bn: int,
                        schedule: str = "k_inner", epilogue=None,
                        out_dtype=torch.float32) -> torch.Tensor:
    """K9 for a CUDA tensor, the plain version for a CPU tensor."""
    if a.is_cuda:
        return block_sparse_matmul_cuda(a, b, layout, bias, residual, bn=bn,
                                        schedule=schedule, epilogue=epilogue,
                                        out_dtype=out_dtype)
    if schedule not in SCHEDULE_IDS:
        raise ValueError(f"unknown schedule {schedule!r}")
    return block_sparse_matmul_plain(a, b, layout, bias, residual,
                                     epilogue=epilogue, out_dtype=out_dtype)
