"""Dense schedule family of the planned matmul: Hopper kernels + plain
versions.

Kernels (CUDA C++, `csrc/skew_matmul.cu`):
  K1 — the dense family, one kernel per loop order: k_inner, a_resident,
       b_resident (replaces `repro/kernels/skew_matmul.py::
       skew_matmul_padded`);
  K2 — the batched grid: k_inner with the batch as a grid dim (replaces
       `skew_matmul_batched_padded`).

    C = act(scale * (A @ B) + bias) + residual

with fp32 accumulation, the epilogue at fp32 and one cast.  Operands need
no padding: the kernels mask ragged edges and read A and B through their
strides, so a transposed view (a tied embedding used as E^T) costs no copy.

k_inner (K1's planned schedule, and K2) keeps its fp32 sums in registers,
streams A and B through a `cp.async` ring and stacks the batch slices'
rows, so decode's 4 x 1 rows read B once; `k_inner_config` gives its CTA
tile, ring and grid (mirroring `ki_config` in the source).  a_resident
keeps the sums of a chunk of column tiles in registers over the whole k
loop (no workspace), each k block's partial formed from zero and added
once, with A and B on the same kind of ring; `a_resident_config` gives
its rows, tile, ring and chunks (mirroring `ard_config`).  b_resident
is its mirror image and K9 b_resident's template walking every block:
the sums of a chunk of row blocks in registers (no workspace), each k
block's B slice held while the chunk's row blocks pass, A blocks and B
slices on a `cp.async` ring; `b_resident_config` gives its tile, warp
grid, ring and chunk (mirroring `brd_config`).

`skew_matmul` / `skew_matmul_batched` dispatch on the device of their
input: a CUDA tensor always launches the kernel (or raises); a CPU tensor
runs the plain version, which repeats the kernels' arithmetic — fp32 sums
over k blocks of width bk, in order, then the epilogue.

Each wrapper counts its launches in `LAUNCHES` (one per kernel launch, on
the CUDA path only).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch

from repro_torch.core import epilogue as epilogue_mod
from repro_torch.kernels import build

SCHEDULE_IDS = {"k_inner": 0, "a_resident": 1, "b_resident": 2}
SMEM_MAX = 232_448
LAUNCHES: collections.Counter = collections.Counter()

_ACTS = {None: 0, "gelu": 1, "silu": 2}


# ------------------------------------------------------------ plain versions
def skew_matmul_plain(a: torch.Tensor, b: torch.Tensor, bias=None,
                      residual=None, *, bk: int, epilogue=None,
                      out_dtype=torch.float32) -> torch.Tensor:
    """C = epilogue(A @ B) with fp32 sums over k blocks of width `bk`.

    `a` may carry leading batch dims (the batched variant); `residual`
    broadcast-matches the output.
    """
    k = a.shape[-1]
    acc = None
    for k0 in range(0, k, bk):
        part = torch.matmul(a[..., k0:k0 + bk].float(), b[k0:k0 + bk].float())
        acc = part if acc is None else acc + part
    ops = {"bias": bias, "residual": residual}
    z = epilogue_mod.apply_spec(acc, epilogue, ops)
    return z.to(out_dtype)


# The batched grid's plain version is the same function: a (nb, m, k).
skew_matmul_batched_plain = skew_matmul_plain


# ------------------------------------------------------------ CUDA launches
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("skew_matmul")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.rt_skew_matmul.argtypes = [
        i, i, i, p, ll, ll, ll, p, ll, ll, p, i, i, i, i, i, i, i, i,
        f, i, p, i, i, p, i, ll, ll, ll, p]
    lib.rt_skew_matmul.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def smem_bytes(dtype: torch.dtype, bm: int, bk: int, bn: int) -> int:
    """Shared memory of one plan block's tile set, A, B and an fp32 C
    (mirrors `tile_smem_bytes` in csrc/common.cuh): the budget within
    which K1 k_inner's ring fits (`k_inner_config`), and the limit on the
    blocks every matmul kernel takes (`check_blocks`)."""
    size = 2 if dtype == torch.bfloat16 else 4
    pad = 16 // size
    return (_round_up(bm * (bk + pad) * size, 128)
            + _round_up(bk * (bn + pad) * size, 128)
            + _round_up(bm * (bn + 4) * 4, 128))


@dataclasses.dataclass(frozen=True)
class KInnerConfig:
    """k_inner's shape on the card (mirrors `ki_config` in
    csrc/skew_matmul.cu).  The CTA covers `rows` x `tile_w` of the plan's
    (bm, bn) block.  rows: bf16 8 when the stacked rows fit in 8 (the
    MMA's other 8 rows read a zero row), else min(bm, 64, the 16-row
    granules the rows fill); fp32 16.  mr: 16-row fragments a warp holds
    (1 or 4, the only kernels built).  tile_w: the widest power-of-two
    multiple of 16 within bn and 128 (a 16-column strip for each of the 8
    warps, whose sums stay in registers), or, where that grid has fewer
    than `sms` CTAs, the narrower one `_narrow_tile` picks; for a
    transposed B (`b_trans`: copied n-major) halved until each slice is
    128 bytes deep.  A and B stream in `ks`-deep slices (a power of two
    dividing round_up(k, bk)) through `stages` >= 3 shared-memory stages
    (bf16 tiles unpadded and XOR-swizzled, fp32 tiles with a 16-byte row
    pad).  `smem` never exceeds the plan's tile set (`smem_bytes`) unless
    that cannot hold three 16-deep stages.  K9's k_inner uses the same
    record (`block_sparse_matmul.k_inner_config`), with mr = rows / 16 up
    to 4 and tiles up to 256 columns (two strips a warp)."""

    rows: int
    mr: int
    tile_w: int
    ks: int
    stages: int
    b_trans: bool
    gm: int
    gn: int
    smem: int


def _narrow_tile(gm: int, n: int, tw: int, sms: int) -> int:
    """Below a grid of `tw`-wide tiles that leaves SMs idle: the widest
    narrower power of two whose grid fills the card with its CTAs spread
    evenly (the busiest SM at most 1 / 0.85 of the mean), else the most
    even of those that fill it (16 columns at the least)."""
    best, best_bal = 16, -1.0
    w = tw // 2
    while w >= 16:
        ctas = gm * -(-n // w)
        if ctas >= sms or w == 16:
            bal = ctas / (sms * -(-ctas // sms))
            if bal >= 0.85:
                return w
            if bal > best_bal:
                best, best_bal = w, bal
        w //= 2
    return best


def _ki_stage_bytes(size: int, rows: int, tw: int, ks: int,
                    b_trans: bool) -> int:
    pad = 0 if size == 2 else 16 // size     # bf16 tiles are swizzled
    a = _round_up(rows * (ks + pad) * size, 128)
    b = (tw * (ks + pad) if b_trans else ks * (tw + pad)) * size
    return a + _round_up(b, 128)


def _ki_fixed_bytes(size: int, rows: int, ks: int) -> int:
    """The row offset table, and an 8-row tile's zero row."""
    return (_round_up(rows * 8, 128)
            + (_round_up(ks * size, 128) if rows < 16 else 0))


def _ki_ring(size: int, rows: int, tw: int, kp: int, b_trans: bool,
             plan: int) -> tuple[int, int, int]:
    """(ks, stages, smem) of the deepest ring for a tile width: a
    power-of-two slice up to 256 deep that divides kp and leaves room for
    >= 3 stages (at most 8) in the budget."""
    budget = max(plan, _ki_fixed_bytes(size, rows, 16)
                 + 3 * _ki_stage_bytes(size, rows, tw, 16, b_trans))
    ks = 256
    while ks >= 16:
        if kp % ks == 0:
            st = _ki_stage_bytes(size, rows, tw, ks, b_trans)
            fixed = _ki_fixed_bytes(size, rows, ks)
            stages = (budget - fixed) // st
            if stages >= 3:
                stages = min(stages, 8)
                return ks, stages, fixed + stages * st
        ks //= 2
    raise AssertionError("unreachable: 16-deep stages always fit")


@functools.lru_cache(maxsize=4096)
def k_inner_config(rows_total: int, k: int, n: int, bm: int, bk: int,
                   bn: int, dtype: torch.dtype, b_trans: bool,
                   sms: int) -> KInnerConfig:
    """The k_inner CTA tile, ring and grid for `rows_total` = nb * m
    stacked rows against a (k, n) B at the plan's blocks on a card with
    `sms` SMs."""
    size = 2 if dtype == torch.bfloat16 else 4
    if size == 4:
        rows = 16
    elif rows_total <= 8:
        rows = 8
    else:
        rows = min(bm, 64, _round_up(rows_total, 16))
    mr = 1 if rows <= 16 else 4
    tw = 16
    while 2 * tw <= bn and 2 * tw <= 128:
        tw *= 2
    gm = -(-rows_total // rows)
    if gm * -(-n // tw) < sms:
        tw = _narrow_tile(gm, n, tw, sms)
    plan = smem_bytes(dtype, bm, bk, bn)
    kp = _round_up(k, bk)
    ks, stages, smem = _ki_ring(size, rows, tw, kp, b_trans, plan)
    # a transposed B is read in runs of ks elements along k: narrow the
    # tile until they are 128 bytes long
    while b_trans and tw > 16 and ks * size < 128:
        tw //= 2
        ks, stages, smem = _ki_ring(size, rows, tw, kp, b_trans, plan)
    return KInnerConfig(rows, mr, tw, ks, stages, b_trans, gm, -(-n // tw),
                        smem)


@dataclasses.dataclass(frozen=True)
class AResidentConfig:
    """a_resident's shape on the card (mirrors `ard_config` in
    csrc/skew_matmul.cu).  rows / mr: k_inner's rule (bf16 8 rows when
    every row fits, the MMA's other 8 reading a zero row, else min(bm, 64,
    the 16-row granules m fills) with mr 4; fp32 16).  tile_w: 128 (a
    16-column strip for each of the 8 warps), narrowed as k_inner's where
    one tile a CTA would leave SMs idle, and for a transposed B until a
    slice is 128 bytes deep.  A stage holds one B slice (ks x tile_w) and
    one A buffer of a `group` = max(bk, ks) columns of k; ks is the deepest
    power of two up to 256 that divides round_up(k, bk), divides bk or (at
    a bk that is a multiple of 64) is a multiple of it, and leaves room for
    >= 3 `stages` (at most 8) within
    `A_RESIDENT_BUDGET` (two CTAs an SM).  `per` column tiles a CTA:
    the fewest that fit the grid in one wave of two CTAs an SM (the
    kernel's launch bound), at most 8 / mr (so a lane keeps 64 sums); the
    grid is (`chunks`, `gm`)."""

    rows: int
    mr: int
    tile_w: int
    ks: int
    group: int
    stages: int
    b_trans: bool
    per: int
    gm: int
    chunks: int
    smem: int

    @property
    def max_tiles(self) -> int:
        """Column tiles a CTA may hold: 8 / mr (8 sums a lane a tile and
        fragment)."""
        return 8 // self.mr


def _ar_stage_bytes(size: int, rows: int, group: int, tw: int, ks: int,
                    b_trans: bool) -> int:
    pad = 0 if size == 2 else 16 // size     # bf16 tiles are swizzled
    a = _round_up(group // ks * rows * (ks + pad) * size, 128)
    b = (tw * (ks + pad) if b_trans else ks * (tw + pad)) * size
    return a + _round_up(b, 128)


def _ar_fixed_bytes(size: int, rows: int, ks: int) -> int:
    """An 8-row tile's zero row."""
    return _round_up(ks * size, 128) if rows < 16 else 0


# a_resident's shared-memory budget: two CTAs an SM, its launch bound.
A_RESIDENT_BUDGET = (SMEM_MAX - 1024) // 2


def _ar_ring(size: int, rows: int, tw: int, kp: int, bk: int,
             b_trans: bool) -> tuple[int, int, int, int]:
    """(ks, group, stages, smem) of a_resident's deepest ring."""
    def stage(ks):
        return _ar_stage_bytes(size, rows, max(bk, ks), tw, ks, b_trans)
    budget = max(A_RESIDENT_BUDGET,
                 _ar_fixed_bytes(size, rows, 16) + 3 * stage(16))
    ks = 256
    while ks >= 16:
        # whole blocks a step only at a bk that is a multiple of 64 (the
        # kernel reads each block at an offset of the swizzled tiles)
        if kp % ks == 0 and (bk % ks == 0
                             or (ks % bk == 0 and bk % 64 == 0)):
            fixed = _ar_fixed_bytes(size, rows, ks)
            stages = (budget - fixed) // stage(ks)
            if stages >= 3:
                stages = min(stages, 8)
                return ks, max(bk, ks), stages, fixed + stages * stage(ks)
        ks //= 2
    raise AssertionError("unreachable: 16-deep stages always fit")


@functools.lru_cache(maxsize=4096)
def a_resident_config(m: int, k: int, n: int, bm: int, bk: int,
                      dtype: torch.dtype, b_trans: bool,
                      sms: int) -> AResidentConfig:
    """a_resident's rows, tile, ring and chunks for an (m, k) @ (k, n)
    product at the plan's (bm, bk) on a card with `sms` SMs (the plan's bn
    does not enter: the tile is the kernel's choice)."""
    size = 2 if dtype == torch.bfloat16 else 4
    if size == 4:
        rows = 16
    elif m <= 8:
        rows = 8
    else:
        rows = min(bm, 64, _round_up(m, 16))
    mr = 1 if rows <= 16 else 4
    gm = -(-m // rows)
    tw = 128
    if gm * -(-n // tw) < sms:
        tw = _narrow_tile(gm, n, tw, sms)
    kp = _round_up(k, bk)
    ks, group, stages, smem = _ar_ring(size, rows, tw, kp, bk, b_trans)
    while b_trans and tw > 16 and ks * size < 128:
        tw //= 2
        ks, group, stages, smem = _ar_ring(size, rows, tw, kp, bk, b_trans)
    tiles = -(-n // tw)
    rows_per_wave = max(1, 2 * sms // gm)
    per = min(8 // mr, -(-tiles // rows_per_wave))
    return AResidentConfig(rows, mr, tw, ks, group, stages, b_trans, per, gm,
                           -(-tiles // per), smem)


# ------------------------------------------------------------ b_resident
# The pieces K1's and K9's b_resident configs share (mirroring
# csrc/b_resident.cuh).
def br_width(bn: int, size: int) -> int:
    """The widest tile a plan's bn gives: bf16 a power-of-two multiple of
    16 within bn and 128, fp32 16 (`br_width`)."""
    tw = 16
    while 2 * tw <= bn and 2 * tw <= 128 and size == 2:
        tw *= 2
    return tw


def br_layout(rows: int, tw: int, size: int) -> tuple[int, int, int, int]:
    """(wr, wc, tile_w, mr): the 8 warps' grid over a row block's rows x tw
    tile, tw halved until mr (16-row fragments a warp, a power of two)
    fits 4 (bf16) or 2 (fp32) (`br_layout`)."""
    mr_max = 4 if size == 2 else 2
    bm16 = -(-rows // 16)
    while True:
        wc = tw // 16
        wr = 8 // wc
        need = -(-bm16 // wr)
        mr = 1
        while mr < need:
            mr *= 2
        if mr <= mr_max or tw == 16:
            return wr, wc, tw, mr
        tw //= 2


def br_stage_bytes(size: int, rows: int, bk: int, tw: int,
                   b_trans: bool) -> int:
    """One stage: an A block of `rows` rows and a B slice (n-major for a
    transposed B), rows padded by 16 bytes (`br_stage_bytes`)."""
    pad = 16 // size
    b = tw * (bk + pad) if b_trans else bk * (tw + pad)
    return _round_up(rows * (bk + pad) * size, 128) + _round_up(b * size, 128)


def br_ring(stage: int, fixed: int, smax: int) -> tuple[int, int]:
    """(stages, smem): smax (K9 4, K1 8) to 2 stages within two CTAs an
    SM, else within one, beside `fixed` bytes; (0, -1) when not even 2 fit
    (`br_ring`)."""
    for cap in ((SMEM_MAX - 1024) // 2, SMEM_MAX):
        for stages in range(smax, 1, -1):
            if stages * stage + fixed <= cap:
                return stages, stages * stage + fixed
    return 0, -1


@dataclasses.dataclass(frozen=True)
class BResidentConfig:
    """K1 b_resident's shape on the card (mirrors `brd_config` in
    csrc/skew_matmul.cu).  tile_w: K9's rule (`br_width`: bf16 the widest
    power-of-two multiple of 16 within bn and 128, fp32 16), narrowed as
    k_inner's where one row block a CTA would leave SMs idle; the 8 warps
    form a wr x wc grid over a row block's `rows` x tile_w tile (rows: bm,
    or at m < bm the 16-row granules of m, so decode holds one granule), a
    warp owning 16 * mr rows and one 16-column strip (`br_layout`).  A
    blocks of `rows` rows and B slices (n-major for a transposed B) stream
    through `stages` (2-8) shared-memory stages, two CTAs an SM where they
    fit (`br_ring`); `smem` is -1 when no shape fits.  `per` row blocks a
    CTA: as many as its
    registers allow (8 / mr), fewer where that would leave under 2 x SMs
    CTAs and more chunks can be had; the grid is (`chunks`, `gn`)."""

    rows: int
    wr: int
    wc: int
    tile_w: int
    mr: int
    stages: int
    b_trans: bool
    per: int
    chunks: int
    gn: int
    smem: int

    @property
    def max_rows(self) -> int:
        """Row blocks a CTA may hold: 8 / mr (8 sums a lane a row block
        and fragment)."""
        return 8 // self.mr


@functools.lru_cache(maxsize=4096)
def b_resident_config(m: int, k: int, n: int, bm: int, bk: int, bn: int,
                      dtype: torch.dtype, b_trans: bool,
                      sms: int) -> BResidentConfig:
    """K1 b_resident's tile, warp grid, ring and chunk for an (m, k) @
    (k, n) product at the plan's (bm, bk, bn) on a card with `sms` SMs (k
    does not enter: the walk covers round_up(k, bk))."""
    size = 2 if dtype == torch.bfloat16 else 4
    gm = -(-m // bm)
    tw = br_width(bn, size)
    if gm * -(-n // tw) < sms:
        tw = _narrow_tile(gm, n, tw, sms)
    rows = min(bm, _round_up(m, 16))
    wr, wc, tw, mr = br_layout(rows, tw, size)
    stages, smem = (0, -1) if mr > (4 if size == 2 else 2) else br_ring(
        br_stage_bytes(size, rows, bk, tw, b_trans), 0, 8)
    gn = -(-n // tw)
    per = max(1, min(8 // mr, gm))
    while per > 1 and -(-gm // per) * gn < 2 * sms:
        per -= 1
    return BResidentConfig(rows, wr, wc, tw, mr, stages, b_trans, per,
                           -(-gm // per), gn, smem)


def _dtype_flag(t: torch.Tensor, what: str) -> int:
    if t.dtype == torch.bfloat16:
        return 1
    if t.dtype == torch.float32:
        return 0
    raise TypeError(f"{what} must be bfloat16 or float32, got {t.dtype}")


def check_blocks(dtype: torch.dtype, bm: int, bk: int, bn: int) -> None:
    """Raise ValueError for blocks the CUDA kernels cannot take."""
    if min(bm, bk, bn) <= 0 or bm % 16 or bk % 16 or bn % 16:
        raise ValueError(f"CUDA kernels need positive blocks that are "
                         f"multiples of 16, got {(bm, bk, bn)}")
    need = smem_bytes(dtype, bm, bk, bn)
    if need > SMEM_MAX:
        raise ValueError(f"blocks {(bm, bk, bn)} need {need} bytes of shared "
                         f"memory, above the {SMEM_MAX} a CTA may use")


def epilogue_args(spec, bias, residual, device, n: int):
    """(scale, has_scale, bias_ptr, bias_bf16, act, res, res_bf16, res
    strides, keepalive) for a normalized epilogue spec."""
    spec = epilogue_mod.normalize_spec(spec)
    tokens = dict(spec)
    scale = float(tokens["scale"]) if "scale" in tokens else 1.0
    act = next((t for t in tokens if t in _ACTS and t is not None), None)
    keep = []
    bias_ptr, bias_bf16 = None, 0
    if "bias" in tokens:
        if bias is None or tuple(bias.shape) != (n,):
            raise ValueError("epilogue names 'bias': pass a (n,) vector")
        bias = bias.to(device).contiguous()
        keep.append(bias)
        bias_ptr, bias_bf16 = bias.data_ptr(), _dtype_flag(bias, "bias")
    res_ptr, res_bf16, rstrides = None, 0, (0, 0, 0)
    if "residual" in tokens:
        if residual is None:
            raise ValueError("epilogue names 'residual' but none was passed")
        if residual.device != device:
            raise ValueError("residual must be on the kernel's device")
        res_ptr, res_bf16 = residual.data_ptr(), _dtype_flag(residual,
                                                             "residual")
        st = residual.stride()
        rstrides = (0,) * (3 - len(st)) + tuple(st)
    return (scale, int("scale" in tokens), bias_ptr, bias_bf16, _ACTS[act],
            res_ptr, res_bf16, rstrides, keep)


def _launch(schedule: str, a3: torch.Tensor, b: torch.Tensor, bias,
            residual, *, bm: int, bk: int, bn: int, epilogue,
            out_dtype) -> torch.Tensor:
    """Launch the dense kernel on a (nb, m, k) view; returns (nb, m, n)."""
    nb, m, k = a3.shape
    k2, n = b.shape
    if not (a3.is_cuda and b.is_cuda):
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(a3.shape)} @ "
                         f"{tuple(b.shape)}")
    if b.device != a3.device:
        raise ValueError("A and B must be on the same CUDA device")
    if a3.dtype != b.dtype:
        raise TypeError(f"A and B dtypes differ: {a3.dtype} vs {b.dtype}")
    in_bf16 = _dtype_flag(a3, "A")
    out_bf16 = {torch.bfloat16: 1, torch.float32: 0}.get(out_dtype)
    if out_bf16 is None:
        raise TypeError(f"out_dtype must be bfloat16 or float32, "
                        f"got {out_dtype}")
    check_blocks(a3.dtype, bm, bk, bn)
    sid = SCHEDULE_IDS[schedule]
    sms = _sm_count(a3.device.index or 0)
    b_trans = b.stride(0) == 1 and b.stride(1) != 1
    if sid == 0:
        cfg = k_inner_config(nb * m, k, n, bm, bk, bn, a3.dtype, b_trans, sms)
        if cfg.gn > 65535:
            raise ValueError(f"grid too large: {cfg.gn} column tiles")
    elif sid == 1:
        if nb != 1:
            raise ValueError("a_resident takes one (m, k) operand")
        cfg = a_resident_config(m, k, n, bm, bk, a3.dtype, b_trans, sms)
        if cfg.gm > 65535:
            raise ValueError(f"grid too large: {cfg.gm} row tiles")
    else:
        if nb != 1:
            raise ValueError("b_resident takes one (m, k) operand")
        cfg = b_resident_config(m, k, n, bm, bk, bn, a3.dtype, b_trans, sms)
        if cfg.smem < 0:
            raise ValueError(f"b_resident cannot take blocks {(bm, bk)} of "
                             f"{a3.dtype}: no pipeline fits the {SMEM_MAX} "
                             f"bytes of shared memory a CTA may use")
        if cfg.gn > 65535:
            raise ValueError(f"grid too large: {cfg.gn} column tiles")
    if residual is not None:
        if tuple(residual.shape[-2:]) != (m, n) or (
                residual.dim() == 3 and residual.shape[0] != nb):
            raise ValueError(f"residual {tuple(residual.shape)} does not "
                             f"match the output {(nb, m, n)}")
        if residual.dim() == 3 and nb == 1:
            residual = residual[0]
    (scale, has_scale, bias_ptr, bias_bf16, act, res_ptr, res_bf16,
     rst, keep) = epilogue_args(epilogue, bias, residual, a3.device, n)
    out = torch.empty((nb, m, n), dtype=out_dtype, device=a3.device)
    sa = a3.stride()
    stream = torch.cuda.current_stream(a3.device).cuda_stream
    err = _lib().rt_skew_matmul(
        sid, in_bf16, out_bf16, a3.data_ptr(), sa[0], sa[1], sa[2],
        b.data_ptr(), b.stride(0), b.stride(1), out.data_ptr(), nb, m, k, n,
        bm, bk, bn, sms, scale, has_scale, bias_ptr, bias_bf16, act, res_ptr,
        res_bf16, rst[0], rst[1], rst[2], stream)
    build.check(err, f"skew_matmul[{schedule}]")
    # `keep` (a contiguous bias copy) may be freed once the launch is
    # enqueued: the caching allocator reuses it only for later work on
    # this stream.
    del keep
    return out


def skew_matmul_cuda(a, b, bias=None, residual=None, *, bm: int, bk: int,
                     bn: int, schedule: str = "k_inner", epilogue=None,
                     out_dtype=torch.float32) -> torch.Tensor:
    """K1 on the card: a (m, k) @ b (k, n) -> (m, n) in one launch."""
    if schedule not in SCHEDULE_IDS:
        raise ValueError(f"unknown schedule {schedule!r}")
    out = _launch(schedule, a.unsqueeze(0), b, bias, residual, bm=bm, bk=bk,
                  bn=bn, epilogue=epilogue, out_dtype=out_dtype)
    LAUNCHES[f"skew_matmul_{schedule}"] += 1
    return out[0]


def skew_matmul_batched_cuda(a, b, bias=None, residual=None, *, bm: int,
                             bk: int, bn: int, epilogue=None,
                             out_dtype=torch.float32) -> torch.Tensor:
    """K2 on the card: a (nb, m, k) @ b (k, n) -> (nb, m, n), one launch."""
    out = _launch("k_inner", a, b, bias, residual, bm=bm, bk=bk, bn=bn,
                  epilogue=epilogue, out_dtype=out_dtype)
    LAUNCHES["skew_matmul_batched"] += 1
    return out


# ------------------------------------------------------------ dispatch
def skew_matmul(a, b, bias=None, residual=None, *, bm: int, bk: int,
                bn: int, schedule: str = "k_inner", epilogue=None,
                out_dtype=torch.float32) -> torch.Tensor:
    """Dense family: the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    if a.is_cuda:
        return skew_matmul_cuda(a, b, bias, residual, bm=bm, bk=bk, bn=bn,
                                schedule=schedule, epilogue=epilogue,
                                out_dtype=out_dtype)
    if schedule not in SCHEDULE_IDS:
        raise ValueError(f"unknown schedule {schedule!r}")
    return skew_matmul_plain(a, b, bias, residual, bk=bk, epilogue=epilogue,
                             out_dtype=out_dtype)


def skew_matmul_batched(a, b, bias=None, residual=None, *, bm: int, bk: int,
                        bn: int, epilogue=None,
                        out_dtype=torch.float32) -> torch.Tensor:
    """Batched grid: the kernel for a CUDA tensor, else the plain version."""
    if a.is_cuda:
        return skew_matmul_batched_cuda(a, b, bias, residual, bm=bm, bk=bk,
                                        bn=bn, epilogue=epilogue,
                                        out_dtype=out_dtype)
    return skew_matmul_batched_plain(a, b, bias, residual, bk=bk,
                                     epilogue=epilogue, out_dtype=out_dtype)
