"""The pure functions that shape the redesigned kernels, on the CPU.

* K4 (`gemv_splitk_reduce`): `reduce_strip(gk)` keeps the gk x W fp32
  strip within the 227 KB of shared memory a block may use, as wide as
  that allows (W >= 32 up to gk 1816); a numpy mirror of the kernel's
  loops (stage a strip, fold each column level by level in place, or fold
  whole levels through a scratch first when not even 4 columns fit)
  equals the port's `tree_sum` bit for bit on random fp32 slabs.
* K9 a_resident: `a_resident_config` fits shared memory and keeps the
  warp layout the kernel assumes; `a_resident_chunk` gives chunks that
  cover every column tile exactly once, hold no more sums a lane than
  `AR_SUMS_PER_LANE`, and keep at least 2 x SMs CTAs where the grid
  allows, for SM counts 78, 114 and 132.
* K1 k_inner (and K2): `k_inner_config` keeps its ring within the plan's
  tile set (`smem_bytes`) and the 227 KB limit, covers each output column
  and stacked row exactly once, reaches >= 132 CTAs at decode on a
  132-SM card, and leaves today's grid where that already fills the card
  (bf16, row-major B; a block taller than 64 rows or wider than 128
  columns is covered by CTAs of 64 x 128, and a transposed B narrows the
  tile for 128-byte runs along k).
* K9 b_resident: `b_resident_config` / `b_resident_chunk` fit, lay out all
  8 warps, and cover every row block once; a numpy mirror of the kernel's
  walk (column blocks ascending, thread 0's merge of the rows' sorted
  lists) visits each (row block, nonzero block) once, in each row's s
  order, and fetches each B slice once per chunk.
* K9 k_inner: `block_sparse_matmul.k_inner_config` keeps each CTA's rows
  inside one row block, covers every output once, divides bk into its
  slices, fits shared memory at the tuner's blocks and the (128, 128, 64)
  fail-over, and takes the widest column tile (up to 256) whose grid fills
  a 78 / 114 / 132-SM card; a mirror of its walk visits each nonzero
  block's bk in ascending slices and is K1's dense walk at density 1.0.
* K1 a_resident: `skew_matmul.a_resident_config` sizes rows by the real
  rows (8 at decode), keeps whole k blocks in each step's fold, fits its
  ring, and chunks the column tiles so each is covered once within the
  register sums a lane may hold and the grid fits a wave of two CTAs an SM.
* K1 b_resident: `skew_matmul.b_resident_config` (K9's template walking
  every block) fits its ring in shared memory, lays out all 8 warps over
  the row block, covers every row block and column once, holds no more
  sums a lane than `AR_SUMS_PER_LANE`, and narrows the tile where one row
  block a CTA would leave SMs idle; a numpy mirror of its dense walk
  visits each (row block, k block) once in (k block, row block) order and
  fetches each B slice once per chunk.
* K3 (`gemv_splitk_partial`): `gemv_splitk.splitk_config` (K1's k_inner
  with the split walk) fits its ring in shared memory, divides bk into
  its slices, covers every output and every split exactly once, and fills
  a 132-SM card at the LM head and the decode projections; a mirror of its
  walk visits each split's slices in ascending k and stores the split's
  plane at its end, K1's dense walk over the slice pair.
* K5 (`grouped_matmul`): `grouped_matmul.grouped_config` fits, covers
  every output once, fills a 132-SM card at dbrx's decode and prefill
  shapes, and its prefill tile pads under a fifth of its MMA rows at
  m = 160; the prefill tile's two rows of four warps cover each (row,
  column) of the tile once.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import block_sparse_matmul as bsr
from repro_torch.kernels import gemv_splitk as gk_mod
from repro_torch.kernels import grouped_matmul as gmm_mod
from repro_torch.kernels import skew_matmul as mm

SMEM_MAX = 232_448
RNG = np.random.default_rng(16)


# ------------------------------------------------------------------ K4
@pytest.mark.parametrize("gk", [1, 2, 3, 24, 84, 101, 227, 228, 1000, 1800,
                                1816, 1817, 5000, 14528, 14529, 60000])
def test_reduce_strip_fits_shared_memory_and_is_as_wide_as_it_may_be(gk):
    w = gk_mod.reduce_strip(gk)
    assert w % 4 == 0 and 0 <= w <= gk_mod.REDUCE_MAX_W
    assert gk * w * 4 <= SMEM_MAX
    assert w == gk_mod.REDUCE_MAX_W or gk * (w + 4) * 4 > SMEM_MAX
    if gk <= 1816:
        assert w >= 32
    assert (w >= 4) == (gk <= 14528)


def test_reduce_strip_refuses_an_empty_slab():
    with pytest.raises(ValueError, match="gk"):
        gk_mod.reduce_strip(0)


def _fold_like_k4(slab: np.ndarray) -> np.ndarray:
    """K4's loops in numpy fp32: fold whole levels while no strip fits
    (splitk_fold_level_kernel, in place after the first level), then stage
    strips of W elements and fold each column in place level by level
    (splitk_reduce_kernel)."""
    gk, mn = slab.shape
    planes = slab
    length = gk
    while gk_mod.reduce_strip(length) == 0:
        h = length // 2
        nxt = planes.copy() if planes is slab else planes
        for i in range(h):
            nxt[i] = planes[i] + planes[i + h]
        if length % 2:
            nxt[h] = planes[2 * h]
        planes, length = nxt, h + length % 2
    w = gk_mod.reduce_strip(length)
    out = np.empty(mn, np.float32)
    for e0 in range(0, mn, w):
        sv = planes[:length, e0:e0 + w].copy()
        n_len = length
        while n_len > 1:
            h = n_len // 2
            for i in range(h):
                sv[i] = sv[i] + sv[i + h]
            if n_len % 2:
                sv[h] = sv[2 * h]
            n_len = h + n_len % 2
        out[e0:e0 + w] = sv[0]
    return out


@pytest.mark.parametrize("gk", list(range(1, 71, 3)) + [84, 300])
def test_k4_fold_order_equals_tree_sum_bitwise(gk):
    slab = (RNG.normal(size=(gk, 3, 7)) * 10.0 ** RNG.integers(
        -3, 4, size=(gk, 3, 7))).astype(np.float32)
    want = gk_mod.tree_sum(torch.from_numpy(slab)).numpy().reshape(-1)
    got = _fold_like_k4(slab.reshape(gk, -1))
    np.testing.assert_array_equal(got, want)


def test_k4_level_folds_above_the_staging_limit_keep_the_order():
    gk = 14529 + 8                     # two level folds before a strip fits
    slab = RNG.normal(size=(gk, 1, 2)).astype(np.float32)
    want = gk_mod.tree_sum(torch.from_numpy(slab)).numpy().reshape(-1)
    np.testing.assert_array_equal(_fold_like_k4(slab.reshape(gk, -1)), want)


# ------------------------------------------------------------------ K9
DTYPES = [torch.bfloat16, torch.float32]
BLOCKS = [(16, 16), (32, 128), (48, 64), (64, 64), (64, 128), (128, 128),
          (144, 128), (256, 64)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", BLOCKS)
def test_a_resident_config_fits_and_lays_out_all_warps(block, dtype):
    bm, bk = block
    cfg = bsr.a_resident_config(bm, bk, dtype)
    assert cfg.wr * cfg.wc == 8 and cfg.tile_w == 16 * cfg.wc
    assert cfg.mr in (1, 2, 4, 8)
    assert cfg.wr * cfg.mr * 16 >= bm            # the warps cover the rows
    if bm <= 128:
        assert cfg.wr == 1 and cfg.tile_w == 128  # all 8 warps split columns
    if cfg.smem < 0:
        return
    size = 2 if dtype == torch.bfloat16 else 4
    a = -(-bm * (bk + 16 // size) * size // 128) * 128
    assert bk % cfg.ks == 0 and cfg.ks % 16 == 0
    # the deepest slice of bk up to 128 that fits
    assert cfg.ks == max(d for d in (16, 32, 64, 128) if bk % d == 0) or \
        2 * a + 2 * (2 * cfg.ks) * (cfg.tile_w + 16 // size) * size > SMEM_MAX
    assert 2 * a + 2 * cfg.ks * cfg.tile_w * size <= cfg.smem
    assert cfg.smem <= SMEM_MAX


def test_a_resident_config_at_the_tuners_layouts():
    for dtype in DTYPES:
        assert bsr.a_resident_config(32, 128, dtype).smem > 0
        assert bsr.a_resident_config(128, 128, dtype).smem > 0
    c = bsr.a_resident_config(32, 128, torch.bfloat16)
    assert (c.mr, c.tile_w, c.max_tiles, c.ks) == (2, 128, 4, 128)


@pytest.mark.parametrize("sms", [78, 114, 132])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", BLOCKS)
def test_a_resident_chunks_cover_every_tile_once_and_fit(block, dtype, sms):
    bm, bk = block
    cfg = bsr.a_resident_config(bm, bk, dtype)
    for gm in (1, 3, 16, 128, 1000):
        for n in (1, 90, 128, 700, 4096, 200064):
            per = bsr.a_resident_chunk(gm, n, bm, bk, dtype, sms)
            tiles = -(-n // cfg.tile_w)
            assert 1 <= per <= max(1, min(cfg.max_tiles, tiles))
            assert per * cfg.mr * 8 <= bsr.AR_SUMS_PER_LANE
            chunks = -(-tiles // per)
            seen = [t for c in range(chunks)
                    for t in range(c * per, min(tiles, (c + 1) * per))]
            assert seen == list(range(tiles))      # each tile exactly once
            assert tiles * cfg.tile_w >= n > (tiles - 1) * cfg.tile_w
            if per > 1:                            # narrower would not
                assert gm * chunks >= 2 * sms      # have been needed
            if per < min(cfg.max_tiles, tiles):    # wider would starve
                assert gm * -(-tiles // (per + 1)) < 2 * sms


def test_a_resident_chunk_at_the_tuners_shape():
    # 4096^2, (32, 128), n 4096 on 132 SMs: 4 tiles of 128 columns a CTA,
    # 8 chunks x 128 row blocks = 1024 CTAs
    assert bsr.a_resident_chunk(128, 4096, 32, 128, torch.bfloat16, 132) == 4
    # (128, 128): one tile a CTA (64 sums a lane already)
    assert bsr.a_resident_chunk(32, 4096, 128, 128, torch.bfloat16, 132) == 1
    # a small grid takes narrower chunks to fill the card
    assert bsr.a_resident_chunk(100, 600, 32, 128, torch.bfloat16, 132) == 2


# ------------------------------------------------------------------ K1 k_inner
# (m, k, n, nb): phi4 decode o / down / gate-up rows, the LM head, prefill,
# K2's 4 x 1 and 4 x 128 rows, the tuner's 4096^3, small and ragged shapes
KI_SHAPES = [(4, 3072, 3072, 1), (4, 8192, 3072, 1), (4, 3072, 16384, 1),
             (4, 3072, 200064, 1), (1, 3072, 200064, 4), (512, 3072, 8192, 1),
             (128, 3072, 8192, 4), (4096, 4096, 4096, 1), (1, 3072, 3072, 1),
             (16, 3072, 3072, 1), (100, 320, 200, 1), (40, 192, 130, 3),
             (3, 700, 90, 5), (1, 16, 16, 1)]
KI_BLOCKS = [(64, 64, 128), (64, 128, 128), (128, 64, 128), (16, 16, 16),
             (64, 64, 64), (32, 64, 256), (256, 16, 64), (64, 64, 192),
             (48, 80, 112)]


@pytest.mark.parametrize("sms", [78, 132])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("blocks", KI_BLOCKS)
def test_k_inner_config_fits_and_covers_every_output_once(blocks, dtype, sms):
    bm, bk, bn = blocks
    if mm.smem_bytes(dtype, bm, bk, bn) > SMEM_MAX:
        with pytest.raises(ValueError, match="shared"):
            mm.check_blocks(dtype, bm, bk, bn)
        return
    size = 2 if dtype == torch.bfloat16 else 4
    for m, k, n, nb in KI_SHAPES:
        for b_trans in (False, True):
            c = mm.k_inner_config(nb * m, k, n, bm, bk, bn, dtype, b_trans,
                                  sms)
            # the ring: >= 3 stages of a power-of-two slice dividing the
            # zero-padded k, within the plan's tile set (or three 16-deep
            # stages where that cannot hold them) and the 227 KB limit
            assert c.stages >= 3 and c.ks & (c.ks - 1) == 0 and c.ks >= 16
            assert -(-k // bk) * bk % c.ks == 0
            pad = 0 if size == 2 else 16 // size   # bf16 tiles: swizzled
            a_bytes = -(-c.rows * (c.ks + pad) * size // 128) * 128
            b_elems = (c.tile_w * (c.ks + pad) if b_trans
                       else c.ks * (c.tile_w + pad))
            stage = a_bytes + -(-b_elems * size // 128) * 128
            assert stage == mm._ki_stage_bytes(size, c.rows, c.tile_w, c.ks,
                                               b_trans)
            table = -(-c.rows * 8 // 128) * 128
            zrow = -(-c.ks * size // 128) * 128 if c.rows < 16 else 0
            assert c.smem == table + zrow + c.stages * stage <= SMEM_MAX
            floor = (table + (32 * size if c.rows < 16 else 0)
                     + 3 * mm._ki_stage_bytes(size, c.rows, c.tile_w, 16,
                                              b_trans))
            assert c.smem <= max(mm.smem_bytes(dtype, bm, bk, bn), floor)
            # the tile: 16-row granules within bm (at most 64 rows for
            # bf16, 16 for fp32: a warp holds 1 or 4 fragments, the only
            # kernels built), or 8 rows of bf16 when every row fits; a
            # power-of-two number of 16-column strips within bn, at most
            # one a warp, and at most 64 sums a lane
            if size == 2 and nb * m <= 8:
                assert c.rows == 8
            else:
                assert c.rows % 16 == 0
                assert c.rows <= min(bm, 64 if size == 2 else 16)
            assert c.mr == (1 if c.rows <= 16 else 4)
            assert c.tile_w % 16 == 0 and c.tile_w & (c.tile_w - 1) == 0
            assert c.tile_w <= min(128, max(16, bn))
            assert c.mr * 8 <= bsr.AR_SUMS_PER_LANE
            if b_trans and c.tile_w > 16:     # runs of 128 bytes along k
                assert c.ks * size >= 128
            # every stacked row and every column exactly once
            rows = [c.rows * i + r for i in range(c.gm)
                    for r in range(c.rows) if c.rows * i + r < nb * m]
            assert rows == list(range(nb * m))
            cols = [c.tile_w * j + x for j in range(c.gn)
                    for x in range(c.tile_w) if c.tile_w * j + x < n]
            assert cols == list(range(n))
            assert (c.gm - 1) * c.rows < nb * m <= c.gm * c.rows


@pytest.mark.parametrize("n", [3072, 8192, 16384, 200064])
def test_k_inner_config_fills_a_132_sm_card_at_decode(n):
    for m, b_trans in ((1, False), (4, False), (16, False), (4, True)):
        c = mm.k_inner_config(m, 3072, n, 64, 64, 128, torch.bfloat16,
                              b_trans, 132)
        assert c.gm * c.gn >= 132
        # one MMA granule, not 64 rows; up to 8 rows, half of it
        assert c.rows == (8 if m <= 8 else 16) and c.mr == 1
    # today's grid at n = 3072 is 24 CTAs; 16-column tiles give 192
    c = mm.k_inner_config(4, 3072, 3072, 64, 64, 128, torch.bfloat16, False,
                          132)
    assert (c.tile_w, c.gm * c.gn) == (16, 192)
    # n = 5120: 320 CTAs of 16 columns (2.4 an SM, the busiest 3), not 160
    # of 32 (the busiest SM 2 against a mean of 1.2); n = 8192 and 16384:
    # the widest tile that fills the card evenly
    for n, tw in ((5120, 16), (8192, 32), (16384, 64), (6144, 16)):
        c = mm.k_inner_config(4, 3072, n, 64, 64, 128, torch.bfloat16,
                              False, 132)
        assert c.tile_w == tw
    # the LM head's E^T: 128 columns a CTA, read 64 deep (128 bytes a row)
    c = mm.k_inner_config(4, 3072, 200064, 64, 64, 128, torch.bfloat16, True,
                          132)
    assert (c.tile_w, c.ks, c.stages) == (128, 64, 3)
    # the decode o / down projections: 8 rows, 16 columns, 256 deep
    c = mm.k_inner_config(4, 8192, 3072, 64, 64, 128, torch.bfloat16, False,
                          132)
    assert (c.rows, c.tile_w, c.ks, c.stages) == (8, 16, 256, 4)


def test_k_inner_config_stacks_decode_batches_into_one_row_tile():
    # K2 at 4 x 1 rows: one row tile, B read once; the same grid as K1 at
    # 4 rows
    k2 = mm.k_inner_config(4 * 1, 3072, 200064, 64, 64, 128, torch.bfloat16,
                           True, 132)
    k1 = mm.k_inner_config(4, 3072, 200064, 64, 64, 128, torch.bfloat16,
                           True, 132)
    assert k2 == k1 and k2.gm == 1
    # prefill batches of 128 rows: 64-row tiles that never straddle slices
    c = mm.k_inner_config(4 * 128, 3072, 8192, 64, 64, 128, torch.bfloat16,
                          False, 132)
    assert (c.rows, c.gm) == (64, 8)


@pytest.mark.parametrize("sms", [78, 114, 132])
@pytest.mark.parametrize("blocks", [(64, 64, 128), (64, 128, 128),
                                    (128, 64, 128), (64, 64, 64),
                                    (32, 64, 256), (16, 16, 16)])
def test_k_inner_config_keeps_todays_grid_where_it_fills_the_card(blocks,
                                                                  sms):
    bm, bk, bn = blocks
    for m, k, n in ((512, 3072, 8192), (4096, 4096, 4096), (4, 3072, 200064),
                    (100, 320, 200), (256, 1024, 1024)):
        today = -(-m // bm) * -(-n // bn)
        c = mm.k_inner_config(m, k, n, bm, bk, bn, torch.bfloat16, False,
                              sms)
        rows = min(bm, 64)           # a taller block: 64-row CTAs
        if today >= sms and bn <= 128:
            assert (c.gm, c.gn, c.tile_w) == (-(-m // rows), -(-n // bn),
                                              bn)
        elif today >= sms:           # a wider block: 128-column CTAs
            assert (c.gm, c.tile_w) == (-(-m // rows), 128)
        else:
            assert c.gm * c.gn >= min(sms, c.gm * -(-n // 16))


# ------------------------------------------------------------------ K9 b_resident
@pytest.mark.parametrize("bn", [16, 64, 128, 256])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", BLOCKS)
def test_b_resident_config_fits_and_lays_out_all_warps(block, dtype, bn):
    bm, bk = block
    cfg = bsr.b_resident_config(bm, bk, bn, dtype)
    assert cfg.wr * cfg.wc == 8 and cfg.tile_w == 16 * cfg.wc
    assert cfg.tile_w <= min(128, bn) and cfg.tile_w & (cfg.tile_w - 1) == 0
    assert cfg.mr in (1, 2, 4, 8)
    if dtype == torch.float32:
        assert cfg.tile_w == 16
    if cfg.smem > 0:                 # only mr <= 4 (bf16) / 2 (fp32) built
        assert cfg.mr <= (4 if dtype == torch.bfloat16 else 2)
        assert cfg.wr * cfg.mr * 16 >= bm       # the warps cover the rows
    assert cfg.max_rows * cfg.mr * 8 <= bsr.AR_SUMS_PER_LANE
    if cfg.smem < 0:
        return
    size = 2 if dtype == torch.bfloat16 else 4
    pad = 16 // size
    stage = (-(-bm * (bk + pad) * size // 128) * 128
             + -(-bk * (cfg.tile_w + pad) * size // 128) * 128)
    assert 2 <= cfg.stages <= 4
    assert cfg.smem == cfg.stages * stage + bsr.BR_CTL_BYTES <= SMEM_MAX
    two_per_sm = (SMEM_MAX - 1024) // 2
    if cfg.stages < 4 and cfg.smem <= two_per_sm:   # a deeper ring would
        assert (cfg.stages + 1) * stage + bsr.BR_CTL_BYTES > two_per_sm


@pytest.mark.parametrize("block", [(32, 128), (64, 64), (128, 128)])
def test_b_resident_config_puts_all_8_warps_on_the_tuners_blocks(block):
    for dtype in DTYPES:
        cfg = bsr.b_resident_config(*block, 64, dtype)
        assert cfg.smem > 0 and cfg.wr * cfg.wc == 8
        # every warp has a fragment of every row block: rows and strips
        # tile the bm x tile_w tile (bf16: 64 columns, fp32: 16)
        assert cfg.tile_w == (64 if dtype == torch.bfloat16 else 16)
        assert cfg.wr * cfg.mr * 16 == max(16 * cfg.wr, block[0])
    c = bsr.b_resident_config(32, 128, 64, torch.bfloat16)
    assert (c.wr, c.wc, c.mr, c.max_rows, c.stages) == (2, 4, 1, 8, 4)
    # 4096^2, (32, 128), n 4096 on 132 SMs: 8 row blocks a CTA, 16 chunks
    # x 64 column tiles = 1024 CTAs
    assert bsr.b_resident_chunk(128, 4096, 32, 128, 64, torch.bfloat16,
                                132) == 8


@pytest.mark.parametrize("sms", [78, 132])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", BLOCKS)
def test_b_resident_chunks_cover_every_row_block_once(block, dtype, sms):
    bm, bk = block
    for bn in (64, 128):
        cfg = bsr.b_resident_config(bm, bk, bn, dtype)
        for gm in (1, 3, 16, 100, 128, 1000):
            for n in (90, 700, 4096):
                per = bsr.b_resident_chunk(gm, n, bm, bk, bn, dtype, sms)
                assert 1 <= per <= max(1, min(cfg.max_rows, gm))
                chunks = -(-gm // per)
                seen = [i for c in range(chunks)
                        for i in range(c * per, min(gm, (c + 1) * per))]
                assert seen == list(range(gm))
                tiles = -(-n // cfg.tile_w)
                if per > 1:
                    assert chunks * tiles >= 2 * sms
                if per < min(cfg.max_rows, gm):
                    assert -(-gm // (per + 1)) * tiles < 2 * sms


def _b_resident_walk(cols: np.ndarray, nnz: np.ndarray, i0: int, per: int):
    """The kernel's steps for the CTA holding row blocks i0 .. i0 + per - 1:
    thread 0 keeps one cursor per row block; a step takes, within the
    current column block, the next row block (in row order) whose cursor
    points at it, else opens the smallest column block at any cursor (and
    fetches its B slice).  Returns the steps and the column blocks opened."""
    rows = list(range(i0, min(i0 + per, len(nnz))))
    cur = np.zeros(len(rows), np.int64)
    big = np.iinfo(np.int64).max
    head = np.array([cols[i, 0] if nnz[i] else big for i in rows])
    kb, rr = -1, len(rows)
    steps, opened = [], []
    for _ in range(int(nnz[rows].sum())):
        nxt = [j for j in range(rr + 1, len(rows)) if head[j] == kb]
        if nxt:
            r = nxt[0]
        else:
            kb = int(head.min())
            opened.append(kb)
            r = int(np.flatnonzero(head == kb)[0])
        rr = r
        steps.append((rows[r], kb))
        cur[r] += 1
        head[r] = cols[rows[r], cur[r]] if cur[r] < nnz[rows[r]] else big
    return steps, opened


def _random_layout(gm: int, gk: int, density: float, seed: int,
                   empty_every: int = 0):
    rng = np.random.default_rng(seed)
    mask = rng.random((gm, gk)) < density
    if empty_every:
        mask[::empty_every] = False
    nnz = mask.sum(1)
    cols = np.zeros((gm, max(1, gk)), np.int64)
    for i in range(gm):
        c = np.flatnonzero(mask[i])
        cols[i, :len(c)] = c
    return cols, nnz


@pytest.mark.parametrize("case", [
    # (gm, gk, density, seed, empty_every, per)
    (128, 32, 0.25, 0, 0, 8), (128, 32, 0.5, 1, 0, 8), (128, 32, 1.0, 2, 0, 8),
    (32, 32, 0.1, 3, 0, 2), (32, 32, 0.4, 4, 0, 2), (64, 64, 0.05, 5, 3, 4),
    (32, 12, 0.5, 6, 3, 8),      # a ragged last row block (m = 1000 at bm 32)
    (7, 5, 0.0, 7, 0, 8), (9, 40, 0.3, 8, 2, 3), (1, 1, 1.0, 9, 0, 1),
    (50, 20, 0.7, 10, 5, 7)])
def test_b_resident_walk_visits_every_block_once_in_s_order(case):
    gm, gk, density, seed, empty_every, per = case
    cols, nnz = _random_layout(gm, gk, density, seed, empty_every)
    visits = []
    for i0 in range(0, gm, per):
        steps, opened = _b_resident_walk(cols, nnz, i0, per)
        # each B slice once per chunk, in ascending order
        assert opened == sorted(set(opened))
        assert opened == sorted({kb for _, kb in steps})
        kbs = [kb for _, kb in steps]
        assert kbs == sorted(kbs)
        visits += steps
    assert sorted(visits) == sorted((i, int(cols[i, s])) for i in range(gm)
                                    for s in range(nnz[i]))
    assert len(set(visits)) == len(visits)
    for i in range(gm):           # each row's blocks arrive in its s order
        assert [kb for r, kb in visits if r == i] == list(cols[i, :nnz[i]])


# ------------------------------------------------------------------ K9 k_inner
# (bm, bk, bn): the tuner's layouts, the (128, 128, 64) fail-over plan, and
# small, odd and tall blocks
BKI_BLOCKS = [(32, 128, 64), (64, 64, 64), (128, 128, 64), (128, 128, 128),
              (16, 16, 16), (48, 64, 64), (144, 128, 64), (256, 64, 64),
              (64, 80, 64)]
BKI_SHAPES = [(4096, 4096), (1000, 700), (100, 200), (3200, 600), (256, 192),
              (20, 16), (4096, 64)]


def _bki_stage(size: int, rows: int, tw: int, ks: int, b_trans: bool) -> int:
    a = -(-rows * (ks + (0 if size == 2 else 16 // size)) * size // 128) * 128
    pad = 0 if size == 2 else 16 // size
    b = (tw * (ks + pad) if b_trans else ks * (tw + pad)) * size
    return a + -(-b // 128) * 128


@pytest.mark.parametrize("sms", [78, 114, 132])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("blocks", BKI_BLOCKS)
def test_bsr_k_inner_config_fits_and_covers_every_output_once(blocks, dtype,
                                                              sms):
    bm, bk, bn = blocks
    size = 2 if dtype == torch.bfloat16 else 4
    cap = 256 if size == 2 else 128
    for m, n in BKI_SHAPES:
        for b_trans in (False, True):
            c = bsr.k_inner_config(m, n, bm, bk, dtype, b_trans, sms)
            # rows: a power-of-two number of 16-row fragments dividing bm,
            # so that no CTA's rows cross a row block
            assert c.rows in ((16, 32, 64) if size == 2 else (16,))
            assert bm % c.rows == 0 and c.mr == c.rows // 16
            if size == 2:
                assert c.rows == max(r for r in (16, 32, 64) if bm % r == 0)
            for i in range(c.gm):
                r0, r1 = i * c.rows, min(m, (i + 1) * c.rows) - 1
                assert r0 // bm == r1 // bm
            # every row and column exactly once
            assert (c.gm - 1) * c.rows < m <= c.gm * c.rows
            cols = [c.tile_w * j + x for j in range(c.gn)
                    for x in range(c.tile_w) if c.tile_w * j + x < n]
            assert cols == list(range(n))
            # the slice divides bk: no slice straddles two nonzero blocks
            assert bk % c.ks == 0 and c.ks & (c.ks - 1) == 0 and c.ks >= 16
            assert 3 <= c.stages <= 8
            table = -(-c.rows * 8 // 128) * 128
            stage = _bki_stage(size, c.rows, c.tile_w, c.ks, b_trans)
            assert stage == mm._ki_stage_bytes(size, c.rows, c.tile_w, c.ks,
                                               b_trans)
            assert c.smem == table + c.stages * stage <= SMEM_MAX
            floor = table + 3 * _bki_stage(size, c.rows, c.tile_w, 16,
                                           b_trans)
            assert c.smem <= max(bsr.K_INNER_BUDGET, floor)
            # the column tile: the widest power of two up to 256 (fp32 128)
            # whose grid fills the card (16 at the least); a transposed B
            # narrows it further for 128-byte runs along k
            assert c.tile_w & (c.tile_w - 1) == 0 and 16 <= c.tile_w <= cap
            fills = c.gm * c.gn >= sms
            assert fills or c.tile_w == 16 or b_trans
            if c.tile_w < cap and not b_trans:
                assert c.gm * -(-n // (2 * c.tile_w)) < sms
            if b_trans and c.tile_w > 16:
                assert c.ks * size >= 128
            # a warp's sums: mr fragments of each of its strips (two at 256)
            strips = 2 if c.tile_w > 128 else 1
            assert c.mr * strips * 8 <= bsr.AR_SUMS_PER_LANE


def test_bsr_k_inner_config_at_the_tuners_layouts():
    # 4096^2, (32, 128), n 4096 on 132 SMs: 32 rows (2 fragments), 256
    # columns, so each nonzero A block is read 16 times, not 64; 128 row
    # blocks x 16 tiles = 2048 CTAs, two an SM
    c = bsr.k_inner_config(4096, 4096, 32, 128, torch.bfloat16, False, 132)
    assert (c.rows, c.mr, c.tile_w, c.gm, c.gn) == (32, 2, 256, 128, 16)
    assert (c.ks, c.stages) == (64, 3) and 2 * (c.smem + 1024) <= 233_472
    # the fail-over (128, 128, 64): two CTAs of 64 rows a row block
    c = bsr.k_inner_config(4096, 4096, 128, 128, torch.bfloat16, False, 132)
    assert (c.rows, c.mr, c.tile_w, c.gm) == (64, 4, 256, 64)
    for dtype in DTYPES:
        for bm, bk in ((32, 128), (64, 64), (128, 128)):
            c = bsr.k_inner_config(4096, 4096, bm, bk, dtype, False, 132)
            assert c.smem <= SMEM_MAX and c.gm * c.gn >= 132


def _k_inner_walk(cols: np.ndarray, nnz: np.ndarray, i: int, bk: int,
                  ks: int) -> list[int]:
    """The k offsets of K9 k_inner's steps for row block i: the kernel's
    copy cursor (block s, slice sl) advanced one step at a time over
    nnz[i] * bk / ks steps, at cols[i, s] * bk + sl * ks."""
    ks_per = bk // ks
    s = sl = 0
    walk = []
    for _ in range(int(nnz[i]) * ks_per):
        walk.append(int(cols[i, s]) * bk + sl * ks)
        sl += 1
        if sl == ks_per:
            sl, s = 0, s + 1
    return walk


@pytest.mark.parametrize("case", [
    # (gm, gk, density, seed, empty_every, bk, ks)
    (128, 32, 0.25, 0, 0, 128, 64), (128, 32, 0.5, 1, 0, 128, 128),
    (128, 32, 1.0, 2, 0, 128, 64), (32, 32, 0.1, 3, 0, 128, 32),
    (32, 32, 0.4, 4, 0, 128, 32), (64, 64, 0.05, 5, 3, 64, 16),
    (32, 12, 0.5, 6, 3, 128, 128), (7, 5, 0.0, 7, 0, 64, 64),
    (9, 40, 0.3, 8, 2, 80, 16), (1, 1, 1.0, 9, 0, 16, 16),
    (50, 20, 1.0, 10, 0, 256, 64)])
def test_bsr_k_inner_walk_visits_each_block_in_ascending_slices(case):
    gm, gk, density, seed, empty_every, bk, ks = case
    cols, nnz = _random_layout(gm, gk, density, seed, empty_every)
    for i in range(gm):
        walk = _k_inner_walk(cols, nnz, i, bk, ks)
        # ascending, ks apart inside a block, each slice inside one block
        assert walk == sorted(set(walk))
        assert all(k0 // bk == (k0 + ks - 1) // bk for k0 in walk)
        want = [int(c) * bk + sl for c in cols[i, :nnz[i]]
                for sl in range(0, bk, ks)]
        assert walk == want
        if nnz[i] == gk:            # a full row: K1's dense walk exactly
            assert walk == list(range(0, gk * bk, ks))


# ------------------------------------------------------------------ K1 a_resident
AR_SHAPES = [(m, k, n) for m, k, n, nb in KI_SHAPES if nb == 1] + [
    (8, 4096, 4096), (4, 4096, 4096), (1, 4096, 4096), (17, 256, 1000)]


@pytest.mark.parametrize("sms", [78, 114, 132])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("blocks", KI_BLOCKS)
def test_dense_a_resident_config_fits_and_covers_every_output_once(
        blocks, dtype, sms):
    bm, bk, bn = blocks
    if mm.smem_bytes(dtype, bm, bk, bn) > SMEM_MAX:
        return                       # check_blocks refuses these blocks
    size = 2 if dtype == torch.bfloat16 else 4
    pad = 0 if size == 2 else 16 // size
    for m, k, n in AR_SHAPES:
        for b_trans in (False, True):
            c = mm.a_resident_config(m, k, n, bm, bk, dtype, b_trans, sms)
            # rows sized by the real rows (k_inner's rule)
            if size == 2 and m <= 8:
                assert c.rows == 8 and c.mr == 1 and c.max_tiles == 8
            else:
                assert c.rows % 16 == 0
                assert c.rows <= min(bm, 64 if size == 2 else 16)
            assert c.mr == (1 if c.rows <= 16 else 4)
            assert (c.gm - 1) * c.rows < m <= c.gm * c.rows
            # the ring: a power-of-two slice dividing round_up(k, bk) that
            # divides bk or, at a bk that is a multiple of 64, is a
            # multiple of it (the fold needs whole blocks, read at offsets
            # of the swizzled tiles), its A buffer max(bk, ks) columns
            kp = -(-k // bk) * bk
            assert c.ks & (c.ks - 1) == 0 and 16 <= c.ks <= 256
            assert kp % c.ks == 0 and (
                bk % c.ks == 0 or (c.ks % bk == 0 and bk % 64 == 0))
            assert c.group == max(bk, c.ks) and kp % c.group == 0
            assert 3 <= c.stages <= 8
            a_bytes = -(-c.group // c.ks * c.rows * (c.ks + pad) * size
                        // 128) * 128
            b_el = (c.tile_w * (c.ks + pad) if b_trans
                    else c.ks * (c.tile_w + pad))
            stage = a_bytes + -(-b_el * size // 128) * 128
            zrow = -(-c.ks * size // 128) * 128 if c.rows < 16 else 0
            assert c.smem == zrow + c.stages * stage <= SMEM_MAX
            assert c.smem <= mm.A_RESIDENT_BUDGET or c.stages == 3
            if c.stages < 8:              # no deeper ring fits the budget
                assert zrow + (c.stages + 1) * stage > max(
                    mm.A_RESIDENT_BUDGET, c.smem)
            # chunks: every column tile exactly once, within the sums a
            # lane may hold; the fewest tiles a CTA that fit the grid in
            # one wave of two CTAs an SM, where 8 / mr tiles allow it
            tiles = -(-n // c.tile_w)
            assert 1 <= c.per <= min(c.max_tiles, tiles)
            assert c.per * c.mr * 8 <= bsr.AR_SUMS_PER_LANE
            assert c.chunks == -(-tiles // c.per)
            seen = [t for ch in range(c.chunks)
                    for t in range(ch * c.per, min(tiles, (ch + 1) * c.per))]
            assert seen == list(range(tiles))
            assert tiles * c.tile_w >= n > (tiles - 1) * c.tile_w
            if c.per < c.max_tiles and c.gm <= 2 * sms:
                assert c.gm * c.chunks <= 2 * sms
            if c.per > 1:
                assert c.gm * -(-tiles // (c.per - 1)) > 2 * sms
            assert c.tile_w & (c.tile_w - 1) == 0 and 16 <= c.tile_w <= 128
            if b_trans and c.tile_w > 16:
                assert c.ks * size >= 128


def test_dense_a_resident_config_at_decode_and_the_lm_head():
    bf = torch.bfloat16
    # the LM head's E^T: 8 rows (4 real), 128 columns, a 128-deep slice (two
    # k blocks) in 3 stages of 34 KB, 6 tiles (768 columns) a CTA: 261 CTAs,
    # one wave of two an SM (5 tiles would give 313, a wave and a fifth)
    c = mm.a_resident_config(4, 3072, 200064, 64, 64, bf, True, 132)
    assert (c.rows, c.mr, c.tile_w, c.ks, c.group, c.stages) == (
        8, 1, 128, 128, 128, 3)
    assert (c.per, c.chunks, c.gm) == (6, 261, 1)
    # the tuner's decode class 4 x 4096 x 4096: k_inner's 16-column tiles,
    # 256 CTAs of one tile, 256 deep at both candidate plans (two k blocks
    # of 128 or four of 64 a step, each folded on its own)
    for m in (1, 4, 8):
        for bk in (128, 64):
            c = mm.a_resident_config(m, 4096, 4096, 64, bk, bf, False, 132)
            assert (c.rows, c.tile_w, c.per, c.chunks) == (8, 16, 1, 256)
            assert (c.ks, c.group, c.stages) == (256, 256, 8)
    # chunks cover the columns at n = 4096 and 200064 on a 132-SM card
    for n in (4096, 200064):
        c = mm.a_resident_config(4, 3072, n, 64, 64, bf, False, 132)
        tiles = -(-n // c.tile_w)
        assert c.chunks * c.per >= tiles > (c.chunks - 1) * c.per


# ------------------------------------------------------------------ K1 b_resident
@pytest.mark.parametrize("sms", [78, 114, 132])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("blocks", KI_BLOCKS)
def test_dense_b_resident_config_fits_and_covers_every_row_block_once(
        blocks, dtype, sms):
    bm, bk, bn = blocks
    if mm.smem_bytes(dtype, bm, bk, bn) > SMEM_MAX:
        return                       # check_blocks refuses these blocks
    size = 2 if dtype == torch.bfloat16 else 4
    pad = 16 // size
    for m, k, n, nb in KI_SHAPES:
        if nb != 1:
            continue
        for b_trans in (False, True):
            c = mm.b_resident_config(m, k, n, bm, bk, bn, dtype, b_trans,
                                     sms)
            # all 8 warps over the row block's bm x tile_w tile
            assert c.wr * c.wc == 8 and c.tile_w == 16 * c.wc
            assert c.tile_w & (c.tile_w - 1) == 0
            assert 16 <= c.tile_w <= min(128, max(16, bn))
            if size == 4:
                assert c.tile_w == 16
            assert c.mr in (1, 2, 4) and c.mr <= (4 if size == 2 else 2)
            # the warps cover the rows a row block holds: bm, or the
            # 16-row granules of m where there is one row block
            assert c.rows == min(bm, -(-m // 16) * 16)
            assert c.wr * c.mr * 16 >= c.rows
            # the ring: 2-8 stages of an A block and a B slice, two CTAs
            # an SM where they fit
            b_el = (c.tile_w * (bk + pad) if b_trans
                    else bk * (c.tile_w + pad))
            stage = (-(-c.rows * (bk + pad) * size // 128) * 128
                     + -(-b_el * size // 128) * 128)
            assert 2 <= c.stages <= 8
            assert c.smem == c.stages * stage <= SMEM_MAX
            two_per_sm = (SMEM_MAX - 1024) // 2
            if c.stages < 8 and c.smem <= two_per_sm:
                assert (c.stages + 1) * stage > two_per_sm
            # chunks: every row block once, within the sums a lane holds
            gm = -(-m // bm)
            assert 1 <= c.per <= min(c.max_rows, gm)
            assert c.per * c.mr * 8 <= bsr.AR_SUMS_PER_LANE
            assert c.chunks == -(-gm // c.per)
            seen = [i for ch in range(c.chunks)
                    for i in range(ch * c.per, min(gm, (ch + 1) * c.per))]
            assert seen == list(range(gm))
            assert c.gn == -(-n // c.tile_w)
            if c.per > 1:
                assert c.chunks * c.gn >= 2 * sms
            if c.per < min(c.max_rows, gm):
                assert -(-gm // (c.per + 1)) * c.gn < 2 * sms
            # a tile narrower than the plan's only where the plan's grid
            # would leave SMs idle
            widest = mm.br_width(bn, size)
            if gm * -(-n // widest) >= sms:
                assert c.tile_w == mm.br_layout(c.rows, widest, size)[2]
            else:
                assert c.gn * gm >= min(sms, gm * -(-n // 16))


def test_dense_b_resident_config_at_the_lm_head_and_4096():
    bf = torch.bfloat16
    # the LM head's E^T at (64, 64, 128): one row block whose 4 rows fill
    # one 16-row granule, so a warp holds one 16 x 16 fragment of a
    # 128-column tile (two CTAs an SM), 5 stages of 20 KB (16 A rows, E^T
    # n-major), 1563 CTAs
    c = mm.b_resident_config(4, 3072, 200064, 64, 64, 128, bf, True, 132)
    assert (c.rows, c.wr, c.wc, c.tile_w, c.mr, c.stages, c.smem) == (
        16, 1, 8, 128, 1, 5, 103680)
    assert (c.per, c.chunks, c.gn) == (1, 1, 1563)
    # 4096^3 at the same plan: 2 of the 64 row blocks a CTA (8 sums a lane
    # a fragment, 4 fragments), 32 x 32 = 1024 CTAs
    c = mm.b_resident_config(4096, 4096, 4096, 64, 64, 128, bf, False, 132)
    assert (c.tile_w, c.mr, c.stages, c.per, c.chunks, c.gn) == (
        128, 4, 4, 2, 32, 32)
    # the decode o projection 4 x 3072 x 3072: 24 tiles of 128 would leave
    # 108 SMs idle, so 16-column tiles (192 CTAs), a warp a 16-row fragment
    c = mm.b_resident_config(4, 3072, 3072, 64, 64, 128, bf, False, 132)
    assert (c.wr, c.wc, c.tile_w, c.mr, c.per, c.gn, c.stages) == (
        8, 1, 16, 1, 1, 192, 8)


def _dense_b_resident_walk(gm: int, gk: int, i0: int, per: int):
    """The dense walk's steps for the CTA holding row blocks i0 .. i0 + per
    - 1: step q is (k block q // rbn, row block q % rbn); a step opens its
    k block's B slice when it is the block's first."""
    rbn = min(per, gm - i0)
    steps, opened = [], []
    for q in range(gk * rbn):
        kb, r = divmod(q, rbn)
        if r == 0:
            opened.append(kb)
        steps.append((i0 + r, kb))
    return steps, opened


@pytest.mark.parametrize("gm, gk, per", [(1, 48, 1), (64, 64, 2), (7, 5, 3),
                                         (9, 1, 8), (100, 12, 4)])
def test_dense_b_resident_walk_is_k9s_walk_at_density_one(gm, gk, per):
    """At density 1.0 every row's sorted list is 0 .. gk - 1, and K9's
    merge (`_b_resident_walk`) takes the same steps in the same order as
    the dense walk: each (row block, k block) once, each row's blocks in
    k order, each B slice fetched once per chunk."""
    cols = np.tile(np.arange(gk), (gm, 1))
    nnz = np.full(gm, gk)
    visits = []
    for i0 in range(0, gm, per):
        steps, opened = _dense_b_resident_walk(gm, gk, i0, per)
        assert (steps, opened) == _b_resident_walk(cols, nnz, i0, per)
        assert opened == list(range(gk))
        visits += steps
    assert sorted(visits) == [(i, kb) for i in range(gm) for kb in range(gk)]


# ------------------------------------------------------------------ K3
SK_SHAPES = [(4, 3072, 200064), (4, 3072, 8192), (4, 8192, 3072),
             (1, 3072, 3072), (8, 1000, 700), (16, 768, 256), (64, 300, 2050),
             (3, 16, 16), (37, 5000, 130)]
SK_BLOCKS = [(64, 128, 128), (64, 64, 128), (64, 192, 64), (16, 48, 64),
             (128, 256, 128), (64, 64, 256), (64, 16, 16)]


@pytest.mark.parametrize("sms", [78, 114, 132])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("blocks", SK_BLOCKS)
def test_splitk_config_fits_and_covers_every_output_and_split_once(
        blocks, dtype, sms):
    bm, bk, bn = blocks
    size = 2 if dtype == torch.bfloat16 else 4
    for m, k, n in SK_SHAPES:
        if m > bm:
            continue                      # split-K never blocks m: bm >= m
        for b_trans in (False, True):
            c = gk_mod.splitk_config(m, k, n, bm, bk, bn, dtype, b_trans,
                                     sms)
            # the ring: >= 3 stages of a power-of-two slice that divides
            # bk (no slice straddles two splits), within two CTAs an SM
            assert c.stages >= 3 and c.ks & (c.ks - 1) == 0 and c.ks >= 16
            assert bk % c.ks == 0
            stage = mm._ki_stage_bytes(size, c.rows, c.tile_w, c.ks, b_trans)
            assert c.smem == mm._ki_fixed_bytes(size, c.rows, c.ks) \
                + c.stages * stage
            assert c.smem <= max(gk_mod.SPLITK_BUDGET,
                                 mm._ki_fixed_bytes(size, c.rows, 16) + 3
                                 * mm._ki_stage_bytes(size, c.rows, c.tile_w,
                                                      16, b_trans))
            assert c.smem <= SMEM_MAX
            # k_inner's rows: 8 bf16 rows at m <= 8, else 16-row granules
            # within bm and 64 (fp32: 16); a warp holds 1 or 4 fragments
            if size == 2 and m <= 8:
                assert c.rows == 8
            else:
                assert c.rows % 16 == 0
                assert c.rows <= min(bm, 64 if size == 2 else 16)
            assert c.mr == (1 if c.rows <= 16 else 4)
            assert c.tile_w % 16 == 0 and c.tile_w & (c.tile_w - 1) == 0
            assert c.tile_w <= min(128, max(16, bn))
            if b_trans and c.tile_w > 16:     # runs of 128 bytes along k
                assert c.ks * size >= 128
            # every row, every column and every split exactly once
            rows = [c.rows * i + r for i in range(c.gm)
                    for r in range(c.rows) if c.rows * i + r < m]
            assert rows == list(range(m))
            cols = [c.tile_w * j + x for j in range(c.gn)
                    for x in range(c.tile_w) if c.tile_w * j + x < n]
            assert cols == list(range(n))
            gk = -(-k // bk)
            splits = [z * c.per_group + s for z in range(c.groups)
                      for s in range(c.per_group) if z * c.per_group + s < gk]
            assert splits == list(range(gk))
            assert (c.groups - 1) * c.per_group < gk
            # the most splits a group with which the grid fills a wave of
            # two CTAs an SM (one where none does)
            tiles = c.gm * c.gn
            assert tiles * c.groups >= min(2 * sms, tiles * gk)
            assert c.per_group == gk or \
                tiles * -(-gk // (c.per_group + 1)) < 2 * sms


def test_splitk_config_fills_a_132_sm_card_at_decode():
    bf = torch.bfloat16
    # the LM head: its 128-column tiles alone fill the card, so one split
    # group walks all 24 splits and B streams once; E^T is read 128 deep
    c = gk_mod.splitk_config(4, 3072, 200064, 64, 128, 128, bf, True, 132)
    assert (c.rows, c.tile_w, c.ks, c.gn, c.groups, c.per_group) == (
        8, 128, 128, 1563, 1, 24)
    # the decode projections: the splits are cut over grid z until the
    # grid fills a wave of two CTAs an SM
    for k, n, gk in ((3072, 8192, 24), (8192, 3072, 64)):
        c = gk_mod.splitk_config(4, k, n, 64, 128, 128, bf, False, 132)
        assert c.gm * c.gn < 132
        assert c.gm * c.gn * c.groups >= 2 * 132
        assert c.groups * c.per_group >= gk > (c.groups - 1) * c.per_group
    for m, k, n in ((1, 3072, 200064), (4, 3072, 200064), (8, 3072, 200064),
                    (4, 3072, 3072), (16, 8192, 3072)):
        c = gk_mod.splitk_config(m, k, n, 64, 128, 128, bf, False, 132)
        assert c.gm * c.gn * c.groups >= 132


def _splitk_walk(k: int, bk: int, ks: int, z: int, per: int):
    """K3's walk for split group z: the kernel's copy cursor (k0 = the
    group's first k + q * ks) and its compute cursor, which stores the sums
    to plane `split` after the split's last slice.  Returns the (plane,
    slice offsets) list in store order."""
    gk = -(-k // bk)
    first = z * per
    steps = (min(gk, first + per) - first) * (bk // ks)
    planes, cur, split, csl = [], [], first, 0
    for q in range(steps):
        cur.append(first * bk + q * ks)
        csl += 1
        if csl == bk // ks:
            planes.append((split, cur))
            cur, csl, split = [], 0, split + 1
    assert not cur                     # the last step ends a split
    return planes


@pytest.mark.parametrize("k, bk, ks, per", [
    (3072, 128, 128, 24), (3072, 128, 64, 5), (8192, 128, 128, 6),
    (1000, 128, 32, 3), (1000, 192, 64, 1), (300, 64, 16, 7),
    (16, 16, 16, 1), (5000, 256, 256, 4)])
def test_splitk_walk_stores_each_split_after_its_ascending_slices(k, bk, ks,
                                                                   per):
    gk = -(-k // bk)
    groups = -(-gk // per)
    stored = []
    for z in range(groups):
        for split, offsets in _splitk_walk(k, bk, ks, z, per):
            # ascending, ks apart, inside the split: K1's dense walk over
            # the slice pair A[:, s bk:(s + 1) bk] @ B[s bk:(s + 1) bk]
            assert offsets == [split * bk + o for o in range(0, bk, ks)]
            assert all(o // bk == (o + ks - 1) // bk == split
                       for o in offsets)
            stored.append(split)
    assert stored == list(range(gk))   # each plane once, in order


# ------------------------------------------------------------------ K5
G_SHAPES = [(16, 8, 6144, 10752), (16, 8, 10752, 6144),
            (16, 160, 6144, 10752), (16, 160, 10752, 6144),
            (4, 40, 1000, 700), (3, 8, 256, 300), (2, 100, 320, 200),
            (2, 16, 96, 40), (1, 1, 16, 16), (8, 17, 64, 1000),
            (4, 161, 200, 129), (2, 320, 512, 384)]


@pytest.mark.parametrize("sms", [78, 132])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("blocks", [(64, 64, 128), (64, 64, 64),
                                    (128, 128, 128), (16, 16, 16)])
def test_grouped_config_fits_and_covers_every_output_once(blocks, dtype,
                                                          sms):
    bm, bk, bn = blocks
    size = 2 if dtype == torch.bfloat16 else 4
    for g, m, k, n in G_SHAPES:
        for b_trans in (False, True):
            c = gmm_mod.grouped_config(g, m, k, n, bk, bn, dtype, b_trans,
                                       sms)
            assert c.stages >= 3 and c.ks & (c.ks - 1) == 0 and c.ks >= 16
            assert -(-k // bk) * bk % c.ks == 0
            stage = mm._ki_stage_bytes(size, c.rows, c.tile_w, c.ks, b_trans)
            assert c.smem == mm._ki_fixed_bytes(size, c.rows, c.ks) \
                + c.stages * stage <= SMEM_MAX
            if c.wide:
                # the prefill tile: bf16 rows past one granule; two rows of
                # four warps, each 16 mr rows x two strips of 16 columns
                assert size == 2 and m > 16
                assert c.mr in (2, 5) and c.rows == 32 * c.mr
                assert c.tile_w == (256 if c.mr == 5 else 128)
                if c.mr == 2:                  # two CTAs an SM
                    assert c.smem <= gmm_mod.GROUPED_BUDGET
            else:
                assert c.mr == 1
                assert c.rows == (8 if size == 2 and m <= 8 else 16)
                assert size == 4 or m <= 16
                assert c.tile_w % 16 == 0 and c.tile_w & (c.tile_w - 1) == 0
                assert c.tile_w <= min(128, max(16, bn))
                assert c.smem <= max(gmm_mod.GROUPED_BUDGET,
                                     mm._ki_fixed_bytes(size, c.rows, 16) + 3
                                     * mm._ki_stage_bytes(size, c.rows,
                                                          c.tile_w, 16,
                                                          b_trans))
                if b_trans and c.tile_w > 16:
                    assert c.ks * size >= 128
            rows = [c.rows * i + r for i in range(c.gm)
                    for r in range(c.rows) if c.rows * i + r < m]
            assert rows == list(range(m))
            cols = [c.tile_w * j + x for j in range(c.gn)
                    for x in range(c.tile_w) if c.tile_w * j + x < n]
            assert cols == list(range(n))


def test_grouped_config_fills_a_132_sm_card_at_dbrx():
    bf = torch.bfloat16
    # decode: 8 capacity rows a group, the 8-row granule; 84 (48) column
    # tiles of 128 x 16 groups
    for k, n, gn in ((6144, 10752, 84), (10752, 6144, 48)):
        c = gmm_mod.grouped_config(16, 8, k, n, 64, 128, bf, False, 132)
        assert (c.wide, c.rows, c.tile_w, c.gm, c.gn) == (False, 8, 128, 1,
                                                          gn)
        assert 16 * c.gm * c.gn >= 132
    # prefill: 160 capacity rows a group in one 160-row tile, so each
    # expert's B tile is read once; 256 columns a CTA, so A is read from
    # L2 42 (24) times, not 84 (48)
    for k, n, gn in ((6144, 10752, 42), (10752, 6144, 24)):
        c = gmm_mod.grouped_config(16, 160, k, n, 64, 128, bf, False, 132)
        assert (c.wide, c.rows, c.mr, c.tile_w, c.gm, c.gn) == (
            True, 160, 5, 256, 1, gn)
        assert 16 * c.gm * c.gn >= 132
    # a narrow decode grid narrows its tile until it fills the card
    c = gmm_mod.grouped_config(2, 4, 3072, 3072, 64, 128, bf, False, 132)
    assert 2 * c.gm * c.gn >= 132 and c.tile_w < 128


@pytest.mark.parametrize("m", [17, 32, 40, 64, 100, 128, 150, 160, 200, 320,
                               480, 1000])
def test_grouped_prefill_tile_pads_the_fewest_rows(m):
    c = gmm_mod.grouped_config(16, m, 6144, 10752, 64, 128, torch.bfloat16,
                               False, 132)
    padded = c.gm * c.rows - m
    assert c.wide and padded == min(-(-m // r) * r - m for r in (64, 160))
    if m == 160:
        # dbrx's prefill: no padded MMA rows (a 128-row tile would pad
        # 37.5%: 256 rows for 160)
        assert padded == 0 and padded / (c.gm * c.rows) < 0.2


@pytest.mark.parametrize("mr", [2, 5])
def test_grouped_prefill_warps_cover_the_tile_once(mr):
    """The prefill tile (WR = 2 in csrc/k_inner.cuh, ns = tile_w / 64
    strips a warp): warp w owns rows 16 mr (w // 4) .. 16 mr (w // 4 + 1)
    and strips w % 4 + 4 j, j < ns; together the 8 warps hold each (row,
    column) of the tile once, 40 MMAs a 16-deep step from 9 ldmatrix at
    mr 5."""
    c = gmm_mod.grouped_config(16, 160 if mr == 5 else 64, 6144, 10752, 64,
                               128, torch.bfloat16, False, 132)
    assert c.mr == mr
    ns, wc_n = c.tile_w // 64, 4
    held = np.zeros((c.rows, c.tile_w), int)
    for w in range(8):
        rbase = w // wc_n * 16 * mr
        for j in range(ns):
            strip = w % wc_n + wc_n * j
            held[rbase:rbase + 16 * mr, 16 * strip:16 * strip + 16] += 1
    assert (held == 1).all()
    mmas = mr * ns * 2            # fragments x strips x two n8 halves
    ldsm = mr + ns                # one A fragment a row block, one B a strip
    assert (mmas, ldsm) == ((40, 9) if mr == 5 else (8, 4))
