"""The pure functions that shape two kernels, on the CPU.

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
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import block_sparse_matmul as bsr
from repro_torch.kernels import gemv_splitk as gk_mod

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
