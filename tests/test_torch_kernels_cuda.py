"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where no CUDA device is
present; run them on a GPU machine with

    REPRO_TORCH_REQUIRE_CUDA=1 PYTHONPATH=src \
        python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

(with REPRO_TORCH_REQUIRE_CUDA=1 a missing device fails instead of
skipping, so a run on the card cannot pass by skipping).

Tolerances: fp32 runs true fp32 in both versions, only the summation order
differs (rtol/atol 1e-4 at k <= 1024); bf16 outputs are compared after the
kernel's single rounding to bf16 (rtol 2e-2, atol 2e-2 at unit-scale
values: one bf16 ulp is 2**-8 relative).  Flash attention splits P into
the same two bf16 terms in both versions, and the RG-LRU scan runs fp32 in
both, so the same bounds hold there; the scan's fp32 carry is held at
1e-4.  The SSD scan takes the same fp64 log-decay prefix sum and fp32
products in both versions and rounds y once, so the same bounds hold for
y; its fp32 state is held at 1e-4.  Under a strong decay it is also held
against the sequential recurrence in fp64: within 1e-6 of the largest |y|,
and no further than the chunked form with an fp32 prefix sum.  The
block-sparse matmul (K9) sums the same fp32 products as its plain version
in another order, so the dense bounds hold; at density 1.0 it is held
bitwise equal to K1.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import gemv_splitk as gk_mod
from repro_torch.kernels import grouped_matmul as gmm_mod
from repro_torch.kernels import rglru_scan as rg_mod
from repro_torch.kernels import ref
from repro_torch.kernels import skew_matmul as mm_mod
from repro_torch.kernels import ssd_scan as ssd_mod

RNG = np.random.default_rng(11)
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        if os.environ.get("REPRO_TORCH_REQUIRE_CUDA") == "1":
            pytest.fail("REPRO_TORCH_REQUIRE_CUDA=1 but no CUDA device")
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(shape, dtype, dev, scale=1.0):
    return torch.tensor(RNG.normal(size=shape) * scale,
                        dtype=torch.float32).to(dev, dtype)


EPILOGUES = [None, "silu", "gelu", "bias_gelu", "residual", "scale_bias",
             "silu_residual"]


def _operands(spec, m, n, dtype, dev):
    bias = _t((n,), dtype, dev) if spec and "bias" in spec else None
    res = _t((m, n), dtype, dev) if spec and "residual" in spec else None
    tokens = tuple((t, 0.5 if t == "scale" else None)
                   for t in (spec.split("_") if spec else ()))
    return tokens, bias, res


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("schedule", ["k_inner", "a_resident", "b_resident"])
@pytest.mark.parametrize("spec", EPILOGUES)
def test_dense_matches_plain(dev, dtype, schedule, spec):
    m, k, n = 100, 320, 200            # ragged against (64, 64, 128) blocks
    a, b = _t((m, k), dtype, dev, 0.2), _t((k, n), dtype, dev, 0.2)
    tokens, bias, res = _operands(spec, m, n, dtype, dev)
    for out_dtype in (dtype, torch.float32):
        got = mm_mod.skew_matmul_cuda(a, b, bias, res, bm=64, bk=64, bn=128,
                                      schedule=schedule, epilogue=tokens,
                                      out_dtype=out_dtype)
        want = mm_mod.skew_matmul_plain(a, b, bias, res, bk=64,
                                        epilogue=tokens, out_dtype=out_dtype)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_transposed_b_and_decode_rows(dev, dtype):
    """B read through its strides (a tied embedding used as E^T) and m of a
    few rows inside a 64-row block."""
    emb = _t((1000, 256), dtype, dev, 0.2)
    for m in (1, 4, 17):
        a = _t((m, 256), dtype, dev)
        for schedule in ("k_inner", "a_resident"):
            got = mm_mod.skew_matmul_cuda(a, emb.T, bm=64, bk=64, bn=128,
                                          schedule=schedule,
                                          out_dtype=torch.float32)
            want = mm_mod.skew_matmul_plain(a, emb.T, bk=64,
                                            out_dtype=torch.float32)
            torch.testing.assert_close(got, want, **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_matches_plain(dev, dtype):
    nb, m, k, n = 3, 40, 192, 130
    a, b = _t((nb, m, k), dtype, dev, 0.2), _t((k, n), dtype, dev, 0.2)
    res = _t((nb, m, n), dtype, dev)
    tokens = (("silu", None), ("residual", None))
    got = mm_mod.skew_matmul_batched_cuda(a, b, None, res, bm=64, bk=64,
                                          bn=64, epilogue=tokens,
                                          out_dtype=dtype)
    want = mm_mod.skew_matmul_batched_plain(a, b, None, res, bk=64,
                                            epilogue=tokens, out_dtype=dtype)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spec", [None, "bias_gelu", "residual"])
def test_splitk_matches_plain(dev, dtype, spec):
    m, k, n = 4, 1000, 300
    a, b = _t((m, k), dtype, dev, 0.2), _t((k, n), dtype, dev, 0.2)
    tokens, bias, res = _operands(spec, m, n, dtype, dev)
    got = gk_mod.gemv_splitk(a, b, bias, res, bm=64, bk=128, bn=128,
                             epilogue=tokens, out_dtype=torch.float32)
    slab = gk_mod.gemv_splitk_partial_plain(a, b, bk=128)
    want = gk_mod.gemv_splitk_reduce_plain(slab, bias, res, epilogue=tokens,
                                           out_dtype=torch.float32)
    torch.testing.assert_close(got, want, **TOL[dtype])


@pytest.mark.cuda
def test_splitk_bitwise_across_split_counts(dev):
    m, k, n = 8, 768, 256
    a = torch.tensor(RNG.integers(-8, 8, (m, k)), dtype=torch.float32,
                     device=dev)
    b = torch.tensor(RNG.integers(-8, 8, (k, n)), dtype=torch.float32,
                     device=dev)
    want = (a.double() @ b.double()).float()
    for bk in (16, 48, 64, 128, 256, 384):     # gk = 48, 16, 12, 6, 3, 2
        got = gk_mod.gemv_splitk(a, b, bm=16, bk=bk, bn=64)
        assert torch.equal(got, want), bk


GROUPED_EPILOGUES = [None, "gelu", "scale", "residual", "silu_residual"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spec", GROUPED_EPILOGUES)
def test_grouped_matches_plain(dev, dtype, spec):
    """K5 at a shape ragged in m, k and n against (64, 64, 128) blocks."""
    g, m, k, n = 4, 40, 1000, 700
    a, b = _t((g, m, k), dtype, dev, 0.2), _t((g, k, n), dtype, dev, 0.1)
    tokens = tuple((t, 0.5 if t == "scale" else None)
                   for t in (spec.split("_") if spec else ()))
    res = _t((g, m, n), dtype, dev) if spec and "residual" in spec else None
    for out_dtype in (dtype, torch.float32):
        got = gmm_mod.grouped_matmul_cuda(a, b, res, bm=64, bk=64, bn=128,
                                          epilogue=tokens,
                                          out_dtype=out_dtype)
        want = gmm_mod.grouped_matmul_plain(a, b, res, bk=64,
                                            epilogue=tokens,
                                            out_dtype=out_dtype)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_strided_operands_and_decode_rows(dev, dtype):
    """A and B read through their strides (B a transposed view, A a slice
    of a wider buffer) with m = 8 capacity rows in a 64-row block."""
    g, m, k, n = 3, 8, 256, 300
    b = _t((g, n, k), dtype, dev, 0.1).transpose(1, 2)
    a = _t((g, m, k + 64), dtype, dev, 0.2)[:, :, 64:]
    got = gmm_mod.grouped_matmul_cuda(a, b, bm=64, bk=64, bn=128,
                                      out_dtype=torch.float32)
    want = gmm_mod.grouped_matmul_plain(a, b, bk=64,
                                        out_dtype=torch.float32)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL[dtype])


@pytest.mark.cuda
def test_grouped_refuses_bias_and_bad_blocks(dev):
    a = _t((2, 8, 64), torch.bfloat16, dev)
    b = _t((2, 64, 64), torch.bfloat16, dev)
    with pytest.raises(ValueError, match="bias"):
        gmm_mod.grouped_matmul_cuda(a, b, bm=64, bk=64, bn=64,
                                    epilogue=(("bias", None),))
    with pytest.raises(ValueError, match="multiples of 16"):
        gmm_mod.grouped_matmul_cuda(a, b, bm=8, bk=64, bn=64)


FA_CASES = {  # name: (Hq, Hkv, S, D, kwargs)
    "gqa_d128_causal": (8, 2, 200, 128, dict()),
    "mqa_d256_window": (4, 1, 300, 256, dict(window=100)),
    "gqa_d128_window_softcap": (4, 2, 257, 128, dict(window=64,
                                                     softcap=50.0)),
    "mha_d64_full": (2, 2, 96, 64, dict(causal=False)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FA_CASES))
def test_flash_attention_matches_plain(dev, dtype, case):
    """K7 at ragged lengths (no S divides a tile) against its plain
    version, read through the model's transposed (B, S, H, D) views."""
    hq, hkv, s, d, kw = FA_CASES[case]
    q = _t((2, s, hq, d), dtype, dev).transpose(1, 2)
    k = _t((2, s, hkv, d), dtype, dev).transpose(1, 2)
    v = _t((2, s, hkv, d), dtype, dev).transpose(1, 2)
    fa_mod.LAUNCHES.clear()
    got = fa_mod.flash_attention(q, k, v, **kw)
    want = fa_mod.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_mod.LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
def test_flash_attention_explicit_tiles_and_refusals(dev):
    q = _t((1, 4, 130, 128), torch.bfloat16, dev)
    k = _t((1, 1, 130, 128), torch.bfloat16, dev)
    want = fa_mod.flash_attention_plain(q, k, k, window=50)
    got = fa_mod.flash_attention_cuda(q, k, k, window=50, bq=32, bkv=16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])
    with pytest.raises(ValueError, match="multiple of 16"):
        fa_mod.flash_attention_cuda(q[..., :100], k[..., :100],
                                    k[..., :100])
    with pytest.raises(ValueError, match="shared memory"):
        fa_mod.flash_attention_cuda(q, k, k, bq=256, bkv=256)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", [1, 37, 300])
def test_rglru_scan_and_carry_match_plain(dev, dtype, length):
    """K6 at ragged L (no chunk) with its fp32 carry, the gates read
    through strided views of one (B, L, 3D) buffer."""
    d = 200
    xri = _t((3, length, 3 * d), dtype, dev)
    x, r, i = xri[..., :d], xri[..., d:2 * d], xri[..., 2 * d:]
    lam = _t((d,), torch.float32, dev)
    rg_mod.LAUNCHES.clear()
    y, h = rg_mod.rglru_scan(x, r, i, lam, c=8.0, return_state=True)
    want, hw = rg_mod.rglru_scan_plain(x, r, i, lam, c=8.0,
                                       return_state=True)
    torch.cuda.synchronize()
    assert rg_mod.LAUNCHES["rglru_scan"] == 1
    assert y.dtype == dtype and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(h, hw, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_rglru_scan_strong_decay_stays_finite(dev):
    """sigmoid(r) ~ 1 and softplus(4) ~ 4: a ~ e^-32, the regime that the
    clamp under the square root keeps finite."""
    x = _t((1, 128, 64), torch.float32, dev)
    r = torch.full_like(x, 5.0)
    lam = torch.full((64,), 4.0, device=dev)
    y = rg_mod.rglru_scan_cuda(x, r, x, lam)
    want = rg_mod.rglru_scan_plain(x, r, x, lam)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-5)


# (B, L, H, P, G, S, chunk): mamba2-2.7b's batch-4 prefill (one chunk), its
# long prompt (23 whole chunks and a 56-row tail), a grouped ragged shape,
# and odd sizes under the kernel's limits.
SSD_CASES = {
    "mamba2_b4_p128": (4, 128, 80, 64, 1, 128, 128),
    "mamba2_b1_p3000": (1, 3000, 80, 64, 1, 128, 128),
    "grouped_ragged": (2, 200, 16, 64, 4, 64, 128),
    "odd_sizes": (3, 77, 6, 40, 3, 72, 48),
}


def _ssd_inputs(case, dtype, dev, strong_decay=False):
    b, length, h, p, g, s, _ = SSD_CASES[case]
    x = _t((b, length, h, p), dtype, dev)
    dt = torch.tensor(RNG.uniform(0.001, 0.2, size=(b, length, h)),
                      dtype=torch.float32).to(dev)
    a_log = torch.tensor(RNG.uniform(-0.5, 1.0, size=(h,)),
                         dtype=torch.float32).to(dev)
    if strong_decay:        # A ~ -e^3, dt ~ 5: each step decays by ~e^-100
        dt, a_log = dt * 25.0, torch.full_like(a_log, 3.0)
    bm = _t((b, length, g, s), dtype, dev, 0.5)
    cm = _t((b, length, g, s), dtype, dev, 0.5)
    return x, dt, a_log, bm, cm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_scan_and_state_match_plain(dev, dtype, case):
    """K8 with its fp32 state against the plain chunk math, at any L (the
    tail of the last chunk masked) and B / C shared per group."""
    chunk = SSD_CASES[case][-1]
    x, dt, a_log, bm, cm = _ssd_inputs(case, dtype, dev)
    ssd_mod.LAUNCHES.clear()
    y, st = ssd_mod.ssd_scan(x, dt, a_log, bm, cm, chunk=chunk,
                             return_state=True)
    want, st_want = ssd_mod.ssd_scan_plain(x, dt, a_log, bm, cm, chunk=chunk,
                                           return_state=True)
    torch.cuda.synchronize()
    assert ssd_mod.LAUNCHES["ssd_scan"] == 1
    assert y.dtype == dtype and y.shape == x.shape
    assert st.dtype == torch.float32 and st.shape == st_want.shape
    torch.testing.assert_close(y.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(st, st_want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_reads_strided_views(dev, dtype):
    """x, B and C as column slices of one (B, L, H P + 2 G S) buffer and dt
    as a slice of a wider one, as a fused in-projection would hand them
    over: K8 reads them in place."""
    b, length, h, p, g, s = 2, 150, 8, 32, 2, 48
    xbc = _t((b, length, h * p + 2 * g * s), dtype, dev, 0.5)
    x = xbc[..., :h * p].unflatten(-1, (h, p))
    bm = xbc[..., h * p:h * p + g * s].unflatten(-1, (g, s))
    cm = xbc[..., h * p + g * s:].unflatten(-1, (g, s))
    dt = torch.tensor(RNG.uniform(0.001, 0.2, size=(b, length, 2 * h)),
                      dtype=torch.float32).to(dev)[..., :h]
    a_log = torch.tensor(RNG.uniform(-0.5, 1.0, size=(h,)),
                         dtype=torch.float32).to(dev)
    assert not x.is_contiguous() and not dt.is_contiguous()
    y, st = ssd_mod.ssd_scan_cuda(x, dt, a_log, bm, cm, chunk=64,
                                  return_state=True)
    want, st_want = ssd_mod.ssd_scan_plain(x.contiguous(), dt.contiguous(),
                                           a_log, bm.contiguous(),
                                           cm.contiguous(), chunk=64,
                                           return_state=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(st, st_want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_ssd_scan_strong_decay_stays_finite(dev):
    """exp(cum_i - cum_j) overflows for j > i here: those entries must be
    selected away, not multiplied by a mask."""
    x, dt, a_log, bm, cm = _ssd_inputs("grouped_ragged", torch.float32, dev,
                                       strong_decay=True)
    y, st = ssd_mod.ssd_scan_cuda(x, dt, a_log, bm, cm, return_state=True)
    want, st_want = ssd_mod.ssd_scan_plain(x, dt, a_log, bm, cm,
                                           return_state=True)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, st_want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_ssd_scan_is_nearer_the_exact_answer_than_an_fp32_cumsum(dev):
    """At the served chunk of 128 under a strong decay |cum| reaches
    thousands: K8 (fp64 prefix sum and differences) must come at least as
    near the sequential recurrence in fp64 (`ref.ssd_ref`) as the same
    chunked form with torch.cumsum in fp32 does."""
    x, dt, a_log, bm, cm = _ssd_inputs("grouped_ragged", torch.float32, dev,
                                       strong_decay=True)
    exact = ref.ssd_ref(x.double(), dt.double(), a_log.double(),
                        bm.double(), cm.double())
    y = ssd_mod.ssd_scan_cuda(x, dt, a_log, bm, cm, chunk=128)
    y32 = ssd_mod.ssd_scan_plain(x, dt, a_log, bm, cm, chunk=128,
                                 cum_dtype=torch.float32)
    scale = exact.abs().max()
    err = ((y.double() - exact).abs().max() / scale).item()
    err32 = ((y32.double() - exact).abs().max() / scale).item()
    assert err <= err32 and err < 1e-6, (err, err32)


@pytest.mark.cuda
def test_ssd_scan_refuses_what_it_does_not_take(dev):
    x, dt, a_log, bm, cm = _ssd_inputs("grouped_ragged", torch.bfloat16, dev)
    with pytest.raises(ValueError, match="P <= 64"):
        ssd_mod.ssd_scan_cuda(torch.cat([x, x], -1), dt, a_log, bm, cm)
    with pytest.raises(ValueError, match="chunk"):
        ssd_mod.ssd_scan_cuda(x, dt, a_log, bm, cm, chunk=256)
    with pytest.raises(ValueError, match="H % G"):
        ssd_mod.ssd_scan_cuda(x, dt, a_log, bm[:, :, :3], cm[:, :, :3])
    with pytest.raises(TypeError, match="float32"):
        ssd_mod.ssd_scan_cuda(x, dt.bfloat16(), a_log, bm, cm)
    with pytest.raises(TypeError, match="share dtype"):
        ssd_mod.ssd_scan_cuda(x, dt, a_log, bm.float(), cm)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_mod.ssd_scan_cuda(x.cpu(), dt, a_log, bm, cm)


# ------------------------------------------------------------------ K9
BSR_CASES = {  # (m, k, n, block, density, bn)
    "ragged_d0.25": (100, 520, 200, (32, 128), 0.25, 64),
    "ragged_d0.5_64x64": (150, 300, 90, (64, 64), 0.5, 64),
    "d0.05_128": (256, 1024, 192, (128, 128), 0.05, 64),
}


def _bsr_layout(m, k, block, density, empty_rows=True):
    from repro_torch.sparse.layout import BlockSparseLayout
    lay = BlockSparseLayout.random(m, k, block, density, seed=3)
    if not empty_rows:
        return lay
    mask = lay.block_mask()
    mask[0] = False                     # an empty row block: epilogue(0)
    return BlockSparseLayout.from_block_mask(mask, block, shape=(m, k))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("schedule", ["k_inner", "a_resident", "b_resident"])
@pytest.mark.parametrize("case", list(BSR_CASES))
def test_block_sparse_matches_plain(dev, dtype, schedule, case):
    from repro_torch.kernels import block_sparse_matmul as bsr_mod
    m, k, n, block, density, bn = BSR_CASES[case]
    lay = _bsr_layout(m, k, block, density)
    a, b = _t((m, k), dtype, dev, 0.2), _t((k, n), dtype, dev, 0.2)
    for spec in (None, "bias_silu", "residual"):
        tokens, bias, res = _operands(spec, m, n, dtype, dev)
        for out_dtype in (dtype, torch.float32):
            got = bsr_mod.block_sparse_matmul_cuda(
                a, b, lay, bias, res, bn=bn, schedule=schedule,
                epilogue=tokens, out_dtype=out_dtype)
            want = bsr_mod.block_sparse_matmul_plain(
                a, b, lay, bias, res, epilogue=tokens, out_dtype=out_dtype)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(),
                                       **TOL[out_dtype])
    # rows of the empty row block hold epilogue(0) exactly: bias / residual
    tokens, bias, res = _operands("residual", m, n, dtype, dev)
    got = bsr_mod.block_sparse_matmul_cuda(a, b, lay, None, res, bn=bn,
                                           schedule=schedule, epilogue=tokens,
                                           out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got[:block[0]], res[:block[0]].float())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("schedule", ["k_inner", "a_resident", "b_resident"])
def test_block_sparse_dense_layout_bitwise_equals_k1(dev, dtype, schedule):
    """At density 1.0 K9 visits every k block in order with K1's device
    code, so its output equals K1's bit for bit."""
    from repro_torch.kernels import block_sparse_matmul as bsr_mod
    from repro_torch.sparse.layout import BlockSparseLayout
    m, k, n = 200, 700, 300
    for block, bn in (((64, 128), 128), ((32, 128), 64)):
        lay = BlockSparseLayout.dense(m, k, block)
        a, b = _t((m, k), dtype, dev, 0.2), _t((k, n), dtype, dev, 0.2)
        tokens, bias, res = _operands("bias_gelu", m, n, dtype, dev)
        got = bsr_mod.block_sparse_matmul_cuda(a, b, lay, bias, res, bn=bn,
                                               schedule=schedule,
                                               epilogue=tokens,
                                               out_dtype=dtype)
        want = mm_mod.skew_matmul_cuda(a, b, bias, res, bm=block[0],
                                       bk=block[1], bn=bn, schedule=schedule,
                                       epilogue=tokens, out_dtype=dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_block_sparse_index_tables_upload_once(dev):
    """The layout keeps its (cols, nnz) tensors per device: a second call
    reuses the same storage, so a timing loop copies nothing host to
    device."""
    from repro_torch.kernels import block_sparse_matmul as bsr_mod
    lay = _bsr_layout(128, 512, (32, 128), 0.5, empty_rows=False)
    first = lay.device_tensors(dev)
    assert lay.device_tensors("cuda") is first
    assert first[0].dtype == torch.int32 and first[0].is_cuda
    a = _t((128, 512), torch.bfloat16, dev)
    b = _t((512, 64), torch.bfloat16, dev)
    bsr_mod.block_sparse_matmul_cuda(a, b, lay, bn=64)
    cols, nnz = lay.device_tensors(a.device)
    assert cols.data_ptr() == first[0].data_ptr()
    assert nnz.data_ptr() == first[1].data_ptr()
    cpu = lay.device_tensors("cpu")
    assert cpu[0].device.type == "cpu"


@pytest.mark.cuda
def test_block_sparse_refuses_what_it_does_not_take(dev):
    from repro_torch.core.costmodel import BlockPlan
    from repro_torch.kernels import block_sparse_matmul as bsr_mod
    from repro_torch.kernels import ops
    lay = _bsr_layout(128, 512, (40, 128), 0.5, empty_rows=False)
    a = _t((128, 512), torch.bfloat16, dev)
    b = _t((512, 64), torch.bfloat16, dev)
    with pytest.raises(ValueError, match="multiples of 16"):
        bsr_mod.block_sparse_matmul_cuda(a, b, lay, bn=64)
    lay = _bsr_layout(128, 512, (32, 128), 0.5, empty_rows=False)
    with pytest.raises(ValueError, match="layout block shape"):
        ops.sparse_matmul(a, b, lay, plan=BlockPlan(64, 128, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        bsr_mod.block_sparse_matmul_cuda(a.cpu(), b, lay, bn=64)
    with pytest.raises(TypeError, match="dtypes differ"):
        bsr_mod.block_sparse_matmul_cuda(a, b.float(), lay, bn=64)
