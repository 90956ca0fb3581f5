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
and no further than the chunked form with an fp32 prefix sum.  Its
chunk-state kernel and state pass sum the same fp32 products as their
plain pieces in another order: 1e-4.  The
block-sparse matmul (K9) sums the same fp32 products as its plain version
in another order, so the dense bounds hold; at density 1.0 it is held
bitwise equal to K1.  K3's slab planes and K5's groups are held bitwise
equal to K1 k_inner on the same operands (the same chains); K5's bf16
epilogues within two bf16 ulps of plain at the largest magnitude.
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


# The tied LM heads of internvl2-1b (896 x 151655) and seamless-m4t
# (1024 x 256206): their fp32 output rows start off 16-byte alignment
# (151655 * 4 = 12 and 256206 * 4 = 8 mod 16)
ODD_HEADS = {"internvl2_1b": (896, 151655), "seamless_m4t": (1024, 256206)}


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("head", list(ODD_HEADS))
def test_odd_vocab_lm_head_matches_plain(dev, head, m):
    """Every dense schedule and the planned call at an odd LM head, the
    embedding read as E^T in place, bf16 in and fp32 out."""
    from repro_torch.core import skewmm

    k, n = ODD_HEADS[head]
    emb = _t((n, k), torch.bfloat16, dev, 0.02)
    a = _t((m, k), torch.bfloat16, dev)
    want = mm_mod.skew_matmul_plain(a, emb.T, bk=64, out_dtype=torch.float32)
    for schedule in ("k_inner", "a_resident", "b_resident"):
        got = mm_mod.skew_matmul_cuda(a, emb.T, bm=64, bk=64, bn=128,
                                      schedule=schedule,
                                      out_dtype=torch.float32)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL[torch.float32])
    got = skewmm.matmul(a, emb.T, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (m, n)
    torch.testing.assert_close(got, want, **TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 4, 16])
def test_k_inner_decode_rows_at_phi4_widths(dev, dtype, m):
    """k_inner at decode rows against its plain version: the o projection
    (row-major B, 16-column tiles so the grid fills the card) and a tied
    embedding read as E^T in place (n-major copies), with the plan's
    (64, 64, 128) blocks."""
    w = _t((3072, 3072), dtype, dev, 3072 ** -0.5)
    emb = _t((4000, 3072), dtype, dev, 0.02)
    a = _t((m, 3072), dtype, dev)
    for b, spec in ((w, "residual"), (emb.T, None)):
        tokens, bias, res = _operands(spec, m, b.shape[1], dtype, dev)
        for out_dtype in (dtype, torch.float32):
            got = mm_mod.skew_matmul_cuda(a, b, bias, res, bm=64, bk=64,
                                          bn=128, epilogue=tokens,
                                          out_dtype=out_dtype)
            want = mm_mod.skew_matmul_plain(a, b, bias, res, bk=64,
                                            epilogue=tokens,
                                            out_dtype=out_dtype)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(),
                                       **TOL[out_dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [3, 37])
def test_k_inner_reads_any_strides_bitwise(dev, dtype, m):
    """A transposed A and a B with a column stride of 2 (no 16-byte copies:
    the element loads) or a transposed B (n-major copies) give the same
    bits as contiguous operands: the layout moves no sum."""
    k, n = 333, 150
    a = _t((m, k), dtype, dev)
    b = _t((k, n), dtype, dev, k ** -0.5)
    want = mm_mod.skew_matmul_cuda(a, b, bm=64, bk=64, bn=128,
                                   out_dtype=torch.float32)
    a_t = a.T.contiguous().T                          # sa_k = m
    b_s = torch.zeros((k, 2 * n), dtype=dtype, device=dev)[:, ::2]
    b_s.copy_(b)                                      # sb_n = 2
    b_t = b.T.contiguous().T                          # sb_k = 1
    for aa, bb in ((a_t, b), (a, b_s), (a, b_t), (a_t, b_t)):
        got = mm_mod.skew_matmul_cuda(aa, bb, bm=64, bk=64, bn=128,
                                      out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [(4, 1), (3, 5), (4, 128), (3, 40)])
def test_batched_bitwise_equals_separate_k1_calls(dev, dtype, rows):
    """K2 stacks the batch slices' rows (all in one row tile when nb * m
    <= 16, across tiles otherwise); each row keeps its own A slice and
    residual batch stride, so the output equals nb K1 calls bit for bit,
    with B row-major and as a transposed view."""
    nb, m = rows
    k, n = 200, 300
    a = _t((nb, 2 * m, k), dtype, dev)[:, ::2]          # strided rows
    res = _t((n, m, nb), dtype, dev).permute(2, 1, 0)   # batch-strided
    tokens = (("bias", None), ("silu", None), ("residual", None))
    bias = _t((n,), dtype, dev)
    for b in (_t((k, n), dtype, dev, k ** -0.5),
              _t((n, k), dtype, dev, k ** -0.5).T):
        for out_dtype in (dtype, torch.float32):
            got = mm_mod.skew_matmul_batched_cuda(
                a, b, bias, res, bm=64, bk=64, bn=128, epilogue=tokens,
                out_dtype=out_dtype)
            for i in range(nb):
                want = mm_mod.skew_matmul_cuda(
                    a[i], b, bias, res[i], bm=64, bk=64, bn=128,
                    epilogue=tokens, out_dtype=out_dtype)
                torch.cuda.synchronize()
                assert torch.equal(got[i], want)


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


def _k3_operands(dtype, dev, m, k, n, b_trans):
    a = _t((m, k), dtype, dev)
    b = (_t((n, k), dtype, dev, k ** -0.5).T if b_trans
         else _t((k, n), dtype, dev, k ** -0.5))
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("b_trans", [False, True])
@pytest.mark.parametrize("m", [1, 4, 8, 16, 64])
def test_splitk_partial_planes_bitwise_equal_k1_on_each_slice(dev, m,
                                                              b_trans):
    """K3 is K1's k_inner with the split walk: plane s is one chain over
    the s-th bk slice in 16-deep steps, so it equals K1 k_inner on the
    slice pair bit for bit, a ragged last slice (k 1000 at bk 128 and
    192) included; the fp32 slab is within 1e-4 of the plain partials."""
    for k, n, bk in ((1000, 700, 128), (1000, 2050, 192), (3072, 333, 128)):
        a, b = _k3_operands(torch.bfloat16, dev, m, k, n, b_trans)
        slab = gk_mod.gemv_splitk_partial_cuda(a, b, bm=64, bk=bk, bn=128)
        for s in range(slab.shape[0]):
            k1 = mm_mod.skew_matmul_cuda(
                a[:, s * bk:(s + 1) * bk], b[s * bk:(s + 1) * bk], bm=64,
                bk=bk, bn=128, out_dtype=torch.float32)
            assert torch.equal(slab[s], k1), (k, n, bk, s)
        want = gk_mod.gemv_splitk_partial_plain(a, b, bk=bk)
        torch.testing.assert_close(slab, want, **TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b_trans", [False, True])
def test_splitk_partial_one_split_is_k1_and_fp32_is_true_fp32(dev, dtype,
                                                              b_trans):
    """With bk >= k the slab's one plane is K1 k_inner's product bit for
    bit (both routes); the decode projections' split groups (4 x 8192 x
    3072 at gk 64: groups over grid z) agree with plain within 1e-4."""
    a, b = _k3_operands(dtype, dev, 4, 256, 3000, b_trans)
    slab = gk_mod.gemv_splitk_partial_cuda(a, b, bm=64, bk=256, bn=64)
    k1 = mm_mod.skew_matmul_cuda(a, b, bm=64, bk=256, bn=64,
                                 out_dtype=torch.float32)
    assert slab.shape[0] == 1 and torch.equal(slab[0], k1)
    a, b = _k3_operands(dtype, dev, 4, 8192, 3072, b_trans)
    slab = gk_mod.gemv_splitk_partial_cuda(a, b, bm=64, bk=128, bn=128)
    want = gk_mod.gemv_splitk_partial_plain(a, b, bk=128)
    torch.testing.assert_close(slab, want, **TOL[torch.float32])


# K4 at many slab depths: odd and even levels, a depth past the 1816 that
# keeps a 32-wide strip, and one past the 14528 at which not even 4
# columns fit (folded level by level through a scratch first); n is
# ragged against the strip, with m * n a multiple of 4 (16-byte cp.async
# staging) and not (scalar staging).
SPLITK_REDUCE_GKS = [1, 2, 3, 5, 7, 8, 24, 33, 64, 65, 84, 2000, 14600]


@pytest.mark.cuda
@pytest.mark.parametrize("gk", SPLITK_REDUCE_GKS)
@pytest.mark.parametrize("n", [340, 333])
def test_splitk_reduce_bitwise_equals_plain(dev, gk, n):
    m = 3 if gk < 1000 else 1
    slab = _t((gk, m, n), torch.float32, dev) * torch.tensor(
        10.0 ** RNG.integers(-3, 4, size=(gk, 1, n)), dtype=torch.float32,
        device=dev)
    keep = slab.clone()
    want = gk_mod.gemv_splitk_reduce_plain(slab, out_dtype=torch.float32)
    got = gk_mod.gemv_splitk_reduce_cuda(slab, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(slab, keep)              # the input is not folded
    got16 = gk_mod.gemv_splitk_reduce_cuda(slab, out_dtype=torch.bfloat16)
    assert torch.equal(got16, want.to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", EPILOGUES)
@pytest.mark.parametrize("gk", [1, 24, 84, 101])
def test_splitk_reduce_epilogues_match_plain(dev, spec, gk):
    m, n = 4, 1001
    slab = _t((gk, m, n), torch.float32, dev, 0.2)
    tokens, bias, res = _operands(spec, m, n, torch.float32, dev)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = gk_mod.gemv_splitk_reduce_cuda(slab, bias, res, epilogue=tokens,
                                             out_dtype=out_dtype)
        want = gk_mod.gemv_splitk_reduce_plain(slab, bias, res,
                                               epilogue=tokens,
                                               out_dtype=out_dtype)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   **TOL[out_dtype])


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


def _two_ulps(want: torch.Tensor) -> float:
    """Two bf16 ulps at the largest magnitude of `want`."""
    scale = want.float().abs().max().item()
    return 2.0 * 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(16, 8, 6144, 1000), (4, 160, 1024, 700),
                                  (4, 40, 1000, 700), (3, 8, 256, 300),
                                  (2, 100, 320, 200)])
def test_grouped_bitwise_equals_k1_per_group(dev, case):
    """K5 is K1's k_inner with the grouped walk (decode rows) or with the
    prefill tile's two rows of warps (m > 16): each output is one chain over
    k in 16-deep steps, so group g equals K1 k_inner on A[g] @ B[g] bit for
    bit, with strided operands (A a slice of a wider buffer, B a transposed
    view) and with the residual epilogue too."""
    g, m, k, n = case
    for strided in (False, True):
        if strided:
            b = _t((g, n, k), torch.bfloat16, dev, k ** -0.5).transpose(1, 2)
            a = _t((g, m, k + 64), torch.bfloat16, dev)[:, :, 64:]
        else:
            a = _t((g, m, k), torch.bfloat16, dev)
            b = _t((g, k, n), torch.bfloat16, dev, k ** -0.5)
        res = _t((g, m, n), torch.bfloat16, dev)
        for spec, r, odt in (((), None, torch.float32),
                             ((("residual", None),), res, torch.bfloat16)):
            got = gmm_mod.grouped_matmul_cuda(a, b, r, bm=64, bk=64, bn=128,
                                              epilogue=spec, out_dtype=odt)
            for i in range(g):
                k1 = mm_mod.skew_matmul_cuda(
                    a[i], b[i], residual=None if r is None else r[i], bm=64,
                    bk=64, bn=128, epilogue=spec, out_dtype=odt)
                assert torch.equal(got[i], k1), (case, strided, spec, i)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [(("gelu", None),), (("scale", 0.5),),
                                  (("residual", None),)])
@pytest.mark.parametrize("m", [8, 40, 160])
def test_grouped_epilogues_within_two_bf16_ulps(dev, spec, m):
    """bf16 out of K5 (decode and prefill tiles) against plain: both sum in
    fp32 in another order and round once, so within two bf16 ulps at the
    largest magnitude; the fp32 route within 1e-4 of it."""
    g, k, n = 4, 1000, 700
    for dtype in (torch.bfloat16, torch.float32):
        a, b = _t((g, m, k), dtype, dev), _t((g, k, n), dtype, dev, k ** -0.5)
        res = _t((g, m, n), dtype, dev) if spec[0][0] == "residual" else None
        got = gmm_mod.grouped_matmul_cuda(a, b, res, bm=64, bk=64, bn=128,
                                          epilogue=spec, out_dtype=dtype)
        want = gmm_mod.grouped_matmul_plain(a, b, res, bk=64, epilogue=spec,
                                            out_dtype=dtype)
        diff = (got.float() - want.float()).abs().max().item()
        if dtype == torch.bfloat16:
            assert diff <= _two_ulps(want), (m, spec, diff)
        else:
            assert diff <= 1e-4 * want.abs().max().item(), (m, spec, diff)


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
    # internvl2-1b's prefill: a GQA group of 7 at head dim 64, 256 prefix
    # rows + 128 prompt rows
    "gqa7_d64_causal": (14, 2, 384, 64, dict()),
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


# Sq != Skv, not causal (the encoder-decoder's cross-attention): (Hq, Hkv,
# Sq, Skv, D); seamless-m4t's 128 decoder rows over 4096 frames, ragged
# lengths against both tiles, and one row
FA_CROSS_CASES = {
    "seamless_cross": (16, 16, 128, 4096, 64),
    "ragged_cross": (4, 4, 130, 257, 64),
    "one_row_cross": (16, 16, 1, 4096, 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FA_CROSS_CASES))
def test_flash_attention_cross_lengths_match_plain(dev, dtype, case):
    hq, hkv, sq, skv, d = FA_CROSS_CASES[case]
    q = _t((2, sq, hq, d), dtype, dev).transpose(1, 2)
    k = _t((2, skv, hkv, d), dtype, dev).transpose(1, 2)
    v = _t((2, skv, hkv, d), dtype, dev).transpose(1, 2)
    fa_mod.LAUNCHES.clear()
    got = fa_mod.flash_attention(q, k, v, causal=False)
    want = fa_mod.flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa_mod.LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
def test_flash_attention_explicit_tiles_and_refusals(dev):
    """bf16 takes q rows in 16s up to 128 (a warp each 16 rows) and 64 kv
    columns: one warp here; fp32 takes any multiple of 16 that fits."""
    q = _t((1, 4, 130, 128), torch.bfloat16, dev)
    k = _t((1, 1, 130, 128), torch.bfloat16, dev)
    want = fa_mod.flash_attention_plain(q, k, k, window=50, bq=16, bkv=64)
    got = fa_mod.flash_attention_cuda(q, k, k, window=50, bq=16, bkv=64)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])
    qf, kf = q.float(), k.float()
    want = fa_mod.flash_attention_plain(qf, kf, kf, window=50, bq=32,
                                        bkv=16)
    got = fa_mod.flash_attention_cuda(qf, kf, kf, window=50, bq=32, bkv=16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    with pytest.raises(ValueError, match="multiple of 16"):
        fa_mod.flash_attention_cuda(q[..., :100], k[..., :100],
                                    k[..., :100])
    with pytest.raises(ValueError, match="shared memory"):
        fa_mod.flash_attention_cuda(q, k, k, bq=256, bkv=256)
    with pytest.raises(ValueError, match="shared memory"):
        fa_mod.flash_attention_cuda(q, k, k, bq=64, bkv=32)


# K7's register-resident bf16 route: (Hq, Hkv, D, kwargs); every case runs
# at Sq = Skv = 1, 15, 65 and 257, ragged against 64- and 128-row q tiles
# of 64 kv columns
FA_BF16_CASES = {
    "mqa16_d256_window": (16, 1, 256, dict(window=40)),
    "gqa_d128_softcap": (8, 2, 128, dict(softcap=50.0)),
    "mqa16_d64_window_softcap": (16, 1, 64, dict(window=24, softcap=5.0)),
    "mha_d128_full": (2, 2, 128, dict(causal=False)),
    "gqa_d64_causal": (4, 2, 64, dict()),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FA_BF16_CASES))
@pytest.mark.parametrize("s", [1, 15, 65, 257])
def test_flash_attention_bf16_tiles_match_plain(dev, case, s):
    """K7 (bf16: S, P and O in registers) against its plain version at
    head dims 64 / 128 / 256, MQA with 16 q heads on one kv head, windows
    of 24 and 40 that cut a 64-column kv tile in its middle, a
    softcap, and lengths ragged against the default 64-row q tile and an
    explicit 128-row one (8 warps)."""
    hq, hkv, d, kw = FA_BF16_CASES[case]
    q = _t((2, s, hq, d), torch.bfloat16, dev).transpose(1, 2)
    k = _t((2, s, hkv, d), torch.bfloat16, dev).transpose(1, 2)
    v = _t((2, s, hkv, d), torch.bfloat16, dev).transpose(1, 2)
    bkv = fa_mod.BF16_BKV
    for bq in (64, 128):
        fa_mod.LAUNCHES.clear()
        got = fa_mod.flash_attention(q, k, v, bq=bq, bkv=bkv, **kw)
        want = fa_mod.flash_attention_plain(q, k, v, bq=bq, bkv=bkv, **kw)
        torch.cuda.synchronize()
        assert fa_mod.LAUNCHES["flash_attention"] == 1
        assert got.shape == q.shape and got.dtype == torch.bfloat16
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), want.float(),
                                   **TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 65, 257])
def test_flash_attention_mla_widths_match_plain(dev, dtype, s):
    """K7 at MLA's prefill widths: q / k 192 (nope 128 + rope 64), v 128,
    scale 192^-0.5, read as the model reads them (k the concatenated
    (B, S, H, 192) keys, v the strided last 128 columns of wkv_b's
    (B, S, H, 256) output); the output is (B, H, S, 128)."""
    q = _t((2, s, 8, 192), dtype, dev).transpose(1, 2)
    k = _t((2, s, 8, 192), dtype, dev).transpose(1, 2)
    v = _t((2, s, 8, 256), dtype, dev)[..., 128:].transpose(1, 2)
    kw = dict(scale=192 ** -0.5)
    fa_mod.LAUNCHES.clear()
    got = fa_mod.flash_attention(q, k, v, **kw)
    want = fa_mod.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_mod.LAUNCHES["flash_attention"] == 1
    assert got.shape == (2, 8, s, 128) and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    with pytest.raises(ValueError, match="v width"):
        fa_mod.flash_attention_cuda(q[..., :128], k[..., :128], k)


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 3072, 4096), (2, 300, 201)],
                         ids=["b1_p3072", "odd_width"])
def test_rglru_scan_batch1_long_and_odd_width_match_plain(dev, dtype, shape):
    """recurrentgemma-9b's 1 x 3072 prefill (16-channel tiles, 12 blocks of
    steps) and an odd width (one channel a thread) with the fp32 carry."""
    x, r, i = (_t(shape, dtype, dev) for _ in range(3))
    lam = _t((shape[-1],), torch.float32, dev)
    rg_mod.LAUNCHES.clear()
    y, h = rg_mod.rglru_scan(x, r, i, lam, return_state=True)
    want, hw = rg_mod.rglru_scan_plain(x, r, i, lam, return_state=True)
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
# and odd sizes under the kernel's limits; exactly two chunks, the odd
# sizes at batch 1, and a head dim that is not a multiple of 4 over
# chunks of 2 rows.
SSD_CASES = {
    "mamba2_b4_p128": (4, 128, 80, 64, 1, 128, 128),
    "mamba2_b1_p3000": (1, 3000, 80, 64, 1, 128, 128),
    "grouped_ragged": (2, 200, 16, 64, 4, 64, 128),
    "odd_sizes": (3, 77, 6, 40, 3, 72, 48),
    "two_chunks": (2, 256, 8, 64, 2, 128, 128),
    "odd_sizes_b1": (1, 77, 6, 40, 3, 72, 48),
    "p3_s5_chunk2": (1, 5, 2, 3, 1, 5, 2),
}
MULTI_CHUNK = [c for c, v in SSD_CASES.items() if v[1] > v[-1]]


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
@pytest.mark.parametrize("return_state", [True, False])
@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_scan_launch_counts(dev, case, return_state):
    """One readout launch per call; the chunk-state kernel and the state
    pass once each, only with more than one chunk."""
    chunk = SSD_CASES[case][-1]
    args = _ssd_inputs(case, torch.bfloat16, dev)
    ssd_mod.LAUNCHES.clear()
    ssd_mod.ssd_scan(*args, chunk=chunk, return_state=return_state)
    torch.cuda.synchronize()
    multi = int(case in MULTI_CHUNK)
    want = {"ssd_scan": 1, "ssd_chunk_state": multi, "ssd_state_pass": multi}
    assert {k: ssd_mod.LAUNCHES[k] for k in want} == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MULTI_CHUNK)
def test_ssd_chunk_states_and_state_pass_match_their_plain_pieces(
        dev, dtype, case):
    """The chunk-state kernel (every chunk's dS, columns past P zero, and
    exp(cum_last)) and the state pass (each chunk's incoming state, the
    final state) against their plain pieces on the same inputs."""
    chunk, p = SSD_CASES[case][-1], SSD_CASES[case][3]
    x, dt, a_log, bm, _ = _ssd_inputs(case, dtype, dev)
    ssd_mod.LAUNCHES.clear()
    ws, decay = ssd_mod.ssd_chunk_state_cuda(x, dt, a_log, bm, chunk=chunk)
    ds, dec = ssd_mod.ssd_chunk_state_plain(x, dt, a_log, bm, chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(ws[..., :p], ds, rtol=1e-4, atol=1e-4)
    assert (ws[..., p:] == 0).all()
    torch.testing.assert_close(decay, dec, rtol=1e-5, atol=0)
    incoming, st_want = ssd_mod.ssd_state_pass_plain(ws[..., :p].clone(),
                                                     decay, ws.shape[2])
    st = ssd_mod.ssd_state_pass_cuda(ws, decay, p)
    torch.cuda.synchronize()
    assert dict(ssd_mod.LAUNCHES) == {"ssd_chunk_state": 1,
                                      "ssd_state_pass": 1}
    torch.testing.assert_close(ws[:, :, 1:, :, :p], incoming[:, :, 1:],
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, st_want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_long_prompt_under_strong_decay(dev, dtype):
    """mamba2's 1 x 3000 prompt (24 chunks through the state pass) under a
    strong decay: y and the state stay finite and match the plain version;
    in fp32 K8 comes at least as near the fp64 recurrence as the chunked
    form with an fp32 torch.cumsum."""
    x, dt, a_log, bm, cm = _ssd_inputs("mamba2_b1_p3000", dtype, dev,
                                       strong_decay=True)
    y, st = ssd_mod.ssd_scan_cuda(x, dt, a_log, bm, cm, return_state=True)
    want, st_want = ssd_mod.ssd_scan_plain(x, dt, a_log, bm, cm,
                                           return_state=True)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    torch.testing.assert_close(y.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(st, st_want, rtol=1e-4, atol=1e-4)
    if dtype == torch.float32:
        exact = ref.ssd_ref(x.double(), dt.double(), a_log.double(),
                            bm.double(), cm.double())
        y32 = ssd_mod.ssd_scan_plain(x, dt, a_log, bm, cm,
                                     cum_dtype=torch.float32)
        scale = exact.abs().max()
        err = ((y.double() - exact).abs().max() / scale).item()
        err32 = ((y32.double() - exact).abs().max() / scale).item()
        assert err <= err32 and err < 1e-6, (err, err32)


@pytest.mark.cuda
def test_ssd_pieces_refuse_what_they_do_not_take(dev):
    x, dt, a_log, bm, _ = _ssd_inputs("mamba2_b4_p128", torch.bfloat16, dev)
    with pytest.raises(ValueError, match="one chunk"):
        ssd_mod.ssd_chunk_state_cuda(x, dt, a_log, bm, chunk=128)
    x, dt, a_log, bm, _ = _ssd_inputs("two_chunks", torch.bfloat16, dev)
    ws, decay = ssd_mod.ssd_chunk_state_cuda(x, dt, a_log, bm, chunk=128)
    with pytest.raises(ValueError, match="workspace"):
        ssd_mod.ssd_state_pass_cuda(ws, decay, 60)
    with pytest.raises(ValueError, match="workspace"):
        ssd_mod.ssd_state_pass_cuda(ws, decay[:, :1], 64)


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


# A shape at which a_resident's CTA holds more than one column tile at
# (32, 128) blocks on a 132-SM card (2 tiles of 128 columns, 100 row
# blocks), with a ragged last chunk (one tile, 88 of its columns real).
AR_CHUNKED = (3200, 520, 600)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [(32, 128), (64, 64), (128, 128)])
def test_block_sparse_a_resident_chunked_matches_plain(dev, dtype, block):
    from repro_torch.kernels import block_sparse_matmul as bsr_mod
    m, k, n = AR_CHUNKED
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per = bsr_mod.a_resident_chunk(-(-m // block[0]), n, *block, dtype, sms)
    if block == (32, 128) and sms >= 114:
        assert per > 1
    a, b = _t((m, k), dtype, dev, 0.2), _t((k, n), dtype, dev, 0.2)
    for density in (0.05, 0.25, 0.5, 1.0):
        lay = _bsr_layout(m, k, block, density, empty_rows=density < 1.0)
        for spec in (None, "bias_silu", "residual"):
            tokens, bias, res = _operands(spec, m, n, dtype, dev)
            got = bsr_mod.block_sparse_matmul_cuda(
                a, b, lay, bias, res, bn=64, schedule="a_resident",
                epilogue=tokens, out_dtype=dtype)
            want = bsr_mod.block_sparse_matmul_plain(
                a, b, lay, bias, res, epilogue=tokens, out_dtype=dtype)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(),
                                       **TOL[dtype])


def _allocates_only_its_output(dev, dtype, schedule):
    from repro_torch.kernels import block_sparse_matmul as bsr_mod
    m, k, n = 1024, 1024, 1024
    lay = _bsr_layout(m, k, (32, 128), 0.5, empty_rows=False)
    a, b = _t((m, k), dtype, dev, 0.2), _t((k, n), dtype, dev, 0.2)
    bsr_mod.block_sparse_matmul_cuda(a, b, lay, bn=64,
                                     schedule=schedule)   # tables, build
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = bsr_mod.block_sparse_matmul_cuda(a, b, lay, bn=64,
                                           schedule=schedule,
                                           out_dtype=dtype)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated(dev) - before
    assert grown == -(-out.numel() * out.element_size() // 512) * 512


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_sparse_a_resident_allocates_only_its_output(dev, dtype):
    _allocates_only_its_output(dev, dtype, "a_resident")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_sparse_b_resident_allocates_only_its_output(dev, dtype):
    """b_resident keeps its chunk's sums in registers: no fp32 workspace."""
    _allocates_only_its_output(dev, dtype, "b_resident")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("schedule", ["k_inner", "a_resident", "b_resident"])
def test_block_sparse_dense_layout_bitwise_equals_k1(dev, dtype, schedule):
    """At density 1.0 K9 visits every k block in order with K1's MMAs and
    K1's fold of the block partials, so its output equals K1's bit for
    bit, on a chunked shape, at (128, 128) blocks, and where K9 k_inner
    takes 256-column tiles (4000 rows)."""
    from repro_torch.kernels import block_sparse_matmul as bsr_mod
    from repro_torch.sparse.layout import BlockSparseLayout
    for (m, k, n), block, bn in (((200, 700, 300), (64, 128), 128),
                                 ((200, 700, 300), (32, 128), 64),
                                 ((200, 700, 300), (128, 128), 64),
                                 (AR_CHUNKED, (32, 128), 64),
                                 (AR_CHUNKED, (128, 128), 64),
                                 ((4000, 520, 1000), (32, 128), 64)):
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


# K9 k_inner: (m, k, n, block, bn), ragged against every block; (128, 128)
# at bn 64 is the sparse planner's fail-over plan; the "wide" shapes have
# enough row tiles for 256-column tiles (two strips a warp, bf16)
BKI_CASES = {
    "ragged_32x128": (1000, 1500, 700, (32, 128), 64),
    "ragged_64x64": (150, 300, 90, (64, 64), 64),
    "failover_128x128x64": (600, 1100, 500, (128, 128), 64),
    "small_16x16": (40, 70, 50, (16, 16), 16),
    "wide_32x128": (4000, 520, 1000, (32, 128), 64),
    "wide_failover_128x128x64": (4000, 520, 1000, (128, 128), 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(BKI_CASES))
def test_block_sparse_k_inner_matches_plain(dev, dtype, case):
    """K9 k_inner's walk over the nonzero blocks' slices, at densities 0.05
    to 1.0, with empty row blocks below 1.0, and B row-major or a
    transposed view (copied n-major)."""
    from repro_torch.kernels import block_sparse_matmul as bsr_mod
    m, k, n, block, bn = BKI_CASES[case]
    a = _t((m, k), dtype, dev, 0.2)
    b_rows = _t((k, n), dtype, dev, 0.2)
    b_cols = _t((n, k), dtype, dev, 0.2).T
    for density in (0.05, 0.25, 0.5, 1.0):
        lay = _bsr_layout(m, k, block, density, empty_rows=density < 1.0)
        for b in (b_rows, b_cols):
            for spec in (None, "bias_silu", "residual"):
                tokens, bias, res = _operands(spec, m, n, dtype, dev)
                got = bsr_mod.block_sparse_matmul_cuda(
                    a, b, lay, bias, res, bn=bn, schedule="k_inner",
                    epilogue=tokens, out_dtype=dtype)
                want = bsr_mod.block_sparse_matmul_plain(
                    a, b, lay, bias, res, epilogue=tokens, out_dtype=dtype)
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), want.float(),
                                           **TOL[dtype])
        if density < 1.0:            # the empty row block: epilogue(0)
            tokens, _, res = _operands("residual", m, n, dtype, dev)
            got = bsr_mod.block_sparse_matmul_cuda(
                a, b_rows, lay, None, res, bn=bn, schedule="k_inner",
                epilogue=tokens, out_dtype=torch.float32)
            torch.cuda.synchronize()
            assert torch.equal(got[:block[0]], res[:block[0]].float())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 4, 8])
def test_dense_a_resident_decode_rows_match_plain(dev, dtype, m):
    """K1 a_resident at decode rows (8-row tiles, up to 8 column tiles a
    CTA) against its plain version: the tuner's decode plans (64, 128, 64)
    and (64, 64, 64) (a slice of two k blocks) with row-major B, and a tied
    embedding read as E^T in place."""
    w = _t((1024, 2048), dtype, dev, 1024 ** -0.5)
    emb = _t((3000, 1024), dtype, dev, 0.02)
    a = _t((m, 1024), dtype, dev)
    for b, spec in ((w, "residual"), (w, "silu"), (emb.T, None)):
        tokens, bias, res = _operands(spec, m, b.shape[1], dtype, dev)
        for blocks in ((64, 128, 64), (64, 64, 64), (64, 64, 128)):
            for out_dtype in (dtype, torch.float32):
                got = mm_mod.skew_matmul_cuda(
                    a, b, bias, res, bm=blocks[0], bk=blocks[1],
                    bn=blocks[2], schedule="a_resident", epilogue=tokens,
                    out_dtype=out_dtype)
                want = mm_mod.skew_matmul_plain(a, b, bias, res,
                                                bk=blocks[1],
                                                epilogue=tokens,
                                                out_dtype=out_dtype)
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), want.float(),
                                           **TOL[out_dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_a_resident_allocates_only_its_output(dev, dtype):
    """K1 a_resident keeps its chunk's sums in registers: no fp32 (m, n)
    workspace, at decode rows and at a shape of several k blocks and row
    tiles."""
    for m, k, n in ((4, 1024, 4096), (200, 700, 300)):
        a, b = _t((m, k), dtype, dev, 0.2), _t((k, n), dtype, dev, 0.2)
        mm_mod.skew_matmul_cuda(a, b, bm=64, bk=64, bn=128,
                                schedule="a_resident")   # the build
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = mm_mod.skew_matmul_cuda(a, b, bm=64, bk=64, bn=128,
                                      schedule="a_resident", out_dtype=dtype)
        torch.cuda.synchronize()
        grown = torch.cuda.max_memory_allocated(dev) - before
        assert grown == -(-out.numel() * out.element_size() // 512) * 512


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 4, 17])
def test_dense_b_resident_decode_rows_allocate_only_their_output(dev, dtype,
                                                                m):
    """K1 b_resident (K9's template walking every block) at decode rows
    against its plain version, with a tied embedding read as E^T in place
    (copied n-major) and a row-major B, keeping its sums in registers: it
    allocates its output and no fp32 (m, n) workspace."""
    emb = _t((3000, 1024), dtype, dev, 0.02)
    w = _t((1024, 2048), dtype, dev, 1024 ** -0.5)
    a = _t((m, 1024), dtype, dev)
    for b, spec in ((emb.T, None), (w, "residual"), (w, "bias_silu")):
        tokens, bias, res = _operands(spec, m, b.shape[1], dtype, dev)
        for out_dtype in (dtype, torch.float32):
            kw = dict(bm=64, bk=64, bn=128, schedule="b_resident",
                      epilogue=tokens, out_dtype=out_dtype)
            mm_mod.skew_matmul_cuda(a, b, bias, res, **kw)   # the build
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            got = mm_mod.skew_matmul_cuda(a, b, bias, res, **kw)
            torch.cuda.synchronize()
            grown = torch.cuda.max_memory_allocated(dev) - before
            assert grown == -(-got.numel() * got.element_size() // 512) * 512
            want = mm_mod.skew_matmul_plain(a, b, bias, res, bk=64,
                                            epilogue=tokens,
                                            out_dtype=out_dtype)
            torch.testing.assert_close(got.float(), want.float(),
                                       **TOL[out_dtype])


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
