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
values: one bf16 ulp is 2**-8 relative).
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import gemv_splitk as gk_mod
from repro_torch.kernels import skew_matmul as mm_mod

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
