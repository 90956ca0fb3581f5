"""The port's flash attention (plain version, ops wrapper, oracle) against
the JAX package's `kernels.ref.attention_ref` and its Pallas kernel run in
interpret mode (`kernels.ops.flash_attention`), on the same numpy-seeded
q / k / v.

Tolerance: fp32 rtol = atol = 1e-5.  Both sides take fp32 scores and an
fp32 softmax; they differ only in the order of the sums (the online softmax
rescales per kv tile, the oracle normalises once), ~1e-7 at these sizes.
bf16 (plain version only): atol 2e-2, which covers the one rounding of the
output to bf16 (2**-9 relative at unit scale); P enters P @ V as two bf16
terms hi + lo (~16 significant bits, the kernel's tensor-core operands),
which moves the result by ~2**-17 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref

TOL = dict(rtol=1e-5, atol=1e-5)

MASKS = {
    "causal": dict(causal=True),
    "window": dict(causal=True, window=48),
    "softcap": dict(causal=True, softcap=5.0),
    "window_softcap": dict(causal=True, window=40, softcap=3.0),
    "full": dict(causal=False),
}


def _qkv(b, hq, hkv, s, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, s, d)).astype(dtype)
    k = rng.normal(size=(b, hkv, s, d)).astype(dtype)
    v = rng.normal(size=(b, hkv, s, d)).astype(dtype)
    return q, k, v


def _torch(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("heads", [(4, 2), (4, 1)], ids=["gqa", "mqa"])
@pytest.mark.parametrize("d", [32, 64])
def test_plain_matches_jax_oracle_and_pallas_interpret(mask, heads, d):
    hq, hkv = heads
    q, k, v = _qkv(2, hq, hkv, 128, d, seed=d + hq + hkv)
    kw = MASKS[mask]
    got = fa.flash_attention_plain(*_torch(q, k, v), **kw).numpy()
    want = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), **kw))
    np.testing.assert_allclose(got, want, **TOL)
    pallas = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=64, bkv=64,
        **kw))
    np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("s", [1, 37, 100, 129])
@pytest.mark.parametrize("mask", ["causal", "window_softcap", "full"])
def test_ragged_lengths_match_jax_oracle(s, mask):
    """No length has to divide a tile (the Pallas kernel needs S % bq ==
    0, so ragged lengths are held against the oracle only)."""
    q, k, v = _qkv(1, 4, 2, s, 32, seed=s)
    kw = MASKS[mask]
    got = fa.flash_attention_plain(*_torch(q, k, v), **kw).numpy()
    want = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), **kw))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("tile", [(16, 16), (32, 64), (64, 16)])
def test_tiles_do_not_change_the_result(tile):
    q, k, v = _qkv(1, 2, 1, 96, 32, seed=3)
    kw = dict(causal=True, window=30, softcap=4.0)
    want = fa.flash_attention_plain(*_torch(q, k, v), **kw)
    got = fa.flash_attention_plain(*_torch(q, k, v), bq=tile[0],
                                   bkv=tile[1], **kw)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("mask", ["causal", "window_softcap", "full"])
def test_port_oracle_matches_jax_oracle(mask):
    q, k, v = _qkv(2, 6, 2, 50, 16, seed=8)
    kw = MASKS[mask]
    got = ref.attention_ref(*_torch(q, k, v), **kw).numpy()
    want = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), **kw))
    np.testing.assert_allclose(got, want, **TOL)


def test_scale_argument_matches_jax():
    q, k, v = _qkv(1, 2, 2, 64, 32, seed=12)
    got = ops.flash_attention(*_torch(q, k, v), scale=0.3).numpy()
    want = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), scale=0.3))
    np.testing.assert_allclose(got, want, **TOL)


def test_ops_wrapper_runs_the_plain_version_on_cpu():
    q, k, v = _torch(*_qkv(2, 4, 1, 70, 32, seed=5))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, window=20)
    want = fa.flash_attention_plain(q, k, v, window=20)
    assert torch.equal(got, want)
    assert ops.launch_counts()["flash_attention"] == 0


def test_bf16_plain_close_to_the_oracle():
    q, k, v = _qkv(1, 4, 2, 96, 64, seed=21)
    tq, tk, tv = (t.to(torch.bfloat16) for t in _torch(q, k, v))
    got = fa.flash_attention_plain(tq, tk, tv, window=64, softcap=8.0)
    want = ref.attention_ref(tq.float(), tk.float(), tv.float(), window=64,
                             softcap=8.0)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, rtol=0, atol=2e-2)


def test_tiles_fit_shared_memory():
    """bf16 (S, P and O in registers, K and V on a ring) takes 128 x 64 at
    every head dim (8 warps), with room for two CTAs an SM up to head dim
    128; fp32 (every intermediate in shared memory) drops to 64 x 32 at
    256; every choice fits the 227 KB a CTA may hold."""
    assert fa.tiles(torch.bfloat16, 128) == (128, 64)
    assert fa.tiles(torch.bfloat16, 256) == (128, 64)
    assert fa.tiles(torch.float32, 128) == (64, 64)
    assert fa.tiles(torch.float32, 256) == (64, 32)
    for dt in (torch.bfloat16, torch.float32):
        for d in (16, 32, 64, 128, 256):
            bq, bkv = fa.tiles(dt, d)
            assert fa.smem_bytes(dt, bq, bkv, d) <= fa.SMEM_MAX
            assert fa.takes_tiles(dt, bq, bkv, d)
            if dt == torch.bfloat16:
                assert fa.stages(bq, bkv, d) >= 2
                assert (d > 128 or fa.smem_bytes(dt, bq, bkv, d)
                        <= (fa.SMEM_MAX - 1024) // 2)
    assert fa.stages(128, 64, 256) == 2 and fa.stages(64, 64, 64) == 4
    assert fa.smem_bytes(torch.float32, 64, 64, 256) > fa.SMEM_MAX
    assert fa.takes_tiles(torch.bfloat16, 16, 64, 256)
    assert not fa.takes_tiles(torch.bfloat16, 64, 32, 128)
    assert not fa.takes_tiles(torch.bfloat16, 256, 64, 128)


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = _torch(*_qkv(1, 2, 1, 16, 32, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, v)
