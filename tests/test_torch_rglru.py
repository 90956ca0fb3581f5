"""The port's RG-LRU pieces against the JAX package's, on the same
numpy-seeded inputs: the scan's plain version and its carry (against the
Pallas kernel in interpret mode, `rglru_jnp` with `return_state` and
`ref.rglru_ref`), the plain log-depth scan, the decode step, the causal
conv with and without a state, the block-diagonal gate projection and the
whole recurrent mixer (JAX parameters carried over by `convert`).

Tolerances (fp32): rtol = atol = 1e-5 — every side runs the same fp32
recurrence (a_t in [0, 1], so rounding does not grow along the sequence)
and differs only in the order of its products and sums (observed
~1e-7).  The mixer: 1e-5 as well (its matmuls sum at most 128 terms).
bf16 outputs: one bf16 rounding apart at most (atol 2e-2 at unit scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.config import mm_config as jmm_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.config import mm_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as scan
from repro_torch.models import rglru
from repro_torch.models.ssm import causal_conv1d

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, length, d, seed, strong_decay=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, length, d)).astype(np.float32)
    r = rng.normal(size=(b, length, d)).astype(np.float32)
    i = rng.normal(size=(b, length, d)).astype(np.float32)
    lam = rng.uniform(-2, 2, size=(d,)).astype(np.float32)
    if strong_decay:        # sigmoid(r) ~ 1 and softplus(4) ~ 4: a ~ e^-32
        r = np.full_like(r, 5.0)
        lam = np.full_like(lam, 4.0)
    return x, r, i, lam


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("strong_decay", [False, True],
                         ids=["random", "strong_decay"])
@pytest.mark.parametrize("chunk", [32, 128])
def test_plain_scan_and_carry_match_jax(strong_decay, chunk):
    x, r, i, lam = _inputs(2, 256, 32, seed=chunk, strong_decay=strong_decay)
    y, h = scan.rglru_scan_plain(*_t(x, r, i, lam), return_state=True)
    assert h.dtype == torch.float32 and h.shape == (2, 32)
    assert not torch.isnan(y).any()
    pallas = np.asarray(jops.rglru_scan(*_j(x, r, i, lam), chunk=chunk))
    np.testing.assert_allclose(y.numpy(), pallas, **TOL)
    jy, jh = jrglru.rglru_jnp(*_j(x, r, i, lam), return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    ry, rh = jref.rglru_ref(*_j(x, r, i, lam), return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), **TOL)


@pytest.mark.parametrize("length", [1, 37, 200])
def test_ragged_lengths_and_carry_match_jax_oracle(length):
    """Any L (the Pallas kernel needs L % chunk == 0)."""
    x, r, i, lam = _inputs(3, length, 16, seed=length)
    y, h = ops.rglru_scan(*_t(x, r, i, lam), c=6.0, return_state=True)
    ry, rh = jref.rglru_ref(*_j(x, r, i, lam), c=6.0, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), **TOL)


def test_port_oracle_with_init_state_matches_jax():
    x, r, i, lam = _inputs(2, 40, 8, seed=4)
    h0 = np.random.default_rng(5).normal(size=(2, 8)).astype(np.float32)
    y, h = ref.rglru_ref(*_t(x, r, i, lam), init_state=torch.tensor(h0),
                         return_state=True)
    jy, jh = jref.rglru_ref(*_j(x, r, i, lam), init_state=jnp.asarray(h0),
                            return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("length", [1, 5, 64, 100])
@pytest.mark.parametrize("with_init", [False, True])
def test_log_depth_scan_matches_rglru_jnp(length, with_init):
    x, r, i, lam = _inputs(2, length, 24, seed=length + 7)
    h0 = (np.random.default_rng(9).normal(size=(2, 24)).astype(np.float32)
          if with_init else None)
    y, h = rglru.rglru_torch(*_t(x, r, i, lam), c=8.0,
                             init_state=None if h0 is None
                             else torch.tensor(h0), return_state=True)
    jy, jh = jrglru.rglru_jnp(*_j(x, r, i, lam), c=8.0,
                              init_state=None if h0 is None
                              else jnp.asarray(h0), return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


def test_bf16_plain_scan_close_to_the_oracle():
    x, r, i, lam = _inputs(2, 64, 32, seed=13)
    tx, tr, ti = (t.to(torch.bfloat16) for t in _t(x, r, i))
    y, h = scan.rglru_scan_plain(tx, tr, ti, torch.tensor(lam),
                                 return_state=True)
    want, hw = ref.rglru_ref(tx.float(), tr.float(), ti.float(),
                             torch.tensor(lam), return_state=True)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), want, rtol=0, atol=2e-2)
    torch.testing.assert_close(h, hw, **TOL)


def test_decode_step_matches_jax():
    rng = np.random.default_rng(17)
    state = rng.normal(size=(3, 16)).astype(np.float32)
    xt, rt, it = (rng.normal(size=(3, 16)).astype(np.float32)
                  for _ in range(3))
    lam = rng.uniform(-2, 2, size=(16,)).astype(np.float32)
    y, h = rglru.rglru_decode_step(*_t(state, xt, rt, it, lam), c=8.0)
    jy, jh = jrglru.rglru_decode_step(*_j(state, xt, rt, it, lam), c=8.0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("seq", [1, 9])
def test_causal_conv1d_matches_jax(with_state, seq):
    rng = np.random.default_rng(seq)
    x = rng.normal(size=(2, seq, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state \
        else None
    out, new = causal_conv1d(*_t(x, w), state=None if st is None
                             else torch.tensor(st))
    jout, jnew = jssm.causal_conv1d(*_j(x, w), state=None if st is None
                                    else jnp.asarray(st))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gate_proj_matches_jax(dtype):
    rng = np.random.default_rng(23)
    xc = jnp.asarray(rng.normal(size=(2, 5, 64)), dtype)
    w = jnp.asarray(rng.normal(size=(16, 4, 4)) * 0.5, dtype)
    # XLA on the CPU has no bf16 x bf16 -> fp32 dot: feed it the same bf16
    # values in fp32 (exact) and round its fp32 sums once, as JAX does.
    want = jrglru.gate_proj(xc.astype(jnp.float32),
                            w.astype(jnp.float32)).astype(dtype)
    tree = params_from_numpy({"x": np.asarray(xc), "w": np.asarray(w)},
                             "cpu")
    got = rglru.gate_proj(tree["x"], tree["w"])
    assert str(got.dtype).endswith(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(TOL if dtype == "float32"
                                  else dict(rtol=0, atol=2e-2)))


def _rec_setup(seed=3):
    jcfg = jget_config("recurrentgemma-9b").reduced()
    cfg = get_config("recurrentgemma-9b").reduced()
    assert jcfg.__dict__ == cfg.__dict__
    jp = jrglru.init_rec(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy({"mixer": jax.tree.map(np.asarray, jp)},
                           "cpu")["mixer"]
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_rec_mixer_matches_jax(backend):
    jcfg, cfg, jp, tp = _rec_setup()
    x = np.random.default_rng(29).normal(size=(2, 70, cfg.d_model)).astype(
        np.float32)
    with jmm_config(backend="xla"):
        want = jrglru.rec_mixer(jnp.asarray(x), jp, jcfg)
    with mm_config(backend=backend):
        got = rglru.rec_mixer(torch.tensor(x), tp, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_converted_rec_params_keep_shapes_and_dtypes():
    """w_r / w_i arrive as (nb, bw, bw) per layer, a_param in fp32, and
    the port's own init draws the same shapes and dtypes."""
    jcfg, cfg, jp, tp = _rec_setup()
    own = rglru.init_rec(torch.Generator().manual_seed(0), cfg, "cpu")
    nb = rglru.N_GATE_BLOCKS
    assert tp["w_r"].shape == (nb, cfg.lru_width // nb, cfg.lru_width // nb)
    assert tp["a_param"].dtype == torch.float32
    for key, arr in jp.items():
        assert tuple(tp[key].shape) == arr.shape == tuple(own[key].shape)
        assert tp[key].dtype == own[key].dtype


def test_ops_wrapper_runs_the_plain_version_on_cpu():
    x, r, i, lam = _t(*_inputs(1, 33, 8, seed=31))
    ops.reset_launch_counts()
    got = ops.rglru_scan(x, r, i, lam)
    assert torch.equal(got, scan.rglru_scan_plain(x, r, i, lam))
    assert ops.launch_counts()["rglru_scan"] == 0


def test_cuda_wrapper_refuses_cpu_tensors():
    x, r, i, lam = _t(*_inputs(1, 4, 8, seed=2))
    with pytest.raises(ValueError, match="CUDA"):
        scan.rglru_scan_cuda(x, r, i, lam)
