"""The port's SSD (Mamba-2) pieces against the JAX package's, on the same
numpy-seeded inputs: the scan's plain version with its state (against the
Pallas kernel in interpret mode, `ssd_chunked` and `ref.ssd_ref`), the
port's oracle and `ssd_chunked` (with and without an initial state), the
split-sequence state property, the decode step, and the whole mixer on
mamba2-2.7b's `reduced()` config (JAX parameters carried over by
`convert`).

Layouts: `ssd_ref` returns its state as (B, H, P, S); `ssd_chunked`, the
kernel and the decode cache use (B, H, S, P).  Each function keeps its
own; the tests transpose only when they compare with `ssd_ref`.

Tolerances (fp32): rtol = atol = 1e-5 — every side runs the same fp32
algebra (decays <= 1, so rounding does not grow along the sequence) and
differs only in the order of its sums (observed ~1e-7).  The mixer: 1e-5
as well (its matmuls sum at most 256 terms).  Under a strong decay the
chunked forms are compared with the sequential oracle at 1e-3: |cum|
reaches thousands there, where fp32 holds cum_i - cum_j to a few ulps of
|cum| only, and exp turns that into ~1e-4 relative; the plain version
(K8's math, fp64 prefix sum) is also held against the recurrence in fp64
at the served chunk of 128, within 1e-6 and nearer than the fp32 forms.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.config import mm_config as jmm_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.config import mm_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as scan
from repro_torch.models import ssm

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "mamba2-2.7b"


def _inputs(b, length, h, p, g, s, seed, strong_decay=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, length, h, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(b, length, h)).astype(np.float32)
    a_log = rng.uniform(-0.5, 1.0, size=(h,)).astype(np.float32)
    if strong_decay:        # A = -e^3, dt up to 5: |cum| in the thousands
        dt = dt * 50.0
        a_log = np.full_like(a_log, 3.0)
    bm = (rng.normal(size=(b, length, g, s)) * 0.5).astype(np.float32)
    cm = (rng.normal(size=(b, length, g, s)) * 0.5).astype(np.float32)
    return x, dt, a_log, bm, cm


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _ref_state(st):
    """ssd_ref's (B, H, P, S) state in the (B, H, S, P) layout."""
    return np.swapaxes(np.asarray(st), -1, -2)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("chunk", [16, 32])
def test_plain_scan_matches_pallas_and_oracle(chunk, groups):
    args = _inputs(2, 64, 4, 16, groups, 8, seed=chunk + groups)
    y, st = scan.ssd_scan_plain(*_t(*args), chunk=chunk, return_state=True)
    assert y.shape == (2, 64, 4, 16) and st.shape == (2, 4, 8, 16)
    assert st.dtype == torch.float32
    pallas = np.asarray(jops.ssd_scan(*_j(*args), chunk=chunk,
                                      interpret=True))
    np.testing.assert_allclose(y.numpy(), pallas, **TOL)
    ry, rst = jref.ssd_ref(*_j(*args), return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(st.numpy(), _ref_state(rst), **TOL)


@pytest.mark.parametrize("length", [1, 5, 50])
def test_ragged_length_and_state_match_ssd_chunked(length):
    """Any L: the plain scan's short last chunk against JAX's zero-dt
    padding, with the (B, H, S, P) state of both."""
    args = _inputs(2, length, 4, 8, 2, 8, seed=length)
    y, st = ops.ssd_scan(*_t(*args), chunk=16, return_state=True)
    jy, jst = jssm.ssd_chunked(*_j(*args), chunk=16, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)
    ry, rst = jref.ssd_ref(*_j(*args), return_state=True)
    np.testing.assert_allclose(st.numpy(), _ref_state(rst), **TOL)


def test_strong_decay_stays_finite():
    """exp(cum_i - cum_j) overflows for j > i here; both chunked forms
    select those entries away, so nothing is NaN or inf."""
    args = _inputs(2, 100, 4, 8, 1, 8, seed=7, strong_decay=True)
    ry, rst = jref.ssd_ref(*_j(*args), return_state=True)
    y, st = scan.ssd_scan_plain(*_t(*args), chunk=32, return_state=True)
    y2, st2 = ssm.ssd_chunked(*_t(*args), chunk=32, return_state=True)
    for got, state in ((y, st), (y2, st2)):
        assert torch.isfinite(got).all() and torch.isfinite(state).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(ry), rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(state.numpy(), _ref_state(rst),
                                   rtol=1e-3, atol=1e-3)


def test_plain_scan_is_nearest_the_exact_answer_under_strong_decay():
    """At the served chunk of 128 under a strong decay |cum| reaches
    thousands.  K8's math (the plain version) takes the log-decay prefix
    sum and its differences in fp64; the JAX package's chunked form and the
    "torch" rung take an fp32 prefix sum, which holds cum_i - cum_j to a few
    ulps of |cum| only (observed: y within 6e-8 of the largest |y| against
    ~1.5e-5 for both fp32 forms; the state, which the last rows dominate,
    within 3e-8 for all three).  Against the sequential recurrence in fp64,
    the plain version's y must be the nearest."""
    args = _t(*_inputs(2, 256, 4, 8, 1, 8, seed=21, strong_decay=True))
    ey, est = ref.ssd_ref(*[t.double() for t in args], return_state=True)
    est = est.transpose(-1, -2)

    def err(got, want):
        got = torch.from_numpy(np.array(got, dtype=np.float64))
        return ((got - want).abs().max() / want.abs().max()).item()

    y, st = scan.ssd_scan_plain(*args, chunk=128, return_state=True)
    ty, tst = ssm.ssd_chunked(*args, chunk=128, return_state=True)
    jy, jst = jssm.ssd_chunked(*_j(*[t.numpy() for t in args]), chunk=128,
                               return_state=True)
    assert err(y, ey) <= min(err(ty, ey), err(jy, ey))
    assert err(y, ey) < 1e-6
    for state in (st, tst, jst):
        assert err(state, est) < 1e-6


@pytest.mark.parametrize("length", [24, 50])
def test_ssd_chunked_with_init_state_matches_jax(length):
    args = _inputs(2, length, 4, 8, 2, 8, seed=11)
    st0 = np.random.default_rng(12).normal(size=(2, 4, 8, 8)).astype(
        np.float32)
    y, st = ssm.ssd_chunked(*_t(*args), chunk=16,
                            init_state=torch.tensor(st0), return_state=True)
    jy, jst = jssm.ssd_chunked(*_j(*args), chunk=16,
                               init_state=jnp.asarray(st0),
                               return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)
    ry, rst = jref.ssd_ref(*_j(*args), init_state=jnp.swapaxes(
        jnp.asarray(st0), -1, -2), return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    oy, ost = ref.ssd_ref(*_t(*args), init_state=torch.tensor(st0)
                          .transpose(-1, -2), return_state=True)
    np.testing.assert_allclose(oy.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(ost.numpy(), np.asarray(rst), **TOL)


@pytest.mark.parametrize("b,length,seed", [(1, 32, 0), (2, 96, 1),
                                           (2, 32, 2)])
def test_ssd_state_decomposition(b, length, seed):
    """SSD over [x1; x2] == SSD(x2) seeded with state(x1): the chunked
    algorithm's core invariant (the JAX package's property test in
    tests/test_properties.py, at fixed draws), for `ssd_chunked` and for
    the scan's state feeding `ssd_chunked`."""
    x, dt, a_log, bm, cm = _t(*_inputs(b, length, 2, 8, 1, 4, seed=seed))
    half = length // 2
    y_full = ssm.ssd_chunked(x, dt, a_log, bm, cm, chunk=16)
    first = (x[:, :half], dt[:, :half], a_log, bm[:, :half], cm[:, :half])
    rest = (x[:, half:], dt[:, half:], a_log, bm[:, half:], cm[:, half:])
    for fn in (ssm.ssd_chunked, scan.ssd_scan_plain):
        _, st1 = fn(*first, chunk=16, return_state=True)
        y2 = ssm.ssd_chunked(*rest, chunk=16, init_state=st1)
        np.testing.assert_allclose(y2.numpy(), y_full[:, half:].numpy(),
                                   **TOL)


def test_decode_step_matches_jax():
    rng = np.random.default_rng(17)
    state = rng.normal(size=(3, 4, 8, 16)).astype(np.float32)
    xt = rng.normal(size=(3, 4, 16)).astype(np.float32)
    dtt = rng.uniform(0.01, 0.2, size=(3, 4)).astype(np.float32)
    a_log = rng.uniform(-0.5, 1.0, size=(4,)).astype(np.float32)
    bt, ct = (rng.normal(size=(3, 2, 8)).astype(np.float32)
              for _ in range(2))
    y, st = ssm.ssd_decode_step(*_t(state, xt, dtt, a_log, bt, ct))
    jy, jst = jssm.ssd_decode_step(*_j(state, xt, dtt, a_log, bt, ct))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)


def test_decode_steps_continue_the_scan():
    """The scan's state, advanced token by token with the decode step,
    gives the scan's own outputs over the longer sequence."""
    x, dt, a_log, bm, cm = _t(*_inputs(2, 40, 4, 8, 2, 8, seed=21))
    want = scan.ssd_scan_plain(x, dt, a_log, bm, cm, chunk=16)
    _, st = scan.ssd_scan_plain(x[:, :36], dt[:, :36], a_log, bm[:, :36],
                                cm[:, :36], chunk=16, return_state=True)
    for t in range(36, 40):
        y, st = ssm.ssd_decode_step(st, x[:, t], dt[:, t], a_log, bm[:, t],
                                    cm[:, t])
        np.testing.assert_allclose(y.numpy(), want[:, t].numpy(), **TOL)


def _mixer_setup(seed=3):
    jcfg = jget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    assert jcfg.__dict__ == cfg.__dict__
    jp = jssm.init_ssm(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy({"mixer": jax.tree.map(np.asarray, jp)},
                           "cpu")["mixer"]
    return jcfg, cfg, jp, tp


@pytest.fixture(scope="module")
def mixer_case():
    """Weights, a 40-token input (one whole 32-row chunk and a ragged
    tail) and the JAX mixer's output, computed once for both backends."""
    jcfg, cfg, jp, tp = _mixer_setup()
    x = np.random.default_rng(29).normal(size=(2, 40, cfg.d_model)).astype(
        np.float32)
    with jmm_config(backend="xla"):
        want = jssm.ssm_mixer(jnp.asarray(x), jp, jcfg)
    return cfg, tp, x, np.asarray(want)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_ssm_mixer_matches_jax(backend, mixer_case):
    cfg, tp, x, want = mixer_case
    assert (cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_chunk) == (256, 8, 32, 32, 32)
    with mm_config(backend=backend):
        got, entry = ssm.ssm_mixer(torch.tensor(x), tp, cfg,
                                   return_state=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert entry["state"].shape == (2, 8, 32, 32)
    assert entry["cx"].shape == (2, 3, 256)


def test_converted_ssm_params_keep_shapes_and_dtypes():
    """conv_x arrives as (K, d_inner) per layer, a_log / dt_bias / d_skip
    in fp32 inside a bf16 model, and the port's own init draws the same
    shapes and dtypes."""
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), dtype="bfloat16")
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="bfloat16")
    layers = [jssm.init_ssm(jax.random.PRNGKey(i), jcfg)
              for i in range(cfg.n_layers)]
    stacked = jax.tree.map(lambda *ls: np.stack([np.asarray(t) for t in ls]),
                           *layers)
    jp = {"stage0": {"b0": {"mixer": stacked}}}
    tp = params_from_numpy(jp, "cpu")
    assert len(tp["stage0"]) == cfg.n_layers
    mixer = tp["stage0"][1]["b0"]["mixer"]
    own = ssm.init_ssm(torch.Generator().manual_seed(0), cfg, "cpu")
    assert set(mixer) == set(own)
    for key, t in mixer.items():
        assert t.shape == own[key].shape and t.dtype == own[key].dtype, key
    assert mixer["conv_x"].shape == (cfg.conv_kernel, cfg.d_inner)
    for key in ("a_log", "dt_bias", "d_skip"):
        assert mixer[key].dtype == torch.float32
    assert mixer["in_x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        mixer["conv_x"].float().numpy(),
        np.asarray(jp["stage0"]["b0"]["mixer"]["conv_x"][1], np.float32))
