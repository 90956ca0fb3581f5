"""The port's training path against the JAX package, on the CPU.

At JAX's fp32 `reduced()` configs: `warmup_cosine`; AdamW (JAX's own
cases, and one update of a seeded fp32 + bf16 tree against JAX's
`update`); int8 `quantize` bit for bit and `compress_grads` over ten
steps; `chunked_softmax_xent` (values and grads, and a backward run on a
second thread, where the recompute must keep the forward's matmul config);
`fold_in` bit for bit; one whole train step of each model family from
JAX's `init_train_state`, carried across by `convert.state_from_numpy`,
and its plan log; and the kernels' refusal of a backward.

Tolerances (fp32):
  * loss and grad_norm 1e-5 (sums of a few thousand terms in other
    orders);
  * params, moments and residual 1e-4 of the leaf's largest magnitude.
    One AdamW step moves a param by lr * g / (|g| + eps): where |g| is
    near eps = 1e-8, fp32 reorderings of g (~1e-10) move the update by up
    to ~1e-2 of lr, so the steps run at the default lr 3e-4, where that is
    under 1e-4 of the leaf's largest magnitude (the worst seen is 7.4e-5,
    recurrentgemma's `w_up`);
  * with `compress_grads` the int8 codes are a step function of the
    gradient: an element whose quantizer input lies within the gradients'
    reordering error of a rounding boundary may round the other way in
    the other package (a tie).  So the residual is held at 1e-4 of its
    quantizer's input range (127 quanta: the residual is a difference of
    near-equal values, so its error is the gradient's), every element
    beyond that must differ by exactly one quantum, those ties must be
    fewer than 1e-4 of the elements, and the ties' moments and params are
    left out of the 1e-4 comparison;
  * the schedule 2 fp32 ulps (XLA's fp32 cosine is not correctly
    rounded; see `optim.schedule`); quantize, fold_in, step and rng
    bitwise.
"""

import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten as jflatten
from repro.configs.base import get_config as jget_config
from repro.core import skewmm as jskewmm
from repro.core.config import mm_config as jmm_config
from repro.models.model import build_model as jbuild_model
from repro.optim import compression as jcompression
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.schedule import warmup_cosine as jwarmup_cosine
from repro.serve.sched import buckets as jbuckets
from repro.train.loss import chunked_softmax_xent as jxent
from repro.train.train_step import TrainStepConfig as JTrainStepConfig
from repro.train.train_step import init_train_state as jinit_train_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.checkpoint.ckpt import flatten
from repro_torch.configs.base import get_config
from repro_torch.convert import state_from_numpy
from repro_torch.core import skewmm
from repro_torch.core.config import mm_config
from repro_torch.guard import fallback, health
from repro_torch.kernels import ops
from repro_torch.models.model import build_model
from repro_torch.optim import compression
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.serve.sched import buckets
from repro_torch.sparse.layout import BlockSparseLayout
from repro_torch.train import prng
from repro_torch.train.loss import chunked_softmax_xent
from repro_torch.train.train_step import (TrainStepConfig, init_train_state,
                                          make_train_step)

RNG = np.random.default_rng(17)
TOL = dict(rtol=1e-5, atol=1e-5)
B, S, CHUNK = 2, 32, 16


@pytest.fixture(autouse=True)
def _clean_ledger():
    health.reset()
    fallback.reset_ladders()
    yield
    health.reset()
    fallback.reset_ladders()


# ------------------------------------------------------------- schedule
@pytest.mark.parametrize("args", [(3e-4, 2, 6), (1.0, 10, 100),
                                  (2e-3, 20, 200, 0.05)])
def test_warmup_cosine_equals_jax(args):
    lr, jlr = warmup_cosine(*args), jwarmup_cosine(*args)
    steps = range(args[2] + 6)
    got = np.array([lr(s).item() for s in steps], np.float32)
    want = np.array([jlr(jnp.asarray(s, jnp.int32)) for s in steps],
                    np.float32)
    np.testing.assert_array_max_ulp(got, want, maxulp=2)
    np.testing.assert_array_equal(got[:args[1] + 1], want[:args[1] + 1])
    assert lr(torch.tensor(3, dtype=torch.int32)).dtype == torch.float32


def test_warmup_cosine_schedule():
    """JAX's `test_warmup_cosine_schedule` on the port."""
    lr = warmup_cosine(1.0, 10, 100)
    assert float(lr(0)) == 0.0
    np.testing.assert_allclose(float(lr(10)), 1.0, rtol=1e-5)
    assert float(lr(100)) <= 0.11


# ---------------------------------------------------------------- AdamW
def test_adamw_against_reference():
    """JAX's `test_adamw_against_reference` on the port."""
    opt = AdamW(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                grad_clip=0.0)
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = {"w": torch.tensor([0.1, 0.2, -0.3])}
    state = opt.init(p)
    new_p, state, _ = opt.update(g, state, p)
    m = 0.1 * g["w"].numpy()
    v = 0.01 * g["w"].numpy() ** 2
    mhat, vhat = m / (1 - 0.9), v / (1 - 0.99)
    want = p["w"].numpy() - 0.1 * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-6)
    assert int(state.step) == 1


def test_grad_clip_bounds_update():
    """JAX's `test_grad_clip_bounds_update` on the port."""
    opt = AdamW(lr=1.0, grad_clip=1.0)
    p = {"w": torch.zeros(4)}
    g = {"w": torch.full((4,), 100.0)}
    _, _, metrics = opt.update(g, opt.init(p), p)
    assert float(metrics["grad_norm"]) == 200.0   # pre-clip norm reported


def _seeded_tree(rng):
    """A fp32 + bf16 param tree, its grads, and a stage's per-layer list
    (JAX: one stacked leaf)."""
    w = rng.normal(size=(2, 8, 16)).astype(np.float32)
    b = rng.normal(size=(33,)).astype(np.float32)
    e = rng.normal(size=(64, 12)).astype(np.float32)
    gw = (rng.normal(size=w.shape) * 0.1).astype(np.float32)
    gb = (rng.normal(size=b.shape) * 3.0).astype(np.float32)
    ge = (rng.normal(size=e.shape) * 1e-3).astype(np.float32)
    jp = {"b": jnp.asarray(b), "e": jnp.asarray(e, jnp.bfloat16),
          "stage0": {"w": jnp.asarray(w)}}
    jg = {"b": jnp.asarray(gb), "e": jnp.asarray(ge, jnp.bfloat16),
          "stage0": {"w": jnp.asarray(gw)}}
    tp = {"b": torch.tensor(b), "e": torch.tensor(e).to(torch.bfloat16),
          "stage0": [{"w": torch.tensor(w[r])} for r in range(2)]}
    tg = {"b": torch.tensor(gb), "e": torch.tensor(ge).to(torch.bfloat16),
          "stage0": [{"w": torch.tensor(gw[r])} for r in range(2)]}
    return jp, jg, tp, tg


def _assert_flat_close(got: dict, want: dict, rtol: float, skip=()):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, a in want.items():
        if k in skip:
            continue
        p = np.asarray(got[k], np.float64)
        a = np.asarray(a, np.float64)
        assert p.shape == a.shape, (k, p.shape, a.shape)
        scale = max(np.abs(a).max(), 1e-30)
        err = np.abs(p - a).max()
        assert err <= rtol * scale, (k, err, scale)


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_equals_jax(clip):
    """Two updates of a seeded fp32 + bf16 tree (a warm-up schedule, weight
    decay, the clip on and off): params, moments, grad_norm and lr within
    1e-6 of JAX's."""
    jp, jg, tp, tg = _seeded_tree(np.random.default_rng(3))
    jopt = JAdamW(lr=jwarmup_cosine(1e-2, 1, 4), grad_clip=clip)
    opt = AdamW(lr=warmup_cosine(1e-2, 1, 4), grad_clip=clip)
    jstate, state = jopt.init(jp), opt.init(tp)
    before = flatten(tp)
    for _ in range(2):
        jp, jstate, jm = jopt.update(jg, jstate, jp)
        tp2, state, m = opt.update(tg, state, tp)
        # out of place: the inputs are untouched
        for k, v in flatten(tp).items():
            assert np.array_equal(v, before[k]), k
        tp = tp2
        before = flatten(tp)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert tp["e"].dtype == torch.bfloat16
        _assert_flat_close(flatten((tp, state)), jflatten(
            jax.tree.map(np.asarray, (jp, jstate))), 1e-6)


def test_adamw_none_grad_counts_as_zero():
    """A param the loss never reached (grad None) updates as a zero
    gradient does in JAX: its moments decay, weight decay applies."""
    jp, jg, tp, tg = _seeded_tree(np.random.default_rng(4))
    jg["b"] = jnp.zeros_like(jg["b"])
    tg["b"] = None
    jopt, opt = JAdamW(lr=1e-2), AdamW(lr=1e-2)
    jnew, jstate, _ = jopt.update(jg, jopt.init(jp), jp)
    new, state, _ = opt.update(tg, opt.init(tp), tp)
    _assert_flat_close(flatten((new, state)), jflatten(
        jax.tree.map(np.asarray, (jnew, jstate))), 1e-6)


# ---------------------------------------------------------- compression
def test_quantize_bitwise_equal_to_jax():
    cases = [RNG.normal(size=(1000,)).astype(np.float32),
             (RNG.normal(size=(7, 33)) * 1e-4).astype(np.float32),
             # amax 127 -> scale 1: exact .5 ties round half to even
             np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5,
                       -127.0], np.float32),
             np.zeros((5, 3), np.float32)]
    for x in cases:
        q, s = compression.quantize(torch.tensor(x))
        jq, js = jcompression.quantize(jnp.asarray(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert np.float32(float(s)) == np.float32(js)
        np.testing.assert_array_equal(
            compression.dequantize(q, s).numpy(),
            np.asarray(jcompression.dequantize(jq, js)))
    q, _ = compression.quantize(torch.tensor(cases[2]))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -127]


def test_compress_grads_ten_steps_equal_jax():
    """compress_grads over ten steps on a tree with a stage's per-layer
    list: the stacked leaf's units share one scale, as in JAX."""
    rng = np.random.default_rng(5)
    shapes = {"w": (64,), "stage0": (3, 8, 16)}
    jef = jcompression.init_error_feedback(
        {"w": jnp.zeros(shapes["w"]), "stage0": {"u": jnp.zeros(
            shapes["stage0"])}})
    ef = compression.init_error_feedback(
        {"w": torch.zeros(shapes["w"]),
         "stage0": [{"u": torch.zeros(shapes["stage0"][1:])}
                    for _ in range(3)]})
    for _ in range(10):
        w = (rng.normal(size=shapes["w"]) * 1e-3).astype(np.float32)
        u = rng.normal(size=shapes["stage0"]).astype(np.float32)
        u[1] *= 10.0                     # one layer sets the shared scale
        jdeq, jef = jcompression.compress_grads(
            {"w": jnp.asarray(w), "stage0": {"u": jnp.asarray(u)}}, jef)
        deq, ef = compression.compress_grads(
            {"w": torch.tensor(w),
             "stage0": [{"u": torch.tensor(u[r])} for r in range(3)]}, ef)
        _assert_flat_close(flatten((deq, ef)), jflatten(
            jax.tree.map(np.asarray, (jdeq, jef))), 1e-7)


def test_compression_error_feedback_preserves_sum():
    """JAX's `test_compression_error_feedback_preserves_sum` on the
    port."""
    g = {"w": torch.tensor(RNG.normal(size=(64,)) * 1e-3,
                           dtype=torch.float32)}
    ef = compression.init_error_feedback(g)
    total_true = np.zeros(64, np.float32)
    total_sent = np.zeros(64, np.float32)
    for _ in range(10):
        gi = {"w": torch.tensor(RNG.normal(size=(64,)) * 1e-3,
                                dtype=torch.float32)}
        total_true += gi["w"].numpy()
        deq, ef = compression.compress_grads(gi, ef)
        total_sent += deq["w"].numpy()
    drift = np.abs(total_sent + ef.residual["w"].numpy() - total_true)
    assert drift.max() < 1e-6


def test_quantize_int8_roundtrip_error():
    """JAX's `test_quantize_int8_roundtrip_error` on the port."""
    x = torch.tensor(RNG.normal(size=(1000,)), dtype=torch.float32)
    q, s = compression.quantize(x)
    err = (compression.dequantize(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-9


# ------------------------------------------------------------------ loss
def _xent_inputs(b, s, d, v, with_mask):
    h = RNG.normal(size=(b, s, d)).astype(np.float32)
    w = RNG.normal(size=(d, v)).astype(np.float32)
    t = RNG.integers(0, v, (b, s)).astype(np.int32)
    m = (RNG.random((b, s)) < 0.7).astype(np.float32) if with_mask else None
    return h, w, t, m


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("chunk", [7, 16, 48, 512])
def test_chunked_xent_equals_jax(chunk, with_mask):
    h, w, t, m = _xent_inputs(2, 48, 16, 100, with_mask)

    def jloss(h, w):
        return jxent(h, jnp.asarray(t), lambda x: x @ w,
                     mask=None if m is None else jnp.asarray(m), chunk=chunk)

    jval, (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    val = chunked_softmax_xent(th, torch.tensor(t), lambda x: x @ tw,
                               mask=None if m is None else torch.tensor(m),
                               chunk=chunk)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), **TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-4,
                               atol=1e-6)


def test_chunked_xent_recompute_on_another_thread():
    """The backward (and so each chunk's recompute) runs on a second
    thread, as the autograd engine's device thread runs it for a CUDA
    tensor.  The thread's own matmul config is the default ("cuda", whose
    kernels refuse a backward): the recompute must re-enter the forward's
    "torch" config, and record no plan a second time."""
    h, w, t, _ = _xent_inputs(2, 40, 16, 64, False)

    def run(on_thread: bool):
        th = torch.tensor(h, requires_grad=True)
        tw = torch.tensor(w, requires_grad=True)
        errors = []
        with mm_config(backend="torch"), skewmm.plan_capture() as log:
            loss = chunked_softmax_xent(
                th, torch.tensor(t), lambda x: skewmm.matmul(x, tw),
                chunk=16)

            def backward():
                try:
                    loss.backward()
                except Exception as e:       # reported below
                    errors.append(e)

            if on_thread:
                worker = threading.Thread(target=backward)
                worker.start()
                worker.join(timeout=120)
                assert not worker.is_alive()
            else:
                backward()
        assert not errors, errors
        return float(loss), th.grad.numpy(), tw.grad.numpy(), len(log)

    same, other = run(False), run(True)
    assert other[3] == same[3] == 1          # the first chunk's plan only
    assert other[0] == same[0]
    np.testing.assert_array_equal(other[1], same[1])
    np.testing.assert_array_equal(other[2], same[2])


# ------------------------------------------------------------------ prng
def test_fold_in_bitwise_equal_to_jax():
    rng = np.random.default_rng(11)
    seeds = rng.integers(0, 2**31, 1000)
    data = rng.integers(0, 2**32, 1000, dtype=np.uint64)
    for seed, d in zip(seeds, data):
        key = jax.random.PRNGKey(int(seed))
        np.testing.assert_array_equal(prng.prng_key(int(seed)),
                                      np.asarray(key))
        np.testing.assert_array_equal(
            prng.fold_in(prng.prng_key(int(seed)), int(d)),
            np.asarray(jax.random.fold_in(key, np.uint32(d))))
    k = prng.fold_in(prng.prng_key(3), 7)
    assert k.dtype == np.uint32 and k.shape == (2,)


# ----------------------------------------------------------- train step
FAMILIES = ["phi4-mini-3.8b", "dbrx-132b", "deepseek-v3-671b",
            "recurrentgemma-9b", "mamba2-2.7b", "internvl2-1b",
            "seamless-m4t-large-v2"]


def _batch(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.family == "vlm":
        out["prefix_embeds"] = (rng.normal(
            size=(B, cfg.frontend_len, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = (rng.normal(
            size=(B, cfg.frontend_len, cfg.d_model)) * 0.1).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _jax_step(arch: str, n: int, compress: bool):
    """JAX's init_train_state and one jitted step (under plan capture):
    (state before as numpy, flat state after, metrics, plan log)."""
    jcfg = jget_config(arch).reduced()
    jbundle = jbuild_model(jcfg)
    ts_cfg = JTrainStepConfig(n_microbatches=n, loss_chunk=CHUNK,
                              compress_grads=compress)
    jopt = JAdamW()
    state = jinit_train_state(jbundle, jopt, jax.random.PRNGKey(3), ts_cfg)
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    with jmm_config(backend="xla"), jskewmm.plan_capture() as log:
        new, metrics = jax.jit(jmake_train_step(jbundle, jopt, ts_cfg))(
            state, batch)
    return (jax.tree.map(np.asarray, state),
            jflatten(jax.tree.map(np.asarray, new)),
            {k: float(v) for k, v in metrics.items()}, list(log))


def _port_step(arch: str, n: int, compress: bool, jstate, **mm):
    cfg = get_config(arch).reduced()
    bundle = build_model(cfg, "cpu")
    state = state_from_numpy(jstate, "cpu")
    step = make_train_step(bundle, AdamW(), TrainStepConfig(
        n_microbatches=n, loss_chunk=CHUNK, compress_grads=compress))
    batch = {k: torch.tensor(v) for k, v in _batch(cfg).items()}
    with mm_config(backend="torch", **mm), \
            skewmm.plan_capture() as log:
        new, metrics = step(state, batch)
    return state, new, metrics, log


def ill_conditioned(flat, jflat, suffix: str) -> np.ndarray:
    """Elements whose Adam denominator sqrt(v_hat) is under 100 eps in
    either state.  There the update's sensitivity to its gradient climbs
    to 1 / eps = 1e8, so fp32 reorderings of a near-zero gradient move
    the param by up to a whole lr; elsewhere it is at most 1e4 and the
    params agree as the moments do."""
    opt = AdamW()
    step = int(jflat[".opt//.step"])
    nu = np.minimum(flat[".opt//.nu//" + suffix].astype(np.float64),
                    jflat[".opt//.nu//" + suffix].astype(np.float64))
    return np.sqrt(nu / (1 - opt.b2 ** step)) < 100 * opt.eps


def _assert_step_equal(new, metrics, jflat, jmetrics, quanta=None):
    """loss, grad_norm and lr at 1e-5, step and rng equal; moments at 1e-4
    of the leaf's largest magnitude, params too but at ill-conditioned
    elements, which must move by at most a bounded Adam step (|u| <= 1
    either side: 2 lr (1 + weight decay)); with compression, the residual
    and its ties as `tie_elements` says."""
    flat = flatten(new)
    assert set(flat) == set(jflat), set(flat) ^ set(jflat)
    np.testing.assert_array_equal(flat[".opt//.step"], jflat[".opt//.step"])
    np.testing.assert_array_equal(flat[".rng"], jflat[".rng"])
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[k]), jmetrics[k], **TOL)
    ties = tie_elements(flat, jflat, quanta) if quanta else {}
    opt = AdamW()
    for k, want in jflat.items():
        if k in (".opt//.step", ".rng") or k.startswith(".ef//"):
            continue
        suffix = k.split("//", 2)[-1] if k.startswith(".opt") else \
            k.split("//", 1)[-1]
        got, want = flat[k].astype(np.float64), want.astype(np.float64)
        skip = ties.get(suffix, np.zeros(want.shape, bool))
        tol = 1e-4 * max(np.abs(want).max(), 1e-30)
        err = np.abs(got - want)
        if k.startswith(".params"):
            ill = ill_conditioned(flat, jflat, suffix) & ~skip
            bound = 2 * opt.lr * (1 + opt.weight_decay) + tol
            assert np.all(err[ill] <= bound), (k, err[ill].max(), bound)
            skip = skip | ill
        assert np.all(err[~skip] <= tol), (k, err[~skip].max(), tol)


def tie_elements(flat, jflat, quanta) -> dict:
    """The residual held at 1e-4 of its quantizer's input range (127
    quanta); every element beyond that must differ by exactly one quantum
    (a code rounded the other way), and such ties must be fewer than 1e-4
    of all elements.  Returns {leaf suffix: tie mask}."""
    ties, n_ties, n_all = {}, 0, 0
    for suffix, q in quanta.items():
        key = ".ef//.residual//" + suffix
        diff = np.abs(flat[key].astype(np.float64) -
                      jflat[key].astype(np.float64))
        tol = 1e-4 * 127 * q
        tie = diff > tol
        assert np.all(np.abs(diff[tie] - q) <= tol), (key, diff.max(), q)
        ties[suffix] = tie
        n_ties += int(tie.sum())
        n_all += diff.size
    assert n_ties <= 1e-4 * n_all, (n_ties, n_all)
    return ties


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_train_step_equals_jax(arch):
    jstate, jflat, jmetrics, _ = _jax_step(arch, 1, False)
    before = flatten(state_from_numpy(jstate, "cpu"))
    state, new, metrics, _ = _port_step(arch, 1, False, jstate)
    _assert_step_equal(new, metrics, jflat, jmetrics)
    for k, v in flatten(state).items():           # the step is pure
        np.testing.assert_array_equal(v, before[k])


def test_three_steps_equal_jax():
    """Three steps on one repeated batch: the state carried from step to
    step (moments past their first bias correction, the key folded with
    each step) stays JAX's."""
    jstate, _, _, _ = _jax_step("phi4-mini-3.8b", 1, False)
    cfg, jcfg = get_config("phi4-mini-3.8b").reduced(), jget_config(
        "phi4-mini-3.8b").reduced()
    ts, jts = TrainStepConfig(loss_chunk=CHUNK), JTrainStepConfig(
        loss_chunk=CHUNK)
    jstep = jax.jit(jmake_train_step(jbuild_model(jcfg), JAdamW(), jts))
    step = make_train_step(build_model(cfg, "cpu"), AdamW(), ts)
    tokens = _batch(cfg)["tokens"]
    state, js = state_from_numpy(jstate, "cpu"), jstate
    for _ in range(3):
        with jmm_config(backend="xla"):
            js, jm = jstep(js, {"tokens": jnp.asarray(tokens)})
        with mm_config(backend="torch"):
            state, m = step(state, {"tokens": torch.tensor(tokens)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **TOL)
    _assert_step_equal(state, m, jflatten(jax.tree.map(np.asarray, js)),
                       {k: float(v) for k, v in jm.items()})


def test_train_step_microbatches_equal_jax():
    jstate, jflat, jmetrics, _ = _jax_step("phi4-mini-3.8b", 2, False)
    _, new, metrics, _ = _port_step("phi4-mini-3.8b", 2, False, jstate)
    _assert_step_equal(new, metrics, jflat, jmetrics)


def test_train_step_compressed_equals_jax(monkeypatch):
    jstate, jflat, jmetrics, _ = _jax_step("phi4-mini-3.8b", 1, True)
    scales = []
    scale_of = compression._scale
    monkeypatch.setattr(compression, "_scale",
                        lambda gs: scales.append(scale_of(gs)) or scales[-1])
    _, new, metrics, _ = _port_step("phi4-mini-3.8b", 1, True, jstate)
    keys = list(flatten(new.ef.residual))
    assert len(scales) == len(keys)
    _assert_step_equal(new, metrics, jflat, jmetrics, quanta=dict(
        zip(keys, (float(s) for s in scales))))


def test_train_step_plan_log_equals_jax():
    """JAX's jitted step logs each stage site once and the LM head's scan
    body once (8 entries at phi4 reduced, batch 2 x 32, chunk 16); the
    port records the same: its second chunk and the backward's recompute
    record nothing."""
    jstate, _, _, jlog = _jax_step("phi4-mini-3.8b", 1, False)
    _, _, _, log = _port_step("phi4-mini-3.8b", 1, False, jstate,
                              chip="tpu_v5e")
    assert len(jlog) == len(log) == 8
    assert [buckets._spec_of(c) for c in log] == [
        jbuckets._spec_of(c) for c in jlog]
    assert sum(c.total_s for c in log) == sum(c.total_s for c in jlog)


def test_init_train_state_matches_jax_layout():
    """The port's own init: JAX's leaves, shapes and dtypes, the step 0 and
    the key PRNGKey(seed)."""
    cfg = get_config("deepseek-v3-671b").reduced()
    ts_cfg = TrainStepConfig(compress_grads=True)
    state = init_train_state(build_model(cfg, "cpu"), AdamW(), 5, ts_cfg)
    jcfg = jget_config("deepseek-v3-671b").reduced()
    jstate = jax.eval_shape(lambda: jinit_train_state(
        jbuild_model(jcfg), JAdamW(), jax.random.PRNGKey(5),
        JTrainStepConfig(compress_grads=True)))
    flat = flatten(state)
    jkeys = jflatten(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                  jstate))
    assert set(flat) == set(jkeys)
    for k, v in jkeys.items():
        assert flat[k].shape == v.shape and flat[k].dtype == v.dtype, k
    np.testing.assert_array_equal(state.rng,
                                  np.asarray(jax.random.PRNGKey(5)))


# ---------------------------------------------------------------- repair
def _grad_inputs():
    def t(*shape):
        return torch.randn(*shape, requires_grad=True)

    lay = BlockSparseLayout.random(64, 256, (32, 128), 0.5)
    return {
        "skew_matmul": lambda: ops.skew_matmul(t(8, 64), t(64, 32)),
        "skew_matmul_batched": lambda: ops.skew_matmul_batched(
            t(2, 8, 64), t(64, 32)),
        "sparse_matmul": lambda: ops.sparse_matmul(t(64, 256), t(256, 32),
                                                   lay),
        "grouped_matmul": lambda: ops.grouped_matmul(
            t(2, 8, 64), t(2, 64, 32), backend="cuda"),
        "flash_attention": lambda: ops.flash_attention(
            t(1, 2, 16, 32), t(1, 2, 16, 32), t(1, 2, 16, 32)),
        "rglru_scan": lambda: ops.rglru_scan(t(1, 8, 16), t(1, 8, 16),
                                             t(1, 8, 16), t(16)),
        "ssd_scan": lambda: ops.ssd_scan(
            t(1, 8, 2, 4), torch.rand(1, 8, 2, requires_grad=True), t(2),
            t(1, 8, 1, 4), t(1, 8, 1, 4)),
    }


@pytest.mark.parametrize("route", list(_grad_inputs()))
def test_kernel_routes_refuse_a_backward(route):
    """Each of the seven kernel routes raises under the "cuda" backend on
    a grad-requiring input, on the CPU too, before the guard ladder: no
    rung moves and the health ledger stays empty.  Under no_grad the same
    call runs (the plain version here)."""
    call = _grad_inputs()[route]
    with mm_config(backend="cuda"):
        with pytest.raises(RuntimeError, match="K1-K9 are forward-only"):
            call()
        assert health.snapshot() == {} and fallback.max_floor() == 0
        with torch.no_grad():
            call()
    assert health.snapshot() == {} and fallback.max_floor() == 0


def test_grouped_matmul_torch_backend_trains():
    """The "torch" branch of grouped_matmul is the differentiable
    reference: it takes a grad-requiring input."""
    a = torch.randn(2, 8, 64, requires_grad=True)
    b = torch.randn(2, 64, 32, requires_grad=True)
    ops.grouped_matmul(a, b, backend="torch").sum().backward()
    assert a.grad is not None and b.grad is not None


def test_train_step_under_cuda_backend_raises():
    cfg = get_config("phi4-mini-3.8b").reduced()
    bundle = build_model(cfg, "cpu")
    state = init_train_state(bundle, AdamW(), 0)
    step = make_train_step(bundle, AdamW(), TrainStepConfig(loss_chunk=16))
    batch = {"tokens": torch.tensor(_batch(cfg)["tokens"])}
    with mm_config(backend="cuda"), pytest.raises(
            RuntimeError, match="skew_matmul.*forward-only"):
        step(state, batch)
    assert health.snapshot() == {} and fallback.max_floor() == 0
    with mm_config(backend="torch"):
        _, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))


def test_train_step_config_equals_jax():
    """TrainStepConfig has JAX's fields and defaults."""
    assert dataclasses.asdict(TrainStepConfig()) == dataclasses.asdict(
        JTrainStepConfig())
