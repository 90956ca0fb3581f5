"""Activation recompute in the port against the JAX package, on the CPU.

The JAX package checkpoints each repeating unit of a stage
(`models/transformer.py` `jax.checkpoint(unit_fwd)`), each encoder and
decoder block (`models/encdec.py`) and each kv step of
`blockwise_attention` (`models/layers.py`); the port does the same with
`models.remat.checkpointed` where a gradient is taken.  At `reduced()`
(fp32), batch 2 x 32, loss chunk 16, for one arch of the dense, MoE,
hybrid, SSM and encoder-decoder families:

  * loss and gradients against JAX's jitted `value_and_grad` of the same
    loss: the loss at 1e-5, each gradient leaf at 1e-4 of its largest
    magnitude (fp32 sums in other orders, as `test_torch_train.py`);
  * the gradients bitwise equal to the same loss without a checkpoint
    (the decoder's blocks walked by a plain loop over `layer_iter` and
    `block_fwd` that lives here, the encoder-decoder's layers run
    unwrapped): the recompute runs the same ops on the same values;
  * the bytes the backward keeps, parameters aside, grow by exactly one
    unit's input (its hidden state and the aux carry) a unit added, where
    the plain loop keeps every block's activations;
  * `blockwise_attention` keeps its (m, l, acc) carry a kv step and no
    chunk's scores, so its bytes grow by one carry a chunk added however
    wide the chunks;
  * the plan log and the MoE slot records of the step equal to JAX's (the
    recompute records nothing);
  * a forward without grad runs no checkpoint and gives the outputs and
    plan log of one with grad.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import skewmm as jskewmm
from repro.core.config import mm_config as jmm_config
from repro.guard import health as jhealth
from repro.models.model import build_model as jbuild_model
from repro.serve.sched import buckets as jbuckets
from repro.train.train_step import TrainStepConfig as JTrainStepConfig
from repro.train.train_step import make_loss_fn as jmake_loss_fn
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.core import skewmm, stage_trace
from repro_torch.core.config import mm_config
from repro_torch.guard import health
from repro_torch.models import blocks, layers, remat, transformer
from repro_torch.models.model import build_model
from repro_torch.serve.sched import buckets
from repro_torch.train.train_step import (TrainStepConfig, make_loss_fn,
                                          value_and_grad)

ARCHS = ["phi4-mini-3.8b", "dbrx-132b", "recurrentgemma-9b", "mamba2-2.7b",
         "seamless-m4t-large-v2"]
B, S, CHUNK = 2, 32, 16
SLOTS = ("moe_slots_total", "moe_slots_filled", "moe_slots_underfilled")


@pytest.fixture(autouse=True)
def _clean_ledger():
    health.reset()
    jhealth.reset()
    yield
    health.reset()
    jhealth.reset()


def _batch(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.family == "encdec":
        out["frames"] = (rng.normal(
            size=(B, cfg.frontend_len, cfg.d_model)) * 0.1).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _jax(arch: str):
    """JAX's params (numpy), and its jitted value_and_grad of the loss
    under plan capture: (params, loss, grads, plan log, MoE slots)."""
    jcfg = jget_config(arch).reduced()
    bundle = jbuild_model(jcfg)
    params = bundle.init(jax.random.PRNGKey(3))
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    loss_fn = jmake_loss_fn(bundle, JTrainStepConfig(loss_chunk=CHUNK))
    jhealth.reset()
    with jmm_config(backend="xla"), jskewmm.plan_capture() as log:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, batch)
    slots = {k: jhealth.snapshot().get(k, 0) for k in SLOTS}
    return (jax.tree.map(np.asarray, params), float(loss),
            jax.tree.map(np.asarray, grads), list(log), slots)


def _port(arch: str, **mm):
    """The port's loss, gradients (JAX's stacked layout, numpy), plan log
    and MoE slots, from JAX's params."""
    cfg = get_config(arch).reduced()
    bundle = build_model(cfg, "cpu")
    params = convert.params_from_numpy(_jax(arch)[0], "cpu")
    batch = {k: torch.tensor(v) for k, v in _batch(cfg).items()}
    grad_fn = value_and_grad(make_loss_fn(bundle, TrainStepConfig(
        loss_chunk=CHUNK)))
    health.reset()
    with mm_config(backend="torch", **mm), skewmm.plan_capture() as log:
        loss, grads = grad_fn(params, batch)
    grads = _stacked(grads, params)
    slots = {k: health.snapshot().get(k, 0) for k in SLOTS}
    return float(loss), grads, log, slots


def _stacked(tree, like):
    """A gradient tree shaped as the port's params `like` in JAX's
    stacked layout with numpy leaves; a None gradient (the loss does not
    reach the param) as zeros, as JAX gives it."""
    if isinstance(like, dict):
        return {k: _stacked(tree[k], like[k]) for k in like}
    if isinstance(like, list):          # per-layer units: stack leaves
        return jax.tree.map(lambda *xs: np.stack(xs), *[
            _stacked(t, u) for t, u in zip(tree, like)])
    return (np.zeros(tuple(like.shape), np.float32) if tree is None
            else convert.to_numpy(tree))


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_jax(arch):
    _, jloss, jgrads, _, _ = _jax(arch)
    loss, grads, _, _ = _port(arch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-5)
    got, want = _leaves(grads), _leaves(jgrads)
    assert set(got) == set(want)
    for k, w in want.items():
        tol = 1e-4 * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[k].astype(np.float64) - w).max())
        assert err <= tol, (k, err, tol)


def _plain_forward_hidden(params, cfg, tokens, *, prefix_embeds=None):
    """`transformer.forward_hidden` without the unit checkpoint: a plain
    loop over the layers."""
    x, positions = transformer.embed_inputs(params, cfg, tokens,
                                            prefix_embeds)
    aux_total = torch.zeros((), dtype=torch.float32)
    for kind, p, _, r, _ in transformer.layer_iter(params, cfg):
        with stage_trace.repeat(r):
            x, aux = blocks.block_fwd(x, p, cfg, kind, positions)
        aux_total = aux_total + aux
    return layers.rmsnorm(x, params["final_norm"], cfg.norm_eps), aux_total


def _no_checkpoint(fn, *args, **kw):
    """`remat.checkpointed`'s stand-in without a checkpoint."""
    return fn(*args)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_bitwise_equal_plain_loop(arch, monkeypatch):
    loss, grads, _, _ = _port(arch)
    calls = []
    checkpointed = remat.checkpointed

    def counted(fn, *args, **kw):
        if kw.get("trips") != 1:      # a walk of one step checkpoints none
            calls.append(fn)
        return checkpointed(fn, *args, **kw)

    monkeypatch.setattr(remat, "checkpointed", counted)
    _port(arch)
    # a unit a repeat (a layer a side for the encoder-decoder) and a
    # chunk of the loss: the kv steps walk one chunk pair at S 32
    cfg = get_config(arch).reduced()
    units = (cfg.enc_layers + cfg.n_layers if cfg.family == "encdec" else
             sum(n for _, n in cfg.stage_list()))
    assert len(calls) == units + (S - 1 + CHUNK - 1) // CHUNK
    if cfg.family == "encdec":
        monkeypatch.setattr(remat, "checkpointed", _no_checkpoint)
    else:
        monkeypatch.setattr(transformer, "forward_hidden",
                            _plain_forward_hidden)
    ploss, pgrads, _, _ = _port(arch)
    assert loss == ploss
    got, want = _leaves(grads), _leaves(pgrads)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _saved_bytes(arch: str, extra_units: int) -> tuple[int, int]:
    """(bytes the backward keeps, parameters aside, the bytes of one
    unit's input) for the loss of `arch` at `reduced()` with
    `extra_units` more repeating units (the encoder-decoder: one encoder
    and one decoder layer more each), its own seeded weights."""
    cfg = get_config(arch).reduced()
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, n_layers=cfg.n_layers + extra_units,
                                  enc_layers=cfg.enc_layers + extra_units)
        unit = B * (S + cfg.frontend_len) * cfg.d_model * 4
    else:
        width = len(cfg.stage_list()[0][0])
        cfg = dataclasses.replace(cfg,
                                  n_layers=cfg.n_layers + extra_units * width)
        unit = B * S * cfg.d_model * 4 + 4         # x and the aux carry
    bundle = build_model(cfg, "cpu")
    params = bundle.init(0)
    live = [p.detach().requires_grad_(True)
            for p in jax.tree_util.tree_leaves(params)]
    param_storages = {p.untyped_storage().data_ptr() for p in live}
    kept: dict[int, int] = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in param_storages:
            kept[st.data_ptr()] = st.nbytes()
        return t

    batch = {k: torch.tensor(v) for k, v in _batch(cfg).items()}
    loss_fn = make_loss_fn(bundle, TrainStepConfig(loss_chunk=CHUNK))
    with mm_config(backend="torch"), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = loss_fn(jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(params), live), batch)
    total = sum(kept.values())
    del loss
    return total, unit


@pytest.mark.parametrize("arch", ARCHS)
def test_saved_bytes_a_unit_are_its_input(arch, monkeypatch):
    base, unit = _saved_bytes(arch, 0)
    more, _ = _saved_bytes(arch, 2)
    assert more - base == 2 * unit, (more - base, unit)
    # without the checkpoint a unit keeps its blocks' activations
    monkeypatch.setattr(remat, "checkpointed", _no_checkpoint)
    pbase, _ = _saved_bytes(arch, 0)
    pmore, _ = _saved_bytes(arch, 2)
    assert pmore - pbase > 4 * unit


def _attention_kept(nk: int, kv_chunk: int, checkpoint=True):
    """(bytes `blockwise_attention` keeps for its backward beyond q, k and
    v, the largest tensor kept in elements) at one q chunk of 16 rows and
    `nk` kv chunks of `kv_chunk`."""
    gen = torch.Generator().manual_seed(5)
    b, h, d = 2, 4, 8
    q = torch.randn((b, h, 16, d), generator=gen, requires_grad=True)
    k = torch.randn((b, h // 2, nk * kv_chunk, d), generator=gen,
                    requires_grad=True)
    v = torch.randn((b, h // 2, nk * kv_chunk, d), generator=gen,
                    requires_grad=True)
    inputs = {t.untyped_storage().data_ptr() for t in (q, k, v)}
    kept: dict[int, int] = {}
    largest = [0]

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in inputs:
            kept[st.data_ptr()] = st.nbytes()
            largest[0] = max(largest[0], t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = layers.blockwise_attention(
            q, k, v, causal=False, q_chunk=16, kv_chunk=kv_chunk)
    out.sum().backward()
    return sum(kept.values()), largest[0]


@pytest.mark.parametrize("kv_chunk", [16, 32])
def test_blockwise_attention_keeps_a_carry_a_chunk(kv_chunk):
    # acc, m and l (fp32) and the chunk's kv positions (int32)
    carry = 2 * 4 * 16 * (8 + 1 + 1) * 4 + kv_chunk * 4
    two, big2 = _attention_kept(2, kv_chunk)
    four, big4 = _attention_kept(4, kv_chunk)
    assert four - two == 2 * carry, (four - two, carry)
    scores = 2 * 4 * 16 * kv_chunk
    assert max(big2, big4) < scores


def test_blockwise_attention_checkpoint_gives_plain_values(monkeypatch):
    """The kv steps' recompute: output and gradients bitwise equal to the
    same walk without it."""
    def run():
        gen = torch.Generator().manual_seed(9)
        q, k, v = (torch.randn((2, 4, 40, 8), generator=gen,
                               requires_grad=True) for _ in range(3))
        out = layers.blockwise_attention(q, k, v, window=24, softcap=30.0,
                                         q_chunk=16, kv_chunk=8)
        out.square().sum().backward()
        return [t.detach() for t in (out, q.grad, k.grad, v.grad)]

    want = run()
    monkeypatch.setattr(remat, "checkpointed", _no_checkpoint)
    for got, w in zip(run(), want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_plan_log_and_slots_equal_jax(arch):
    _, _, _, jlog, jslots = _jax(arch)
    _, _, log, slots = _port(arch, chip="tpu_v5e")
    assert [buckets._spec_of(c) for c in log] == [
        jbuckets._spec_of(c) for c in jlog]
    assert slots == jslots


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "seamless-m4t-large-v2"])
def test_no_grad_forward_runs_no_checkpoint(arch, monkeypatch):
    cfg = get_config(arch).reduced()
    bundle = build_model(cfg, "cpu")
    params = bundle.init(1)
    batch = {k: torch.tensor(v) for k, v in _batch(cfg).items()}

    def forward():
        with mm_config(backend="torch"), skewmm.plan_capture() as log:
            h, aux = bundle.hidden_fn(params, batch)
            logits = bundle.logits_fn(params, h)
        return logits.detach(), aux.detach(), [
            buckets._spec_of(c) for c in log]

    with torch.enable_grad():
        want = forward()

    def refused(*args, **kwargs):
        raise AssertionError("a checkpoint without grad")

    monkeypatch.setattr(remat, "checkpoint", refused)
    with torch.no_grad():
        got = forward()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    assert got[2] == want[2]
