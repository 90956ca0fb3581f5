"""The port's serving path against the JAX package's, on the same weights.

JAX parameters are made by the reference's initializer and carried over
with `repro_torch.convert`; prompts are numpy-seeded.  The port runs on
the CPU, so its "cuda" backend takes the kernels' plain versions.

Tolerances (fp32): rtol = atol = 1e-4 — both packages sum contractions of
at most a few thousand terms in fp32 in different orders (observed
differences are ~1e-6 of logits of magnitude ~1).  bf16: every op rounds
its output to bf16 in both packages, but at different places inside fused
expressions, so logits are compared with atol 0.1 and the mean absolute
difference with 1e-2 (logits here have magnitude ~1; one bf16 ulp is
2**-8 relative, compounding over two layers and ~20 rounded ops).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.config import mm_config as jmm_config
from repro.models.model import build_model as jbuild_model
from repro.serve import engine as jengine
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.config import mm_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models.model import build_model
from repro_torch.serve import engine

RTOL = ATOL = 1e-4


def _configs(variant: str, dtype: str | None = None,
             arch: str = "phi4-mini-3.8b"):
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    if variant == "decode_scale":
        jcfg, cfg = jcfg.decode_scale(), cfg.decode_scale()
    if dtype:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=dtype)
    assert jcfg.__dict__ == cfg.__dict__
    return jcfg, cfg


def _weights(jcfg):
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(3))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("variant", ["reduced", "decode_scale"])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_prefill_and_greedy_decode_match_jax(variant, backend):
    jcfg, cfg = _configs(variant)
    jp, tp = _weights(jcfg)
    rng = np.random.default_rng(5)
    B, S, MAX = 2, 16, 24
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    with jmm_config(backend="xla"):
        jcache, jlogits = jengine.prefill(jp, jcfg,
                                          jnp.asarray(toks, jnp.int32),
                                          max_len=MAX)
    with mm_config(backend=backend):
        cache, logits = engine.prefill(tp, cfg, torch.tensor(toks),
                                       max_len=MAX)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=RTOL,
                               atol=ATOL)
    tok = np.argmax(_np(jlogits), -1)
    for i in range(4):
        pos = S + i
        with jmm_config(backend="xla"):
            jlogits, jcache = jengine.decode_step(
                jp, jcfg, jcache, jnp.asarray(tok, jnp.int32),
                jnp.asarray(pos, jnp.int32))
        with mm_config(backend=backend):
            logits, cache = engine.decode_step(tp, cfg, cache,
                                               torch.tensor(tok), pos)
        np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=RTOL,
                                   atol=ATOL)
        tok = np.argmax(_np(jlogits), -1)
    np.testing.assert_allclose(cache["stage0"]["b0"]["k"].numpy(),
                               _np(jcache["stage0"]["b0"]["k"]), rtol=RTOL,
                               atol=ATOL)


def test_per_row_positions_match_jax():
    """(B,) decode positions — each row at its own depth."""
    jcfg, cfg = _configs("reduced")
    jp, tp = _weights(jcfg)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 10))
    with jmm_config(backend="xla"):
        jcache, _ = jengine.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                    max_len=16)
    cache, _ = engine.prefill(tp, cfg, torch.tensor(toks), max_len=16)
    pos = np.array([10, 7])
    tok = np.array([3, 4])
    with jmm_config(backend="xla"):
        jlogits, _ = jengine.decode_step(jp, jcfg, jcache,
                                         jnp.asarray(tok, jnp.int32),
                                         jnp.asarray(pos, jnp.int32))
    logits, _ = engine.decode_step(tp, cfg, cache, torch.tensor(tok),
                                   torch.tensor(pos))
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=RTOL,
                               atol=ATOL)


def test_last_index_matches_jax():
    """Right-padded prompts: per-row logit positions."""
    jcfg, cfg = _configs("reduced")
    jp, tp = _weights(jcfg)
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 9))
    last = np.array([8, 3])
    with jmm_config(backend="xla"):
        _, jlogits = jengine.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                     max_len=12,
                                     last_index=jnp.asarray(last, jnp.int32))
    _, logits = engine.prefill(tp, cfg, torch.tensor(toks), max_len=12,
                               last_index=torch.tensor(last))
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=RTOL,
                               atol=ATOL)


def test_prefill_matches_jax_pallas_interpret():
    jcfg, cfg = _configs("reduced")
    jp, tp = _weights(jcfg)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 8))
    with jmm_config(backend="pallas", interpret=True):
        _, jlogits = jengine.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                     max_len=8)
    _, logits = engine.prefill(tp, cfg, torch.tensor(toks), max_len=8)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=RTOL,
                               atol=ATOL)


def test_forward_hidden_and_unembed_match_jax():
    """The training-style forward (residual fused into the down
    projection) against the JAX bundle."""
    jcfg, cfg = _configs("reduced")
    jp, tp = _weights(jcfg)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 12))
    jb, tb = jbuild_model(jcfg), build_model(cfg, "cpu")
    with jmm_config(backend="xla"):
        jh, _ = jb.hidden_fn(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
        jl = jb.logits_fn(jp, jh)
    h, _ = tb.hidden_fn(tp, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(tb.logits_fn(tp, h).numpy(), _np(jl),
                               rtol=RTOL, atol=ATOL)


def test_bf16_prefill_close_to_jax():
    jcfg, cfg = _configs("reduced", dtype="bfloat16")
    jp, tp = _weights(jcfg)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 16))
    with jmm_config(backend="xla"):
        _, jlogits = jengine.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                     max_len=16)
    _, logits = engine.prefill(tp, cfg, torch.tensor(toks), max_len=16)
    got, want = logits.numpy(), _np(jlogits)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=0.1)
    assert np.abs(got - want).mean() <= 1e-2


def test_launcher_runs_on_cpu_when_asked():
    res = serve_mod.main(["--arch", "phi4-mini-3.8b", "--reduced",
                          "--batch", "2", "--prompt-len", "6", "--gen", "3",
                          "--device", "cpu"])
    assert tuple(res["tokens"].shape) == (2, 3)
    assert res["logits_finite"]


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_moe_prefill_and_greedy_decode_match_jax(backend):
    """dbrx-132b reduced (MoE FFN in every layer): prefill plus four greedy
    decode steps against the JAX engine, weights carried by `convert`.
    Decode has T = 2 tokens, so every expert runs at the minimum capacity
    of 8 slots; prefill (T = 32) at 16."""
    jcfg, cfg = _configs("reduced", arch="dbrx-132b")
    jp, tp = _weights(jcfg)
    assert tp["stage0"][0]["b0"]["moe"]["router"].dtype == torch.float32
    rng = np.random.default_rng(15)
    B, S, MAX = 2, 16, 24
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    with jmm_config(backend="xla"):
        jcache, jlogits = jengine.prefill(jp, jcfg,
                                          jnp.asarray(toks, jnp.int32),
                                          max_len=MAX)
    with mm_config(backend=backend):
        cache, logits = engine.prefill(tp, cfg, torch.tensor(toks),
                                       max_len=MAX)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=RTOL,
                               atol=ATOL)
    tok = np.argmax(_np(jlogits), -1)
    for i in range(4):
        with jmm_config(backend="xla"):
            jlogits, jcache = jengine.decode_step(
                jp, jcfg, jcache, jnp.asarray(tok, jnp.int32),
                jnp.asarray(S + i, jnp.int32))
        with mm_config(backend=backend):
            logits, cache = engine.decode_step(tp, cfg, cache,
                                               torch.tensor(tok), S + i)
        np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=RTOL,
                                   atol=ATOL)
        tok = np.argmax(_np(jlogits), -1)


def test_moe_launcher_runs_on_cpu_when_asked():
    res = serve_mod.main(["--arch", "dbrx-132b", "--reduced", "--batch",
                          "2", "--prompt-len", "6", "--gen", "3",
                          "--device", "cpu"])
    assert tuple(res["tokens"].shape) == (2, 3)
    assert res["logits_finite"]
