"""internvl2-1b (the VLM backbone; its InternViT frontend a stub that hands
in precomputed patch embeddings) in the port, against the JAX package.

The config is the JAX one field for field (published and `reduced()`).
At `reduced()` sizes (fp32, 16 prefix rows; JAX on the CPU through its
"xla" backend), with the JAX parameters carried over by
`repro_torch.convert` and the same numpy-seeded prefix: the forward with
and without the prefix, and `engine.prefill(prefix_embeds=)` with two
decode steps at positions offset by the prefix (as tests/test_serve.py
drives the JAX engine), on both port backends (the "cuda" one runs the
kernels' plain versions on the CPU); the prefill's plan log equals JAX's;
the continuous-batching scheduler refuses the VLM frontend, and passes
the encoder-decoder, as JAX's does.

Tolerances (fp32): logits and hidden states 1e-4, as in
test_torch_serve.py (sums of a few thousand terms in other orders); the
k / v cache entries 1e-5 (sums of at most a few hundred terms).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import skewmm as jskewmm
from repro.core.config import mm_config as jmm_config
from repro.models.model import build_model as jbuild_model
from repro.serve import engine as jengine
from repro.serve.sched import buckets as jbuckets
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import skewmm
from repro_torch.core.config import mm_config
from repro_torch.models.model import build_model
from repro_torch.serve import engine
from repro_torch.serve.sched import buckets

ARCH = "internvl2-1b"
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
BACKENDS = ["cuda", "torch"]
B, S = 2, 12


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(5))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(17)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 2))
    prefix = (rng.normal(size=(B, cfg.frontend_len, cfg.d_model)) * 0.1
              ).astype(np.float32)
    return jcfg, cfg, jp, tp, toks, prefix


def test_config_equals_jax_field_for_field():
    assert ARCH in ARCH_IDS
    for jcfg, cfg in ((jget_config(ARCH), get_config(ARCH)),
                      (jget_config(ARCH).reduced(),
                       get_config(ARCH).reduced())):
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.frontend, cfg.frontend_len) == ("vlm", "patch",
                                                            256)
    assert cfg.n_heads // cfg.n_kv_heads == 7 and cfg.vocab_size % 2 == 1
    assert get_config(ARCH).reduced().frontend_len == 16


@pytest.mark.parametrize("with_prefix", [True, False])
@pytest.mark.parametrize("backend", BACKENDS)
def test_forward_hidden_matches_jax(model, backend, with_prefix):
    jcfg, cfg, jp, tp, toks, prefix = model
    jbatch = {"tokens": jnp.asarray(toks[:, :S], jnp.int32)}
    batch = {"tokens": torch.tensor(toks[:, :S])}
    if with_prefix:
        jbatch["prefix_embeds"] = jnp.asarray(prefix)
        batch["prefix_embeds"] = torch.tensor(prefix)
    jbundle = jbuild_model(jcfg)
    with jmm_config(backend="xla"):
        jh, _ = jbundle.hidden_fn(jp, jbatch)
        jlogits = jbundle.logits_fn(jp, jh)
    bundle = build_model(cfg, "cpu")
    with mm_config(backend=backend), torch.no_grad():
        h, aux = bundle.hidden_fn(tp, batch)
        logits = bundle.logits_fn(tp, h)
    t = S + (cfg.frontend_len if with_prefix else 0)
    assert tuple(h.shape) == (B, t, cfg.d_model)
    assert float(aux) == 0.0
    np.testing.assert_allclose(h.numpy(), _np(jh), **LOGIT_TOL)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **LOGIT_TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefix_prefill_and_decode_match_jax(model, backend):
    jcfg, cfg, jp, tp, toks, prefix = model
    off = cfg.frontend_len
    max_len = off + S + 2
    with jmm_config(backend="xla"):
        jcache, jlogits = jengine.prefill(
            jp, jcfg, jnp.asarray(toks[:, :S], jnp.int32), max_len=max_len,
            prefix_embeds=jnp.asarray(prefix))
    with mm_config(backend=backend):
        cache, logits = engine.prefill(
            tp, cfg, torch.tensor(toks[:, :S]), max_len=max_len,
            prefix_embeds=torch.tensor(prefix))
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **LOGIT_TOL)
    for col in (S, S + 1):
        with jmm_config(backend="xla"):
            jlogits, jcache = jengine.decode_step(
                jp, jcfg, jcache, jnp.asarray(toks[:, col], jnp.int32),
                jnp.asarray(col + off, jnp.int32))
        with mm_config(backend=backend):
            logits, cache = engine.decode_step(
                tp, cfg, cache, torch.tensor(toks[:, col]),
                torch.tensor(col + off, dtype=torch.int32))
        np.testing.assert_allclose(logits.numpy(), _np(jlogits),
                                   **LOGIT_TOL)
    for si, stage in cache.items():
        for name in ("k", "v"):
            np.testing.assert_allclose(stage["b0"][name].numpy(),
                                       _np(jcache[si]["b0"][name]),
                                       **CACHE_TOL)


def test_prefix_prefill_decode_matches_the_forward(model):
    """The port alone, as tests/test_serve.py holds the JAX engine: the
    prefill's and two teacher-forced decode steps' logits equal the
    forward's at the same positions."""
    _, cfg, _, tp, toks, prefix = model
    bundle = build_model(cfg, "cpu")
    with torch.no_grad():
        h, _ = bundle.hidden_fn(tp, {"tokens": torch.tensor(toks),
                                     "prefix_embeds": torch.tensor(prefix)})
        want = bundle.logits_fn(tp, h)
    off = cfg.frontend_len
    cache, logits = engine.prefill(tp, cfg, torch.tensor(toks[:, :S]),
                                   max_len=off + S + 2,
                                   prefix_embeds=torch.tensor(prefix))
    np.testing.assert_allclose(logits.numpy(), want[:, -3].numpy(),
                               **LOGIT_TOL)
    for i, col in enumerate((S, S + 1)):
        logits, cache = engine.decode_step(tp, cfg, cache,
                                           torch.tensor(toks[:, col]),
                                           col + off)
        np.testing.assert_allclose(logits.numpy(), want[:, i - 2].numpy(),
                                   **LOGIT_TOL)


def test_prefix_prefill_plan_log_equals_jax(model):
    """Each stage site is recorded once, as the JAX engine's `lax.scan`
    traces its body once: the same plans in order, at T = 16 + 12."""
    jcfg, cfg, jp, tp, toks, prefix = model
    with jmm_config(backend="xla"), jskewmm.plan_capture() as jlog:
        jengine.prefill(jp, jcfg, jnp.asarray(toks[:, :S], jnp.int32),
                        max_len=40, prefix_embeds=jnp.asarray(prefix))
    with mm_config(chip="tpu_v5e"), skewmm.plan_capture() as log:
        engine.prefill(tp, cfg, torch.tensor(toks[:, :S]), max_len=40,
                       prefix_embeds=torch.tensor(prefix))
    assert len(log) == len(jlog) > 0
    assert [buckets._spec_of(c) for c in log] == [
        jbuckets._spec_of(c) for c in jlog]
    assert sum(c.total_s for c in log if hasattr(c, "total_s")) == sum(
        c.total_s for c in jlog if hasattr(c, "total_s"))


@pytest.mark.parametrize("arch", [ARCH, "seamless-m4t-large-v2"])
def test_scheduler_refuses_what_jax_refuses(arch):
    """The bucket table refuses the VLM frontend, as JAX's does, and
    passes the encoder-decoder's attention-only decoder as JAX's does."""
    kw = dict(max_batch=4, max_prompt=16, max_new=4)
    jtable = jbuckets.BucketTable.for_workload(**kw)
    table = buckets.BucketTable.for_workload(**kw)
    results = []
    for tb, cfg in ((jtable, jget_config(arch)), (table, get_config(arch))):
        try:
            tb.validate_for(cfg)
            results.append(None)
        except ValueError as e:
            results.append(str(e))
    assert results[0] == results[1]
    if arch == ARCH:
        assert "VLM" in results[1]
