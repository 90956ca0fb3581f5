"""mamba2-2.7b `reduced()` (2 mixer-only ssm layers, d_inner 256, 8 SSD
heads of 32, state 32, chunk 32) in the port against the JAX package, on
the same weights: made by the reference's initializer and carried over
with `repro_torch.convert`; prompts numpy-seeded, 40 tokens long (one
whole 32-row chunk and a ragged tail).  The port runs on the CPU, so its
"cuda" backend takes the SSD kernel's plain version (the fp32 chunk math)
and its "torch" backend `ssd_chunked`; no kernel is launched.

Tolerance (fp32): rtol = atol = 1e-4, as for the other served models —
contractions of at most a few hundred terms in fp32, summed in different
orders, and an fp32 recurrence whose rounding does not grow (observed
differences ~1e-6 of logits of magnitude ~1).
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
from repro.serve import kvcache as jkvcache
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.config import mm_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.models.model import build_model
from repro_torch.serve import engine, kvcache

RTOL = ATOL = 1e-4
ARCH = "mamba2-2.7b"


def _configs(dtype: str | None = None):
    jcfg = jget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    if dtype:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=dtype)
    assert jcfg.__dict__ == cfg.__dict__
    return jcfg, cfg


def _weights(jcfg, seed=3):
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


B, S, MAX, STEPS = 2, 40, 44, 4


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side, computed once for both backends: weights, the forward
    pass, and a prefill followed by greedy decode steps with the cache
    after the prefill and after the last step."""
    jcfg, _ = _configs()
    jp, tp = _weights(jcfg)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (B, S))
    with jmm_config(backend="xla"):
        jb = jbuild_model(jcfg)
        jh, _ = jb.hidden_fn(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
        jl = jb.logits_fn(jp, jh)
        jcache, jlogits = jengine.prefill(jp, jcfg,
                                          jnp.asarray(toks, jnp.int32),
                                          max_len=MAX)
        caches = [jax.tree.map(_np, jcache)]
        logits = [_np(jlogits)]
        for i in range(STEPS):
            tok = np.argmax(logits[-1], -1)
            jlogits, jcache = jengine.decode_step(
                jp, jcfg, jcache, jnp.asarray(tok, jnp.int32),
                jnp.asarray(S + i, jnp.int32))
            logits.append(_np(jlogits))
        caches.append(jax.tree.map(_np, jcache))
    return dict(tp=tp, toks=toks, hidden=_np(jh), head=_np(jl),
                logits=logits, caches=caches)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_forward_hidden_and_unembed_match_jax(backend, jax_run):
    _, cfg = _configs()
    tb = build_model(cfg, "cpu")
    tp = jax_run["tp"]
    with mm_config(backend=backend):
        h, aux = tb.hidden_fn(tp, {"tokens": torch.tensor(jax_run["toks"])})
        logits = tb.logits_fn(tp, h)
    assert float(aux) == 0.0
    np.testing.assert_allclose(h.numpy(), jax_run["hidden"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), jax_run["head"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_prefill_and_greedy_decode_match_jax(backend, jax_run):
    """Prompt 40 (one whole 32-row chunk and a ragged tail), then 4 decode
    steps: each ssm block's fp32 state and three conv tails carry over
    from prefill; every cache leaf is held against the JAX engine's after
    prefill and after the last step."""
    _, cfg = _configs()
    tp, want = jax_run["tp"], jax_run["logits"]
    ops.reset_launch_counts()

    def check_cache(jcache):
        for si, stage in cache.items():
            for bi, entry in stage.items():
                assert set(entry) == {"state", "cx", "cb", "cc"}
                assert entry["state"].dtype == torch.float32
                for key, t in entry.items():
                    np.testing.assert_allclose(
                        t.float().numpy(), jcache[si][bi][key], rtol=RTOL,
                        atol=ATOL, err_msg=f"{si}/{bi}/{key}")

    with mm_config(backend=backend):
        cache, logits = engine.prefill(tp, cfg, torch.tensor(jax_run["toks"]),
                                       max_len=MAX)
        np.testing.assert_allclose(logits.numpy(), want[0], rtol=RTOL,
                                   atol=ATOL)
        check_cache(jax_run["caches"][0])
        for i in range(STEPS):
            tok = torch.tensor(np.argmax(want[i], -1))
            logits, cache = engine.decode_step(tp, cfg, cache, tok, S + i)
            np.testing.assert_allclose(logits.numpy(), want[i + 1],
                                       rtol=RTOL, atol=ATOL)
    check_cache(jax_run["caches"][1])
    assert ops.launch_counts()["ssd_scan"] == 0          # CPU: plain


def test_cache_layout_matches_jax():
    jcfg, cfg = _configs()
    jc = jkvcache.init_cache(jcfg, 3, 100)
    tc = kvcache.init_cache(cfg, 3, 100, "cpu")
    for si, stage in jc.items():
        for bi, entry in stage.items():
            assert set(entry) == set(tc[si][bi])
            for key, arr in entry.items():
                t = tc[si][bi][key]
                assert tuple(t.shape) == arr.shape, (si, bi, key)
                assert str(t.dtype).split(".")[-1] == str(arr.dtype)
    assert kvcache.cache_bytes(tc) == jkvcache.cache_bytes(jc)


def test_blocks_are_mixer_only():
    _, cfg = _configs()
    params = build_model(cfg, "cpu").init(0)
    block = params["stage0"][0]["b0"]
    assert set(block) == {"ln1", "mixer"}


def test_bf16_backends_close_to_the_fp32_run():
    """bf16 weights (XLA on the CPU has no bf16 x bf16 -> fp32 dot, which
    JAX's `ssd_chunked` einsums need, so the reference is the port's own
    fp32 run of the same weights): both backends' prefill and first-decode
    logits lie within the bf16 rounding of it (atol 0.1, mean 1e-2 at
    logit scale ~1)."""
    jcfg, cfg = _configs(dtype="bfloat16")
    _, tp = _weights(jcfg)
    f32 = dataclasses.replace(cfg, dtype="float32")
    tp32 = jax.tree.map(lambda t: t.float(), tp)
    toks = torch.tensor(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 40)))
    cache, want = engine.prefill(tp32, f32, toks, max_len=41)
    nxt = torch.argmax(want, -1)
    want_dec, _ = engine.decode_step(tp32, f32, cache, nxt, 40)
    for backend in ("cuda", "torch"):
        with mm_config(backend=backend):
            cache, got = engine.prefill(tp, cfg, toks, max_len=41)
            got_dec, _ = engine.decode_step(tp, cfg, cache, nxt, 40)
        for g, w in ((got, want), (got_dec, want_dec)):
            diff = (g - w).abs()
            assert diff.max() <= 0.1 and diff.mean() <= 1e-2, backend


def test_launcher_runs_on_cpu_when_asked():
    ops.reset_launch_counts()
    res = serve_mod.main(["--arch", ARCH, "--reduced", "--batch", "2",
                          "--prompt-len", "37", "--gen", "3",
                          "--device", "cpu"])
    assert tuple(res["tokens"].shape) == (2, 3)
    assert res["logits_finite"]
    assert ops.launch_counts()["ssd_scan"] == 0          # CPU: plain


def test_reduced_config_mirrors_the_published_one():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads,
            cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_chunk,
            cfg.conv_kernel, cfg.vocab_size, cfg.tie_embeddings) == (
        64, 2560, 5120, 80, 64, 128, 1, 128, 4, 50280, True)
    assert cfg.__dict__ == jget_config(ARCH).__dict__
    assert cfg.stage_list() == [(("ssm",), 64)]
