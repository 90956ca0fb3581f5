"""recurrentgemma-9b `reduced()` (rec, rec, attn_local units plus a
trailing rec layer; a 64-token local window) in the port against the JAX
package, on the same weights: made by the reference's initializer and
carried over with `repro_torch.convert`; prompts numpy-seeded and longer
than the window, so the local attention's mask bites at prefill and the
ring caches wrap at decode.  The port runs on the CPU, so its "cuda"
backend takes the kernels' plain versions (flash attention and the RG-LRU
scan); its "torch" backend takes `blockwise_attention` and the log-depth
scan.

Tolerance (fp32): rtol = atol = 1e-4, as for the dense and MoE serves —
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
ARCH = "recurrentgemma-9b"


def _configs(dtype: str | None = None):
    jcfg = jget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    if dtype:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=dtype)
    assert jcfg.__dict__ == cfg.__dict__
    assert cfg.local_window == 64
    return jcfg, cfg


def _weights(jcfg, seed=3):
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_forward_hidden_and_unembed_match_jax(backend):
    jcfg, cfg = _configs()
    jp, tp = _weights(jcfg)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 90))
    jb, tb = jbuild_model(jcfg), build_model(cfg, "cpu")
    with jmm_config(backend="xla"):
        jh, _ = jb.hidden_fn(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
        jl = jb.logits_fn(jp, jh)
    with mm_config(backend=backend):
        h, _ = tb.hidden_fn(tp, {"tokens": torch.tensor(toks)})
        logits = tb.logits_fn(tp, h)
    np.testing.assert_allclose(logits.numpy(), _np(jl), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_prefill_and_greedy_decode_match_jax(backend):
    """Prompt 80 > window 64, then 6 decode steps: the rec blocks' fp32
    state and conv tail, and the ring caches, carry over from prefill."""
    jcfg, cfg = _configs()
    jp, tp = _weights(jcfg)
    B, S, MAX = 2, 80, 90
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S))
    with jmm_config(backend="xla"):
        jcache, jlogits = jengine.prefill(jp, jcfg,
                                          jnp.asarray(toks, jnp.int32),
                                          max_len=MAX)
    with mm_config(backend=backend):
        cache, logits = engine.prefill(tp, cfg, torch.tensor(toks),
                                       max_len=MAX)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=RTOL,
                               atol=ATOL)
    rec = cache["stage0"]["b0"]
    assert rec["lru"].dtype == torch.float32
    np.testing.assert_allclose(rec["lru"].numpy(),
                               _np(jcache["stage0"]["b0"]["lru"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rec["conv"].numpy(),
                               _np(jcache["stage0"]["b0"]["conv"]),
                               rtol=RTOL, atol=ATOL)
    tok = np.argmax(_np(jlogits), -1)
    for i in range(6):
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
    for si, stage in cache.items():
        for bi, entry in stage.items():
            for key, t in entry.items():
                np.testing.assert_allclose(
                    t.float().numpy(), _np(jcache[si][bi][key]), rtol=RTOL,
                    atol=ATOL, err_msg=f"{si}/{bi}/{key}")


def test_per_row_positions_match_jax():
    """(B,) decode positions: each row at its own depth, one past the
    window and one inside it."""
    jcfg, cfg = _configs()
    jp, tp = _weights(jcfg)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 70))
    with jmm_config(backend="xla"):
        jcache, _ = jengine.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                    max_len=80)
    cache, _ = engine.prefill(tp, cfg, torch.tensor(toks), max_len=80)
    pos, tok = np.array([70, 41]), np.array([3, 4])
    with jmm_config(backend="xla"):
        jlogits, _ = jengine.decode_step(jp, jcfg, jcache,
                                         jnp.asarray(tok, jnp.int32),
                                         jnp.asarray(pos, jnp.int32))
    logits, _ = engine.decode_step(tp, cfg, cache, torch.tensor(tok),
                                   torch.tensor(pos))
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=RTOL,
                               atol=ATOL)


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


def test_bf16_backends_close_to_the_fp32_run():
    """bf16 weights (XLA on the CPU has no bf16 x bf16 -> fp32 dot, which
    the JAX gate projection needs, so the reference is the port's own fp32
    run of the same weights): both backends' prefill logits lie within
    the bf16 rounding of it (atol 0.1, mean 1e-2 at logit scale ~1)."""
    jcfg, cfg = _configs(dtype="bfloat16")
    _, tp = _weights(jcfg)
    f32 = dataclasses.replace(cfg, dtype="float32")
    tp32 = jax.tree.map(lambda t: t.float(), tp)
    toks = torch.tensor(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 72)))
    _, want = engine.prefill(tp32, f32, toks, max_len=72)
    for backend in ("cuda", "torch"):
        with mm_config(backend=backend):
            _, got = engine.prefill(tp, cfg, toks, max_len=72)
        diff = (got - want).abs()
        assert diff.max() <= 0.1 and diff.mean() <= 1e-2, backend


def test_launcher_runs_on_cpu_when_asked():
    ops.reset_launch_counts()
    res = serve_mod.main(["--arch", ARCH, "--reduced", "--batch", "2",
                          "--prompt-len", "70", "--gen", "3",
                          "--device", "cpu"])
    assert tuple(res["tokens"].shape) == (2, 3)
    assert res["logits_finite"]
    assert ops.launch_counts()["flash_attention"] == 0     # CPU: plain


def test_reduced_config_mirrors_the_published_one():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.lru_width, cfg.local_window) == (
        38, 4096, 16, 1, 256, 4096, 2048)
    assert cfg.__dict__ == jget_config(ARCH).__dict__
    assert cfg.stage_list() == [(("rec", "rec", "attn_local"), 12),
                                (("rec", "rec"), 1)]
