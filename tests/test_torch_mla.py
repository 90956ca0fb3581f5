"""deepseek-v3-671b's MLA attention and MTP head in the port, against the
JAX package.

The config is the JAX one field for field (published and `reduced()`).
At `reduced()` sizes (fp32; JAX on the CPU through its "xla" backend),
with the JAX parameters carried over by `repro_torch.convert`:
`mla_latent`, `mla_queries` and `mla_attn` on both port backends (the
"cuda" one runs K7's plain version on the CPU); prefill and greedy decode
steps of the engine (absorbed-form MLA decode) against
`repro.serve.engine`, with a scalar position and with per-row (B,)
positions; the whole forward; and `mtp_hidden`.  K7's plain version is
also held at a q / k width unlike v's (MLA's prefill) against
`blockwise_attention`.

Tolerances (fp32): the attention pieces and the cache entries 1e-5 (both
packages sum the same fp32 products of at most a few hundred terms in
other orders, ~1e-7 here); logits and hidden states 1e-4, as in
test_torch_serve.py (a few thousand terms, two layers of them).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.config import mm_config as jmm_config
from repro.models import attention as jattn
from repro.models import transformer as jtransformer
from repro.models.model import build_model as jbuild_model
from repro.serve import engine as jengine
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.config import mm_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention, layers, transformer
from repro_torch.models.model import build_model
from repro_torch.serve import engine, kvcache

ARCH = "deepseek-v3-671b"
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BACKENDS = ["cuda", "torch"]
STEPS = 4


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _configs():
    return jget_config(ARCH).reduced(), get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _configs()
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(7))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def test_config_equals_jax_field_for_field():
    assert ARCH in ARCH_IDS
    for jcfg, cfg in ((jget_config(ARCH), get_config(ARCH)), _configs()):
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    cfg = get_config(ARCH)
    assert cfg.use_mla and cfg.kv_cache_kind == "mla"
    assert (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim) == (192, 128)
    assert [(u, n) for u, n in cfg.stage_list()] == [
        (("attn_dense",), 3), (("attn_moe",), 58)]


def test_params_carry_the_mtp_head(model):
    """`params_from_numpy` maps the non-stage `mtp` dict leaf for leaf, and
    the port's own init draws the same tree of shapes."""
    jcfg, cfg, jp, tp = model
    assert set(tp) == set(jp) and "mtp" in tp
    flat = jax.tree_util.tree_flatten_with_path(jp["mtp"])[0]
    assert flat
    for path, leaf in flat:
        t = tp["mtp"]
        for key in path:
            t = t[key.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    own = build_model(cfg, "cpu").init(0)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(own) == shapes(tp)


def _attn_inputs(model, seed, s=20):
    jcfg, cfg, jp, tp = model
    x = np.random.default_rng(seed).normal(size=(2, s, cfg.d_model)).astype(
        np.float32)
    pos = np.arange(s, dtype=np.int32)
    # the MoE stage's first layer: the JAX stage stacks its layers
    return (jax.tree.map(lambda a: a[0], jp["stage1"]["b0"]["attn"]),
            tp["stage1"][0]["b0"]["attn"], x, pos)


@pytest.mark.parametrize("backend", BACKENDS)
def test_mla_pieces_match_jax(model, backend):
    jcfg, cfg = model[0], model[1]
    jpa, tpa, x, pos = _attn_inputs(model, seed=3)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    jpos, tpos = jnp.asarray(pos), torch.tensor(pos)
    with jmm_config(backend="xla"):
        jlat, jrope = jattn.mla_latent(jx, jpa, jcfg, jpos)
        jqn, jqr = jattn.mla_queries(jx, jpa, jcfg, jpos)
        jout = jattn.mla_attn(jx, jpa, jcfg, positions=jpos)
    with mm_config(backend=backend), torch.no_grad():
        lat, rope = attention.mla_latent(tx, tpa, cfg, tpos)
        qn, qr = attention.mla_queries(tx, tpa, cfg, tpos)
        out = attention.mla_attn(tx, tpa, cfg, positions=tpos)
        via = attention.attn(tx, tpa, cfg, window=None, positions=tpos)
    for got, want in ((lat, jlat), (rope, jrope), (qn, jqn), (qr, jqr),
                      (out, jout), (via, jout)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_mla_cache_entry_is_full_length_latent(model):
    cfg = model[1]
    cache = kvcache.init_cache(cfg, 3, 40, "cpu")
    for si, (unit, n) in enumerate(cfg.stage_list()):
        entry = cache[f"stage{si}"]["b0"]
        assert {k: tuple(v.shape) for k, v in entry.items()} == {
            "latent": (n, 3, 40, cfg.kv_lora_rank),
            "k_rope": (n, 3, 40, cfg.qk_rope_dim)}
        assert all(v.dtype == torch.float32 for v in entry.values())
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    entry = kvcache.init_cache(bf, 1, 8, "meta")["stage0"]["b0"]
    assert all(v.dtype == torch.bfloat16 for v in entry.values())


def _assert_caches(cache, jcache, cfg):
    for si in range(len(cfg.stage_list())):
        for name in ("latent", "k_rope"):
            np.testing.assert_allclose(
                cache[f"stage{si}"]["b0"][name].numpy(),
                _np(jcache[f"stage{si}"]["b0"][name]), **TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_and_greedy_decode_match_jax(model, backend):
    jcfg, cfg, jp, tp = model
    b, s = 2, 16
    max_len = s + STEPS
    toks = np.random.default_rng(21).integers(0, cfg.vocab_size, (b, s))
    with jmm_config(backend="xla"):
        jcache, jlogits = jengine.prefill(
            jp, jcfg, jnp.asarray(toks, jnp.int32), max_len=max_len)
    with mm_config(backend=backend):
        cache, logits = engine.prefill(tp, cfg, torch.tensor(toks),
                                       max_len=max_len)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **LOGIT_TOL)
    _assert_caches(cache, jcache, cfg)
    tok = np.argmax(_np(jlogits), -1)
    for i in range(STEPS):
        with jmm_config(backend="xla"):
            jlogits, jcache = jengine.decode_step(
                jp, jcfg, jcache, jnp.asarray(tok, jnp.int32),
                jnp.asarray(s + i, jnp.int32))
        with mm_config(backend=backend):
            logits, cache = engine.decode_step(
                tp, cfg, cache, torch.tensor(tok),
                torch.tensor(s + i, dtype=torch.int32))
        np.testing.assert_allclose(logits.numpy(), _np(jlogits),
                                   **LOGIT_TOL)
        tok = np.argmax(_np(jlogits), -1)
    _assert_caches(cache, jcache, cfg)


@pytest.mark.parametrize("backend", BACKENDS)
def test_per_row_positions_match_jax(model, backend):
    """Rows of one batch at their own depths (the continuous-batching
    case): right-padded prompts, prefilled with per-row last indices,
    then decode steps at per-row (B,) positions."""
    jcfg, cfg, jp, tp = model
    b, s = 3, 12
    lens = np.array([12, 7, 9], np.int32)
    max_len = s + STEPS
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (b, s))
    with jmm_config(backend="xla"):
        jcache, jlogits = jengine.prefill(
            jp, jcfg, jnp.asarray(toks, jnp.int32), max_len=max_len,
            last_index=jnp.asarray(lens - 1))
    with mm_config(backend=backend):
        cache, logits = engine.prefill(
            tp, cfg, torch.tensor(toks), max_len=max_len,
            last_index=torch.tensor(lens - 1, dtype=torch.long))
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **LOGIT_TOL)
    tok = np.argmax(_np(jlogits), -1)
    for i in range(STEPS):
        pos = lens + i
        with jmm_config(backend="xla"):
            jlogits, jcache = jengine.decode_step(
                jp, jcfg, jcache, jnp.asarray(tok, jnp.int32),
                jnp.asarray(pos))
        with mm_config(backend=backend):
            logits, cache = engine.decode_step(
                tp, cfg, cache, torch.tensor(tok),
                torch.tensor(pos, dtype=torch.int32))
        np.testing.assert_allclose(logits.numpy(), _np(jlogits),
                                   **LOGIT_TOL)
        tok = np.argmax(_np(jlogits), -1)
    _assert_caches(cache, jcache, cfg)


def test_forward_hidden_matches_jax(model):
    jcfg, cfg, jp, tp = model
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 14))
    with jmm_config(backend="xla"):
        jh, jaux = jbuild_model(jcfg).hidden_fn(
            jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        h, aux = build_model(cfg, "cpu").hidden_fn(
            tp, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(h.numpy(), _np(jh), **LOGIT_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5, atol=0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_mtp_hidden_matches_jax(model, backend):
    jcfg, cfg, jp, tp = model
    toks = np.random.default_rng(17).integers(0, cfg.vocab_size, (2, 10))
    h = np.random.default_rng(18).normal(size=(2, 10, cfg.d_model)).astype(
        np.float32)
    with jmm_config(backend="xla"):
        want = jtransformer.mtp_hidden(jp, jcfg, jnp.asarray(h),
                                       jnp.asarray(toks, jnp.int32))
    with mm_config(backend=backend), torch.no_grad():
        got = transformer.mtp_hidden(tp, cfg, torch.tensor(h),
                                     torch.tensor(toks))
    assert tuple(got.shape) == (2, 9, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), _np(want), **LOGIT_TOL)


@pytest.mark.parametrize("mask", [dict(causal=True),
                                  dict(causal=True, window=20),
                                  dict(causal=False)],
                         ids=["causal", "window", "full"])
@pytest.mark.parametrize("widths", [(48, 32), (192, 128)],
                         ids=["reduced", "published"])
def test_flash_plain_takes_a_narrower_v(widths, mask):
    """K7's plain version at q / k width d and v width dv < d, with MLA's
    scale (d^-0.5 of the q / k width), against `blockwise_attention`."""
    d, dv = widths
    rng = np.random.default_rng(d)
    q = torch.tensor(rng.normal(size=(2, 4, 70, d)), dtype=torch.float32)
    k = torch.tensor(rng.normal(size=(2, 4, 70, d)), dtype=torch.float32)
    v = torch.tensor(rng.normal(size=(2, 4, 70, dv)), dtype=torch.float32)
    scale = d ** -0.5
    got = fa.flash_attention_plain(q, k, v, scale=scale, **mask)
    want = layers.blockwise_attention(q, k, v, scale=scale, **mask)
    assert tuple(got.shape) == (2, 4, 70, dv)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_flash_refuses_a_wider_v():
    q = torch.zeros((1, 2, 8, 32))
    with pytest.raises(ValueError, match="v width"):
        fa.flash_attention_plain(q, q, torch.zeros((1, 2, 8, 48)))
