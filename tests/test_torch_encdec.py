"""seamless-m4t-large-v2 (the encoder-decoder; its conformer frontend a stub
that hands in precomputed frame embeddings) in the port, against the JAX
package.

The config is the JAX one field for field (published and `reduced()`),
and `layers.sinusoidal_pos` JAX's at positions 0..4096 and the served
widths.  At `reduced()` sizes (fp32, 2 + 2 layers; JAX on the CPU through
its "xla" backend), with the JAX parameters carried over by
`repro_torch.convert` and the same numpy-seeded frames: `encode`,
`cross_kv`, `cross_attn`, `decode_hidden` and the forward, and
`encdec_engine.prefill` with two decode steps (as tests/test_serve.py
drives the JAX engine), on both port backends (the "cuda" one runs the
kernels' plain versions on the CPU); the prefill's plan log equals JAX's.
Under the "cuda" backend a prefill calls K7's dispatcher three times a
layer (encoder self, decoder self, cross at Sq != Skv) and a decode step
never; the decode graph's CPU plumbing steps the encoder-decoder.  K7's
plain version is held at Sq != Skv, not causal, against
`blockwise_attention`.

Tolerances (fp32): logits and hidden states 1e-4, as in
test_torch_serve.py (sums of a few thousand terms in other orders); the
cross k / v, the cross-attention output and the cache entries 1e-5 (sums
of at most a few hundred terms); `sinusoidal_pos` 1e-6 (both round the
same fp32 angles through their own sin / cos, ~6e-8 apart); K7's plain
version 1e-5 against `blockwise_attention` in fp32 and two bf16 ulps of
the largest output in bf16 (each rounds its own fp32 sums once).
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
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models.model import build_model as jbuild_model
from repro.serve import encdec_engine as jengine
from repro.serve.sched import buckets as jbuckets
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import skewmm
from repro_torch.core.config import mm_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import encdec, layers
from repro_torch.models.model import build_model
from repro_torch.serve import encdec_engine, graphs
from repro_torch.serve.sched import buckets

ARCH = "seamless-m4t-large-v2"
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-5, atol=1e-5)
BACKENDS = ["cuda", "torch"]
B, S, F = 2, 12, 16


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(6))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(19)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 2))
    frames = (rng.normal(size=(B, F, cfg.d_model)) * 0.1).astype(np.float32)
    return jcfg, cfg, jp, tp, toks, frames


def test_config_equals_jax_field_for_field():
    assert ARCH in ARCH_IDS
    for jcfg, cfg in ((jget_config(ARCH), get_config(ARCH)),
                      (jget_config(ARCH).reduced(),
                       get_config(ARCH).reduced())):
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.pos_embedding, cfg.enc_layers,
            cfg.frontend_len) == ("encdec", "sinusoidal", 24, 4096)
    assert cfg.vocab_size % 4 == 2
    red = cfg.reduced()
    assert (red.enc_layers, red.n_layers, red.frontend_len) == (2, 2, 16)


@pytest.mark.parametrize("d", [896, 1024, 128])
def test_sinusoidal_pos_matches_jax(d):
    pos = np.arange(4097, dtype=np.int32)
    want = _np(jlayers.sinusoidal_pos(jnp.asarray(pos), d))
    got = layers.sinusoidal_pos(torch.tensor(pos), d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (4097, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # a (B, 1) decode position gives the rows of the table
    rows = layers.sinusoidal_pos(torch.tensor([[3], [4096]]), d)
    assert torch.equal(rows[:, 0], got[[3, 4096]])


def test_params_from_numpy_unstacks_encoder_and_decoder(model):
    jcfg, cfg, jp, tp, *_ = model
    assert len(tp["enc"]) == cfg.enc_layers and len(tp["dec"]) == \
        cfg.n_layers
    for key in ("enc", "dec"):
        for r, layer in enumerate(tp[key]):
            jlayer = jax.tree.map(lambda x, r=r: np.asarray(x[r]), jp[key])
            flat = jax.tree_util.tree_flatten_with_path(jlayer)[0]
            assert len(flat) == sum(1 for _ in _tensors(layer))
            for path, leaf in flat:
                t = layer
                for k in path:
                    t = t[k.key]
                np.testing.assert_array_equal(t.numpy(), leaf)
    shapes = jax.tree.map(lambda x: tuple(x.shape),
                          {k: v for k, v in jp.items()
                           if k not in ("enc", "dec")})
    assert {k: tuple(v.shape) for k, v in tp.items()
            if k not in ("enc", "dec")} == shapes


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


@pytest.mark.parametrize("backend", BACKENDS)
def test_encoder_and_decoder_pieces_match_jax(model, backend):
    jcfg, cfg, jp, tp, toks, frames = model
    jx, x = jnp.asarray(frames), torch.tensor(frames)
    jt, t = jnp.asarray(toks[:, :S], jnp.int32), torch.tensor(toks[:, :S])
    with jmm_config(backend="xla"):
        jenc = jencdec.encode(jp, jcfg, jx)
        jp0 = jax.tree.map(lambda a: a[0], jp["dec"])
        jkv = jencdec.cross_kv(jenc, jp0["xattn"], jcfg)
        h = jnp.asarray(np.random.default_rng(3).normal(
            size=(B, S, cfg.d_model)).astype(np.float32))
        jca = jencdec.cross_attn(h, jkv, jp0["xattn"], jcfg)
        jdec = jencdec.decode_hidden(jp, jcfg, jt, jenc)
        jfwd, _ = jencdec.forward_hidden(jp, jcfg, jt, jx)
    with mm_config(backend=backend), torch.no_grad():
        enc = encdec.encode(tp, cfg, x)
        kv = encdec.cross_kv(enc, tp["dec"][0]["xattn"], cfg)
        ca = encdec.cross_attn(torch.tensor(np.asarray(h)), kv,
                               tp["dec"][0]["xattn"], cfg)
        ca_dec = encdec.cross_attn(torch.tensor(np.asarray(h)), kv,
                                   tp["dec"][0]["xattn"], cfg, decode=True)
        dec = encdec.decode_hidden(tp, cfg, t, enc)
        fwd, aux = encdec.forward_hidden(tp, cfg, t, x)
    np.testing.assert_allclose(enc.numpy(), _np(jenc), **LOGIT_TOL)
    for got, want in zip(kv, jkv):
        assert tuple(got.shape) == (B, F, cfg.n_heads, cfg.head_dim)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(ca.numpy(), _np(jca), **TOL)
    np.testing.assert_allclose(ca_dec.numpy(), _np(jca), **TOL)
    np.testing.assert_allclose(dec.numpy(), _np(jdec), **LOGIT_TOL)
    np.testing.assert_allclose(fwd.numpy(), _np(jfwd), **LOGIT_TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_build_model_forward_matches_jax(model, backend):
    jcfg, cfg, jp, tp, toks, frames = model
    jbundle = jbuild_model(jcfg)
    with jmm_config(backend="xla"):
        jh, _ = jbundle.hidden_fn(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                                       "frames": jnp.asarray(frames)})
        jlogits = jbundle.logits_fn(jp, jh)
    bundle = build_model(cfg, "cpu")
    with mm_config(backend=backend), torch.no_grad():
        h, _ = bundle.hidden_fn(tp, {"tokens": torch.tensor(toks),
                                     "frames": torch.tensor(frames)})
        logits = bundle.logits_fn(tp, h)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **LOGIT_TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_and_decode_match_jax(model, backend):
    jcfg, cfg, jp, tp, toks, frames = model
    max_len = S + 4
    with jmm_config(backend="xla"):
        jcache, jlogits = jengine.prefill(
            jp, jcfg, jnp.asarray(frames), jnp.asarray(toks[:, :S], jnp.int32),
            max_len=max_len)
    with mm_config(backend=backend):
        cache, logits = encdec_engine.prefill(
            tp, cfg, torch.tensor(frames), torch.tensor(toks[:, :S]),
            max_len=max_len)
    assert tuple(cache["self_k"].shape) == (cfg.n_layers, B, max_len,
                                            cfg.n_kv_heads, cfg.head_dim)
    assert tuple(cache["cross_k"].shape) == (cfg.n_layers, B, F,
                                             cfg.n_heads, cfg.head_dim)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **LOGIT_TOL)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in jengine.init_cache(
            jcfg, B, max_len, F).items()}
    cross = {k: cache[k].clone() for k in ("cross_k", "cross_v")}
    for col in (S, S + 1):
        with jmm_config(backend="xla"):
            jlogits, jcache = jengine.decode_step(
                jp, jcfg, jcache, jnp.asarray(toks[:, col], jnp.int32),
                jnp.asarray(col, jnp.int32))
        with mm_config(backend=backend):
            logits, out = encdec_engine.decode_step(
                tp, cfg, cache, torch.tensor(toks[:, col]),
                torch.tensor(col, dtype=torch.int32))
        assert out is cache
        np.testing.assert_allclose(logits.numpy(), _np(jlogits),
                                   **LOGIT_TOL)
    for name in cache:
        np.testing.assert_allclose(cache[name].numpy(), _np(jcache[name]),
                                   **TOL)
    for name, t in cross.items():             # decode never writes these
        assert torch.equal(cache[name], t)


def test_prefill_decode_matches_the_forward(model):
    """The port alone, as tests/test_serve.py holds the JAX engine: the
    prefill's and two teacher-forced decode steps' logits equal the
    forward's at the same positions."""
    _, cfg, _, tp, toks, frames = model
    bundle = build_model(cfg, "cpu")
    with torch.no_grad():
        h, _ = bundle.hidden_fn(tp, {"tokens": torch.tensor(toks),
                                     "frames": torch.tensor(frames)})
        want = bundle.logits_fn(tp, h)
    cache, logits = encdec_engine.prefill(tp, cfg, torch.tensor(frames),
                                          torch.tensor(toks[:, :S]),
                                          max_len=S + 2)
    np.testing.assert_allclose(logits.numpy(), want[:, -3].numpy(),
                               **LOGIT_TOL)
    for i, col in enumerate((S, S + 1)):
        logits, cache = encdec_engine.decode_step(
            tp, cfg, cache, torch.tensor(toks[:, col]), col)
        np.testing.assert_allclose(logits.numpy(), want[:, i - 2].numpy(),
                                   **LOGIT_TOL)


def test_prefill_plan_log_equals_jax(model):
    """Encoder and decoder sites are recorded once each, as the JAX
    engine's two `lax.scan`s trace their bodies once: the same plans in
    order, and the decoder's MLP residual left unfused."""
    jcfg, cfg, jp, tp, toks, frames = model
    with jmm_config(backend="xla"), jskewmm.plan_capture() as jlog:
        jengine.prefill(jp, jcfg, jnp.asarray(frames),
                        jnp.asarray(toks[:, :S], jnp.int32), max_len=S + 2)
    with mm_config(chip="tpu_v5e"), skewmm.plan_capture() as log:
        encdec_engine.prefill(tp, cfg, torch.tensor(frames),
                              torch.tensor(toks[:, :S]), max_len=S + 2)
    assert len(log) == len(jlog) > 0
    assert [buckets._spec_of(c) for c in log] == [
        jbuckets._spec_of(c) for c in jlog]
    assert sum(c.total_s for c in log if hasattr(c, "total_s")) == sum(
        c.total_s for c in jlog if hasattr(c, "total_s"))


def test_cuda_backend_routes_prefill_attention_to_k7(model, monkeypatch):
    """Under the "cuda" backend every prefill attention reaches K7's
    dispatcher — encoder self (not causal), decoder self (causal) and
    cross-attention (Sq != Skv, not causal), three a layer — and a
    decode step reaches it never."""
    _, cfg, _, tp, toks, frames = model
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2], kw.get("causal", True)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    with mm_config(backend="cuda"):
        cache, logits = encdec_engine.prefill(
            tp, cfg, torch.tensor(frames), torch.tensor(toks[:, :S]),
            max_len=S + 1)
        n_prefill = len(calls)
        encdec_engine.decode_step(tp, cfg, cache, torch.argmax(logits, -1),
                                  S)
    assert n_prefill == len(calls) == cfg.enc_layers + 2 * cfg.n_layers
    assert calls.count((F, F, False)) == cfg.enc_layers
    assert calls.count((S, S, True)) == cfg.n_layers
    assert calls.count((S, F, False)) == cfg.n_layers


def test_decode_graph_steps_the_encoder_decoder_on_cpu(model):
    """The decode graph's CPU plumbing (no capture): its warm-up runs on a
    scratch copy, so the served cache is untouched until the first step,
    and each step equals an eager `encdec_engine.decode_step`."""
    _, cfg, _, tp, toks, frames = model
    cache, logits = encdec_engine.prefill(
        tp, cfg, torch.tensor(frames), torch.tensor(toks[:, :S]),
        max_len=S + 2)
    twin = graphs.clone_cache(cache)
    step = graphs.DecodeGraph(tp, cfg, cache, B)
    for name in cache:
        assert torch.equal(cache[name], twin[name])
    tok = torch.argmax(logits, -1)
    for i in range(2):
        got = step.step(tok, S + i).clone()
        want, _ = encdec_engine.decode_step(tp, cfg, twin, tok, S + i)
        assert torch.equal(got, want)
        tok = torch.argmax(got, -1)
    assert step.launches_per_step == {}


@pytest.mark.parametrize("dtype,sq,skv,hq,hkv,d", [
    (torch.float32, 40, 300, 4, 4, 64),
    (torch.float32, 1, 257, 4, 2, 32),
    (torch.bfloat16, 130, 257, 4, 4, 64),
    (torch.bfloat16, 16, 4096, 2, 2, 64),
])
def test_flash_plain_cross_lengths_match_blockwise(dtype, sq, skv, hq, hkv,
                                                   d):
    """Sq != Skv, not causal (cross-attention): the plain version's tiles
    walk every kv column of every q row, ragged tails masked."""
    g = torch.Generator().manual_seed(sq + skv)
    q = torch.randn((2, hq, sq, d), generator=g).to(dtype)
    k = torch.randn((2, hkv, skv, d), generator=g).to(dtype)
    v = torch.randn((2, hkv, skv, d), generator=g).to(dtype)
    got = fa.flash_attention_plain(q, k, v, causal=False)
    want = layers.blockwise_attention(q, k, v, causal=False)
    assert got.dtype == dtype and tuple(got.shape) == (2, hq, sq, d)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    else:
        scale = want.float().abs().max().item()
        ulp2 = 2.0 * 2.0 ** (np.floor(np.log2(scale)) - 7)
        assert (got.float() - want.float()).abs().max().item() <= ulp2
