"""The port's MoE layer against the JAX package's `moe_mlp`, on the same
weights and inputs (dbrx-132b `reduced()`: 8 experts, top-2, d 128).

JAX parameters come from the reference's `init_moe` and are carried over
as numpy arrays; inputs are numpy-seeded.  The JAX side runs its default
"xla" backend (the einsum reference).  The port runs on the CPU, where
its "cuda" backend takes K5's plain version.

Tolerances (fp32): rtol = atol = 1e-5 — both route identically (same
fp32 router logits to ~1e-7, no near-ties at these inputs), pack the same
slots, and sum each expert GEMM of at most 128 terms in fp32 in another
order; the combine adds at most top-k = 2 terms per token (on the CPU
`index_add_` adds in index order).
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
from repro.models import moe as jmoe
from repro.models.model import build_model as jbuild_model
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import skewmm
from repro_torch.core.config import mm_config
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.serve import engine
from repro_torch.sparse.costmodel import SparseMatmulCost

RTOL = ATOL = 1e-5

VARIANTS = {
    "base": {},
    "drops": {"capacity_factor": 0.5},
    "shared": {"n_shared_experts": 1},
    "gelu": {"mlp_type": "gelu"},
}


def _configs(**overrides):
    jcfg = dataclasses.replace(jget_config("dbrx-132b").reduced(), **overrides)
    cfg = dataclasses.replace(get_config("dbrx-132b").reduced(), **overrides)
    assert jcfg.__dict__ == cfg.__dict__
    return jcfg, cfg


def _moe_weights(jcfg, seed=4):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tree = {"moe": jax.tree.map(np.asarray, jp)}
    return jp, params_from_numpy(tree, "cpu")["moe"]


def _x(shape, seed):
    return (np.random.default_rng(seed).normal(size=shape) * 0.5).astype(
        np.float32)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_mlp_matches_jax(variant, backend):
    jcfg, cfg = _configs(**VARIANTS[variant])
    jp, tp = _moe_weights(jcfg)
    x = _x((2, 32, cfg.d_model), seed=12)
    with jmm_config(backend="xla"), jskewmm.plan_capture() as jlog:
        jy, jaux = jmoe.moe_mlp(jnp.asarray(x), jp, jcfg)
    with mm_config(backend=backend), skewmm.plan_capture() as log, \
            moe.routing_capture() as routes:
        y, aux = moe.moe_mlp(torch.tensor(x), tp, cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=RTOL, atol=0)
    # the same workload is planned: grouped and dense plans alike
    jgrouped = sum(type(c).__name__ == "SparseMatmulCost" for c in jlog)
    grouped = sum(isinstance(c, SparseMatmulCost) for c in log)
    assert grouped == jgrouped == (3 if cfg.mlp_type == "swiglu" else 2)
    assert len(log) == len(jlog)
    dropped = int(routes[0]["dropped"])
    if variant == "drops":
        assert dropped > 0          # capacity 8 against ~16 copies/expert
    else:
        assert dropped == 0


def test_capacity_matches_jax():
    jcfg, cfg = _configs()
    for t in (1, 4, 8, 63, 64, 512, 4096):
        for factor in (0.5, 1.0, 1.25, 2.0):
            j = dataclasses.replace(jcfg, capacity_factor=factor)
            c = dataclasses.replace(cfg, capacity_factor=factor)
            assert moe._capacity(t, c) == jmoe._capacity(t, j)


def test_equal_routes_drop_by_stable_order():
    """Every token routes to experts 0 and 1 (a router that reads only
    feature 0, set to 1 in every token), so each expert's sort keys all
    tie and capacity keeps exactly the first tokens in token order, as
    JAX's stable sort does."""
    jcfg, cfg = _configs(capacity_factor=0.5)
    jp, tp = _moe_weights(jcfg)
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    router[0, 0], router[0, 1] = 4.0, 2.0
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.tensor(router))
    x = _x((1, 40, cfg.d_model), seed=13)
    x[..., 0] = 1.0
    jy, _ = jmoe.moe_mlp(jnp.asarray(x), jp, jcfg)
    with moe.routing_capture() as routes:
        y, _ = moe.moe_mlp(torch.tensor(x), tp, cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    cap = moe._capacity(40, cfg)
    assert int(routes[0]["dropped"]) == 2 * (40 - cap)
    assert np.all(y.numpy()[0, cap:] == 0)
    assert np.all(np.abs(y.numpy()[0, :cap]).max(-1) > 0)


def test_forward_hidden_aux_matches_jax():
    """The whole MoE LM's forward: hidden states and the summed aux loss."""
    jcfg, cfg = _configs()
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(5))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(14).integers(0, cfg.vocab_size, (2, 12))
    with jmm_config(backend="xla"):
        jh, jaux = jbuild_model(jcfg).hidden_fn(
            jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    h, aux = build_model(cfg, "cpu").hidden_fn(tp, {"tokens":
                                                    torch.tensor(toks)})
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5, atol=0)
    assert aux.item() > 0


def test_mla_moe_config_builds_and_serves_one_step():
    """dbrx's reduced MoE config with MLA attention (deepseek's reduced
    latent widths) builds, prefills and decodes one step on the CPU, on
    an MLA cache: finite logits of the vocabulary's width."""
    ds = get_config("deepseek-v3-671b").reduced()
    cfg = dataclasses.replace(
        get_config("dbrx-132b").reduced(), use_mla=True,
        **{f: getattr(ds, f) for f in ("q_lora_rank", "kv_lora_rank",
                                       "qk_nope_dim", "qk_rope_dim",
                                       "v_head_dim")})
    params = build_model(cfg, "cpu").init(0)
    toks = torch.tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 6)))
    cache, logits = engine.prefill(params, cfg, toks, max_len=8)
    assert set(cache["stage0"]["b0"]) == {"latent", "k_rope"}
    logits, cache = engine.decode_step(params, cfg, cache,
                                       torch.argmax(logits, -1), 6)
    assert tuple(logits.shape) == (2, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert bool(cache["stage0"]["b0"]["latent"][:, :, 6].abs().sum() > 0)
