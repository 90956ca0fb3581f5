"""The parameter accounting of `repro_torch.models.model` against the JAX
package's: `count_params`, `param_shapes`, `count_params_active` and
`model_flops`, for every entry of ARCH_IDS at full size.

`param_shapes` runs the port's init on the meta device (nothing is
allocated); its tree, with each per-layer list read as one stacked leaf,
has JAX's `eval_shape` leaves path for path (shape and dtype).  The
counts and MODEL_FLOPS are equal exactly (integers, and floats made from
the same integers).  The published totals of tests/test_smoke_archs.py
hold, and deepseek-v3's active count; every expert stack of the MoE
archs has ``moe`` in its key path, as JAX's tree has, so the k/E
discount finds it in the port's per-layer lists too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS as JARCH_IDS
from repro.configs.base import get_config as jget_config
from repro.models import model as jmodel
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import model

PUBLISHED = {  # published totals, tolerance 6%, as in test_smoke_archs.py
    "mamba2-2.7b": 2.7e9, "phi4-mini-3.8b": 3.8e9,
    "granite-34b": 34e9, "gemma2-27b": 27.2e9,
    "dbrx-132b": 132e9, "deepseek-v3-671b": 671e9,
    "internvl2-1b": 0.49e9, "recurrentgemma-9b": 9.0e9,
}


@functools.lru_cache(maxsize=None)
def _jshapes(arch: str):
    """JAX's eval_shape tree, once per arch (deepseek-v3's takes ~40 s)."""
    return jmodel.param_shapes(jget_config(arch))


def _jax_leaves(shapes) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = tuple(getattr(k, "key", str(k)) for k in path)
        out[names] = (tuple(leaf.shape), jnp.dtype(leaf.dtype).name)
    return out


def _port_leaves(tree, names=()) -> dict:
    """The port's tree as JAX stacks it: a per-layer list becomes one leaf
    per key path with the layer count as a leading dim."""
    if isinstance(tree, torch.Tensor):
        return {names: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, names + (k,)))
        return out
    per_layer = [_port_leaves(t, names) for t in tree]
    return {k: ((len(tree),) + shape, dt)
            for k, (shape, dt) in per_layer[0].items()}


def test_arch_ids_equal_jax():
    assert sorted(ARCH_IDS) == sorted(JARCH_IDS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shapes_equal_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    shapes = model.param_shapes(cfg)
    assert all(t.device.type == "meta"
               for t in _port_leaves_tensors(shapes))
    assert _port_leaves(shapes) == _jax_leaves(_jshapes(arch))


def _port_leaves_tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    else:
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _port_leaves_tensors(v)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_active_and_model_flops_equal_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    shapes, jshapes = model.param_shapes(cfg), _jshapes(arch)
    got = model.count_params_active(cfg, shapes)
    assert got == jmodel.count_params_active(jcfg, jshapes)
    assert all(isinstance(x, int) for x in got)
    assert model.count_params(shapes) == got[0]
    for mode in ("train", "serve"):
        for tokens in (1, 4096):
            f = model.model_flops(cfg, tokens=tokens, mode=mode,
                                  shapes=shapes)
            assert isinstance(f, float)
            assert f == jmodel.model_flops(jcfg, tokens=tokens, mode=mode,
                                           shapes=jshapes)


@pytest.mark.parametrize("arch,active,flops", [
    ("internvl2-1b", 493780992, 987561984.0),
    ("seamless-m4t-large-v2", 1369776128, 2739552256.0),
])
def test_new_families_counts(arch, active, flops):
    cfg = get_config(arch)
    assert model.count_params_active(cfg) == (active, active)
    assert model.model_flops(cfg, tokens=1, mode="serve") == flops


def test_published_totals_and_moe_active():
    for arch, want in PUBLISHED.items():
        total, _ = model.count_params_active(get_config(arch))
        assert abs(total - want) / want < 0.06, (arch, total, want)
    total, active = model.count_params_active(get_config("deepseek-v3-671b"))
    assert active < 40e9 and total > 600e9


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v3-671b"])
def test_expert_stacks_sit_under_moe(arch):
    """Every (E, ., .) expert stack of the port's per-layer lists has
    ``moe`` in its key path, and the discount counts each at k/E."""
    cfg = get_config(arch)
    shapes = model.param_shapes(cfg)
    n_stacks = 0
    for names, n, ndim in model._stacked_leaves(shapes):
        if names[-1] in ("w_gate", "w_up", "w_down") and ndim >= 4:
            assert "moe" in names, names
            n_stacks += 1
    assert n_stacks == 3 * sum(1 for unit, _ in cfg.stage_list()
                               for kind in unit if kind.endswith("_moe"))
    total, active = model.count_params_active(cfg, shapes)
    assert total > active


def test_count_params_of_a_built_model_equals_jax():
    """On real tensors too: the reduced config's weights carried over from
    JAX count what JAX counts."""
    jcfg = jget_config("seamless-m4t-large-v2").reduced()
    jp = jmodel.build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert model.count_params(tp) == jmodel.count_params(jp)
    cfg = get_config("internvl2-1b").reduced()
    jp = jmodel.build_model(jget_config(cfg.name[:-6]).reduced()).init(
        jax.random.PRNGKey(0))
    assert model.count_params(model.build_model(cfg, "cpu").init(0)) == \
        jmodel.count_params(jp)
