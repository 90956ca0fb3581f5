"""The port's sharding rules (`repro_torch.distributed.sharding`) against
the JAX package's, at full size, as arithmetic over axis sizes: nothing
is allocated (the port's params and caches on the meta device, JAX's as
ShapeDtypeStructs, its meshes `AbstractMesh`es).

  * every param leaf of the eleven configs on meshes (1, 1), (4, 2),
    (16, 16) and (pod, data, model) (2, 16, 16), fsdp off and on: the
    port's spec is JAX's spec on the stacked leaf with its leading layer
    entries dropped, entry for entry, and `sharding.unmatched_params`
    counts the same.  JAX names a mesh axis on a layer dim in two cases
    only, both listed: a shared expert's stacked (R, D, F) weights read as
    an expert stack (R over "model"), and FSDP / ZeRO choosing R as the
    largest replicated dim; a per-layer tensor cannot hold that split;
  * the moments' ZeRO-1 specs (`tree_optstate_specs`);
  * `batch_spec` at divisible and non-divisible batches;
  * `cache_leaf_spec` for every cache leaf name, and `tree_cache_specs` of
    every arch's serving cache;
  * `matmul_shard_spec` / `tp_matmul_spec` field for field, `_guard`'s
    ValueError, and `to_placements`.

JAX's param trees are built from the port's meta tensors, stacked as JAX
stacks a stage; tests/test_torch_accounting.py holds that this tree
equals JAX's `eval_shape` tree path for path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs.base import get_config as jget_config
from repro.core import costmodel as jcostmodel
from repro.distributed import sharding as jshd
from repro.obs import metrics as jmetrics
from repro.serve import encdec_engine as jencdec_engine
from repro.serve import kvcache as jkvcache
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.models.model import param_shapes
from repro_torch.obs import metrics
from repro_torch.serve import encdec_engine, kvcache

MESHES = [((1, 1), ("data", "model")), ((4, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["1x1", "4x2", "16x16", "2x16x16"]

_SHAPES: dict = {}


def _port_shapes(arch):
    if arch not in _SHAPES:
        _SHAPES[arch] = param_shapes(get_config(arch))
    return _SHAPES[arch]


def _jax_tree(tree):
    """The port's meta tree as JAX's: each per-layer list one stacked
    leaf per key path."""
    if isinstance(tree, torch.Tensor):
        return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.float32)
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    units = [_jax_tree(u) for u in tree]
    return jax.tree.map(lambda *xs: jax.ShapeDtypeStruct(
        (len(xs),) + xs[0].shape, jnp.float32), *units)


def _jax_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {tuple(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in flat}


def _port_specs(shapes, specs) -> dict:
    """{key names: (spec, number of stacked dims)} of the port's tree; the
    units of a list share one spec a key path."""
    out = {}
    for (names, _leaf, layers), spec in zip(shd._walk(shapes, (), ()),
                                            shd._spec_leaves(specs)):
        assert out.setdefault(names, (tuple(spec), len(layers))) == \
            (tuple(spec), len(layers)), names
    return out


def _layer_axis(names, jspec, n, fsdp):
    """Why JAX named an axis on a layer dim (one of the two known
    cases)."""
    lead = jspec[:n]
    if "moe" in names and "shared" in names and lead[-1] == "model":
        return "shared expert read as an expert stack"
    if fsdp and "data" in lead:
        return "fsdp chose the layer dim"
    raise AssertionError((names, jspec))


def _compare(shapes, specs, jspecs, fsdp) -> list:
    port = _port_specs(shapes, specs)
    assert set(port) == set(jspecs), set(port) ^ set(jspecs)
    cases = []
    for names, jspec in jspecs.items():
        spec, n = port[names]
        assert spec == jspec[n:], (names, spec, jspec)
        if any(e is not None for e in jspec[:n]):
            cases.append(_layer_axis(names, jspec, n, fsdp))
    return cases


@pytest.mark.parametrize("mesh_dims", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax(arch, mesh_dims):
    sizes, names = mesh_dims
    shapes = _port_shapes(arch)
    jtree = _jax_tree(shapes)
    jmesh, mesh = AbstractMesh(sizes, names), shd.MeshShape(sizes, names)
    for fsdp in (False, True):
        jmetrics.REGISTRY.reset()
        metrics.REGISTRY.reset()
        jspecs = _jax_specs(jshd.tree_param_specs(jtree, jmesh, fsdp=fsdp))
        specs = shd.tree_param_specs(shapes, mesh, fsdp=fsdp)
        unmatched = metrics.REGISTRY.value("sharding.unmatched_params")
        assert unmatched == jmetrics.REGISTRY.value(
            "sharding.unmatched_params"), (arch, fsdp)
        cases = _compare(shapes, specs, jspecs, fsdp)
        if arch == "deepseek-v3-671b" and sizes == (4, 2):
            # the shared expert's three weights, R = 58 over "model"
            assert cases.count("shared expert read as an expert stack") \
                == 3, cases
        # the moments: ZeRO-1 over "data" on the stacked shape
        if not fsdp:
            jmu = _jax_specs(jshd.tree_optstate_specs(
                jshd.tree_param_specs(jtree, jmesh), jtree, jmesh))
            _compare(shapes, shd.tree_optstate_specs(specs, shapes, mesh),
                     jmu, True)
    metrics.REGISTRY.reset()
    jmetrics.REGISTRY.reset()


def test_param_spec_single_leaf_and_stacked_dims():
    """`param_spec` on one per-layer leaf: the stacked dims it is told of
    decide the rule as they do in JAX (a per-layer vector is 2-D there)."""
    mesh, jmesh = shd.MeshShape((4, 2), ("data", "model")), \
        AbstractMesh((4, 2), ("data", "model"))
    leaf = torch.empty((64, 128), device="meta")
    for names, layers in ((["stage0", "b0", "attn", "wq"], (6,)),
                          (["embed"], ()), (["stage1", "b0", "moe", "w_up"],
                                            ()),
                          (["stage0", "b0", "mixer", "conv_w"], (3,)),
                          (["stage0", "b0", "odd"], (2,))):
        jleaf = jax.ShapeDtypeStruct(tuple(layers) + (64, 128), jnp.float32)
        want = tuple(jshd.param_spec(names, jleaf, jmesh))
        got = shd.param_spec(names, leaf, mesh, layers=layers)
        assert tuple(got) == want[len(layers):], names
    metrics.REGISTRY.reset()
    jmetrics.REGISTRY.reset()


@pytest.mark.parametrize("mesh_dims", MESHES, ids=MESH_IDS)
def test_batch_specs_equal_jax(mesh_dims):
    sizes, names = mesh_dims
    jmesh, mesh = AbstractMesh(sizes, names), shd.MeshShape(sizes, names)
    for shape in ((512, 4096), (256, 128), (32, 7), (7, 128), (4,),
                  (1, 3, 5), (48, 16, 16), (1024,)):
        assert tuple(shd.batch_spec(shape, mesh)) == \
            tuple(jshd.batch_spec(shape, jmesh)), shape
    batch = {"tokens": torch.empty((64, 32), device="meta"),
             "frames": torch.empty((3, 8, 16), device="meta")}
    jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
              for k, v in batch.items()}
    jspecs = jshd.tree_batch_specs(jbatch, jmesh)
    assert {k: tuple(v) for k, v in shd.tree_batch_specs(batch, mesh).items()
            } == {k: tuple(v) for k, v in jspecs.items()}


# every cache leaf name at its rank (R, B, ...); "other" at each rank
_CACHE_NAMES = {5: ("k", "v", "self_k", "self_v", "cross_k", "cross_v",
                    "state", "other"),
                4: ("latent", "k_rope", "conv", "cx", "cb", "cc", "other"),
                3: ("lru", "other")}


@pytest.mark.parametrize("mesh_dims", MESHES, ids=MESH_IDS)
def test_cache_leaf_specs_equal_jax(mesh_dims):
    """Divisible and non-divisible batches, heads, lengths and widths."""
    sizes, names = mesh_dims
    jmesh, mesh = AbstractMesh(sizes, names), shd.MeshShape(sizes, names)
    shapes = {3: [(4, 32, 64), (2, 7, 33), (38, 64, 4096)],
              4: [(4, 64, 4096, 512), (2, 7, 100, 64), (3, 32, 3, 5120),
                  (61, 64, 4096, 64)],
              5: [(4, 64, 4096, 32, 128), (2, 8, 4096, 8, 128),
                  (2, 7, 30, 3, 64), (64, 16, 80, 128, 64)]}
    n = 0
    for rank, leaf_names in _CACHE_NAMES.items():
        for name in leaf_names:
            for shape in shapes[rank]:
                leaf = torch.empty(shape, device="meta")
                jleaf = jax.ShapeDtypeStruct(shape, jnp.float32)
                assert tuple(shd.cache_leaf_spec(name, leaf, mesh)) == \
                    tuple(jshd.cache_leaf_spec(name, jleaf, jmesh)), \
                    (name, shape)
                n += 1
    assert n == 3 * 2 + 4 * 7 + 4 * 8


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tree_cache_specs_equal_jax(arch):
    """Each arch's serving cache at full width (batch 64, 4096 positions)
    on the (16, 16) and (2, 16, 16) meshes."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    if cfg.family == "encdec":
        cache = encdec_engine.init_cache(cfg, 64, 4096, 1024, "meta")
        jcache = jax.eval_shape(
            lambda: jencdec_engine.init_cache(jcfg, 64, 4096, 1024))
    else:
        cache = kvcache.init_cache(cfg, 64, 4096, "meta")
        jcache = jax.eval_shape(lambda: jkvcache.init_cache(jcfg, 64, 4096))
    for sizes, names in MESHES[2:]:
        jspecs = _jax_specs(jshd.tree_cache_specs(
            jcache, AbstractMesh(sizes, names)))
        specs = shd.tree_cache_specs(cache, shd.MeshShape(sizes, names))
        flat = {}

        def walk(t, path):
            if isinstance(t, shd.P):
                flat[path] = tuple(t)
            else:
                for k, v in t.items():
                    walk(v, path + (k,))
        walk(specs, ())
        assert flat == jspecs


@pytest.mark.parametrize("mesh_dims", MESHES, ids=MESH_IDS)
def test_shard_specs_equal_jax(mesh_dims):
    sizes, names = mesh_dims
    jmesh, mesh = AbstractMesh(sizes, names), shd.MeshShape(sizes, names)
    fields = [f.name for f in dataclasses.fields(jcostmodel.ShardSpec)]
    calls = [dict(), dict(batch_axes="data", n_axes="model"),
             dict(m_axes="data", k_axes="model", partials="reduce_scatter"),
             dict(batch_axes=("data",), k_axes="model", zero3=True),
             dict(n_axes=("data", "model"))]
    if "pod" in names:
        calls.append(dict(batch_axes=("pod", "data"), n_axes="model"))
    for kw in calls:
        got = shd.matmul_shard_spec(mesh, **kw)
        want = jshd.matmul_shard_spec(jmesh, **kw)
        assert [getattr(got, f) for f in fields] == \
            [getattr(want, f) for f in fields], kw
    for kind in ("col", "row"):
        for dp in (True, False):
            got = shd.tp_matmul_spec(mesh, kind, dp=dp)
            want = jshd.tp_matmul_spec(jmesh, kind, dp=dp)
            assert [getattr(got, f) for f in fields] == \
                [getattr(want, f) for f in fields], (kind, dp)
    with pytest.raises(ValueError, match="kind"):
        shd.tp_matmul_spec(mesh, "diag")


def test_guard_raises_on_a_spec_longer_than_the_value():
    mesh = shd.MeshShape((4, 2), ("data", "model"))
    jmesh = AbstractMesh((4, 2), ("data", "model"))
    with pytest.raises(ValueError, match="must not outrank"):
        shd._guard(shd.P("data", "model", None), (8, 8), mesh)
    with pytest.raises(ValueError, match="must not outrank"):
        jshd._guard(JP("data", "model", None), (8, 8), jmesh)
    assert tuple(shd._guard(shd.P("data", "model"), (6, 8), mesh)) == \
        tuple(jshd._guard(JP("data", "model"), (6, 8), jmesh)) == \
        (None, "model")


def test_to_placements_and_constrain_without_a_mesh():
    from torch.distributed.tensor import Replicate, Shard
    mesh = shd.MeshShape((2, 4, 2), ("pod", "data", "model"))
    assert shd.to_placements(shd.P(("pod", "data"), None, "model"), mesh) \
        == (Shard(0), Shard(0), Shard(2))
    assert shd.to_placements(shd.P(None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    assert shd.dp_axes(mesh) == ("pod", "data")
    x = torch.ones(4, 4)
    assert shd.constrain(x, "dp", "model") is x
    shd.set_annotation_mesh(mesh)        # shape-only: still the identity
    try:
        assert shd.constrain(x, "dp", "model") is x
    finally:
        shd.set_annotation_mesh(None)
