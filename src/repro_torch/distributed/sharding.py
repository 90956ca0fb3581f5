"""Logical-axis sharding rules for params, optimizer state, batches and
caches, and their placement on a `DeviceMesh`.

Megatron-style TP over the "model" axis; DP over ("pod", "data"); ZeRO-1
optimizer-state sharding over "data".  The rules are name-based over
parameter key paths (one rule table instead of a parallel spec tree), with
divisibility guards that fall back to replication, which is what makes the
same rules valid for full-size configs and tiny smoke configs alike.  They
are the JAX package's rules entry for entry.

A spec (`P`) is a tuple of entries, one per tensor dim: None, a mesh axis
name or a tuple of axis names.  The rules read only axis names and sizes,
so they take a `MeshShape` (names and sizes, no devices: what a one-host
caller prices a 256- or 512-chip mesh with) or a `DeviceMesh` alike.

Stacked layers: the JAX package stacks a stage's layers into one ``(R,
...)`` leaf and its rules prepend None for that dim.  The port keeps a list
of per-layer units (stacked only on disk, `checkpoint.ckpt`), so a leaf's
spec here is JAX's spec on the stacked leaf with the leading layer entries
dropped.  The rules run on the stacked shape (``layers`` gives the leading
dims), which keeps every guard, the ``>= 2``-D tests and the
``sharding.unmatched_params`` count exactly as JAX computes them.  Where a
JAX rule puts a mesh axis on a layer dim (a shared expert's stacked
weights read as an expert stack; FSDP / ZeRO picking the layer dim as the
largest), no per-layer tensor can hold that split: the leaf replicates
over that axis instead.

Placement: `to_placements` turns a spec into one `Shard(dim)` /
`Replicate()` per mesh dim; `shard_like` places a tree leaf by leaf with
`distribute_tensor`; `constrain` redistributes a `DTensor` to its guarded
placements under the annotation mesh and is the identity otherwise.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.tree import unflatten
from repro_torch.obs import metrics as _metrics


class P(tuple):
    """A partition spec: ``P("model", None)``, ``P(("pod", "data"), None)``.
    A one-axis tuple entry is stored as the axis name, as `PartitionSpec`
    stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class MeshShape:
    """A mesh of axis names and sizes only (JAX's ``AbstractMesh``)."""

    def __init__(self, sizes: tuple[int, ...], names: tuple[str, ...]):
        if len(sizes) != len(names):
            raise ValueError(f"{len(sizes)} sizes for {len(names)} axes")
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, (int(s) for s in sizes)))

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a `MeshShape` or a `DeviceMesh`."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel mesh axes (pod composes with data when present)."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


# Mesh for in-model sharding annotations (set by the trainer or a caller
# before a forward; None => constraints are no-ops and MoE layers take the
# single-device path).
_ANNOTATE_MESH = None


def set_annotation_mesh(mesh) -> None:
    global _ANNOTATE_MESH
    _ANNOTATE_MESH = mesh


def annotation_mesh():
    return _ANNOTATE_MESH


def constrain(x, *spec_entries):
    """The guarded layout of `x` under the annotation mesh.

    Entries may name mesh axes ("model", "dp" for the data axes) or None;
    entries whose axes don't divide the dim fall back to None.  A `DTensor`
    is redistributed to those placements; a plain tensor (one device's
    whole value) and any tensor without a `DeviceMesh` annotation pass
    through unchanged."""
    mesh = _ANNOTATE_MESH
    if mesh is None or isinstance(mesh, MeshShape):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    entries = [dp_axes(mesh) if e == "dp" else e for e in spec_entries]
    spec = _guard(P(*entries), tuple(x.shape), mesh)
    return x.redistribute(mesh, to_placements(spec, mesh))


def pad(x, widths: tuple, value: float = 0.0):
    """`F.pad(x, widths, value=value)`; a `DTensor` is padded rank by rank
    with its placements kept (a padded dim split over the mesh is gathered
    first, and a pending sum when the fill is not 0).  DTensor's own pad
    rule in torch 2.11 gives one placement on an n-D mesh."""
    import torch.nn.functional as F
    if not hasattr(x, "placements"):
        return F.pad(x, widths, value=value)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    padded = {x.ndim - 1 - i // 2 for i, w in enumerate(widths) if w}
    place = [Replicate() if (isinstance(p, Shard) and p.dim in padded)
             or (p.is_partial() and value != 0) else p
             for p in x.placements]
    local = x.redistribute(x.device_mesh, place).to_local()
    return DTensor.from_local(F.pad(local, widths, value=value),
                              x.device_mesh, place, run_check=False)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _guard(spec: P, shape: tuple[int, ...], mesh) -> P:
    """Replace any spec entry whose mesh-axis product doesn't divide the
    corresponding dim with None (replicate that dim).

    A spec *longer* than the shape is a rule bug, not a divisibility
    problem: silently truncating it would shard fewer dims than asked
    with no signal, so it raises instead."""
    entries = tuple(spec)
    if len(entries) > len(shape):
        raise ValueError(
            f"PartitionSpec {spec} has {len(entries)} entries for a "
            f"{len(shape)}-D shape {shape}; spec must not outrank the value")
    fixed = []
    for dim, axes in zip(shape, entries + (None,) * (len(shape) - len(entries))):
        fixed.append(axes if dim % _axis_size(mesh, axes) == 0 else None)
    return P(*fixed)


# ---------------------------------------------------------------- params
# (match-by-name, ndim) -> spec builder.  Stacked layer dims are handled by
# prepending None for every leading dim beyond the rule's arity.
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "in_z", "in_x", "in_dt",
        "proj_x", "proj_gate", "wq_b", "wkv_b", "wq_a"}
_ROW = {"wo", "w_down", "out_proj", "proj_out"}
_VOCAB_ROW = {"embed"}          # (V, D): shard vocab
_VOCAB_COL = {"unembed"}        # (D, V): shard vocab
_EXPERT = {"w_gate", "w_up", "w_down"}   # under "moe": (E, ...) shard E
_SHARD_LAST_VEC = {"bq", "bk", "bv", "out_norm", "a_param"}
_BLOCKDIAG = {"w_r", "w_i"}     # (nb, bw, bw): shard nb


def _stacked_param_spec(path_names, shape: tuple[int, ...], mesh) -> P:
    """JAX's `param_spec` on a leaf of `shape` (stacked dims included)."""
    name = path_names[-1]
    ndim = len(shape)

    def base(rule: P, arity: int) -> P:
        lead = (None,) * (ndim - arity)
        return _guard(P(*lead, *tuple(rule)), shape, mesh)

    if "moe" in path_names and name in _EXPERT and ndim >= 3:
        return base(P("model", None, None), 3)
    if name in _VOCAB_ROW:
        return base(P("model", None), 2)
    if name in _VOCAB_COL:
        return base(P(None, "model"), 2)
    if name in _BLOCKDIAG and ndim >= 3:
        return base(P("model", None, None), 3)
    if name in _COL and ndim >= 2:
        return base(P(None, "model"), 2)
    if name in _ROW and ndim >= 2:
        return base(P("model", None), 2)
    if name in _SHARD_LAST_VEC and ndim >= 1:
        return base(P("model"), 1)
    if name in ("conv_w", "conv_x") and ndim >= 2:
        return base(P(None, "model"), 2)
    if ndim >= 2:
        # An unrecognized >=2-D weight replicates silently: the safe
        # fallback, but on a real mesh it costs memory and collective
        # bandwidth, so the registry counts every fall-through.
        _metrics.REGISTRY.inc("sharding.unmatched_params")
    return P(*(None,) * ndim)


def _unstack(spec: P, n_layers: int) -> P:
    """The per-layer spec: the stacked spec without its layer entries (a
    layer entry that names an axis cannot split a list: replicated)."""
    return P(*tuple(spec)[n_layers:])


def param_spec(path_names: list[str], leaf, mesh, *,
               layers: tuple[int, ...] = ()) -> P:
    """The spec of one per-layer leaf at key path `path_names`; `layers`
    are the stacked dims the JAX package's tree puts in front of it."""
    shape = tuple(layers) + tuple(leaf.shape)
    return _unstack(_stacked_param_spec(path_names, shape, mesh), len(layers))


def _walk(tree, names: tuple, layers: tuple):
    """(key names, leaf, stacked dims) of every tensor leaf, in
    `core.tree.leaves` order; a list of per-layer units adds one stacked
    dim of its length."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, names + (str(k),), layers)
    elif isinstance(tree, list):
        for unit in tree:
            yield from _walk(unit, names, layers + (len(tree),))
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _walk(v, names, layers)
    else:
        yield names, tree, layers


def tree_param_specs(shapes, mesh, *, fsdp: bool = False):
    """A tree of specs matching a tree of tensors (meta tensors will do).

    fsdp=True additionally shards the largest still-replicated dim of every
    >=2-D weight (stacked dims counted) over "data" (ZeRO-3 / FSDP).  The
    units of a list share one spec a key path, made once, as JAX makes one
    for the stacked leaf (and counts an unmatched one once)."""
    specs, made = [], {}
    for names, leaf, layers in _walk(shapes, (), ()):
        shape = tuple(layers) + tuple(leaf.shape)
        if (names, shape) not in made:
            spec = _stacked_param_spec(list(names), shape, mesh)
            if fsdp and len(shape) >= 2:
                spec = zero1_spec(spec, shape, mesh)
            made[names, shape] = _unstack(spec, len(layers))
        specs.append(made[names, shape])
    return unflatten(shapes, specs)


# ----------------------------------------------------------- optimizer state
def zero1_spec(spec: P, shape: tuple[int, ...], mesh) -> P:
    """ZeRO-1: additionally shard the largest replicated dim over "data".

    No-op when the spec already consumes the data axis (FSDP params)."""
    entries = list(tuple(spec) + (None,) * (len(shape) - len(spec)))
    for e in entries:
        axes = (e,) if isinstance(e, str) else (e or ())
        if "data" in axes:
            return P(*entries)
    dsize = _axis_size(mesh, "data")
    best, best_dim = -1, -1
    for i, (dim, axes) in enumerate(zip(shape, entries)):
        if axes is None and dim % dsize == 0 and dim > best:
            best, best_dim = dim, i
    if best_dim >= 0 and best >= dsize:
        entries[best_dim] = "data"
    return P(*entries)


def tree_optstate_specs(param_specs, shapes, mesh):
    """ZeRO-1 specs of the moments: `zero1_spec` of each param spec on the
    stacked shape, the layer entries dropped after."""
    out = []
    spec_leaves = iter(_spec_leaves(param_specs))
    for _names, leaf, layers in _walk(shapes, (), ()):
        sp = next(spec_leaves)
        shape = tuple(layers) + tuple(leaf.shape)
        stacked = zero1_spec(P(*(None,) * len(layers), *sp), shape, mesh)
        out.append(_unstack(stacked, len(layers)))
    return unflatten(shapes, out)


def _spec_leaves(tree):
    """The `P` leaves of a spec tree, in `_walk` order."""
    if isinstance(tree, P):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _spec_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _spec_leaves(v)


# ----------------------------------------------------------------- batches
def batch_spec(shape: tuple[int, ...], mesh) -> P:
    """Shard dim0 (global batch) over DP axes when divisible."""
    dp = dp_axes(mesh)
    if shape[0] % _axis_size(mesh, dp) == 0:
        return P(dp, *(None,) * (len(shape) - 1))
    return P(*(None,) * len(shape))


def tree_batch_specs(batch: dict, mesh) -> dict:
    return {k: batch_spec(tuple(v.shape), mesh) for k, v in batch.items()}


# ----------------------------------------------------------------- caches
def cache_leaf_spec(name: str, leaf, mesh) -> P:
    """Cache leaves carry a leading stacked-layer dim R, then batch.

    k/v (R,B,L,KV,hd): heads over model if divisible, else L over model.
    latent/k_rope (R,B,L,r): L over model.
    state (R,B,H,S,P): H over model.  lru (R,B,W): W over model.
    conv (R,B,K-1,C): C over model.  cross k/v (R,B,F,H,hd): heads.
    """
    shape = tuple(leaf.shape)
    dp = dp_axes(mesh)
    b_ax = dp if shape[1] % _axis_size(mesh, dp) == 0 else None
    msz = _axis_size(mesh, "model")
    if name in ("k", "v", "self_k", "self_v", "cross_k", "cross_v"):
        if shape[3] % msz == 0:
            return _guard(P(None, b_ax, None, "model", None), shape, mesh)
        return _guard(P(None, b_ax, "model", None, None), shape, mesh)
    if name in ("latent", "k_rope"):
        return _guard(P(None, b_ax, "model", None), shape, mesh)
    if name == "state":
        return _guard(P(None, b_ax, "model", None, None), shape, mesh)
    if name == "lru":
        return _guard(P(None, b_ax, "model"), shape, mesh)
    if name in ("conv", "cx"):
        return _guard(P(None, b_ax, None, "model"), shape, mesh)
    if name in ("cb", "cc"):
        return _guard(P(None, b_ax, None, None), shape, mesh)
    return P(*(None,) * len(shape))


def tree_cache_specs(cache: dict, mesh) -> dict:
    """Specs of a cache tree (``{stage: {slot: {leaf name: tensor}}}``)."""
    return {k: (cache_leaf_spec(k, v, mesh) if hasattr(v, "shape")
                else tree_cache_specs(v, mesh))
            for k, v in cache.items()}


# ------------------------------------------------------------- assembling
def to_placements(spec: P, mesh) -> tuple:
    """One `Shard(dim)` / `Replicate()` per mesh dim of a `DeviceMesh`: a
    mesh axis named in spec entry `dim` shards that dim; a dim split over
    two axes, ``("pod", "data")``, is `Shard(dim)` on both."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for dim, axes in enumerate(tuple(spec)):
        for a in ((axes,) if isinstance(axes, str) else (axes or ())):
            where[a] = dim
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in axis_names(mesh))


def place(x: torch.Tensor, spec: P, mesh):
    """`x` (the whole value, on every rank) as a `DTensor` by `spec`."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, to_placements(spec, mesh))


def map_specs(fn, tree, specs) -> Any:
    """`fn(leaf, spec)` over a tree and its spec tree (a spec tree's
    leaves are `P`s, or None for a leaf that is left as it is)."""
    if specs is None or isinstance(specs, P):
        return fn(tree, specs)
    if isinstance(specs, dict):
        return {k: map_specs(fn, tree[k], v) for k, v in specs.items()}
    out = [map_specs(fn, t, sp) for t, sp in zip(tree, specs)]
    if hasattr(tree, "_fields"):                # a NamedTuple
        return type(tree)(*out)
    return type(tree)(out)


def shard_like(tree, specs, mesh) -> Any:
    """Place a tree of whole tensors leaf by leaf by a spec tree (a leaf
    whose spec is None stays as it is)."""
    return map_specs(lambda x, s: x if s is None else place(x, s, mesh),
                     tree, specs)


# ------------------------------------------------- planner bridge (ShardSpec)
def matmul_shard_spec(mesh, *, batch_axes=None, m_axes=None, k_axes=None,
                      n_axes=None, partials: str = "all_reduce",
                      zero3: bool = False):
    """Derive the planner's `costmodel.ShardSpec` from named mesh axes.

    Each kwarg names the mesh axis (or tuple of axes) a matmul dim is
    split over; the shard count is the product of those axis sizes: e.g. a
    Megatron column-parallel GEMM on mesh (data=4, model=2) is
    ``matmul_shard_spec(mesh, batch_axes="data", n_axes="model")``.  Works
    with `MeshShape` too: only axis sizes are read, no devices."""
    from repro_torch.core.costmodel import ShardSpec

    return ShardSpec(
        m=_axis_size(mesh, m_axes), k=_axis_size(mesh, k_axes),
        n=_axis_size(mesh, n_axes), batch=_axis_size(mesh, batch_axes),
        partials=partials, zero3=zero3)


def tp_matmul_spec(mesh, kind: str, *, dp: bool = True):
    """The two Megatron tensor-parallel GEMM conventions as ShardSpecs.

    kind="col": column-parallel (wq/w_up...), N over "model".
    kind="row": row-parallel (wo/w_down...), K over "model", partials
    all-reduced.  `dp` additionally splits batch over the data axes when
    the mesh has them."""
    if kind not in ("col", "row"):
        raise ValueError(f"kind must be 'col' or 'row', got {kind!r}")
    batch_axes = None
    if dp:
        present = tuple(a for a in dp_axes(mesh) if a in axis_names(mesh))
        batch_axes = present or None
    if kind == "col":
        return matmul_shard_spec(mesh, batch_axes=batch_axes, n_axes="model")
    return matmul_shard_spec(mesh, batch_axes=batch_axes, k_axes="model",
                             partials="all_reduce")
