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
`distributes` says where a trainer or a loader places at all: on a mesh
of more than one rank.
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


def distributes(mesh) -> bool:
    """Whether a trainer or a loader places its tensors on `mesh`: a
    `DeviceMesh` of more than one rank.  Without a mesh, and on a mesh of
    one rank, the state and the batches stay plain tensors on the
    device and a step is the one-device step (no `DTensor` dispatch, no
    annotation mesh), as XLA's program over a one-device mesh is the
    one-device program.  `place`, `shard_like` and `on_local_blocks`
    called directly still place on any mesh."""
    return mesh is not None and mesh.size() > 1


# Mesh for in-model sharding annotations (set by a trainer on more than
# one rank, or a caller, before a forward; None => constraints are no-ops
# and MoE layers take the single-device path).
_ANNOTATE_MESH = None


def set_annotation_mesh(mesh) -> None:
    global _ANNOTATE_MESH
    _ANNOTATE_MESH = mesh


def annotation_mesh():
    return _ANNOTATE_MESH


def on_mesh(fn, mesh):
    """`fn` run with `mesh` as the annotation mesh and plain tensors
    (positions, masks, scalars) taken as replicated, as a step runs on a
    mesh's global-view `DTensor`s."""
    def run(*args):
        from torch.distributed.tensor.experimental import implicit_replication
        prev = annotation_mesh()
        set_annotation_mesh(mesh)
        try:
            with implicit_replication():
                return fn(*args)
        finally:
            set_annotation_mesh(prev)
    return run


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


def on_local_blocks(fn, args, in_specs, out_specs, *, grad_sum=None,
                    out_sum=(), mesh=None):
    """``fn(*args)``.  Where an arg is a `DTensor`, `fn` runs instead on
    each rank's block, as torch's `local_map` does: the one place an op
    that DTensor's own rules cannot split (attention by heads, the SSD
    scan) or splits worse than XLA's partitioner (a row-split projection,
    whose backward DTensor computes whole on each rank) is run rank by
    rank.

    `in_specs` has one spec a arg and `out_specs` one a output of `fn`
    (a single tensor, or a tuple of them): tuples of entries as
    `constrain` takes them ("dp" for the data axes, "model", None).  An
    entry whose axes do not divide its dim in every arg that names it is
    dropped from every spec, inputs and outputs alike, so the blocks line
    up (heads split only where q's and k / v's head counts both divide).
    Each arg (a plain tensor taken as replicated) is laid out by its spec
    and handed to `fn` as this rank's block; each output comes back as a
    `DTensor` laid out by its own, and as a pending sum over the mesh
    axes in `out_sum` (a contraction split over them).

    The gradient of an arg's block is that block's own (the arg's
    placements), except over the mesh axes `grad_sum` names for it (one
    tuple of axis names a arg, "dp" for the data axes): there it is a
    pending sum, as where a weight is whole on every data rank and each
    rank's tokens differ.  `mesh` is the one the blocks are taken on
    where no arg is a `DTensor` (else their mesh; `fn(*args)` with
    neither)."""
    mesh = next((a.device_mesh for a in args if hasattr(a, "placements")),
                mesh)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    dp = dp_axes(mesh)
    names = axis_names(mesh)

    def entries(spec):
        return tuple(dp if e == "dp" else e for e in spec)

    def axes(given) -> set:
        return {a for e in entries(given) for a in
                ((e,) if isinstance(e, str) else e)}

    dropped = {e for a, spec in zip(args, in_specs)
               for dim, e in zip(a.shape, entries(spec))
               if e is not None and dim % _axis_size(mesh, e)}

    def placements(spec):
        return to_placements(P(*(None if e in dropped else e
                                 for e in entries(spec))), mesh)

    # a dropped axis splits nothing: no rank's block differs over it
    unsplit = axes(tuple(dropped))
    local = []
    for i, (a, spec) in enumerate(zip(args, in_specs)):
        if not hasattr(a, "placements"):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        place = placements(spec)
        summed = axes(grad_sum[i]) - unsplit if grad_sum else set()
        grad = [Partial() if n in summed else p
                for n, p in zip(names, place)]
        local.append(a.redistribute(mesh, place).to_local(
            grad_placements=grad))
    out = fn(*local)
    outs = out if isinstance(out, tuple) else (out,)
    summed = axes(out_sum) - unsplit
    placed = tuple(DTensor.from_local(
        o, mesh, [Partial() if n in summed else p
                  for n, p in zip(names, placements(spec))],
        run_check=False) for o, spec in zip(outs, out_specs))
    return placed if isinstance(out, tuple) else placed[0]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, whole.  Where a gradient is taken, a `DTensor` weight whose
    rows are split over "model" (the row-split projections: wo, w_down)
    is contracted on each rank's blocks and its pending sum reduced here,
    so that an epilogue (a fused residual) is applied once, after the sum:
    DTensor's own rule computes that product's backward whole on every
    "model" rank, where XLA's partitioner keeps both gradients split.  The
    weight's gradient on a rank is a pending sum over the data axes (each
    rank's rows of `a` differ).  A forward alone keeps DTensor's rule,
    whose forward is split already; plain tensors are `torch.matmul`."""
    place = getattr(b, "placements", None)
    if place is None or not torch.is_grad_enabled() or \
            not (a.requires_grad or b.requires_grad):
        return torch.matmul(a, b)
    from torch.distributed.tensor import Replicate, Shard
    mesh = b.device_mesh
    names = axis_names(mesh)
    if "model" not in names or place[names.index("model")] != Shard(0):
        return torch.matmul(a, b)
    lead = ("dp",) + (None,) * (a.ndim - 2)
    z = on_local_blocks(
        torch.matmul, (a, b), (lead + ("model",), ("model", None)),
        (lead + (None,),), grad_sum=((), ("dp",)), out_sum=("model",))
    return z.redistribute(mesh, [Replicate() if p.is_partial() else p
                                 for p in z.placements])


def spec_of(x) -> tuple:
    """The spec entries of a `DTensor`'s layout: for each dim, the mesh
    axes that split it (in mesh order) or None."""
    names = axis_names(x.device_mesh)
    return tuple(P(tuple(n for n, p in zip(names, x.placements)
                         if p.is_shard(d)) or None)[0]
                 for d in range(x.ndim))


def block_start(mesh, placements, dim: int, block: int) -> int:
    """The global index of this rank's first entry along `dim` of a
    tensor laid out by `placements`, split evenly into blocks of `block`
    (nested splits in mesh-dim order, as DTensor lays them out)."""
    from torch.distributed.tensor import Shard
    start = 0
    for i, p in enumerate(placements):
        if p == Shard(dim):
            start = start * mesh.size(i) + mesh.get_local_rank(i)
    return start * block


def write_slot(dst: torch.Tensor, dim: int, slot: torch.Tensor,
               src: torch.Tensor) -> None:
    """``dst.index_copy_(dim, slot, src)`` for one slot (a (1,) index
    tensor).  A `DTensor` (a cache) is written rank by rank: each rank
    writes its own block where `dim` is split over the mesh and the slot
    falls in it (tensor ops, no host read); DTensor's own in-place rule
    can re-place `dst` without moving its data."""
    if not hasattr(dst, "placements"):
        dst.index_copy_(dim, slot, src)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh, place = dst.device_mesh, dst.placements
    local = dst.to_local()
    block = local.shape[dim]
    offset = block_start(mesh, place, dim, block)
    src_place = [Replicate() if p == Shard(dim) else p for p in place]
    new = src.redistribute(mesh, src_place).to_local()
    at = (slot - offset).clamp(0, block - 1)
    inside = (slot >= offset) & (slot < offset + block)
    old = local.index_select(dim, at)
    local.index_copy_(dim, at, torch.where(inside, new, old))


def microbatch(v: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Rows [i B/n, (i+1) B/n) of a batch leaf.  A `DTensor` is gathered
    over the mesh dims that split its rows, sliced, and split again by the
    batch rule (as XLA reshards the JAX step's reshape): DTensor's view
    rule cannot split rows that 16 data ranks hold into 8 microbatches."""
    if not hasattr(v, "placements"):
        return v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
    from torch.distributed.tensor import Replicate, Shard
    mesh = v.device_mesh
    whole = v.redistribute(mesh, [Replicate() if p == Shard(0) else p
                                  for p in v.placements])
    rows = v.shape[0] // n
    part = whole[i * rows:(i + 1) * rows]
    return part.redistribute(
        mesh, to_placements(batch_spec(tuple(part.shape), mesh), mesh))


def split_last(x, *sizes):
    """`x.reshape(*x.shape[:-1], *sizes)`.  A `DTensor` whose last dim is
    split over a mesh dim that does not divide ``sizes[0]`` (24 heads over
    16 ranks) is first gathered over that mesh dim, as XLA's partitioner
    reshards such a reshape; DTensor's view rule refuses it."""
    shape = (*x.shape[:-1], *sizes)
    if not hasattr(x, "placements"):
        return x.reshape(shape)
    from torch.distributed.tensor import Replicate, Shard
    last = x.ndim - 1
    place = [Replicate() if isinstance(p, Shard) and p.dim == last
             and sizes[0] % x.device_mesh.size(i) else p
             for i, p in enumerate(x.placements)]
    if list(place) != list(x.placements):
        x = x.redistribute(x.device_mesh, place)
    return x.reshape(shape)


def merge_last(x, n: int):
    """`x` with its last two dims merged into one of `n`.  A `DTensor`'s
    gradient is handed back to the merge in the merged tensor's own
    placements (a redistribute to them, the identity forward): torch
    2.11's view rule refuses to split a gradient whose merged dim is
    sharded over a mesh dim that does not divide the heads."""
    out = x.reshape(*x.shape[:-2], n)
    if not hasattr(out, "placements"):
        return out
    return out.redistribute(out.device_mesh, out.placements)


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
    two axes, ``("pod", "data")``, is `Shard(dim)` on both.  An axis of
    size 1 splits nothing and is `Replicate()`: the same blocks, but
    DTensor's view rules refuse to squeeze or merge a dim `Shard`ed over
    it (a one-row batch on data axes of one rank), where XLA reads such
    a split as none."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = axis_sizes(mesh)
    where = {}
    for dim, axes in enumerate(tuple(spec)):
        for a in ((axes,) if isinstance(axes, str) else (axes or ())):
            where[a] = dim
    return tuple(Shard(where[a]) if a in where and sizes[a] > 1
                 else Replicate() for a in axis_names(mesh))


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
