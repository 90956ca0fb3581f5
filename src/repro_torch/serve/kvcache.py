"""Decode caches for the ported block kinds.

GQA caches are full (L = max_len) or ring (L = window) k/v tensors shaped
(R, B, L, KV, hd) per stage and unit slot, as in the JAX package:
``cache[f"stage{si}"][f"b{i}"]["k"]``.  Ring semantics: the token at
absolute position p lives in slot p % L; slot validity is recovered
arithmetically from the decode position (scalar, or (B,) per row).
An MLA block keeps the compressed entries instead: ``latent`` (R, B, L,
kv_lora_rank) and ``k_rope`` (R, B, L, qk_rope_dim), always full length.
A recurrent (``rec``) block keeps its fp32 scan state ``lru`` (R, B, W)
and its conv tail ``conv`` (R, B, K-1, W) of the last K-1 conv inputs.
A Mamba-2 (``ssm``) block keeps its fp32 SSD state ``state`` (R, B, H, S,
P) and the conv tails of its three segments: ``cx`` (R, B, K-1, d_inner),
``cb`` and ``cc`` (R, B, K-1, G * S).

The continuous-batching scheduler grows its live slab along the batch
axis (`pad_axis`) and hands out its rows through `SlotFreeList`.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


def attn_cache_len(cfg: ModelConfig, kind: str, max_len: int) -> int:
    if kind == "attn_local" and cfg.local_window:
        return min(max_len, cfg.local_window)
    return max_len


def kv_slot_positions(pos: torch.Tensor, cache_len: int,
                      is_ring: bool) -> torch.Tensor:
    """Absolute position held by each slot once the token at `pos` is
    written; invalid slots get -1.  Scalar pos -> (L,), (B,) -> (B, L)."""
    idx = torch.arange(cache_len, dtype=torch.int32, device=pos.device)
    pos = pos.to(torch.int32)[..., None]
    if not is_ring:
        return torch.where(idx <= pos, idx, -1)
    p = pos - torch.remainder(pos - idx, cache_len)
    return torch.where(p >= 0, p, -1)


def place_kv(dst: torch.Tensor, t: torch.Tensor) -> None:
    """Write t (B, S, ...) into the cache row dst (B, L, ...) in place: the
    last L tokens at slots pos % L (ring) or [0:S] (full, S <= L)."""
    s, cache_len = t.shape[1], dst.shape[1]
    if s <= cache_len:
        dst[:, :s] = t
        return
    # the last L tokens fill every slot once: a rotation (which a
    # `DTensor` cache also takes; DTensor cannot scatter into a split dim
    # in place)
    dst.copy_(torch.roll(t[:, s - cache_len:], (s - cache_len) % cache_len,
                         dims=1))


def pad_axis(t: torch.Tensor, axis: int, length: int) -> torch.Tensor:
    """A new zero tensor with `axis` of length `length` and `t` copied into
    its leading entries, on `t`'s device; `t` itself when it already has
    that length.  Used only when the scheduler's slab grows."""
    cur = t.shape[axis]
    if cur == length:
        return t
    if cur > length:
        raise ValueError(f"axis {axis} is {cur}, cannot pad to {length}")
    out = t.new_zeros(t.shape[:axis] + (length,) + t.shape[axis + 1:])
    out.narrow(axis, 0, cur).copy_(t)
    return out


class SlotFreeList:
    """Free-list over the rows of a live KV slab.

    The continuous-batching scheduler allocates one slab row per live
    request; finished requests return their row here and admissions pop
    the lowest free row (deterministic — replay-stable)."""

    def __init__(self, capacity: int):
        self._free = list(range(capacity))
        self.capacity = capacity

    def __len__(self) -> int:
        return len(self._free)

    def grow(self, new_capacity: int) -> None:
        if new_capacity < self.capacity:
            raise ValueError("free-list cannot shrink below capacity")
        self._free.extend(range(self.capacity, new_capacity))
        self._free.sort()
        self.capacity = new_capacity

    def alloc(self) -> int:
        if not self._free:
            raise IndexError("no free KV slots")
        self._free.sort()
        return self._free.pop(0)

    def release(self, slot: int) -> None:
        if not 0 <= slot < self.capacity or slot in self._free:
            raise ValueError(f"bad slot release: {slot}")
        self._free.append(slot)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     n_rep: int, device) -> dict:
    """Zeroed cache entry of one unit slot, stacked over its n_rep
    repeats."""
    dtype = layers.dtype_of(cfg)

    def z(*shape, dt=dtype):
        return torch.zeros((n_rep, batch) + shape, dtype=dt, device=device)

    if kind == "rec":
        return {"lru": z(cfg.lru_width, dt=torch.float32),
                "conv": z(cfg.conv_kernel - 1, cfg.lru_width)}
    if kind == "ssm":
        gs = cfg.ssm_groups * cfg.ssm_state
        return {"state": z(cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim,
                           dt=torch.float32),
                "cx": z(cfg.conv_kernel - 1, cfg.d_inner),
                "cb": z(cfg.conv_kernel - 1, gs),
                "cc": z(cfg.conv_kernel - 1, gs)}
    length = attn_cache_len(cfg, kind, max_len)
    if cfg.use_mla:
        return {"latent": z(length, cfg.kv_lora_rank),
                "k_rope": z(length, cfg.qk_rope_dim)}
    return {"k": z(length, cfg.n_kv_heads, cfg.head_dim),
            "v": z(length, cfg.n_kv_heads, cfg.head_dim)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device, mesh=None) -> dict:
    """Zeroed caches for every layer; with a `DeviceMesh`, `DTensor`s
    placed by `sharding.tree_cache_specs` (each rank allocates its
    shard)."""
    if mesh is not None:
        return zeros_on(init_cache(cfg, batch, max_len, "meta"), mesh)
    return {f"stage{si}": {f"b{i}": init_block_cache(cfg, kind, batch,
                                                     max_len, n, device)
                           for i, kind in enumerate(unit)}
            for si, (unit, n) in enumerate(cfg.stage_list())}


def zeros_on(shapes: dict, mesh) -> dict:
    """A cache tree of zeros shaped as `shapes` (meta tensors will do),
    each leaf a `DTensor` on `mesh` (its device) placed by its cache
    spec."""
    from torch.distributed.tensor import zeros

    from repro_torch.distributed import sharding
    specs = sharding.tree_cache_specs(shapes, mesh)
    return sharding.map_specs(
        lambda t, sp: zeros(tuple(t.shape), dtype=t.dtype, device_mesh=mesh,
                            placements=sharding.to_placements(sp, mesh)),
        shapes, specs)


def cache_bytes(cache) -> int:
    total = 0
    for stage in cache.values():
        for entry in stage.values():
            for t in entry.values():
                total += t.numel() * t.element_size()
    return total
