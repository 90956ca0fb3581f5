"""KV cache structures for the ported block kinds.

GQA caches are full (L = max_len) or ring (L = window) k/v tensors shaped
(R, B, L, KV, hd) per stage and unit slot, as in the JAX package:
``cache[f"stage{si}"][f"b{i}"]["k"]``.  Ring semantics: the token at
absolute position p lives in slot p % L; slot validity is recovered
arithmetically from the decode position (scalar, or (B,) per row).
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
    slots = torch.remainder(torch.arange(s - cache_len, s, device=t.device),
                            cache_len)
    dst[:, slots] = t[:, s - cache_len:]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> dict:
    """Zeroed GQA caches for every attention layer."""
    dtype = layers.dtype_of(cfg)
    cache: dict = {}
    for si, (unit, n) in enumerate(cfg.stage_list()):
        stage = {}
        for i, kind in enumerate(unit):
            length = attn_cache_len(cfg, kind, max_len)
            shape = (n, batch, length, cfg.n_kv_heads, cfg.head_dim)
            stage[f"b{i}"] = {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
        cache[f"stage{si}"] = stage
    return cache


def cache_bytes(cache) -> int:
    total = 0
    for stage in cache.values():
        for entry in stage.values():
            for t in entry.values():
                total += t.numel() * t.element_size()
    return total
