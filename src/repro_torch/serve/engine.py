"""Serving engine: prefill + single-token decode for the dense GQA archs.

`prefill` runs the full-sequence forward while filling the KV cache;
`decode_step` advances one token against it.  Unlike the JAX package's
pure functions, the cache is **updated in place**: `decode_step` writes
the new token's k/v into the cache tensors it is given (and returns the
same dict), so no per-step copy of the cache is made.

Both follow the JAX engine op for op (the MLP's residual add is not fused
in the serving path there, so it is not fused here either), so their
logits compare with the reference's at the same weights.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import config as mmcfg
from repro_torch.core import skewmm
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, transformer
from repro_torch.models.layers import rmsnorm
from repro_torch.serve import kvcache


def _check(cfg: ModelConfig) -> None:
    if cfg.use_mla or cfg.family != "dense" or cfg.pos_embedding != "rope":
        raise NotImplementedError(
            f"{cfg.name}: only dense GQA archs with rope are ported")


def _attn_prefill(h, p, cfg, kind, positions, k_dst, v_dst):
    window = cfg.local_window if kind == "attn_local" else None
    q, k, v = attn_mod.gqa_project(h, p, cfg, positions)
    kvcache.place_kv(k_dst, k)
    kvcache.place_kv(v_dst, v)
    b, s, _ = h.shape
    ctx = layers.blockwise_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=window, softcap=cfg.attn_softcap,
        q_positions=positions, kv_positions=positions)
    ctx = ctx.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    return skewmm.matmul(ctx, p["wo"])


def _ffn(x, p, cfg):
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    h = layers.mlp(h, p["mlp"], cfg)
    if cfg.use_post_norm:
        h = rmsnorm(h, p["post_ln2"], cfg.norm_eps)
    return x + h


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, *, max_len: int,
            last_index: torch.Tensor | None = None,
            mm: mmcfg.MatmulConfig | None = None):
    """tokens (B, S) -> (cache, last-position logits (B, V) fp32).

    The cache is sized for max_len with positions [0, S) filled.
    `last_index` (B,) selects a per-row logit position (right-padded
    prompts).  `mm` scopes a matmul configuration over the prefill.
    """
    _check(cfg)
    with mmcfg.scope(mm):
        b, s = tokens.shape
        x = transformer.embed_tokens(params, cfg, tokens)
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        cache = kvcache.init_cache(cfg, b, max_len, x.device)
        for kind, p, si, r, i in transformer.layer_iter(params, cfg):
            entry = cache[f"stage{si}"][f"b{i}"]
            h = rmsnorm(x, p["ln1"], cfg.norm_eps)
            h = _attn_prefill(h, p["attn"], cfg, kind, positions,
                              entry["k"][r], entry["v"][r])
            if cfg.use_post_norm:
                h = rmsnorm(h, p["post_ln1"], cfg.norm_eps)
            x = _ffn(x + h, p, cfg)
        h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        if last_index is None:
            last = h[:, -1]
        else:
            last = h[torch.arange(b, device=h.device), last_index]
        return cache, transformer.unembed(params, cfg, last)


def _decode_gqa(h, p, cfg: ModelConfig, k_cache, v_cache, pos, window):
    """h (B, 1, D); k_cache/v_cache (B, L, KV, hd), written in place; pos
    a 0-d int tensor or (B,) per-row positions."""
    b = h.shape[0]
    clen = k_cache.shape[1]
    is_ring = window is not None
    if pos.dim() == 0:
        q_pos = pos.reshape(1)
        q, k_new, v_new = attn_mod.gqa_project(h, p, cfg, q_pos)
        slot = (torch.remainder(pos, clen) if is_ring else pos).reshape(1)
        k_cache.index_copy_(1, slot.long(), k_new)
        v_cache.index_copy_(1, slot.long(), v_new)
    else:
        q_pos = pos[:, None]
        q, k_new, v_new = attn_mod.gqa_project(h, p, cfg, q_pos)
        slot = torch.remainder(pos, clen) if is_ring else pos
        rows = torch.arange(b, device=h.device)
        k_cache[rows, slot.long()] = k_new[:, 0]
        v_cache[rows, slot.long()] = v_new[:, 0]
    kv_pos = kvcache.kv_slot_positions(pos, clen, is_ring)
    ctx = layers.blockwise_attention(
        q.transpose(1, 2), k_cache.transpose(1, 2), v_cache.transpose(1, 2),
        causal=True, window=window, softcap=cfg.attn_softcap,
        q_positions=q_pos, kv_positions=kv_pos)
    ctx = ctx.transpose(1, 2).reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return skewmm.matmul(ctx, p["wo"])


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor, pos,
                mm: mmcfg.MatmulConfig | None = None):
    """One decode step.  tokens (B,) int; pos an int / 0-d tensor (the
    absolute position being generated) or (B,) per-row positions.
    Returns (logits (B, V) fp32, cache) — the cache is updated in place."""
    _check(cfg)
    with mmcfg.scope(mm):
        x = transformer.embed_tokens(params, cfg, tokens[:, None])
        pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
        for kind, p, si, r, i in transformer.layer_iter(params, cfg):
            entry = cache[f"stage{si}"][f"b{i}"]
            window = cfg.local_window if kind == "attn_local" else None
            h = rmsnorm(x, p["ln1"], cfg.norm_eps)
            h = _decode_gqa(h, p["attn"], cfg, entry["k"][r], entry["v"][r],
                            pos, window)
            if cfg.use_post_norm:
                h = rmsnorm(h, p["post_ln1"], cfg.norm_eps)
            x = _ffn(x + h, p, cfg)
        h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return transformer.unembed(params, cfg, h[:, 0]), cache
