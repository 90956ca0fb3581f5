"""Serving engine for the encoder-decoder (seamless-m4t).

Prefill encodes the frames, computes each decoder layer's cross-attention
k / v once and runs the decoder over the prompt; decode advances one
decoder token against the self- and cross-attention caches.

The cache is a dict of four (L, B, ...) tensors, the layout of
`serve.kvcache`'s per-stage entries: ``self_k`` / ``self_v`` (L, B,
max_len, KV, hd) and ``cross_k`` / ``cross_v`` (L, B, F, H, hd).  As in
`serve.engine`, the cache is **updated in place**: `decode_step` writes
the new token's self k / v into the tensors it is given with tensor ops
(so `serve.graphs.DecodeGraph` can capture it) and never copies the cross
cache.

Both follow the JAX engine op for op: the decoder's MLP residual is not
fused in the serving path (it is in `models.encdec`'s forward), so the
plan logs of both packages stay equal.  Prefill self-attention and
cross-attention run K7 under the "cuda" backend; decode attention stays
`blockwise_attention`.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import config as mmcfg
from repro_torch.core import stage_trace
from repro_torch.distributed.sharding import constrain
from repro_torch.models import encdec, layers, transformer
from repro_torch.models.layers import rmsnorm
from repro_torch.serve import engine, kvcache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
               device, mesh=None) -> dict:
    """Zeroed self- and cross-attention caches for every decoder layer;
    with a `DeviceMesh`, `DTensor`s placed by the cache specs."""
    if mesh is not None:
        return kvcache.zeros_on(
            init_cache(cfg, batch, max_len, enc_len, "meta"), mesh)
    dt = layers.dtype_of(cfg)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def z(*shape):
        return torch.zeros((cfg.n_layers, batch) + shape, dtype=dt,
                           device=device)

    return {"self_k": z(max_len, kv, hd), "self_v": z(max_len, kv, hd),
            "cross_k": z(enc_len, h, hd), "cross_v": z(enc_len, h, hd)}


def _mlp(x, p, cfg):
    x = constrain(x, "dp", None, None)
    return constrain(x + layers.mlp(rmsnorm(x, p["ln2"], cfg.norm_eps),
                                    p["mlp"], cfg), "dp", None, None)


@torch.no_grad()
def prefill(params, cfg: ModelConfig, frames: torch.Tensor,
            tokens: torch.Tensor, *, max_len: int,
            mm: mmcfg.MatmulConfig | None = None):
    """frames (B, F, D), tokens (B, S) -> (cache, last-position logits
    (B, V) fp32).  The self caches hold positions [0, S) of max_len."""
    with mmcfg.scope(mm):
        enc_out = encdec.encode(params, cfg, frames)
        x, pos = encdec.embed_decoder(params, cfg, tokens)
        cache = init_cache(cfg, tokens.shape[0], max_len, frames.shape[1],
                           x.device, mesh=getattr(x, "device_mesh", None))
        for r, p in enumerate(params["dec"]):
            with stage_trace.repeat(r):
                h = rmsnorm(x, p["ln1"], cfg.norm_eps)
                x = constrain(x + engine._attn_prefill(
                    h, p["attn"], cfg, "attn_global", pos,
                    cache["self_k"][r], cache["self_v"][r]), "dp", None, None)
                h = rmsnorm(x, p["ln_x"], cfg.norm_eps)
                ck, cv = encdec.cross_kv(enc_out, p["xattn"], cfg)
                cache["cross_k"][r].copy_(ck)
                cache["cross_v"][r].copy_(cv)
                x = x + encdec.cross_attn(h, (ck, cv), p["xattn"], cfg)
                x = _mlp(x, p, cfg)
        h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return cache, transformer.unembed(params, cfg, h[:, -1])


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor, pos,
                mm: mmcfg.MatmulConfig | None = None):
    """One decoder token.  tokens (B,) int; pos an int / 0-d tensor (the
    position being generated) or (B,) per-row positions.  Returns (logits
    (B, V) fp32, cache) — the self caches are written in place."""
    with mmcfg.scope(mm):
        x = params["embed"][tokens[:, None]]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
        x = layers.add_pos(x, cfg, pos.reshape(-1, 1))
        for r, p in enumerate(params["dec"]):
            with stage_trace.repeat(r):
                h = rmsnorm(x, p["ln1"], cfg.norm_eps)
                x = x + engine._decode_gqa(
                    h, p["attn"], cfg, cache["self_k"][r],
                    cache["self_v"][r], pos, None)
                h = rmsnorm(x, p["ln_x"], cfg.norm_eps)
                x = x + encdec.cross_attn(
                    h, (cache["cross_k"][r], cache["cross_v"][r]),
                    p["xattn"], cfg, decode=True)
                x = _mlp(x, p, cfg)
        h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return transformer.unembed(params, cfg, h[:, 0]), cache
