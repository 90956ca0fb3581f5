"""Attention sublayers: GQA (the dense archs).  MLA is not ported yet."""

from __future__ import annotations

import torch

from repro_torch.core import config, skewmm
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.layers import apply_rope, linear_init, rope_freqs


def init_gqa(gen, cfg, device) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = layers.dtype_of(cfg)
    p = {
        "wq": linear_init(gen, d, h * hd, dt, device),
        "wk": linear_init(gen, d, kv * hd, dt, device),
        "wv": linear_init(gen, d, kv * hd, dt, device),
        "wo": linear_init(gen, h * hd, d, dt, device),
    }
    if cfg.attn_qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dt, device=device)
        p["bk"] = torch.zeros((kv * hd,), dtype=dt, device=device)
        p["bv"] = torch.zeros((kv * hd,), dtype=dt, device=device)
    return p


def gqa_project(x: torch.Tensor, p: dict, cfg, positions: torch.Tensor):
    """x (B,S,D) -> q (B,S,H,hd), k, v (B,S,KV,hd) with rope applied."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = skewmm.matmul(x, p["wq"])
    k = skewmm.matmul(x, p["wk"])
    v = skewmm.matmul(x, p["wv"])
    if cfg.attn_qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.pos_embedding == "rope":
        cos, sin = rope_freqs(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def sequence_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       cfg, *, window: int | None, positions: torch.Tensor,
                       causal: bool = True) -> torch.Tensor:
    """Attention of a whole sequence over itself: q (B, S, H, hd), k / v
    (B, S, KV, hd) at positions 0..S-1 -> ctx (B, S, H * hd).

    Under the "cuda" backend it runs `ops.flash_attention` (K7 on the
    card), which indexes rows and columns from 0 — the JAX package names
    its flash kernel as the runtime path here.  The "torch" backend keeps
    `blockwise_attention` on `positions`, the reference rung."""
    b, s = q.shape[:2]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if config.resolve().backend == "cuda":
        ctx = ops.flash_attention(qt, kt, vt, causal=causal, window=window,
                                  softcap=cfg.attn_softcap)
    else:
        ctx = layers.blockwise_attention(
            qt, kt, vt, causal=causal, window=window,
            softcap=cfg.attn_softcap, q_positions=positions,
            kv_positions=positions)
    return ctx.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)


def gqa_attn(x: torch.Tensor, p: dict, cfg, *, window: int | None,
             positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    q, k, v = gqa_project(x, p, cfg, positions)
    ctx = sequence_attention(q, k, v, cfg, window=window,
                             positions=positions, causal=causal)
    return skewmm.matmul(ctx, p["wo"])


def init_attn(gen, cfg, device) -> dict:
    if cfg.use_mla:
        raise NotImplementedError("MLA attention is not ported yet")
    return init_gqa(gen, cfg, device)


def attn(x, p, cfg, *, window, positions, causal=True):
    if cfg.use_mla:
        raise NotImplementedError("MLA attention is not ported yet")
    return gqa_attn(x, p, cfg, window=window, positions=positions,
                    causal=causal)
