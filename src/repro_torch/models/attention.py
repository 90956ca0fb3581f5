"""Attention sublayers: GQA (the dense archs), MLA (deepseek-v3) and the
encoder-decoder's cross-attention route.

Prefill attention runs K7 (`ops.flash_attention`) under the "cuda" backend
and `blockwise_attention` under "torch"; decode attention lives in
`repro_torch.serve.engine` and reuses the projection helpers here."""

from __future__ import annotations

import torch

from repro_torch.core import config, skewmm
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.layers import (apply_rope, linear_init, rmsnorm,
                                      rope_freqs)


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
    q = sharding.split_last(q, h, hd)
    k = sharding.split_last(k, kv, hd)
    v = sharding.split_last(v, kv, hd)
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
    def attend(q, k, v):
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if config.resolve().backend == "cuda":
            ctx = ops.flash_attention(qt, kt, vt, causal=causal,
                                      window=window, softcap=cfg.attn_softcap)
        else:
            ctx = layers.blockwise_attention(
                qt, kt, vt, causal=causal, window=window,
                softcap=cfg.attn_softcap, q_positions=positions,
                kv_positions=positions)
        return ctx.transpose(1, 2)

    ctx = per_head(attend, q, k, v)
    return sharding.merge_last(ctx, cfg.n_heads * cfg.head_dim)


def per_head(attend, q, k, v):
    """`attend(q, k, v)` -> (B, S, H, hd); on `DTensor`s, run on each
    rank's batch rows and heads (attention is independent across both, as
    under the JAX package's shard_map; `sharding.on_local_blocks`): every
    other dim (a decode cache's positions too) is gathered first, and
    heads stay split over "model" where q's head count divides by it.
    Where k / v's does not (fewer kv heads than "model" ranks, as MQA),
    k / v stay whole on each rank and a rank attends with the one kv head
    its q heads share, as XLA's partitioner splits the grouped product;
    their gradient is then a pending sum over "model".  Plain tensors go
    straight through."""
    spec = ("dp", None, "model", None)
    mesh = next((t.device_mesh for t in (q, k, v)
                 if hasattr(t, "placements")), None)
    split = sharding.axis_sizes(mesh).get("model", 1) if mesh else 1
    hq, hkv = q.shape[2], k.shape[2]
    group = hq // hkv
    if split == 1 or hkv % split == 0 or hq % split or \
            group % (hq // split):
        return sharding.on_local_blocks(attend, (q, k, v), (spec,) * 3,
                                        (spec,))

    def attend_group(ql, kl, vl):
        j = mesh.get_local_rank("model") * ql.shape[2] // group
        return attend(ql, kl[:, :, j:j + 1], vl[:, :, j:j + 1])

    whole = ("dp", None, None, None)
    return sharding.on_local_blocks(
        attend_group, (q, k, v), (spec, whole, whole), (spec,),
        grad_sum=((), ("model",), ("model",)))


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cfg) -> torch.Tensor:
    """Attention of Sq query rows over Skv other positions, no mask and
    no softcap: q (B, Sq, H, hd), k / v (B, Skv, KV, hd) -> ctx (B, Sq,
    H * hd).

    The sibling of `sequence_attention` for the encoder-decoder's
    cross-attention, where Sq != Skv.  With no causal mask or window,
    K7's columns indexed from 0 are exact, so the "cuda" backend runs
    `ops.flash_attention(causal=False)`; "torch" keeps
    `blockwise_attention`, as the JAX package does."""
    def attend(q, k, v):
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if config.resolve().backend == "cuda":
            ctx = ops.flash_attention(qt, kt, vt, causal=False)
        else:
            ctx = layers.blockwise_attention(qt, kt, vt, causal=False)
        return ctx.transpose(1, 2)

    ctx = per_head(attend, q, k, v)
    return sharding.merge_last(ctx, cfg.n_heads * cfg.head_dim)


def gqa_attn(x: torch.Tensor, p: dict, cfg, *, window: int | None,
             positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    q, k, v = gqa_project(x, p, cfg, positions)
    ctx = sequence_attention(q, k, v, cfg, window=window,
                             positions=positions, causal=causal)
    return skewmm.matmul(ctx, p["wo"])


# --------------------------------------------------------------------- MLA
def init_mla(gen, cfg, device) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = layers.dtype_of(cfg)
    return {
        "wq_a": linear_init(gen, d, qr, dt, device),
        "q_norm": torch.zeros((qr,), dtype=dt, device=device),
        "wq_b": linear_init(gen, qr, h * (nope + rope_d), dt, device),
        # kv_a projects to the latent and the shared (MQA-style) rope key
        "wkv_a": linear_init(gen, d, kvr + rope_d, dt, device),
        "kv_norm": torch.zeros((kvr,), dtype=dt, device=device),
        "wkv_b": linear_init(gen, kvr, h * (nope + vd), dt, device),
        "wo": linear_init(gen, h * vd, d, dt, device),
    }


def mla_latent(x: torch.Tensor, p: dict, cfg, positions: torch.Tensor):
    """Compressed cache entries: latent (B, S, kvr), rope key (B, S, rd)."""
    kvr, rd = cfg.kv_lora_rank, cfg.qk_rope_dim
    kv_a = skewmm.matmul(x, p["wkv_a"])
    latent = rmsnorm(kv_a[..., :kvr], p["kv_norm"], cfg.norm_eps)
    cos, sin = rope_freqs(positions, rd, cfg.rope_theta)
    k_rope = apply_rope(kv_a[..., kvr:][..., None, :], cos, sin)[..., 0, :]
    return latent, k_rope


def mla_queries(x: torch.Tensor, p: dict, cfg, positions: torch.Tensor):
    """q_nope (B, S, H, nope), q_rope (B, S, H, rd)."""
    b, s, _ = x.shape
    h, nope, rd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    # constrained so that rmsnorm's backward hands wq_a's gradient back in
    # this layout (DTensor's mm rule refuses the strided one it can pick)
    q_a = sharding.constrain(skewmm.matmul(x, p["wq_a"]), "dp", None, "model")
    q = rmsnorm(q_a, p["q_norm"], cfg.norm_eps)
    q = skewmm.matmul(q, p["wq_b"]).reshape(b, s, h, nope + rd)
    cos, sin = rope_freqs(positions, rd, cfg.rope_theta)
    return q[..., :nope], apply_rope(q[..., nope:], cos, sin)


def mla_attn(x: torch.Tensor, p: dict, cfg, *, positions: torch.Tensor,
             causal: bool = True, window: int | None = None) -> torch.Tensor:
    """Prefill MLA: the latent expanded to full K / V, then attention at
    q / k width nope + rd and v width vd, scaled by (nope + rd)^-0.5.
    Under the "cuda" backend it runs `ops.flash_attention` (K7 on the
    card), else `blockwise_attention` on `positions`, as in
    `sequence_attention`."""
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = mla_queries(x, p, cfg, positions)
    latent, k_rope = mla_latent(x, p, cfg, positions)
    kv = skewmm.matmul(latent, p["wkv_b"]).reshape(b, s, h, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    # queries / keys concat [nope, rope]; the rope key is shared by heads
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, rd)],
                  dim=-1)
    scale = (nope + rd) ** -0.5

    def attend(q, k, v):
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if config.resolve().backend == "cuda":
            ctx = ops.flash_attention(qt, kt, vt, causal=causal,
                                      window=window,
                                      softcap=cfg.attn_softcap, scale=scale)
        else:
            ctx = layers.blockwise_attention(
                qt, kt, vt, causal=causal, window=window,
                softcap=cfg.attn_softcap, scale=scale,
                q_positions=positions, kv_positions=positions)
        return ctx.transpose(1, 2)

    ctx = sharding.merge_last(per_head(attend, q, k, v), h * vd)
    return skewmm.matmul(ctx, p["wo"])


def init_attn(gen, cfg, device) -> dict:
    return (init_mla if cfg.use_mla else init_gqa)(gen, cfg, device)


def attn(x, p, cfg, *, window, positions, causal=True):
    if cfg.use_mla:
        return mla_attn(x, p, cfg, positions=positions, causal=causal,
                        window=window)
    return gqa_attn(x, p, cfg, window=window, positions=positions,
                    causal=causal)
