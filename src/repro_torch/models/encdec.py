"""Encoder-decoder transformer (the seamless-m4t backbone).

The encoder takes precomputed frame embeddings (the audio frontend is a
stub, as in the JAX package); the decoder is a causal LM with
cross-attention to the encoder's output.  Sinusoidal positions are added
to the frames and to the token embeddings, and no rope is applied.

Parameters are a plain dict: ``embed``, ``enc_norm``, ``final_norm``,
optional ``unembed``, and the lists ``enc`` and ``dec`` of per-layer
block dicts — the JAX package's stacked ``enc`` / ``dec`` arrays unstacked
along the layer axis (see `repro_torch.convert`).  Each layer runs in
`stage_trace.repeat(r)`, so host records are made once per encoder and
decoder site, as under the JAX package's two `lax.scan`s; with grad
enabled each layer is checkpointed (`remat.checkpointed`), as JAX's
`jax.checkpoint(enc_block)` / `jax.checkpoint(dec_block)`.

Encoder self-attention and prefill cross-attention are not causal; under
the "cuda" backend they run K7 (`attention.sequence_attention` and
`attention.cross_attention`), under "torch" `blockwise_attention`.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import skewmm, stage_trace
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention, layers, remat, transformer
from repro_torch.models.layers import (add_pos, embed_init, linear_init,
                                      rmsnorm)


def init_cross_attn(gen, cfg, device) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    dt = layers.dtype_of(cfg)
    return {
        "wq": linear_init(gen, d, h * hd, dt, device),
        "wk": linear_init(gen, d, h * hd, dt, device),
        "wv": linear_init(gen, d, h * hd, dt, device),
        "wo": linear_init(gen, h * hd, d, dt, device),
    }


def cross_attn(x: torch.Tensor, enc_kv, p: dict, cfg, *,
               decode: bool = False) -> torch.Tensor:
    """x (B, S, D) queries; enc_kv = (k, v), each (B, F, H, hd), computed
    once from the encoder's output (`cross_kv`).  `decode` keeps
    `blockwise_attention` on every backend, as every decode attention of
    the port does."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = skewmm.matmul(x, p["wq"]).reshape(b, s, h, hd)
    k, v = enc_kv
    if decode:
        ctx = attention.per_head(
            lambda q, k, v: layers.blockwise_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=False).transpose(1, 2),
            q, k, v).reshape(b, s, h * hd)
    else:
        ctx = attention.cross_attention(q, k, v, cfg)
    return skewmm.matmul(ctx, p["wo"])


def cross_kv(enc_out: torch.Tensor, p: dict, cfg):
    """enc_out (B, F, D) -> cross-attention k, v, each (B, F, H, hd)."""
    b, f, _ = enc_out.shape
    h, hd = cfg.n_heads, cfg.head_dim
    k = skewmm.matmul(enc_out, p["wk"]).reshape(b, f, h, hd)
    v = skewmm.matmul(enc_out, p["wv"]).reshape(b, f, h, hd)
    return k, v


def _init_enc_block(gen, cfg, device) -> dict:
    d, dt = cfg.d_model, layers.dtype_of(cfg)
    return {"ln1": torch.zeros((d,), dtype=dt, device=device),
            "attn": attention.init_gqa(gen, cfg, device),
            "ln2": torch.zeros((d,), dtype=dt, device=device),
            "mlp": layers.init_mlp(gen, cfg, device)}


def _init_dec_block(gen, cfg, device) -> dict:
    d, dt = cfg.d_model, layers.dtype_of(cfg)
    return {"ln1": torch.zeros((d,), dtype=dt, device=device),
            "attn": attention.init_gqa(gen, cfg, device),
            "ln_x": torch.zeros((d,), dtype=dt, device=device),
            "xattn": init_cross_attn(gen, cfg, device),
            "ln2": torch.zeros((d,), dtype=dt, device=device),
            "mlp": layers.init_mlp(gen, cfg, device)}


def init_encdec(cfg, gen: torch.Generator, device) -> dict:
    """Random weights drawn from `gen` on `device`."""
    dt = layers.dtype_of(cfg)
    params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "enc": [_init_enc_block(gen, cfg, device)
                for _ in range(cfg.enc_layers)],
        "dec": [_init_dec_block(gen, cfg, device)
                for _ in range(cfg.n_layers)],
        "enc_norm": torch.zeros((cfg.d_model,), dtype=dt, device=device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = linear_init(gen, cfg.d_model, cfg.vocab_size, dt,
                                        device)
    return params


def encode(params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, F, D) stub embeddings -> encoder output (B, F, D)."""
    pos = torch.arange(frames.shape[1], dtype=torch.int32,
                       device=frames.device)
    x = add_pos(frames.to(layers.dtype_of(cfg)), cfg, pos)

    def enc_block(p, x):
        x = constrain(x, "dp", None, None)
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        x = constrain(x + attention.gqa_attn(
            h, p["attn"], cfg, window=None, positions=pos,
            causal=False), "dp", None, None)
        h = rmsnorm(x, p["ln2"], cfg.norm_eps)
        # residual add fused into the down projection's epilogue
        return layers.mlp(h, p["mlp"], cfg, residual=x)

    for r, p in enumerate(params["enc"]):
        with stage_trace.repeat(r):
            x = remat.checkpointed(functools.partial(enc_block, p), x)
    return rmsnorm(constrain(x, "dp", None, None), params["enc_norm"],
                   cfg.norm_eps)


def embed_decoder(params, cfg, tokens: torch.Tensor):
    """tokens (B, S) -> (embedded tokens with positions added, positions
    0..S-1)."""
    pos = torch.arange(tokens.shape[1], dtype=torch.int32,
                       device=tokens.device)
    return add_pos(transformer.lookup(params["embed"], tokens), cfg,
                   pos), pos


def decode_hidden(params, cfg, tokens: torch.Tensor,
                  enc_out: torch.Tensor) -> torch.Tensor:
    """tokens (B, S), enc_out (B, F, D) -> hidden (B, S, D) after the final
    norm."""
    x, pos = embed_decoder(params, cfg, tokens)

    def dec_block(p, x):
        x = constrain(x, "dp", None, None)
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        x = constrain(x + attention.gqa_attn(
            h, p["attn"], cfg, window=None, positions=pos,
            causal=True), "dp", None, None)
        h = rmsnorm(x, p["ln_x"], cfg.norm_eps)
        x = constrain(x + cross_attn(
            h, cross_kv(enc_out, p["xattn"], cfg), p["xattn"], cfg),
            "dp", None, None)
        h = rmsnorm(x, p["ln2"], cfg.norm_eps)
        # residual add fused into the down projection's epilogue
        return layers.mlp(h, p["mlp"], cfg, residual=x)

    for r, p in enumerate(params["dec"]):
        with stage_trace.repeat(r):
            x = remat.checkpointed(functools.partial(dec_block, p), x)
    return rmsnorm(constrain(x, "dp", None, None), params["final_norm"],
                   cfg.norm_eps)


def forward_hidden(params, cfg, tokens: torch.Tensor, frames: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(hidden (B, S, D), a zero fp32 aux loss)."""
    enc_out = encode(params, cfg, frames)
    return (decode_hidden(params, cfg, tokens, enc_out),
            torch.zeros((), dtype=torch.float32, device=enc_out.device))
