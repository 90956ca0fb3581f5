"""Decoder-only LM assembly: a Python loop over the layers.

Parameters are a plain dict: ``embed``, ``final_norm``, optional
``unembed``, and per stage of ``cfg.stage_list()`` a list ``stage{si}`` of
unit dicts ``{"b{i}": block params}`` — the JAX package's stacked stage
arrays unstacked along the layer axis (see `repro_torch.convert`).
"""

from __future__ import annotations

import torch

from repro_torch.core import skewmm
from repro_torch.models import blocks, layers
from repro_torch.models.layers import embed_init, linear_init, rmsnorm


def init_lm(cfg, gen: torch.Generator, device) -> dict:
    """Random weights drawn from `gen` on `device`."""
    dt = layers.dtype_of(cfg)
    params: dict = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = linear_init(gen, cfg.d_model, cfg.vocab_size, dt,
                                        device)
    for si, (unit, n) in enumerate(cfg.stage_list()):
        params[f"stage{si}"] = [
            {f"b{i}": blocks.init_block(gen, cfg, kind, device)
             for i, kind in enumerate(unit)}
            for _ in range(n)]
    return params


def layer_iter(params, cfg):
    """(kind, block params, stage index, repeat index, unit slot) for every
    decoder layer, in order."""
    for si, (unit, n) in enumerate(cfg.stage_list()):
        for r in range(n):
            for i, kind in enumerate(unit):
                yield kind, params[f"stage{si}"][r][f"b{i}"], si, r, i


def embed_tokens(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def forward_hidden(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> hidden (B, S, D) after the final norm."""
    if cfg.pos_embedding != "rope":
        raise NotImplementedError("only rope position embeddings are ported")
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for kind, p, *_ in layer_iter(params, cfg):
        x = blocks.block_fwd(x, p, cfg, kind, positions)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def unembed(params, cfg, h: torch.Tensor) -> torch.Tensor:
    """h (..., D) -> logits (..., V), final softcap applied, fp32.  A tied
    embedding is read as the strided view E^T (no copy)."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = skewmm.matmul(h, w, out_dtype=torch.float32)
    if cfg.final_softcap > 0.0:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits
