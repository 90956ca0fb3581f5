"""Decoder-only LM assembly: a Python loop over the layers.

Parameters are a plain dict: ``embed``, ``final_norm``, optional
``unembed``, optional ``mtp`` (deepseek's multi-token-prediction head:
``proj``, ``norm`` and an ``attn_dense`` block), and per stage of
``cfg.stage_list()`` a list ``stage{si}`` of unit dicts ``{"b{i}": block
params}`` — the JAX package's stacked stage
arrays unstacked along the layer axis (see `repro_torch.convert`).
Each repeat runs in `stage_trace.repeat(r)`, so host records are made
once per stage site, as under the JAX package's `lax.scan`.
"""

from __future__ import annotations

import torch

from repro_torch.core import skewmm, stage_trace
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
    if cfg.mtp_heads:
        # deepseek-style MTP: next-next-token head = proj([h; emb]) + block
        params["mtp"] = {
            "proj": linear_init(gen, 2 * cfg.d_model, cfg.d_model, dt,
                                device),
            "norm": torch.zeros((cfg.d_model,), dtype=dt, device=device),
            "block": blocks.init_block(gen, cfg, "attn_dense", device),
        }
    return params


def layer_iter(params, cfg):
    """(kind, block params, stage index, repeat index, unit slot) for every
    decoder layer, in order."""
    for si, (unit, n) in enumerate(cfg.stage_list()):
        for r in range(n):
            for i, kind in enumerate(unit):
                yield kind, params[f"stage{si}"][r][f"b{i}"], si, r, i


def _lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """embed[tokens]; on a `DTensor` table, each rank looks up its own
    token rows in the whole table (gathered over the vocab split) and its
    table gradient is a pending sum over the ranks whose tokens differ."""
    if not hasattr(embed, "placements"):
        return embed[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = embed.device_mesh
    tok_place = (tokens.placements if hasattr(tokens, "placements")
                 else (Replicate(),) * mesh.ndim)
    table = embed.redistribute(mesh, (Replicate(),) * mesh.ndim).to_local(
        grad_placements=[Replicate() if p.is_replicate() else Partial()
                         for p in tok_place])
    local = tokens.to_local() if hasattr(tokens, "placements") else tokens
    return DTensor.from_local(table[local], mesh, tok_place,
                              run_check=False)


def embed_tokens(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    x = _lookup(params["embed"], tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def embed_inputs(params, cfg, tokens: torch.Tensor,
                 prefix_embeds: torch.Tensor | None = None):
    """tokens (B, S) [+ prefix_embeds (B, F, D), cast to the model dtype
    and put ahead of the tokens] -> (x (B, T, D), positions 0..T-1), with
    the sinusoidal table added where the config uses one."""
    x = embed_tokens(params, cfg, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return layers.add_pos(x, cfg, positions), positions


def forward_hidden(params, cfg, tokens: torch.Tensor, *,
                   prefix_embeds: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) [+ a VLM's prefix_embeds (B, F, D)] -> (hidden (B, T,
    D) after the final norm, T = F + S, the summed MoE aux loss, fp32
    scalar)."""
    x, positions = embed_inputs(params, cfg, tokens, prefix_embeds)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, p, _, r, _ in layer_iter(params, cfg):
        with stage_trace.repeat(r):
            x, aux = blocks.block_fwd(x, p, cfg, kind, positions)
        aux_total = aux_total + aux
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), aux_total


def unembed(params, cfg, h: torch.Tensor) -> torch.Tensor:
    """h (..., D) -> logits (..., V), final softcap applied, fp32.  A tied
    embedding is read as the strided view E^T (no copy)."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = skewmm.matmul(h, w, out_dtype=torch.float32)
    if cfg.final_softcap > 0.0:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def mtp_hidden(params, cfg, h: torch.Tensor, tokens: torch.Tensor
               ) -> torch.Tensor:
    """deepseek MTP: predict token t+2 from [h_t ; emb(token_{t+1})].
    h (B, S, D), tokens (B, S) -> (B, S-1, D)."""
    p = params["mtp"]
    emb_next = embed_tokens(params, cfg, tokens)[:, 1:]
    cat = torch.cat([rmsnorm(h[:, :-1], p["norm"], cfg.norm_eps), emb_next],
                    dim=-1)
    x = skewmm.matmul(cat, p["proj"])
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, _ = blocks.block_fwd(x, p["block"], cfg, "attn_dense", positions)
    return x
