"""Block dispatcher: one residual block, init + forward.

Ported kinds: attn_global | attn_local | attn_dense (dense FFN), attn_moe
(MoE FFN) and rec (the RG-LRU recurrent mixer, dense FFN).  SSM blocks
are not ported yet and raise.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention, layers, moe, rglru
from repro_torch.models.layers import rmsnorm

_KINDS = ("attn_global", "attn_local", "attn_dense", "attn_moe", "rec")


def ffn_is_moe(kind: str) -> bool:
    return kind.endswith("_moe")


def _check_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")


def init_block(gen, cfg, kind: str, device) -> dict:
    _check_kind(kind)
    dt = layers.dtype_of(cfg)
    d = cfg.d_model
    p: dict = {"ln1": torch.zeros((d,), dtype=dt, device=device)}
    if kind == "rec":
        p["mixer"] = rglru.init_rec(gen, cfg, device)
    else:
        p["attn"] = attention.init_attn(gen, cfg, device)
    p["ln2"] = torch.zeros((d,), dtype=dt, device=device)
    if ffn_is_moe(kind):
        p["moe"] = moe.init_moe(gen, cfg, device)
    else:
        p["mlp"] = layers.init_mlp(gen, cfg, device)
    if cfg.use_post_norm:
        p["post_ln1"] = torch.zeros((d,), dtype=dt, device=device)
        p["post_ln2"] = torch.zeros((d,), dtype=dt, device=device)
    return p


def block_fwd(x: torch.Tensor, p: dict, cfg, kind: str,
              positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual block: attention (or the recurrent mixer), then the FFN.
    A dense MLP fuses the residual add into its down projection's epilogue
    (when there is no post-norm).  Returns (x, aux_loss): the MoE router's
    aux loss, 0 for a dense FFN."""
    _check_kind(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind == "rec":
        h = rglru.rec_mixer(h, p["mixer"], cfg)
    else:
        window = cfg.local_window if kind == "attn_local" else None
        h = attention.attn(h, p["attn"], cfg, window=window,
                           positions=positions)
    if cfg.use_post_norm:
        h = rmsnorm(h, p["post_ln1"], cfg.norm_eps)
    x = x + h
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if ffn_is_moe(kind):
        h, aux = moe.moe_mlp(h, p["moe"], cfg)
    elif not cfg.use_post_norm:
        return layers.mlp(h, p["mlp"], cfg, residual=x), aux
    else:
        h = layers.mlp(h, p["mlp"], cfg)
    if cfg.use_post_norm:
        h = rmsnorm(h, p["post_ln2"], cfg.norm_eps)
    return x + h, aux
