"""Block dispatcher: one residual block, init + forward.

Ported kinds: attn_global | attn_local (dense FFN).  MoE, SSM and RG-LRU
blocks are not ported yet and raise.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention, layers
from repro_torch.models.layers import rmsnorm

_KINDS = ("attn_global", "attn_local", "attn_dense")


def _check_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")


def init_block(gen, cfg, kind: str, device) -> dict:
    _check_kind(kind)
    dt = layers.dtype_of(cfg)
    d = cfg.d_model
    p: dict = {"ln1": torch.zeros((d,), dtype=dt, device=device),
               "attn": attention.init_attn(gen, cfg, device),
               "ln2": torch.zeros((d,), dtype=dt, device=device),
               "mlp": layers.init_mlp(gen, cfg, device)}
    if cfg.use_post_norm:
        p["post_ln1"] = torch.zeros((d,), dtype=dt, device=device)
        p["post_ln2"] = torch.zeros((d,), dtype=dt, device=device)
    return p


def block_fwd(x: torch.Tensor, p: dict, cfg, kind: str,
              positions: torch.Tensor) -> torch.Tensor:
    """Residual block: attention, then the MLP with the residual add fused
    into the down projection's epilogue (when there is no post-norm)."""
    _check_kind(kind)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    window = cfg.local_window if kind == "attn_local" else None
    h = attention.attn(h, p["attn"], cfg, window=window, positions=positions)
    if cfg.use_post_norm:
        h = rmsnorm(h, p["post_ln1"], cfg.norm_eps)
    x = x + h
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if not cfg.use_post_norm:
        return layers.mlp(h, p["mlp"], cfg, residual=x)
    h = rmsnorm(layers.mlp(h, p["mlp"], cfg), p["post_ln2"], cfg.norm_eps)
    return x + h
