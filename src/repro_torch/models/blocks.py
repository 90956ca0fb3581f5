"""Block dispatcher: one residual block, init + forward.

Ported kinds: attn_global | attn_local | attn_dense (dense FFN), attn_moe
(MoE FFN), rec (the RG-LRU recurrent mixer, dense FFN) and ssm (the
Mamba-2 mixer).  "ssm" blocks are mixer-only (mamba2 has no separate
FFN); every other kind carries an FFN.  Other kinds raise.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention, layers, moe, rglru, ssm
from repro_torch.models.layers import rmsnorm

_KINDS = ("attn_global", "attn_local", "attn_dense", "attn_moe", "rec",
          "ssm")


def has_ffn(kind: str) -> bool:
    return kind != "ssm"


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
    elif kind == "ssm":
        p["mixer"] = ssm.init_ssm(gen, cfg, device)
    else:
        p["attn"] = attention.init_attn(gen, cfg, device)
    if has_ffn(kind):
        p["ln2"] = torch.zeros((d,), dtype=dt, device=device)
        if ffn_is_moe(kind):
            p["moe"] = moe.init_moe(gen, cfg, device)
        else:
            p["mlp"] = layers.init_mlp(gen, cfg, device)
    if cfg.use_post_norm:
        p["post_ln1"] = torch.zeros((d,), dtype=dt, device=device)
        if has_ffn(kind):
            p["post_ln2"] = torch.zeros((d,), dtype=dt, device=device)
    return p


def block_fwd(x: torch.Tensor, p: dict, cfg, kind: str,
              positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual block: attention (or a recurrent / SSM mixer), then the FFN
    for every kind but "ssm".  A dense MLP fuses the residual add into its
    down projection's epilogue (when there is no post-norm).  Returns (x,
    aux_loss): the MoE router's aux loss, 0 for a dense FFN or none."""
    _check_kind(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = constrain(x, "dp", None, None)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind == "rec":
        h = rglru.rec_mixer(h, p["mixer"], cfg)
    elif kind == "ssm":
        h = ssm.ssm_mixer(h, p["mixer"], cfg)
    else:
        window = cfg.local_window if kind == "attn_local" else None
        h = attention.attn(h, p["attn"], cfg, window=window,
                           positions=positions)
    if cfg.use_post_norm:
        # constrained first so that the norm's backward hands the
        # projection a gradient in this layout (DTensor's mm rule refuses
        # the strided one it can pick); the identity without a mesh
        h = rmsnorm(constrain(h, "dp", None, None), p["post_ln1"],
                    cfg.norm_eps)
    x = constrain(x + h, "dp", None, None)
    if not has_ffn(kind):
        return x, aux
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if ffn_is_moe(kind):
        h, aux = moe.moe_mlp(h, p["moe"], cfg)
    elif not cfg.use_post_norm:
        return constrain(layers.mlp(h, p["mlp"], cfg, residual=x),
                         "dp", None, None), aux
    else:
        h = layers.mlp(h, p["mlp"], cfg)
    if cfg.use_post_norm:
        h = rmsnorm(constrain(h, "dp", None, None), p["post_ln2"],
                    cfg.norm_eps)
    return constrain(x + h, "dp", None, None), aux
