"""Serving engine: prefill + single-token decode for the GQA archs, with a
dense or an MoE FFN, for the RG-LRU hybrid (recurrent and local attention
blocks) and for the Mamba-2 SSM (mixer-only blocks, no FFN).

`prefill` runs the full-sequence forward while filling the cache;
`decode_step` advances one token against it.  Unlike the JAX package's
pure functions, the cache is **updated in place**: `decode_step` writes
the new token's k/v (or a recurrent or SSM block's state and conv tails)
into the cache tensors it is given (and returns the same dict), so no
per-step copy of the cache is made.

Prefill attention goes through `attention.sequence_attention` (K7 under
the "cuda" backend), the recurrent scan through `rglru.rec_mixer` (K6) and
the SSD scan through `ssm.ssm_mixer` (K8, which also returns the fp32
state for decode); decode attention stays `blockwise_attention` over the
cache positions, and the decode recurrences `rglru_decode_step` and
`ssd_decode_step`, as in the JAX package.

Both follow the JAX engine op for op (the FFN's residual add is not fused
in the serving path there, so it is not fused here either; the MoE aux
loss is discarded), so their logits compare with the reference's at the
same weights.

`guarded_decode_step` adds the serving-boundary NaN scrub of the JAX
engine: a step whose logits an armed fault scope poisoned is re-run on
the "torch" reference backend; any other non-finite step raises.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import config as mmcfg
from repro_torch.core import skewmm
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks, layers, moe, rglru, ssm, transformer
from repro_torch.models.layers import rmsnorm
from repro_torch.serve import kvcache


def _check(cfg: ModelConfig) -> None:
    if (cfg.use_mla or cfg.family not in ("dense", "moe", "hybrid", "ssm")
            or cfg.pos_embedding != "rope"):
        raise NotImplementedError(
            f"{cfg.name}: only dense, MoE and RG-LRU hybrid GQA archs with "
            f"rope, and the Mamba-2 SSM, are ported")


def _attn_prefill(h, p, cfg, kind, positions, k_dst, v_dst):
    window = cfg.local_window if kind == "attn_local" else None
    q, k, v = attn_mod.gqa_project(h, p, cfg, positions)
    kvcache.place_kv(k_dst, k)
    kvcache.place_kv(v_dst, v)
    ctx = attn_mod.sequence_attention(q, k, v, cfg, window=window,
                                      positions=positions)
    return skewmm.matmul(ctx, p["wo"])


def _rec_prefill(h, p, cfg, lru_dst, conv_dst):
    out, entry = rglru.rec_mixer(h, p, cfg, return_state=True)
    lru_dst.copy_(entry["lru"])
    conv_dst.copy_(entry["conv"])
    return out


def _ssm_entry(entry, r: int) -> dict:
    """Row r of an ssm cache entry: views that the engine writes in place."""
    return {key: t[r] for key, t in entry.items()}


def _ssm_prefill(h, p, cfg, dst):
    out, entry = ssm.ssm_mixer(h, p, cfg, return_state=True)
    for key, t in dst.items():
        t.copy_(entry[key])
    return out


def _ffn(x, p, cfg, kind):
    if not blocks.has_ffn(kind):
        return x
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if blocks.ffn_is_moe(kind):
        h, _ = moe.moe_mlp(h, p["moe"], cfg)
    else:
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
            if kind == "rec":
                h = _rec_prefill(h, p["mixer"], cfg, entry["lru"][r],
                                 entry["conv"][r])
            elif kind == "ssm":
                h = _ssm_prefill(h, p["mixer"], cfg, _ssm_entry(entry, r))
            else:
                h = _attn_prefill(h, p["attn"], cfg, kind, positions,
                                  entry["k"][r], entry["v"][r])
            if cfg.use_post_norm:
                h = rmsnorm(h, p["post_ln1"], cfg.norm_eps)
            x = _ffn(x + h, p, cfg, kind)
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


def _decode_rec(h, p, cfg: ModelConfig, lru, conv):
    """h (B, 1, D); lru (B, W) fp32 and conv (B, K-1, W), both written in
    place."""
    gate, xc, new_conv, r, i = rglru.rec_inputs(h, p, conv_state=conv)
    y, new_lru = rglru.rglru_decode_step(lru, xc[:, 0], r[:, 0], i[:, 0],
                                         p["a_param"], c=cfg.rglru_c)
    lru.copy_(new_lru)
    conv.copy_(new_conv)
    return skewmm.matmul(y[:, None].to(h.dtype) * gate, p["proj_out"])


def _decode_ssm(h, p, cfg: ModelConfig, entry):
    """h (B, 1, D); entry {state (B, H, S, P) fp32, cx, cb, cc (B, K-1,
    ch)}, every tensor written in place."""
    b = h.shape[0]
    nh, hp = cfg.ssm_heads, cfg.ssm_head_dim
    g, s = cfg.ssm_groups, cfg.ssm_state
    z, xs, b_mat, c_mat, dt, conv = ssm.ssm_project(h, p, cfg,
                                                    conv_state=entry)
    y, state = ssm.ssd_decode_step(
        entry["state"], xs[:, 0].reshape(b, nh, hp), dt[:, 0], p["a_log"],
        b_mat[:, 0].reshape(b, g, s), c_mat[:, 0].reshape(b, g, s))
    entry["state"].copy_(state)
    for key, t in conv.items():
        entry[key].copy_(t)
    return ssm.ssm_out(y[:, None], xs, z, p, cfg)


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor, pos,
                mm: mmcfg.MatmulConfig | None = None):
    """One decode step.  tokens (B,) int; pos an int / 0-d tensor (the
    absolute position being generated) or (B,) per-row positions.
    Returns (logits (B, V) fp32, cache) — the cache is updated in place.

    Every shape in the step is static and a tensor `pos` on the tokens'
    device (int32) is read only through tensor ops, so the step can be
    captured in a CUDA graph (`serve.graphs`); an int `pos` is copied from
    the host, which a capture cannot hold."""
    _check(cfg)
    with mmcfg.scope(mm):
        x = transformer.embed_tokens(params, cfg, tokens[:, None])
        pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
        for kind, p, si, r, i in transformer.layer_iter(params, cfg):
            entry = cache[f"stage{si}"][f"b{i}"]
            h = rmsnorm(x, p["ln1"], cfg.norm_eps)
            if kind == "rec":
                h = _decode_rec(h, p["mixer"], cfg, entry["lru"][r],
                                entry["conv"][r])
            elif kind == "ssm":
                h = _decode_ssm(h, p["mixer"], cfg, _ssm_entry(entry, r))
            else:
                window = cfg.local_window if kind == "attn_local" else None
                h = _decode_gqa(h, p["attn"], cfg, entry["k"][r],
                                entry["v"][r], pos, window)
            if cfg.use_post_norm:
                h = rmsnorm(h, p["post_ln1"], cfg.norm_eps)
            x = _ffn(x + h, p, cfg, kind)
        h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return transformer.unembed(params, cfg, h[:, 0]), cache


def guarded_decode_step(params, cfg: ModelConfig, cache, tokens, pos,
                        mm: mmcfg.MatmulConfig | None = None):
    """`decode_step` with a serving-boundary NaN scrub.

    Decode is where a poisoned kernel does most harm: one non-finite
    logit corrupts every token sampled after it.  This wrapper is the last
    net of the guard ladder: a *concrete* finiteness check on the logits
    (it reads a device value on the host, so it belongs at the serving
    boundary and never inside a captured decode graph).  The logits are
    themselves a `fault_scope` injection site ("decode"): a step whose
    logits that injection poisoned is counted in guard health
    ("scrubbed_batches") and re-run on the "torch" reference backend,
    outside the injection, as a backend-specific corruption would not
    follow the computation to the reference.  Any other non-finite step
    raises `NumericFault`: unlike the JAX engine, which re-runs every
    non-finite step on its reference backend, a real fault is never
    served by the plain version in a hand-written kernel's place.  A
    reference re-run that is still non-finite raises too.

    `decode_step` updates the cache in place, and a recurrent or SSM
    state advanced twice would be wrong, so while a fault scope is armed
    a copy of the cache from before the step is kept: the re-run starts
    from it and writes its result back into `cache`.  With none armed
    nothing is copied.
    """
    from repro_torch.guard import faults as _faults
    from repro_torch.guard import health as _health
    from repro_torch.guard.fallback import NumericFault
    from repro_torch.serve.graphs import clone_cache

    before = None if _faults.active() is None else clone_cache(cache)
    logits, new_cache = decode_step(params, cfg, cache, tokens, pos, mm)
    logits, injected = _faults.maybe_poison(logits, "decode")
    if bool(torch.isfinite(logits).all()):
        return logits, new_cache
    if not injected:
        raise NumericFault("decode_step logits non-finite with no fault "
                           "injected at the decode site")
    _health.record("faults_caught", injected)
    _health.record("scrubbed_batches")
    _copy_into(cache, before)
    with mmcfg.scope(mm), mmcfg.mm_config(backend="torch"):
        logits, new_cache = decode_step(params, cfg, cache, tokens, pos)
    if not bool(torch.isfinite(logits).all()):
        raise NumericFault("decode_step logits non-finite even on the "
                           "torch reference backend")
    return logits, new_cache


def _copy_into(dst, src) -> None:
    """Copy a cache tree (dicts of tensors) into one of the same shape."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            _copy_into(v, src[k])
    else:
        dst.copy_(src)
