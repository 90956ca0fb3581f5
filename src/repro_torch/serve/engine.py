"""Serving engine: prefill + single-token decode for the GQA and MLA archs,
with a dense or an MoE FFN, for the RG-LRU hybrid (recurrent and local
attention blocks), for the Mamba-2 SSM (mixer-only blocks, no FFN) and
for the VLM backbone (`prefill(prefix_embeds=)` puts the stub frontend's
patch embeddings ahead of the prompt; decode positions count them).  The
encoder-decoder has its own engine, `serve.encdec_engine`.

`prefill` runs the full-sequence forward while filling the cache;
`decode_step` advances one token against it.  Unlike the JAX package's
pure functions, the cache is **updated in place**: `decode_step` writes
the new token's k/v (or a recurrent or SSM block's state and conv tails)
into the cache tensors it is given (and returns the same dict), so no
per-step copy of the cache is made.

Prefill attention goes through `attention.sequence_attention` or, for
MLA, `attention.mla_attn` (K7 under the "cuda" backend), the recurrent
scan through `rglru.rec_mixer` (K6) and the SSD scan through
`ssm.ssm_mixer` (K8, which also returns the fp32 state for decode);
decode attention stays `blockwise_attention` over the cache positions
(MLA's absorbed form: five fp32 contractions over the latent cache), and
the decode recurrences `rglru_decode_step` and `ssd_decode_step`, as in
the JAX package.  An MLA prefill projects
`wkv_a` twice a layer (once for the cache entry, once inside `mla_attn`),
as the JAX engine does, so the plan logs of both packages stay equal.

Each repeat of a stage's unit runs in `stage_trace.repeat(r)`: the host
records (plan log, tuned-lookup ledger, spans, MoE slot counts) are made
once per stage site and call, as under the JAX engine's `lax.scan`.

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
from repro_torch.core import skewmm, stage_trace
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks, layers, moe, rglru, ssm, transformer
from repro_torch.models.layers import rmsnorm
from repro_torch.serve import kvcache


def _check(cfg: ModelConfig) -> None:
    if cfg.family == "encdec":
        raise ValueError(f"{cfg.name} is an encoder-decoder: serve it "
                         f"through serve.encdec_engine")


def _attn_prefill(h, p, cfg, kind, positions, k_dst, v_dst):
    window = cfg.local_window if kind == "attn_local" else None
    q, k, v = attn_mod.gqa_project(h, p, cfg, positions)
    kvcache.place_kv(k_dst, k)
    kvcache.place_kv(v_dst, v)
    ctx = attn_mod.sequence_attention(q, k, v, cfg, window=window,
                                      positions=positions)
    return skewmm.matmul(ctx, p["wo"])


def _mla_prefill(h, p, cfg, kind, positions, latent_dst, k_rope_dst):
    window = cfg.local_window if kind == "attn_local" else None
    latent, k_rope = attn_mod.mla_latent(h, p, cfg, positions)
    kvcache.place_kv(latent_dst, latent)
    kvcache.place_kv(k_rope_dst, k_rope)
    return attn_mod.mla_attn(h, p, cfg, positions=positions, window=window)


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
    x = constrain(x, "dp", None, None)
    if not blocks.has_ffn(kind):
        return x
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if blocks.ffn_is_moe(kind):
        h, _ = moe.moe_mlp(h, p["moe"], cfg)
    else:
        h = layers.mlp(h, p["mlp"], cfg)
    if cfg.use_post_norm:
        h = rmsnorm(h, p["post_ln2"], cfg.norm_eps)
    return constrain(x + h, "dp", None, None)


def _block_prefill(x, p, cfg: ModelConfig, kind: str, positions, entry,
                   r: int):
    """One layer of `prefill`: the block's forward over x (B, S, D),
    writing row r of its cache entry in place.  Returns the new x."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind == "rec":
        h = _rec_prefill(h, p["mixer"], cfg, entry["lru"][r],
                         entry["conv"][r])
    elif kind == "ssm":
        h = _ssm_prefill(h, p["mixer"], cfg, _ssm_entry(entry, r))
    elif cfg.use_mla:
        h = _mla_prefill(h, p["attn"], cfg, kind, positions,
                         entry["latent"][r], entry["k_rope"][r])
    else:
        h = _attn_prefill(h, p["attn"], cfg, kind, positions,
                          entry["k"][r], entry["v"][r])
    if cfg.use_post_norm:
        h = rmsnorm(h, p["post_ln1"], cfg.norm_eps)
    return _ffn(x + h, p, cfg, kind)


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, *, max_len: int,
            prefix_embeds: torch.Tensor | None = None,
            last_index: torch.Tensor | None = None,
            mm: mmcfg.MatmulConfig | None = None):
    """tokens (B, S) [+ prefix_embeds (B, F, D)] -> (cache, last-position
    logits (B, V) fp32).

    The cache is sized for max_len with positions [0, F + S) filled (on
    `DTensor` inputs, `DTensor`s placed by the cache specs).
    `last_index` (B,) selects a per-row logit position (right-padded
    prompts).  `mm` scopes a matmul configuration over the prefill.
    """
    _check(cfg)
    with mmcfg.scope(mm):
        b = tokens.shape[0]
        x, positions = transformer.embed_inputs(params, cfg, tokens,
                                                prefix_embeds)
        cache = kvcache.init_cache(cfg, b, max_len, x.device,
                                   mesh=getattr(x, "device_mesh", None))
        for kind, p, si, r, i in transformer.layer_iter(params, cfg):
            entry = cache[f"stage{si}"][f"b{i}"]
            with stage_trace.repeat(r):
                x = _block_prefill(x, p, cfg, kind, positions, entry, r)
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
        sharding.write_slot(k_cache, 1, slot.long(), k_new)
        sharding.write_slot(v_cache, 1, slot.long(), v_new)
    else:
        q_pos = pos[:, None]
        q, k_new, v_new = attn_mod.gqa_project(h, p, cfg, q_pos)
        slot = torch.remainder(pos, clen) if is_ring else pos
        rows = torch.arange(b, device=h.device)
        k_cache[rows, slot.long()] = k_new[:, 0]
        v_cache[rows, slot.long()] = v_new[:, 0]
    kv_pos = kvcache.kv_slot_positions(pos, clen, is_ring)

    def attend(q, k, v):
        return layers.blockwise_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, window=window, softcap=cfg.attn_softcap,
            q_positions=q_pos, kv_positions=kv_pos).transpose(1, 2)

    ctx = attn_mod.per_head(attend, q, k_cache, v_cache)
    ctx = ctx.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return skewmm.matmul(ctx, p["wo"])


def _decode_mla(h, p, cfg: ModelConfig, latent, k_rope, pos):
    """Absorbed-form MLA decode: scores and values through the latent
    cache, never the full K / V.  h (B, 1, D); latent (B, L, kvr) and
    k_rope (B, L, rd), written in place; pos a 0-d int tensor (written at
    slot pos) or (B,) per-row positions.  The five contractions are fp32,
    unplanned, as in the JAX engine."""
    b = h.shape[0]
    nh, nope, rd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    kvr, vd = cfg.kv_lora_rank, cfg.v_head_dim
    idx = torch.arange(latent.shape[1], device=h.device)
    if pos.dim() == 0:
        pos1 = pos.reshape(1)
        latent_new, k_rope_new = attn_mod.mla_latent(h, p, cfg, pos1)
        sharding.write_slot(latent, 1, pos1.long(), latent_new)
        sharding.write_slot(k_rope, 1, pos1.long(), k_rope_new)
        valid = (idx <= pos)[None]                         # (1, L)
    else:
        pos1 = pos[:, None]
        latent_new, k_rope_new = attn_mod.mla_latent(h, p, cfg, pos1)
        rows = torch.arange(b, device=h.device)
        latent[rows, pos.long()] = latent_new[:, 0]
        k_rope[rows, pos.long()] = k_rope_new[:, 0]
        valid = idx[None, :] <= pos[:, None]               # (B, L)
    q_nope, q_rope = attn_mod.mla_queries(h, p, cfg, pos1)
    q_nope, q_rope = q_nope[:, 0].float(), q_rope[:, 0].float()  # (B, H, *)
    wkv_b = p["wkv_b"].reshape(kvr, nh, nope + vd).float()
    wk, wv = wkv_b[..., :nope], wkv_b[..., nope:]
    lat = latent.float()
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope, wk)       # (B, H, kvr)
    scores = torch.einsum("bhr,blr->bhl", q_lat, lat)
    scores = scores + torch.einsum("bhd,bld->bhl", q_rope, k_rope.float())
    scores = scores * (nope + rd) ** -0.5
    if cfg.attn_softcap > 0.0:
        scores = cfg.attn_softcap * torch.tanh(scores / cfg.attn_softcap)
    scores = torch.where(valid[:, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bhl,blr->bhr", w, lat)
    ctx = torch.einsum("bhr,rhv->bhv", ctx_lat, wv)
    ctx = ctx.reshape(b, 1, nh * vd).to(h.dtype)
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


def _block_decode(x, p, cfg: ModelConfig, kind: str, entry, r: int, pos):
    """One layer of `decode_step`: x (B, 1, D) at `pos` against row r of
    its cache entry, written in place.  Returns the new x."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind == "rec":
        h = _decode_rec(h, p["mixer"], cfg, entry["lru"][r],
                        entry["conv"][r])
    elif kind == "ssm":
        h = _decode_ssm(h, p["mixer"], cfg, _ssm_entry(entry, r))
    elif cfg.use_mla:
        h = _decode_mla(h, p["attn"], cfg, entry["latent"][r],
                        entry["k_rope"][r], pos)
    else:
        window = cfg.local_window if kind == "attn_local" else None
        h = _decode_gqa(h, p["attn"], cfg, entry["k"][r], entry["v"][r],
                        pos, window)
    if cfg.use_post_norm:
        h = rmsnorm(h, p["post_ln1"], cfg.norm_eps)
    return _ffn(x + h, p, cfg, kind)


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
        x = layers.add_pos(x, cfg, pos.reshape(-1, 1))
        for kind, p, si, r, i in transformer.layer_iter(params, cfg):
            entry = cache[f"stage{si}"][f"b{i}"]
            with stage_trace.repeat(r):
                x = _block_decode(x, p, cfg, kind, entry, r, pos)
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
