"""Mamba-2 (SSD) mixer block, and the causal conv it shares with the RG-LRU
block.

`ssd_chunked` is the plain chunked SSD, the JAX package's model path op for
op (the same rounding points in the model's dtype, fp32 state and
log-decay): K8's plain version `kernels.ssd_scan.ssd_scan_plain` with those
rounding points.  The JAX package names its TPU kernel as the runtime path
for this scan; here `ssd` takes that route — `kernels.ops.ssd_scan` (K8 on
the card, fp32 inside) under the "cuda" backend — and keeps `ssd_chunked` as
the "torch" backend's reference rung.  `ssd_decode_step` is the one-token
recurrence the serving engine uses at decode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import config, skewmm
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels import ops, ssd_scan
from repro_torch.models import layers
from repro_torch.models.layers import linear_init, rmsnorm


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, *,
                  state: torch.Tensor | None = None):
    """Depthwise causal conv.  x (B, S, C), w (K, C), state (B, K-1, C): the
    K-1 inputs before x (zeros when None).  Returns (out (B, S, C), the
    last K-1 inputs (B, K-1, C)) — the decode conv state."""
    k = w.shape[0]
    pad = state if state is not None else torch.zeros(
        (x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([pad, x], dim=1)                  # (B, S+K-1, C)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(k))
    new_state = xp[:, -(k - 1):, :] if k > 1 else pad
    return out, new_state


def ssd_chunked(x, dt, a_log, b_mat, c_mat, *, chunk: int,
                init_state=None, return_state: bool = False):
    """Chunked SSD, same contract as `kernels.ref.ssd_ref`, O(L * chunk)
    memory.  x (B, L, H, P), dt (B, L, H) positive, a_log (H,), b / c
    (B, L, G, S).  Returns y (B, L, H, P) [, the fp32 state (B, H, S, P)].

    The JAX package's model path op for op: the scan's plain version with
    x * dt, the scores and the decayed B rounded to x's dtype where the JAX
    package rounds them (fp32 sums), and the log-decay prefix sum in fp32.
    The JAX package takes a log-depth cumsum to keep XLA on the CPU from
    unrolling it; `torch.cumsum` has no such cost, so the prefix sum here
    is the plain one.  A ragged tail is a shorter last chunk, which equals
    the JAX package's zero-dt padding.  The scan carry's layout is pinned
    under an annotation mesh: heads follow "model"."""
    bsz, _, h, p = x.shape
    state0 = (torch.zeros((bsz, h, b_mat.shape[-1], p), dtype=torch.float32,
                          device=x.device)
              if init_state is None else init_state.float())
    state0 = constrain(state0, "dp", "model", None, None)
    return ssd_scan.ssd_scan_plain(
        x, dt, a_log, b_mat, c_mat, chunk=chunk, init_state=state0,
        return_state=return_state, round_dtype=x.dtype,
        cum_dtype=torch.float32)


def _block_specs(lead: int, with_state: bool):
    """`sharding.on_local_blocks` specs of the scan's args (x (B, ..., H,
    P), dt (B, ..., H), a_log (H,), B / C (B, ..., G, S)[, the state (B,
    H, S, P)]) and of its outputs (y placed as x, the state): batch rows
    over the data axes, heads over "model", B / C whole but for the
    batch.  DTensor's own rules refuse the scan's batched einsums on such
    splits."""
    none = (None,) * lead
    x = ("dp", *none, "model", None)
    st = ("dp", "model", None, None)
    bc = ("dp", *none, None, None)
    ins = (x, ("dp", *none, "model"), ("model",), bc, bc)
    return ins + ((st,) if with_state else ()), (x, st)


def ssd(x, dt, a_log, b_mat, c_mat, *, chunk: int,
        return_state: bool = False):
    """The full-sequence SSD of the configured backend: K8 through `ops`
    under "cuda", `ssd_chunked` under "torch" (on `DTensor`s, each rank's
    batch rows and heads)."""
    if config.resolve().backend == "cuda":
        return ops.ssd_scan(x, dt, a_log, b_mat, c_mat, chunk=chunk,
                            return_state=return_state)
    ins, outs = _block_specs(x.ndim - 3, False)
    return sharding.on_local_blocks(
        lambda *a: ssd_chunked(*a, chunk=chunk, return_state=return_state),
        (x, dt, a_log, b_mat, c_mat), ins,
        outs if return_state else outs[:1])


def ssd_decode_step(state, xt, dtt, a_log, bt, ct):
    """One-token SSD update (on `DTensor`s, each rank's batch rows and
    heads).  state (B, H, S, P) fp32; xt (B, H, P); dtt (B, H); bt / ct
    (B, G, S).  Returns (y (B, H, P) in xt's dtype, the fp32 state)."""
    ins, outs = _block_specs(0, True)
    return sharding.on_local_blocks(
        lambda x, dt, a, b, c, st: _ssd_decode_local(st, x, dt, a, b, c),
        (xt, dtt, a_log, bt, ct, state), ins, outs)


def _ssd_decode_local(state, xt, dtt, a_log, bt, ct):
    rep = xt.shape[1] // bt.shape[1]
    neg_a = -torch.exp(a_log.float())
    bt = bt.repeat_interleave(rep, dim=1).float()          # (B,H,S)
    ct = ct.repeat_interleave(rep, dim=1).float()
    decay = torch.exp(dtt.float() * neg_a[None, :])        # (B,H)
    dx = xt.float() * dtt.float()[..., None]
    state = state * decay[..., None, None] + \
        torch.einsum("bhs,bhp->bhsp", bt, dx)
    y = torch.einsum("bhsp,bhs->bhp", state, ct)
    return y.to(xt.dtype), state


# ------------------------------------------------------------------ block
def init_ssm(gen: torch.Generator, cfg, device) -> dict:
    """Random Mamba-2 mixer weights drawn from `gen` on `device`.  The
    projections and the depthwise conv are kept per segment (z / x / B / C
    / dt), as in the JAX package; a_log, dt_bias and d_skip are fp32."""
    d, di = cfg.d_model, cfg.d_inner
    h, g, s = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state
    dt = layers.dtype_of(cfg)

    def conv_init(ch):
        return (torch.randn((cfg.conv_kernel, ch), generator=gen,
                            device=device) * 0.2).to(dt)

    def f32(value):
        return torch.full((h,), value, dtype=torch.float32, device=device)

    return {
        "in_z": linear_init(gen, d, di, dt, device),
        "in_x": linear_init(gen, d, di, dt, device),
        "in_b": linear_init(gen, d, g * s, dt, device),
        "in_c": linear_init(gen, d, g * s, dt, device),
        "in_dt": linear_init(gen, d, h, dt, device),
        "conv_x": conv_init(di),
        "conv_b": conv_init(g * s),
        "conv_c": conv_init(g * s),
        "a_log": f32(0.0),                        # A = -exp(0) = -1
        "dt_bias": f32(-2.0),                     # softplus(-2) ~ 0.13
        "d_skip": f32(1.0),
        "out_norm": torch.zeros((di,), dtype=dt, device=device),
        "out_proj": linear_init(gen, di, d, dt, device),
    }


def ssm_project(x, p, cfg, conv_state=None):
    """The projections and per-segment convs shared by prefill and decode.
    x (B, S, D) -> (z, xs, b, c, dt fp32, the new conv tails {cx, cb, cc}
    (B, K-1, ch)); `conv_state`, when given, holds the decode tails.
    Under an annotation mesh the SSD head dim follows "model" and the
    small B / C projections are replicated over it."""
    cs = conv_state or {}
    z = constrain(skewmm.matmul(x, p["in_z"]), "dp", None, "model")
    xs, conv_sx = causal_conv1d(skewmm.matmul(x, p["in_x"]), p["conv_x"],
                                state=cs.get("cx"))
    b_mat, conv_sb = causal_conv1d(skewmm.matmul(x, p["in_b"]), p["conv_b"],
                                   state=cs.get("cb"))
    c_mat, conv_sc = causal_conv1d(skewmm.matmul(x, p["in_c"]), p["conv_c"],
                                   state=cs.get("cc"))
    xs = constrain(F.silu(xs), "dp", None, "model")
    b_mat = constrain(F.silu(b_mat), "dp", None, None)
    c_mat = constrain(F.silu(c_mat), "dp", None, None)
    dt_raw = skewmm.matmul(x, p["in_dt"])
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    dt = constrain(dt, "dp", None, "model")
    new_conv = {"cx": conv_sx, "cb": conv_sb, "cc": conv_sc}
    return z, xs, b_mat, c_mat, dt, new_conv


def ssm_out(y, xs, z, p, cfg):
    """The mixer after its scan: y (B, S, H, P) plus the D skip of xs, gated
    by silu(z) (fp32, cast back), normed and projected out -> (B, S, D)."""
    b, length = y.shape[:2]
    y = y + p["d_skip"].to(y.dtype)[None, None, :, None] * \
        xs.reshape(y.shape)
    y = y.reshape(b, length, cfg.d_inner)
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p["out_norm"],
                cfg.norm_eps)
    return skewmm.matmul(y, p["out_proj"])


def ssm_mixer(x: torch.Tensor, p: dict, cfg, *, return_state: bool = False):
    """Full-sequence Mamba-2 mixer.  x (B, S, D) -> (B, S, D); with
    ``return_state`` also the decode cache entry {"state": the fp32 SSD
    state (B, H, S, P), "cx" / "cb" / "cc": the conv tails}."""
    b, length, _ = x.shape
    h, hp = cfg.ssm_heads, cfg.ssm_head_dim
    g, s = cfg.ssm_groups, cfg.ssm_state
    z, xs, b_mat, c_mat, dt, conv = ssm_project(x, p, cfg)
    xh = xs.reshape(b, length, h, hp)
    y = ssd(xh, dt, p["a_log"], b_mat.reshape(b, length, g, s),
            c_mat.reshape(b, length, g, s), chunk=cfg.ssm_chunk,
            return_state=return_state)
    if not return_state:
        return ssm_out(y, xh, z, p, cfg)
    y, state = y
    return ssm_out(y, xh, z, p, cfg), {"state": state, **conv}
