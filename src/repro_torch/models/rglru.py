"""Griffin / RecurrentGemma recurrent block (RG-LRU + conv + gating).

`rglru_torch` is the plain scan, the JAX package's `rglru_jnp`: a log-depth
(Hillis-Steele) scan over the composition of first-order recurrences in
fp32, stable because every a_t lies in [0, 1].  The JAX package names its
TPU kernel as the runtime path for this scan; here `rglru` takes that
route — `kernels.ops.rglru_scan` (K6 on the card) under the "cuda" backend
— and keeps the plain scan as the "torch" backend's reference rung.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import config, skewmm
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.layers import linear_init
from repro_torch.models.ssm import causal_conv1d


def _gates(r_gate, i_gate, a_param, c: float):
    """(a, mult * sigmoid(i)) in fp32 from the gate logits."""
    r = torch.sigmoid(r_gate.float())
    gate_i = torch.sigmoid(i_gate.float())
    log_a = -c * r * F.softplus(a_param.float())
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * gate_i


def rglru_torch(x, r_gate, i_gate, a_param, *, c: float = 8.0,
                init_state=None, return_state: bool = False):
    """Scan RG-LRU.  x, gates (B, L, D) logits; a_param (D,).  Returns y in
    x's dtype [, the fp32 state after the last step (B, D)]."""
    a, g = _gates(r_gate, i_gate, a_param, c)
    b = g * x.float()
    length = x.shape[1]
    off = 1
    while off < length:     # (a2, b2) o (a1, b1) = (a1 a2, a2 b1 + b2)
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    h = b if init_state is None else b + a * init_state.float()[:, None]
    out = h.to(x.dtype)
    if return_state:
        return out, h[:, -1]
    return out


def rglru(x, r_gate, i_gate, a_param, *, c: float = 8.0,
          return_state: bool = False):
    """The scan of the configured backend: K6 through `ops` under "cuda",
    the plain scan under "torch"."""
    if config.resolve().backend == "cuda":
        return ops.rglru_scan(x, r_gate, i_gate, a_param, c=c,
                              return_state=return_state)
    return rglru_torch(x, r_gate, i_gate, a_param, c=c,
                       return_state=return_state)


def rglru_decode_step(state, xt, rt, it, a_param, *, c: float = 8.0):
    """One-token RG-LRU update.  state (B, D) fp32; xt / rt / it (B, D)
    logits.  Returns (h in xt's dtype, the fp32 state)."""
    a, g = _gates(rt, it, a_param, c)
    h = a * state + g * xt.float()
    return h.to(xt.dtype), h


# ------------------------------------------------------------------ block
N_GATE_BLOCKS = 16   # RecurrentGemma uses block-diagonal RG-LRU gates


def init_rec(gen: torch.Generator, cfg, device) -> dict:
    """Random recurrent-mixer weights drawn from `gen` on `device`."""
    d, w = cfg.d_model, cfg.lru_width
    dt = layers.dtype_of(cfg)
    nb = min(N_GATE_BLOCKS, w)
    bw = w // nb

    def block_diag():
        return (torch.randn((nb, bw, bw), generator=gen, device=device)
                * bw ** -0.5).to(dt)

    return {
        "proj_x": linear_init(gen, d, w, dt, device),
        "proj_gate": linear_init(gen, d, w, dt, device),
        "conv_w": (torch.randn((cfg.conv_kernel, w), generator=gen,
                               device=device) * 0.2).to(dt),
        "w_r": block_diag(),
        "w_i": block_diag(),
        "a_param": torch.full((w,), 0.65, dtype=torch.float32, device=device),
        "proj_out": linear_init(gen, w, d, dt, device),
    }


def gate_proj(xc: torch.Tensor, w_blk: torch.Tensor) -> torch.Tensor:
    """Block-diagonal linear: xc (..., W), w_blk (nb, bw, bw) -> (..., W),
    fp32 sums, one cast to xc's dtype."""
    nb, bw, _ = w_blk.shape
    xb = xc.reshape(*xc.shape[:-1], nb, bw)
    out = torch.einsum("...nw,nwv->...nv", xb.float(), w_blk.float())
    return out.to(xc.dtype).reshape(xc.shape)


def rec_inputs(x: torch.Tensor, p: dict, conv_state=None):
    """The mixer up to its scan: x (B, S, D) -> (the gelu gate, the conv
    output xc, the new conv tail, r and i gate logits), each (B, S, W)
    but the tail (B, K-1, W).  `conv_state` is the decode conv tail."""
    branch = skewmm.matmul(x, p["proj_x"])
    gate = F.gelu(skewmm.matmul(x, p["proj_gate"]).float(),
                  approximate="tanh").to(x.dtype)
    xc, conv = causal_conv1d(branch, p["conv_w"], state=conv_state)
    return gate, xc, conv, gate_proj(xc, p["w_r"]), gate_proj(xc, p["w_i"])


def rec_mixer(x: torch.Tensor, p: dict, cfg, *, return_state: bool = False):
    """Full-sequence Griffin recurrent mixer.  x (B, S, D) -> (B, S, D);
    with ``return_state`` also the decode cache entry {"lru": the fp32
    scan state (B, W), "conv": the conv tail (B, K-1, W)}."""
    gate, xc, conv, r, i = rec_inputs(x, p)
    h, lru = rglru(xc, r, i, p["a_param"], c=cfg.rglru_c, return_state=True)
    out = skewmm.matmul(h * gate, p["proj_out"])
    if return_state:
        return out, {"lru": lru, "conv": conv}
    return out
