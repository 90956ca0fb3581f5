"""Shared layer primitives.  Every dense contraction routes through
repro_torch.core.skewmm so the planner sees the full workload."""

from __future__ import annotations

import torch

from repro_torch.core import skewmm
from repro_torch.core.epilogue import Epilogue

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ------------------------------------------------------------------ init
def linear_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
                device) -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=gen, device=device,
                    dtype=torch.float32) * (d_in ** -0.5)
    return w.to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=device,
                    dtype=torch.float32) * 0.02
    return w.to(dtype)


# ------------------------------------------------------------------ norms
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """Variance reduced in fp32; the scale applies in the native dtype and
    the weight enters as (1 + w)."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * (1.0 + w).to(x.dtype)


# ------------------------------------------------------------------ rope
def rope_freqs(positions: torch.Tensor, dim: int, theta: float):
    """positions (..., S) -> cos, sin (..., S, dim//2), fp32."""
    half = dim // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=positions.device) / half)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B, S, H, D), rope on the full last dim (half-split convention).
    cos/sin are (B, S, D/2) or (S, D/2), cast to x's dtype before the
    rotation."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == x.dim() - 2:        # (S, half) -> (S, 1, half)
        cos, sin = cos[:, None, :], sin[:, None, :]
    else:                               # (B, S, half) -> (B, S, 1, half)
        cos, sin = cos[..., None, :], sin[..., None, :]
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ------------------------------------------------------------------ MLP
def init_mlp(gen, cfg, device, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    if cfg.mlp_type == "swiglu":
        return {"w_gate": linear_init(gen, d, f, dt, device),
                "w_up": linear_init(gen, d, f, dt, device),
                "w_down": linear_init(gen, f, d, dt, device)}
    return {"w_up": linear_init(gen, d, f, dt, device),
            "w_down": linear_init(gen, f, d, dt, device)}


def mlp(x: torch.Tensor, p: dict, cfg, residual: torch.Tensor | None = None
        ) -> torch.Tensor:
    """MLP with the activation fused into the gate/up projection's epilogue
    and (optionally) the block's residual fused into the down projection."""
    if cfg.mlp_type == "swiglu":
        g = skewmm.matmul(x, p["w_gate"], epilogue=Epilogue(act="silu"))
        u = skewmm.matmul(x, p["w_up"])
        h = g * u
    else:
        h = skewmm.matmul(x, p["w_up"], epilogue=Epilogue(act="gelu"))
    if residual is not None:
        return skewmm.matmul(h, p["w_down"],
                             epilogue=Epilogue(residual=residual))
    return skewmm.matmul(h, p["w_down"])


# ------------------------------------------------- blockwise attention
def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        softcap: float = 0.0, scale: float | None = None,
                        q_positions: torch.Tensor | None = None,
                        kv_positions: torch.Tensor | None = None,
                        q_chunk: int = 512, kv_chunk: int = 1024
                        ) -> torch.Tensor:
    """Memory-efficient attention (online softmax over kv chunks).

    q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) with Hq % Hkv == 0.  Positions
    (1-D shared or 2-D (B, S) per row) drive the causal/window masks; kv
    positions below 0 are invalid.  Masked scores are -1e30, padded q rows
    sit at position 2**30, and the result is acc / max(l, 1e-30) — the
    JAX package's blockwise_attention, with its scans as Python loops.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    dv = v.shape[-1]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    qp = (torch.arange(sq, dtype=torch.int32, device=dev)
          if q_positions is None else q_positions)
    kp = (torch.arange(skv, dtype=torch.int32, device=dev)
          if kv_positions is None else kv_positions)
    qp = torch.broadcast_to(qp, (b, sq))
    kp = torch.broadcast_to(kp, (b, skv))

    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    sq_p = -(-sq // q_chunk) * q_chunk
    skv_p = -(-skv // kv_chunk) * kv_chunk
    if sq_p != sq:
        q = torch.nn.functional.pad(q, (0, 0, 0, sq_p - sq))
        qp = torch.nn.functional.pad(qp, (0, sq_p - sq), value=2**30)
    if skv_p != skv:
        k = torch.nn.functional.pad(k, (0, 0, 0, skv_p - skv))
        v = torch.nn.functional.pad(v, (0, 0, 0, skv_p - skv))
        kp = torch.nn.functional.pad(kp, (0, skv_p - skv), value=-1)

    outs = []
    for q0 in range(0, sq_p, q_chunk):
        qi = q[:, :, q0:q0 + q_chunk].float()
        qpi = qp[:, q0:q0 + q_chunk]
        m_i = torch.full((b, hq, q_chunk, 1), -1e30, dtype=torch.float32,
                         device=dev)
        l_i = torch.zeros((b, hq, q_chunk, 1), dtype=torch.float32,
                          device=dev)
        acc = torch.zeros((b, hq, q_chunk, dv), dtype=torch.float32,
                          device=dev)
        for k0 in range(0, skv_p, kv_chunk):
            kj = k[:, :, k0:k0 + kv_chunk].repeat_interleave(group, dim=1)
            vj = v[:, :, k0:k0 + kv_chunk].repeat_interleave(group, dim=1)
            kpj = kp[:, k0:k0 + kv_chunk]
            s = torch.einsum("bhqd,bhkd->bhqk", qi, kj.float()) * scale
            if softcap > 0.0:
                s = softcap * torch.tanh(s / softcap)
            mask = (kpj[:, None, :] >= 0).expand(b, q_chunk, kv_chunk)
            if causal:
                mask = mask & (kpj[:, None, :] <= qpi[:, :, None])
            if window is not None:
                mask = mask & (kpj[:, None, :] > qpi[:, :, None] - window)
            s = torch.where(mask[:, None], s, -1e30)
            m_cur = torch.amax(s, dim=-1, keepdim=True)
            m_new = torch.maximum(m_i, m_cur)
            p = torch.exp(s - m_new)
            p = torch.where(mask[:, None], p, 0.0)
            alpha = torch.exp(m_i - m_new)
            l_i = l_i * alpha + torch.sum(p, dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p,
                                             vj.float())
            m_i = m_new
        outs.append((acc / torch.clamp(l_i, min=1e-30)).to(q.dtype))
    out = torch.cat(outs, dim=2)
    return out[:, :, :sq]
