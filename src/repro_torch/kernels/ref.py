"""Plain PyTorch oracles for the kernels (allclose targets in tests)."""

from __future__ import annotations

import torch

from repro_torch.core import epilogue as epilogue_mod


def matmul_epilogue_ref(a: torch.Tensor, b: torch.Tensor, *, bias=None,
                        residual=None, epilogue=None,
                        out_dtype=None) -> torch.Tensor:
    """Oracle for the fused-epilogue matmul:
    out = act(scale * (A@B) + bias) + residual, applied at fp32 through the
    shared op table, then one cast.  Supports leading batch dims on `a`."""
    ep = epilogue_mod.Epilogue.parse(epilogue, bias=bias, residual=residual)
    z = torch.matmul(a.float(), b.float())
    z = epilogue_mod.apply_spec(z, ep.spec, ep.operands())
    return z.to(out_dtype or a.dtype)


def block_sparse_matmul_ref(a: torch.Tensor, b: torch.Tensor, layout, *,
                            bias=None, residual=None, epilogue=None,
                            out_dtype=None) -> torch.Tensor:
    """Oracle for the block-sparse matmul: blocks absent from `layout` (a
    `BlockSparseLayout`, or anything with an `element_mask()`) are exact
    zeros whatever A holds there, then the fused-epilogue matmul."""
    mask = torch.as_tensor(layout.element_mask(), device=a.device)
    return matmul_epilogue_ref(a * mask.to(a.dtype), b, bias=bias,
                               residual=residual, epilogue=epilogue,
                               out_dtype=out_dtype)


def grouped_matmul_ref(a: torch.Tensor, b: torch.Tensor, *, residual=None,
                       epilogue=None, out_dtype=None) -> torch.Tensor:
    """Oracle for the grouped (per-group rhs) matmul:
    C[g] = epilogue(A[g] @ B[g]), fp32 accumulation, one cast at the end."""
    ep = epilogue_mod.Epilogue.parse(epilogue, residual=residual)
    z = torch.bmm(a.float(), b.float())
    z = epilogue_mod.apply_spec(z, ep.spec, ep.operands())
    return z.to(out_dtype or a.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  softcap: float = 0.0, scale: float | None = None
                  ) -> torch.Tensor:
    """Oracle for flash attention: q (B, Hq, Sq, D), k / v (B, Hkv, Skv, D)
    with Hq % Hkv == 0 (GQA by repeating kv heads), dense masks over row
    and column indices from 0, masked scores filled with -1e30, an fp32
    softmax, one cast to q's dtype."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    group = hq // hkv
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx).to(q.dtype)


def rglru_ref(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
              a_param: torch.Tensor, *, c: float = 8.0,
              init_state: torch.Tensor | None = None,
              return_state: bool = False):
    """Oracle for the RG-LRU scan (Griffin eq. 1-4), sequential in fp32.

    x, r_gate, i_gate (B, L, D), the gates pre-sigmoid logits; a_param (D,)
    is Lambda, with a_t = exp(-c * softplus(Lambda) * sigmoid(r_t)):

        h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) (sigmoid(i_t) x_t)

    Returns y (B, L, D) in x's dtype [, the fp32 state after the last step
    (B, D)]."""
    xf = x.float()
    r = torch.sigmoid(r_gate.float())
    i = torch.sigmoid(i_gate.float())
    log_a = -c * r * torch.nn.functional.softplus(a_param.float())
    a = torch.exp(log_a)
    gated = i * xf
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    h = (torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32,
                     device=x.device)
         if init_state is None else init_state.float())
    hs = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + mult[:, t] * gated[:, t]
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)
    if return_state:
        return y, h
    return y


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
            b_mat: torch.Tensor, c_mat: torch.Tensor, *,
            init_state: torch.Tensor | None = None,
            return_state: bool = False):
    """Oracle for the Mamba-2 SSD scan: the sequential recurrence in fp32
    (in fp64 for fp64 inputs, the exact answer the kernel is held to).

    x (B, L, H, P), dt (B, L, H) positive, a_log (H,) with A = -exp(a_log),
    b_mat / c_mat (B, L, G, S) with H % G == 0.  Returns y (B, L, H, P) in
    x's dtype [, the state after the last step (fp32, or fp64 for fp64
    inputs), laid out (B, H, P, S) as in the JAX package's oracle —
    `ssd_chunked` and the decode cache use (B, H, S, P)]."""
    bsz, length, h, p = x.shape
    rep = h // b_mat.shape[2]
    work = torch.promote_types(x.dtype, torch.float32)
    a = -torch.exp(a_log.to(work))                              # (H,)
    bm = b_mat.repeat_interleave(rep, dim=2).to(work)           # (B,L,H,S)
    cm = c_mat.repeat_interleave(rep, dim=2).to(work)
    xf, dtf = x.to(work), dt.to(work)
    state = (torch.zeros((bsz, h, p, b_mat.shape[3]), dtype=work,
                         device=x.device)
             if init_state is None else init_state.to(work))
    ys = []
    for t in range(length):
        decay = torch.exp(dtf[:, t] * a[None, :])               # (B, H)
        dx = xf[:, t] * dtf[:, t, :, None]                      # (B, H, P)
        state = state * decay[..., None, None] + \
            torch.einsum("bhp,bhs->bhps", dx, bm[:, t])
        ys.append(torch.einsum("bhps,bhs->bhp", state, cm[:, t]))
    y = torch.stack(ys, dim=1).to(x.dtype)
    if return_state:
        return y, state
    return y
