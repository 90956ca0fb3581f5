"""Int8 gradient compression with error feedback.

Each gradient leaf plus its residual is quantized to int8 with one
symmetric per-tensor scale; what the quantization loses is kept as the
residual and fed into the next step's gradient (error feedback), which
keeps SGD-style convergence.  Across steps, the dequantized gradients plus
the residual sum to the true gradients.  The int8 ring all-reduce that
carries the codes between hosts waits for the distributed slice.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.tree import leaves, stacked_groups, tree_map, unflatten
from repro_torch.optim.adamw import f32_zeros


class EFState(NamedTuple):
    residual: Any          # fp32 tree like grads


def init_error_feedback(params) -> EFState:
    return EFState(residual=tree_map(f32_zeros, params))


def _scale(gs: list[torch.Tensor]) -> torch.Tensor:
    amax = torch.max(torch.stack([torch.max(torch.abs(g)) for g in gs]))
    return torch.clamp(amax, min=1e-12) / 127.0


def _codes(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 -> (int8, scale).  Symmetric per-tensor scaling; `torch.round`
    rounds halves to even, as `jnp.round` does."""
    scale = _scale([g])
    return _codes(g, scale), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads(grads, ef: EFState) -> tuple[Any, EFState]:
    """Quantize (grad + residual); return the dequantized grads and the new
    residual.  A None gradient leaf counts as zeros.  The scale is per
    tensor of the JAX package's tree: a stage's per-layer leaves at one key
    path share one scale, as the stacked ``(R, ...)`` leaf does there."""
    rs = list(leaves(ef.residual))
    gs = list(leaves(grads))
    deq, res = [None] * len(rs), [None] * len(rs)
    for group in stacked_groups(ef.residual):
        gfs = {i: (gs[i].float() if gs[i] is not None
                   else torch.zeros_like(rs[i])) + rs[i] for i in group}
        scale = _scale(list(gfs.values()))
        for i, gf in gfs.items():
            deq[i] = dequantize(_codes(gf, scale), scale)
            res[i] = gf - deq[i]
    return (unflatten(ef.residual, deq),
            EFState(residual=unflatten(ef.residual, res)))
