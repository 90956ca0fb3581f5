"""AdamW with fp32 moments over the port's parameter trees.

Moments are fp32 whatever the param dtype; the update is computed in fp32
and cast back.  The update is pure: it returns new params and a new state
and leaves its inputs untouched, which is what lets `retry_step` replay a
failed step from the same state (no torn optimizer updates).  It works
leaf by leaf, so only one leaf's fp32 temporaries exist at a time.  The
step counter, the bias corrections and the learning rate live on the host
(0-d CPU tensors, which PyTorch passes to a kernel on the card as
scalars), so they are the same on every device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.tree import leaves, tree_map, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor         # () int32, on the host
    mu: Any                    # fp32 tree like params
    nu: Any                    # fp32 tree like params


def f32_zeros(p: torch.Tensor) -> torch.Tensor:
    """fp32 zeros of `p`'s shape on its device (a `DTensor` with `p`'s
    placements for a `DTensor`)."""
    if hasattr(p, "placements"):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          mu=tree_map(f32_zeros, params),
                          nu=tree_map(f32_zeros, params))

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        return self.lr(step) if callable(self.lr) else \
            torch.tensor(self.lr, dtype=torch.float32)

    def update(self, grads, state: AdamWState, params):
        """Returns (new_params, new_state, metrics).  A gradient leaf that
        is None (a param the loss never reached) counts as zeros: its
        moments still decay and the weight decay still applies."""
        step = state.step + 1
        ps = list(leaves(params))
        gs = list(leaves(grads))
        # global-norm clip (the norm reported is the one before clipping)
        gnorm = None
        for g in gs:
            if g is None:
                continue
            gf = g.float()
            sq = torch.sum(gf * gf)
            gnorm = sq if gnorm is None else gnorm + sq
        if gnorm is None:
            gnorm = torch.zeros((), dtype=torch.float32)
        gnorm = torch.sqrt(gnorm)
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0) \
            if self.grad_clip else 1.0

        b1, b2, wd = self.b1, self.b2, self.weight_decay
        s = step.to(torch.float32)
        bc1 = 1 - torch.pow(b1, s)
        bc2 = 1 - torch.pow(b2, s)
        lr = self._lr(step)

        new_p, new_mu, new_nu = [], [], []
        for p, g, m, v in zip(ps, gs, leaves(state.mu), leaves(state.nu)):
            gf = (g.float() if g is not None else f32_zeros(p)) * scale
            mu = m * b1
            mu += (1 - b1) * gf
            t = (1 - b2) * gf
            t *= gf
            del gf
            nu = v * b2
            nu += t
            del t
            u = mu / bc1
            den = nu / bc2
            den.sqrt_()
            den += self.eps
            u /= den
            del den
            pf = p.float()
            u += wd * pf
            u *= lr
            new_p.append((pf - u).to(p.dtype))
            del u, pf
            new_mu.append(mu)
            new_nu.append(nu)
        metrics = {"grad_norm": gnorm, "lr": lr}
        return (unflatten(params, new_p),
                AdamWState(step=step, mu=unflatten(params, new_mu),
                           nu=unflatten(params, new_nu)),
                metrics)
