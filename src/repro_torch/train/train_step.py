"""Training step: microbatched gradient accumulation and the AdamW update.

The step is a pure function of (state, batch): it returns a new
`TrainState` and leaves its input untouched, so `retry_step` can replay it.
Gradients come from autograd through the "torch" backend (the reference
rung: K1-K9 are forward-only, `kernels.ops`).  With ``n_microbatches`` >
1 the fp32 gradients are summed over a Python loop and divided by n; the
microbatches after the first run in `stage_trace.repeat`, so host records
are made once, as under the JAX package's `lax.scan`.  Optional int8
error-feedback compression sits between accumulation and the optimizer.
`rng` is the JAX package's ``uint32[2]`` key (`train.prng`), folded with
the new step after every update.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import stage_trace
from repro_torch.core.tree import leaves, tree_map, unflatten
from repro_torch.distributed import sharding
from repro_torch.models import transformer
from repro_torch.models.model import ModelBundle
from repro_torch.optim import compression
from repro_torch.optim.adamw import AdamW, AdamWState, f32_zeros
from repro_torch.train.loss import chunked_softmax_xent
from repro_torch.train.prng import fold_in, prng_key


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    ef: Any                       # error-feedback residual or None
    rng: np.ndarray               # uint32[2], on the host


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    n_microbatches: int = 1
    loss_chunk: int = 512
    mtp_coef: float = 0.3
    compress_grads: bool = False


def make_loss_fn(bundle: ModelBundle, ts_cfg: TrainStepConfig):
    cfg = bundle.cfg

    def loss_fn(params, batch):
        h, aux = bundle.hidden_fn(params, batch)
        tokens = batch["tokens"]
        # VLM prefix positions carry no next-token loss; slice them off.
        text_h = h[:, -tokens.shape[1]:]
        loss = chunked_softmax_xent(
            text_h[:, :-1], tokens[:, 1:],
            lambda hh: bundle.logits_fn(params, hh),
            mask=batch.get("loss_mask", None),
            chunk=ts_cfg.loss_chunk)
        if cfg.mtp_heads:
            mtp_h = transformer.mtp_hidden(params, cfg, text_h, tokens)
            # mtp_h[:, t] predicts token t+2
            mtp_loss = chunked_softmax_xent(
                mtp_h[:, :-1], tokens[:, 2:],
                lambda hh: bundle.logits_fn(params, hh),
                chunk=ts_cfg.loss_chunk)
            loss = loss + ts_cfg.mtp_coef * mtp_loss
        return loss + aux.to(torch.float32)

    return loss_fn


def value_and_grad(loss_fn):
    """(params, batch) -> (loss, grads): grads in the param dtype, None
    where the loss does not reach a param.  The params themselves are not
    touched (autograd runs on detached aliases).  A `DTensor` param's
    gradient is reduced to the param's placements (the sum over the data
    ranks that a batch split leaves pending)."""
    def run(params, batch):
        live = [p.detach().requires_grad_(True) for p in leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if hasattr(g, "placements") else g
                 for g, p in zip(grads, live)]
        return loss.detach(), unflatten(params, grads)
    return run


def make_train_step(bundle: ModelBundle, opt: AdamW,
                    ts_cfg: TrainStepConfig = TrainStepConfig()):
    grad_fn = value_and_grad(make_loss_fn(bundle, ts_cfg))

    def train_step(state: TrainState, batch: dict):
        n = ts_cfg.n_microbatches
        if n > 1:
            gsum = tree_map(f32_zeros, state.params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=bundle.device)
            for i in range(n):
                mb = {k: sharding.microbatch(v, n, i)
                      for k, v in batch.items()}
                with stage_trace.repeat(i):
                    loss, g = grad_fn(state.params, mb)
                for acc, gi in zip(leaves(gsum), leaves(g)):
                    if gi is not None:
                        acc += gi.to(torch.float32)
                lsum = lsum + loss
            grads = tree_map(lambda acc: acc.div_(n), gsum)
            loss = lsum / n
        else:
            loss, grads = grad_fn(state.params, batch)

        ef = state.ef
        if ts_cfg.compress_grads and ef is not None:
            grads, ef = compression.compress_grads(grads, ef)

        new_params, new_opt, metrics = opt.update(grads, state.opt,
                                                  state.params)
        metrics["loss"] = loss
        new_rng = fold_in(state.rng, int(new_opt.step))
        return TrainState(new_params, new_opt, ef, new_rng), metrics

    return train_step


def init_train_state(bundle: ModelBundle, opt: AdamW, seed: int,
                     ts_cfg: TrainStepConfig = TrainStepConfig()
                     ) -> TrainState:
    """Params from the bundle's seeded init, zero moments (and residual),
    and the key `prng_key(seed)`, as `jax.random.PRNGKey(seed)`."""
    params = bundle.init(seed)
    ef = (compression.init_error_feedback(params)
          if ts_cfg.compress_grads else None)
    return TrainState(params=params, opt=opt.init(params), ef=ef,
                      rng=prng_key(seed))
