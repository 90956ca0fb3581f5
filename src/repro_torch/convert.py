"""Carry the JAX package's parameters over to the port.

The JAX LM stacks each stage's repeating units along a leading layer axis
(``params["stage{si}"]``, one array per leaf with R rows), and the
encoder-decoder its encoder and decoder blocks (``params["enc"]`` /
``params["dec"]``).  The port keeps a list of per-layer dicts instead.
`params_from_numpy` takes the JAX parameter tree with its leaves already
turned into numpy arrays (for example ``jax.tree.map(np.asarray,
params)``) and returns the port's parameters on `device` (the card unless
told otherwise), so both packages compute with the same weights.

Every leaf keeps its dtype: an MoE block's ``(R, E, D, F)`` expert stacks
become ``(E, D, F)`` per layer, and its router stays fp32 in a bf16 model;
a recurrent block's block-diagonal gates ``w_r`` / ``w_i`` become
``(nb, bw, bw)`` per layer, and its ``a_param`` stays fp32; a Mamba-2
mixer's conv taps ``conv_x`` / ``conv_b`` / ``conv_c`` become ``(K, ch)``
per layer, and its ``a_log``, ``dt_bias`` and ``d_skip`` stay fp32.

`state_from_numpy` carries a whole JAX `TrainState` (numpy leaves) over the
same way: params, the AdamW step and moments, the error-feedback residual
and the PRNG key; `state_to_numpy` is its inverse, the per-layer lists
restacked into the JAX package's ``(R, ...)`` leaves (bf16 widened to
fp32: numpy has no bf16).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.compression import EFState
from repro_torch.train.train_step import TrainState


def _tensor(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    name = str(arr.dtype)
    if name == "bfloat16":
        # numpy has no native bf16: go through the raw bits.
        t = torch.from_numpy(arr.view(np.uint16).astype(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(tree, r: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, r) for k, v in tree.items()}
    return tree[r]


def _rows(tree) -> int:
    if isinstance(tree, dict):
        return _rows(next(iter(tree.values())))
    return np.asarray(tree).shape[0]


def params_from_numpy(tree: dict, device=None) -> dict:
    """JAX parameter tree (numpy leaves) -> the port's parameter dict, on
    `device` (default: the card; raises when CUDA is absent)."""
    device = resolve_device(device)
    out: dict = {}
    for key, value in tree.items():
        if key.startswith("stage") or key in ("enc", "dec"):
            out[key] = [_map(_unstack(value, r), lambda x: _tensor(x, device))
                        for r in range(_rows(value))]
        elif isinstance(value, dict):
            out[key] = _map(value, lambda x: _tensor(x, device))
        else:
            out[key] = _tensor(value, device)
    return out


def state_from_numpy(tree, device=None):
    """A JAX `TrainState` with numpy leaves (``jax.tree.map(np.asarray,
    state)``) -> the port's `TrainState` on `device` (default: the card).
    The step and the key stay on the host, as the port keeps them."""
    device = resolve_device(device)
    opt = AdamWState(
        step=torch.tensor(np.asarray(tree.opt.step), dtype=torch.int32),
        mu=params_from_numpy(tree.opt.mu, device),
        nu=params_from_numpy(tree.opt.nu, device))
    ef = None if tree.ef is None else \
        EFState(residual=params_from_numpy(tree.ef.residual, device))
    return TrainState(params=params_from_numpy(tree.params, device), opt=opt,
                      ef=ef, rng=np.array(tree.rng, dtype=np.uint32))


def to_numpy(x) -> np.ndarray:
    """A tensor (or array) as a host array, bf16 widened to fp32 (numpy
    has no bf16); a `DTensor` is gathered whole first."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if hasattr(x, "full_tensor"):           # a DTensor
            x = x.full_tensor()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.cpu().numpy()
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _restack(tree):
    """The port's tree with numpy leaves, each per-layer list stacked into
    one ``(R, ...)`` leaf per key path."""
    if isinstance(tree, dict):
        return {k: _restack(v) for k, v in tree.items()}
    if isinstance(tree, list):
        if isinstance(tree[0], dict):
            return {k: _restack([unit[k] for unit in tree])
                    for k in tree[0]}
        return np.stack([to_numpy(t) for t in tree])
    return to_numpy(tree)


def state_to_numpy(state):
    """The port's `TrainState` -> the same NamedTuples with numpy leaves in
    the JAX package's layout: the inverse of `state_from_numpy` but for
    bf16 leaves, which come back widened to fp32."""
    opt = AdamWState(step=np.asarray(state.opt.step.cpu(), dtype=np.int32),
                     mu=_restack(state.opt.mu), nu=_restack(state.opt.nu))
    ef = None if state.ef is None else \
        EFState(residual=_restack(state.ef.residual))
    return TrainState(params=_restack(state.params), opt=opt, ef=ef,
                       rng=np.array(state.rng, dtype=np.uint32))
