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
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


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
