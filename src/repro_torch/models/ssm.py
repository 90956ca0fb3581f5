"""SSM mixer pieces.  Only `causal_conv1d` is ported so far: the recurrent
(RG-LRU) block shares it; the Mamba-2 mixer comes with the SSM slice."""

from __future__ import annotations

import torch


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
