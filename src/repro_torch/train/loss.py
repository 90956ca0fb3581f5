"""Chunked-vocabulary cross-entropy.

A (tokens x vocab) logits tensor is never materialized whole: the loss
walks the sequence in chunks, computing each chunk's logits from the final
hidden states, and `torch.utils.checkpoint` makes the backward recompute
them, so peak memory is O(B * chunk * V).  This is the vocab projection's
analogue of the paper's memory-budgeted planning (an extremely
right-skewed matmul run in budget-sized slices).

The recompute runs inside the backward, which on a CUDA tensor is the
autograd engine's device thread: a fresh thread, where the thread-local
`mm_config` stack and `core.stage_trace` state are empty.  So the chunk's
function re-enters the configuration resolved at the forward, and host
records (plans, spans) are made once, by the first chunk of the forward,
as the JAX package's `lax.scan` body is traced once; later chunks and the
recompute run under `stage_trace.quiet()`.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import config, stage_trace


def chunked_softmax_xent(hidden: torch.Tensor, targets: torch.Tensor,
                         logits_fn: Callable[[torch.Tensor], torch.Tensor],
                         mask: torch.Tensor | None = None,
                         chunk: int = 512) -> torch.Tensor:
    """Mean NLL, fp32.  hidden (B, S, D); targets (B, S) integer; mask
    (B, S)."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device) \
        if mask is None else mask.to(torch.float32)
    targets = targets.to(torch.int64)
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    cfg = config.resolve()
    calls = itertools.count()

    def step(h, t, m):
        records = next(calls) == 0
        with config.scope(cfg), (contextlib.nullcontext() if records
                                 else stage_trace.quiet()):
            logits = logits_fn(h).to(torch.float32)          # (B, c, V)
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, t[..., None])[..., 0]
            nll = (logz - gold) * m
            return torch.sum(nll), torch.sum(m)

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(hidden.shape[1] // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        nll_sum, cnt = checkpoint(step, hidden[:, sl], targets[:, sl],
                                  mask[:, sl], use_reentrant=False,
                                  preserve_rng_state=False)
        total = total + nll_sum
        count = count + cnt
    return total / torch.clamp(count, min=1.0)
