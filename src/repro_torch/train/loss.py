"""Chunked-vocabulary cross-entropy.

A (tokens x vocab) logits tensor is never materialized whole: the loss
walks the sequence in chunks, computing each chunk's logits from the final
hidden states, and `torch.utils.checkpoint` makes the backward recompute
them, so peak memory is O(B * chunk * V).  This is the vocab projection's
analogue of the paper's memory-budgeted planning (an extremely
right-skewed matmul run in budget-sized slices).

Each chunk of a walk of two or more is checkpointed by
`models.remat.checkpointed`, which re-enters the forward's configuration
in the recompute (the backward's own thread on a CUDA tensor) and
records nothing there; chunks after the first run in
`stage_trace.repeat`, so host records (plans, spans) are made once, as
the JAX package's `lax.scan` body is traced once.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import stage_trace
from repro_torch.distributed import sharding
from repro_torch.models import remat


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
        hidden = sharding.pad(hidden, (0, 0, 0, pad))
        targets = sharding.pad(targets, (0, pad))
        mask = sharding.pad(mask, (0, pad))

    def step(h, t, m):
        logits = logits_fn(h).to(torch.float32)              # (B, c, V)
        logz = torch.logsumexp(logits, dim=-1)
        # on a mesh the gold logit is read from whole vocab rows: DTensor
        # cannot reduce a gather over a vocab split
        whole = sharding.constrain(logits, "dp", None, None)
        gold = torch.gather(whole, -1, t[..., None])[..., 0]
        nll = (logz - gold) * m
        return torch.sum(nll), torch.sum(m)

    # a single chunk: XLA inlines JAX's one-trip scan and merges the
    # checkpoint's recompute with the forward (3 logits-sized dots in its
    # program, 4 a chunk from two chunks on), so nothing is recomputed
    n = hidden.shape[1] // chunk
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        with stage_trace.repeat(i):
            nll_sum, cnt = remat.checkpointed(
                step, hidden[:, sl], targets[:, sl], mask[:, sl], trips=n)
        total = total + nll_sum
        count = count + cnt
    return total / torch.clamp(count, min=1.0)
