"""LR schedules: pure functions of the step, computed in fp32 on the host
as the JAX package computes them."""

from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    """lr(step) -> 0-d fp32 CPU tensor: linear warm-up to `peak_lr`, then a
    cosine decay to ``min_ratio * peak_lr`` at `total_steps`.  `step` is an
    int or an integer tensor; each operation rounds to fp32 in the order of
    the JAX package's expression.  The cosine is taken in fp64 and rounded
    once: XLA's fp32 cosine and torch's each land up to an ulp from the
    correctly rounded value, in different places, so the schedule agrees
    with the JAX one to 2 ulps, not bit for bit."""
    def lr(step):
        s = torch.as_tensor(step, device="cpu").to(torch.float32)
        warm = peak_lr * s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps) /
                           max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                         (1 + torch.cos((math.pi * prog).double()).float()))
        return torch.where(s < warmup_steps, warm, cos)
    return lr
