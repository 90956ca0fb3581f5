"""Activation recompute where the JAX package puts `jax.checkpoint`.

The JAX package checkpoints each repeating unit of a stage
(`transformer.forward_hidden`), each encoder and decoder block
(`encdec`), each kv step of `layers.blockwise_attention` and each chunk
of the loss: the backward keeps only those functions' inputs and runs
their forward again.  `checkpointed` is the port's form of it, a
non-reentrant `torch.utils.checkpoint`, applied only where a gradient is
being taken (`torch.is_grad_enabled()`), as JAX's checkpoint does nothing
in a forward that is not differentiated.  The loss and the kv steps
give the length of their walk (`trips`): a walk of one step is not
checkpointed, as XLA merges a one-trip checkpoint into the forward and
JAX's program recomputes nothing there.
No forward of the models draws random numbers, so no RNG state is kept.

The recompute runs inside the backward, which on a CUDA tensor (a fake
one too) is the autograd engine's device thread: a fresh thread, where
the thread-local `mm_config` stack, `stage_trace` state and
`layers.chunk_override` are empty.  So the function re-enters the
configuration and chunking resolved at the forward, and host records
(plans, spans, MoE slots) are made by the forward call alone, as JAX
traces a checkpointed body once; the recompute runs under
`stage_trace.quiet()`.
"""

from __future__ import annotations

import contextlib
import itertools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import config, stage_trace


def checkpointed(fn, *args, trips: int | None = None):
    """``fn(*args)``; with grad enabled, its activations are recomputed in
    the backward from `args` (the tensors the backward keeps) instead of
    being saved.  `fn` may close over parameters and other live tensors;
    gradients reach them as well.  `trips`, where given, is the number of
    steps of the walk `fn` is one step of: a walk of one step runs `fn`
    plainly."""
    if not torch.is_grad_enabled() or trips == 1:
        return fn(*args)
    from repro_torch.models import layers     # layers runs this helper
    cfg = config.resolve()
    chunks = layers.current_chunk_override()
    calls = itertools.count()

    def run(*a):
        records = next(calls) == 0
        with config.scope(cfg), (layers.chunk_override(*chunks) if chunks
                                 else contextlib.nullcontext()), \
                (contextlib.nullcontext() if records
                 else stage_trace.quiet()):
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)

