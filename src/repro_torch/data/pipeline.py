"""Deterministic token pipeline.

Two sources behind one interface, drawing what the JAX package's draw:
  * SyntheticLM  — a seeded Zipf-ish token stream (benchmarks, smoke runs);
  * MemmapTokens — a flat binary token file (np.memmap), the production
    path.

The loader delivers each batch as an int32 tensor on its device (the card
unless told otherwise), with deterministic resume: the iterator state is a
single step counter, so a restart at `start_step` replays exactly (the
fault-tolerance contract).  A background thread keeps a bounded queue of
ready host batches.  Given a `DeviceMesh` of more than one rank, the
loader delivers each batch as a `DTensor` placed by
`distributed.sharding.batch_spec`: dim 0 split over the data axes when
they divide it.  On a mesh of one rank it is a plain tensor on the mesh's
device (`sharding.distributes`).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.distributed import sharding


class SyntheticLM:
    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.seed = seed

    def batch(self, step: int, batch_size: int, seq_len: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        # Zipf-flavored marginal so losses resemble text, capped to vocab.
        z = rng.zipf(1.3, size=(batch_size, seq_len)).astype(np.int64)
        return (z % self.vocab_size).astype(np.int32)


class MemmapTokens:
    def __init__(self, path: str, vocab_size: int):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.vocab_size = vocab_size

    def batch(self, step: int, batch_size: int, seq_len: int) -> np.ndarray:
        n = batch_size * seq_len
        total = len(self.tokens) - 1
        start = (step * n) % max(total - n, 1)
        flat = np.asarray(self.tokens[start:start + n])
        return flat.reshape(batch_size, seq_len)


class DataLoader:
    """Step-addressable loader with background prefetch; yields
    ``{"tokens": int32 tensor on device}`` (a `DTensor` on `mesh`'s devices
    when a mesh of more than one rank is given)."""

    def __init__(self, source, batch_size: int, seq_len: int, device=None,
                 prefetch: int = 2, start_step: int = 0, mesh=None):
        self.source = source
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.mesh = mesh
        self.device = resolve_device(
            device if mesh is None else mesh.device_type)
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            arr = self.source.batch(step, self.batch_size, self.seq_len)
            while not self._stop.is_set():
                try:
                    self._q.put((step, arr), timeout=0.5)
                    step += 1
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, arr = self._q.get()
        self.step = step + 1
        tokens = torch.from_numpy(arr).to(self.device)
        if sharding.distributes(self.mesh):
            tokens = sharding.place(
                tokens, sharding.batch_spec(tuple(arr.shape), self.mesh),
                self.mesh)
        return {"tokens": tokens}

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
