"""The graph-captured decode step: the port's counterpart of the `jax.jit`
that the JAX launcher puts over `engine.decode_step`.

`DecodeGraph(params, cfg, cache, batch)` captures one `engine.decode_step`
(`encdec_engine.decode_step` for an encoder-decoder) into a
`torch.cuda.CUDAGraph` against the served cache, once per (model, batch,
cache length), and replays it for every token.  `step(tok, pos)`
copies the tokens and the position into static device tensors, replays
the graph and returns the static logits (B, V) fp32; the caller consumes
them before the next step.  A replay runs the hand-written kernels that an
eager step launches, in the same order, on the same planned blocks: the
graph only removes the host's per-op work between them.

Before the capture, `WARMUP_STEPS` eager steps run on a scratch copy of
the cache on a side stream.  Decode updates the cache in place, so a
warm-up on the served cache would advance recurrent and SSD states twice
and write a stray k/v slot.  The warm-up builds and loads every kernel
library, sets the kernels' shared-memory attributes and fills the
planners' caches, so that the capture records launches and nothing else.

Launch counts: the kernel wrappers count on the host, so a capture bumps
them although nothing ran, and a replay would not.  The capture's bumps
are taken back and kept as `per_step`; each replay adds them to the
kernel modules' counters, so `ops.launch_counts()` stays the number of
launches the card ran.  The warm-up's launches ran and stay counted.

The host ledger of `guard.health` is kept by the capture: the warm-up
runs with host records off (`stage_trace.quiet`: it serves no token), and
the counters the capture records (the tuned-plan lookups, the MoE
capacity slots under `moe.track_capacity_slots`, whatever a step records
on the host) stand for the first replay's.  Their increments are kept as
`host_per_step` and every later replay adds them, so a graphed run leaves
the ledger an eager run of the same steps leaves.

On CPU tensors (the caller asks for the CPU) there is no graph: the same
object warms up on a scratch copy and `step` calls `engine.decode_step`
on the same static buffers.  On CUDA a failed capture or replay raises;
nothing falls back to eager decode.
"""

from __future__ import annotations

import collections

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import config as mmcfg
from repro_torch.core import stage_trace
from repro_torch.guard import health
from repro_torch.kernels import ops
from repro_torch.obs.metrics import REGISTRY
from repro_torch.serve import encdec_engine, engine

WARMUP_STEPS = 1


def _counters() -> dict[str, int]:
    """The health registry's counters, its gauges and the tracer's
    `obs_*` counters set apart (those count spans, and a replay makes
    none)."""
    return {name: m["value"] for name, m in REGISTRY.snapshot().items()
            if m["kind"] == "counter" and not name.startswith("obs_")}


def clone_cache(cache):
    """A copy of a cache tree (dicts of tensors), tensor by tensor."""
    if isinstance(cache, dict):
        return {k: clone_cache(v) for k, v in cache.items()}
    return cache.clone()


class DecodeGraph:
    """One decode step of `cfg` against `cache` at `batch` rows, captured
    on the card and replayed by `step`.

    `per_row_pos` makes the position tensor (B,) (each row at its own
    depth) instead of 0-d.  The matmul configuration active at
    construction is the one every step runs under: the capture bakes its
    plans in.
    """

    def __init__(self, params, cfg: ModelConfig, cache, batch: int, *,
                 per_row_pos: bool = False):
        self.params, self.cfg, self.cache = params, cfg, cache
        self.mm = mmcfg.resolve()
        dev = params["embed"].device
        self.tok = torch.zeros((batch,), dtype=torch.long, device=dev)
        self.pos = torch.zeros((batch,) if per_row_pos else (),
                               dtype=torch.int32, device=dev)
        self.graph = None
        self.per_step: list[collections.Counter] = [
            collections.Counter() for _ in ops.launch_counters()]
        self.host_per_step: dict[str, int] = {}
        self._replays = 0
        scratch = clone_cache(cache)
        if dev.type != "cuda":
            with stage_trace.quiet():
                for _ in range(WARMUP_STEPS):
                    out = self._run(scratch)
            self.logits = torch.empty_like(out)
            return
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), stage_trace.quiet():
            for _ in range(WARMUP_STEPS):
                self._run(scratch)
        torch.cuda.current_stream(dev).wait_stream(side)
        del scratch
        self.graph = torch.cuda.CUDAGraph()
        counters = ops.launch_counters()
        before = [collections.Counter(c) for c in counters]
        host = _counters()
        try:
            with torch.cuda.graph(self.graph):
                self.logits = self._run(cache)
        finally:
            for c, b, step in zip(counters, before, self.per_step):
                step.update(c - b)
                c.clear()
                c.update(b)
        self.host_per_step = {name: v - host.get(name, 0)
                              for name, v in _counters().items()
                              if v != host.get(name, 0)}

    def _run(self, cache) -> torch.Tensor:
        step = (encdec_engine.decode_step if self.cfg.family == "encdec"
                else engine.decode_step)
        logits, _ = step(self.params, self.cfg, cache, self.tok, self.pos,
                         mm=self.mm)
        return logits

    @property
    def launches_per_step(self) -> dict[str, int]:
        """Kernel launches one replay runs, by kernel (empty on the CPU)."""
        return dict(sum(self.per_step, collections.Counter()))

    def step(self, tok: torch.Tensor, pos) -> torch.Tensor:
        """Decode one token: tok (B,) int, pos an int, a 0-d tensor or (B,)
        positions.  Returns the static logits (B, V) fp32, overwritten by
        the next step."""
        self.tok.copy_(tok)
        if isinstance(pos, torch.Tensor):
            self.pos.copy_(pos)
        else:
            self.pos.fill_(pos)
        if self.graph is None:
            self.logits.copy_(self._run(self.cache))
            return self.logits
        self.graph.replay()
        for c, step in zip(ops.launch_counters(), self.per_step):
            c.update(step)
        if self._replays:
            for name, n in self.host_per_step.items():
                health.record(name, n)
        self._replays += 1
        return self.logits
