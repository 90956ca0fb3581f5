"""The continuous-batching step loop.

One `Scheduler.step()` is one simulated tick:

1. **Admission** — pop arrived requests (FIFO, bounded by the admission
   policy and free KV rows), group them by prompt bucket, and prefill
   each group as one right-padded batch on a (batch bucket, prompt
   bucket) shape.  Prefilled rows scatter into the live KV slab at
   free-list slots (`index_copy_` along the batch axis of every cache
   tensor); the prefill logits yield each request's first token.
2. **Batched decode** — every live request advances one token through a
   single `decode_step` at the slab's batch bucket with *per-row*
   positions.  Joins scatter in, leaves release their slot; survivors
   are never re-padded or moved.  The slab only grows, by zero-padding
   the batch axis to the next bucket (`kvcache.pad_axis`).  Free rows
   decode token 0 at position 0, and the next admission's scatter
   overwrites them whole.

The slab lives on the device and is written in place.  On the card the
decode step is one replay of a CUDA graph (`serve.graphs.DecodeGraph`,
per-row positions) captured against the slab when it reaches a batch
bucket: the slab only grows, so each bucket is captured at most once a
run, and growing the slab drops the graph captured against the old one.
A join or leave writes only the graph's static token and position
tensors.  A failed capture or replay raises; nothing falls back to eager
decode.  On CPU tensors decode is eager, as in the JAX package, and
``decode_graphs=False`` gives the eager route on the card too.

`guard=True` keeps the serving-boundary scrub.  Eager decode runs
through `engine.guarded_decode_step`.  A prefill and a replay are
followed by one read of the argmax and a finiteness flag of the logits,
in the same transfer to the host; with no fault scope armed, non-finite
logits raise `NumericFault`.  While a fault
scope is armed, decode runs eagerly through `guarded_decode_step`, whose
injection site cannot sit inside a replay (the JAX chaos path).  MoE
models batch every live request's expert GEMMs in the same capacity
slots simply by decoding jointly; with `track_capacity_slots` armed the
health ledger shows whether the slots ship full.  The decode graph adds
the host counters its capture recorded to every replay, so a graphed
run leaves the ledger an eager run leaves.

While a `torch.profiler` records, the scheduler's spans are profiler
ranges (`repro_torch.tick` / `admit` / `prefill` / `decode`, with the
phases `forward`, `sample`, `scatter` and `slab` inside them), and the
scheduler counts its work into `guard.health` as it happens: each
request's wall us from `submit` to the start of its prefill group
(`serve_queue_wait_us` over `serve_queue_waits`), each prefill group's
real prompt tokens against its batch x prompt bucket
(`serve_prefill_tokens`, `serve_prefill_slots`), and each decode step's
cached keys of the live rows against the slab's rows x `max_len`
(`serve_decode_keys`, `serve_kv_slots`).  They are counted outside the
decode graph, so a replay adds none of them; with the profiler off
nothing is counted, and the ledger stays the JAX package's.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.guard import faults, health
from repro_torch.guard.fallback import NumericFault
from repro_torch.models import moe
from repro_torch.obs import spans as _obs
from repro_torch.serve import engine, graphs, kvcache
from repro_torch.serve.sched import moebatch
from repro_torch.serve.sched.buckets import BucketTable
from repro_torch.serve.sched.queue import (AdmissionPolicy, Clock, Request,
                                           RequestQueue)
from repro_torch.serve.sched.telemetry import ServeTelemetry


@dataclasses.dataclass
class _Live:
    """Mutable per-slot progress of one admitted request."""

    req: Request
    row: int
    generated: list[int]
    admit_tick: int


def _map_cache(fn, *trees):
    """Apply `fn` leaf by leaf over cache trees of one structure."""
    if isinstance(trees[0], dict):
        return {k: _map_cache(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


class Scheduler:
    """Continuous-batching scheduler over a bucket table.

    `guard=True` keeps the serving-boundary NaN scrub; `track_moe_slots`
    (default: on for MoE configs) arms `moe.track_capacity_slots()` around
    every model call.  `decode_graphs` (default: on CUDA tensors) decodes
    through one `DecodeGraph` per batch bucket; ``True`` on CPU tensors
    runs the graph object's eager CPU form.  The device is the
    parameters'.
    """

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        table: BucketTable,
        *,
        policy: AdmissionPolicy | None = None,
        clock: Clock | None = None,
        telemetry: ServeTelemetry | None = None,
        guard: bool = True,
        track_moe_slots: bool | None = None,
        trace_logits: bool = False,
        decode_graphs: bool | None = None,
    ):
        table.validate_for(cfg)
        self.params = params
        self.cfg = cfg
        self.table = table
        self.policy = policy or AdmissionPolicy(max_live=table.batch_buckets[-1])
        if self.policy.max_live > table.batch_buckets[-1]:
            raise ValueError(
                f"max_live {self.policy.max_live} exceeds the largest "
                f"batch bucket {table.batch_buckets[-1]}"
            )
        self.clock = clock or Clock()
        self.telemetry = telemetry or ServeTelemetry()
        self.guard = guard
        self.track_moe = (
            moebatch.has_moe(cfg) if track_moe_slots is None else track_moe_slots
        )
        self.device = params["embed"].device
        self.decode_graphs = (self.device.type == "cuda"
                              if decode_graphs is None else decode_graphs)
        self.queue = RequestQueue()
        self.live: dict[int, _Live] = {}
        self.results: dict[int, dict] = {}
        # rid -> [np logits row per generated token]; the join/leave
        # invariant tests compare these to a solo decode.  Beside them, the
        # batch each row was computed at (the prefill group's batch
        # bucket, then the slab's).
        self.trace_logits = trace_logits
        self.logit_trace: dict[int, list[np.ndarray]] = {}
        self.logit_batches: dict[int, list[int]] = {}
        # the slab's batch bucket after each growth, and one entry per
        # decode graph captured: {"batch": B, "ms": host ms of the
        # warm-up and capture (a synchronise on the card)}
        self.slab_history: list[int] = []
        self.captures: list[dict] = []
        self._slab = None  # KV cache tree at the current batch bucket
        self._graph: graphs.DecodeGraph | None = None
        self._free: kvcache.SlotFreeList | None = None
        self._tokens: np.ndarray | None = None  # (B,) last token per row
        self._pos: np.ndarray | None = None  # (B,) next write position
        self._submitted_ns: dict[int, int] = {}  # rid -> submit wall ns

    # ------------------------------------------------------------- intake
    @property
    def n_live(self) -> int:
        return len(self.live)

    @property
    def slab_batch(self) -> int:
        return 0 if self._free is None else self._free.capacity

    def submit(self, req: Request) -> None:
        self.table.prompt_bucket(req.prompt_len)  # raises if unservable
        if req.max_new > self.table.max_new:
            raise ValueError(
                f"request {req.rid}: max_new {req.max_new} exceeds table "
                f"budget {self.table.max_new}"
            )
        self._submitted_ns[req.rid] = time.perf_counter_ns()
        self.queue.push(req)

    # -------------------------------------------------------------- slab
    def _ensure_slab(self, required: int) -> None:
        if required > self.slab_batch:
            with _obs.phase("slab"):
                self._grow_slab(required)

    def _grow_slab(self, required: int) -> None:
        cur = self.slab_batch
        new_b = self.table.batch_bucket(required)
        if self._slab is None:
            self._slab = kvcache.init_cache(self.cfg, new_b,
                                            self.table.max_len, self.device)
            self._free = kvcache.SlotFreeList(new_b)
            self._tokens = np.zeros(new_b, np.int64)
            self._pos = np.zeros(new_b, np.int32)
        else:
            # grow only: survivors keep their rows.  The graph captured
            # against the old slab is stale; drop it before the copy.
            self._graph = None
            self._slab = _map_cache(
                lambda x: kvcache.pad_axis(x, 1, new_b), self._slab)
            self._free.grow(new_b)
            self._tokens = np.pad(self._tokens, (0, new_b - cur))
            self._pos = np.pad(self._pos, (0, new_b - cur))
        self.slab_history.append(new_b)

    def _model_call(self, thunk):
        if self.track_moe:
            with moe.track_capacity_slots():
                return thunk()
        return thunk()

    # --------------------------------------------------------- admission
    def _prefill_group(self, reqs: list[Request], pb: int, now: int) -> None:
        n = len(reqs)
        b_pad = self.table.batch_bucket(n)
        t_ns = time.perf_counter_ns()
        waits = [t_ns - self._submitted_ns.pop(r.rid, t_ns) for r in reqs]
        if _obs.profiling():
            health.record("serve_queue_wait_us", sum(waits) // 1000)
            health.record("serve_queue_waits", n)
            health.record("serve_prefill_tokens",
                          sum(r.prompt_len for r in reqs))
            health.record("serve_prefill_slots", b_pad * pb)
        with _obs.span("prefill", f"pb{pb}", bucket=pb, n=n, batch=b_pad,
                       rids=tuple(r.rid for r in reqs)):
            self._prefill_group_inner(reqs, pb, now, n, b_pad)

    def _prefill_group_inner(self, reqs: list[Request], pb: int, now: int,
                             n: int, b_pad: int) -> None:
        tokens = np.zeros((b_pad, pb), np.int64)
        last = np.zeros(b_pad, np.int64)
        for i, r in enumerate(reqs):
            tokens[i, : r.prompt_len] = r.tokens
            last[i] = r.prompt_len - 1
        dev = self.device
        with _obs.phase("forward"):
            cache, logits = self._model_call(
                lambda: engine.prefill(
                    self.params,
                    self.cfg,
                    torch.from_numpy(tokens).to(dev),
                    max_len=self.table.max_len,
                    last_index=torch.from_numpy(last).to(dev),
                )
            )
        with _obs.phase("sample"):
            first = self._argmax(logits, "prefill")
        if self.trace_logits:
            rows_np = logits.float().cpu().numpy()
            for i, r in enumerate(reqs):
                self.logit_trace[r.rid] = [rows_np[i]]
                self.logit_batches[r.rid] = [b_pad]
        rows = [self._free.alloc() for _ in reqs]
        # pad-on-device stays on device: scatter the n real rows into the
        # slab at their allocated slots (unpad-on-fetch).
        with _obs.phase("scatter"):
            idx = torch.tensor(rows, dtype=torch.long, device=dev)
            _map_cache(lambda slab, new: slab.index_copy_(1, idx, new[:, :n]),
                       self._slab, cache)
        del cache
        self.telemetry.prefill_batches += 1
        for i, r in enumerate(reqs):
            row = rows[i]
            lv = _Live(req=r, row=row, generated=[int(first[i])], admit_tick=now)
            self.telemetry.observe_admission(now - r.arrival)
            self.telemetry.observe_first_token(now - r.arrival + 1)
            self.telemetry.tokens_out += 1
            if r.max_new == 1:
                self._complete(lv, now)
            else:
                self.live[row] = lv
                self._tokens[row] = first[i]
                self._pos[row] = r.prompt_len

    def _admit(self, now: int) -> None:
        budget = self.policy.admit_budget(self.n_live)
        admitted = self.queue.pop_ready(now, budget)
        if not admitted:
            return
        with _obs.span("admit", n=len(admitted)):
            self._ensure_slab(self.n_live + len(admitted))
            groups: dict[int, list[Request]] = {}
            for r in admitted:
                groups.setdefault(
                    self.table.prompt_bucket(r.prompt_len), []
                ).append(r)
            for pb in sorted(groups):
                self._prefill_group(groups[pb], pb, now)

    def _argmax(self, logits: torch.Tensor, what: str) -> np.ndarray:
        """Each row's argmax on the host.  Under `guard` with no fault
        scope armed, a finiteness flag of the logits rides in the same
        transfer, and a non-finite `what` raises `NumericFault`."""
        if not self.guard or faults.active() is not None:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        flag = torch.isfinite(logits).all().reshape(1).long()
        packed = torch.cat([torch.argmax(logits, dim=-1), flag]).cpu()
        if not packed[-1]:
            raise NumericFault(f"{what} logits non-finite with no fault "
                               f"scope armed")
        return packed[:-1].numpy()

    # ------------------------------------------------------------ decode
    def _capture(self) -> graphs.DecodeGraph:
        """The decode graph of the slab's batch bucket, captured against
        the slab (warm-up on a scratch copy, then the capture)."""
        t0 = time.perf_counter()
        graph = graphs.DecodeGraph(self.params, self.cfg, self._slab,
                                   len(self._tokens), per_row_pos=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.captures.append({"batch": len(self._tokens),
                              "ms": (time.perf_counter() - t0) * 1e3})
        return graph

    def _decode_step(self) -> tuple[torch.Tensor, np.ndarray]:
        """One batched decode step over the slab: the logits (B, V) fp32
        and each row's argmax on the host."""
        tok = torch.from_numpy(self._tokens).to(self.device)
        pos = torch.from_numpy(self._pos).to(self.device)
        if self.decode_graphs and not (self.guard and faults.active()):
            if self._graph is None:
                self._graph = self._capture()
            with _obs.phase("forward"):
                logits = self._graph.step(tok, pos)
            with _obs.phase("sample"):
                return logits, self._argmax(logits, "decode step")
        step_fn = (engine.guarded_decode_step if self.guard
                   else engine.decode_step)
        with _obs.phase("forward"):
            logits, self._slab = step_fn(self.params, self.cfg, self._slab,
                                         tok, pos)
        with _obs.phase("sample"):
            return logits, torch.argmax(logits, dim=-1).cpu().numpy()

    def _decode_all(self, now: int) -> None:
        if _obs.profiling():
            # row r attends to its _pos[r] cached keys and the one it writes
            rows = list(self.live)
            health.record("serve_decode_keys",
                          int(self._pos[rows].sum()) + len(rows))
            health.record("serve_kv_slots",
                          len(self._tokens) * self.table.max_len)
        with _obs.span("decode", batch=len(self._tokens), live=len(self.live)):
            logits, tok = self._model_call(self._decode_step)
        # a copy: the decode graph's logits are overwritten by its next step
        logits_np = (logits.to("cpu", torch.float32, copy=True).numpy()
                     if self.trace_logits else None)
        self.telemetry.decode_steps += 1
        for row in sorted(self.live):
            lv = self.live[row]
            if logits_np is not None:
                self.logit_trace[lv.req.rid].append(logits_np[row])
                self.logit_batches[lv.req.rid].append(len(self._tokens))
            lv.generated.append(int(tok[row]))
            self.telemetry.tokens_out += 1
            self._tokens[row] = tok[row]
            self._pos[row] += 1
            if len(lv.generated) >= lv.req.max_new:
                self._complete(lv, now)

    def _complete(self, lv: _Live, now: int) -> None:
        self.live.pop(lv.row, None)
        self._free.release(lv.row)
        self._tokens[lv.row] = 0
        self._pos[lv.row] = 0
        self.results[lv.req.rid] = {
            "tokens": tuple(lv.generated),
            "ttft": lv.admit_tick - lv.req.arrival + 1,
            "latency": now - lv.req.arrival + 1,
        }
        self.telemetry.observe_completion(
            now - lv.req.arrival + 1, len(lv.generated)
        )

    # --------------------------------------------------------------- run
    def step(self) -> None:
        """One tick: admit + prefill, then one batched decode step."""
        now = self.clock.now
        with _obs.span("tick", f"t{now}", tick=now):
            self._admit(now)
            if self.live:
                self._decode_all(now)
        self.telemetry.ticks += 1
        self.clock.advance()

    def run(self, requests=None, max_ticks: int = 1000) -> dict[int, dict]:
        """Drive the loop until the stream drains (or max_ticks)."""
        for r in requests or ():
            self.submit(r)
        for _ in range(max_ticks):
            if not self.queue and not self.live:
                break
            self.step()
        self.telemetry.record_health()
        return self.results


def scripted_trace(
    entries, *, vocab_size: int, seed: int = 0
) -> list[Request]:
    """Deterministic arrival trace: entries of (arrival, prompt_len,
    max_new) become `Request`s with seeded-random prompt tokens.  No
    Poisson, no wall clock — the same entries always replay the same
    trace."""
    rng = np.random.default_rng(seed)
    reqs = []
    for rid, (arrival, prompt_len, max_new) in enumerate(entries):
        toks = tuple(int(t) for t in rng.integers(0, vocab_size, prompt_len))
        reqs.append(
            Request(rid=rid, tokens=toks, max_new=max_new, arrival=arrival)
        )
    return reqs
