"""Closed-loop serving through the port's continuous-batching `Scheduler`.

`clients` clients each keep one request in flight: a client sends its
next request as soon as the previous one has returned its last token.
Requests come from a pool whose lengths and order are the same for every
seed (stratified draws of a log-uniform prompt law and a uniform output
law, `request_pool`); the seed draws the prompt token ids and the weights.
The scheduler runs on its own tick clock, so every run goes through the
same sequence of ticks; only their durations vary.

Set-up (the timed `setup_s`): kernel build, seeded weights, the bucket
table for the mix's envelope, the meta-device GEMM capture and the tuned
cache (modeled measurer, as `launch/serve_bench.py`), one prefill at
every (batch, prompt) bucket pair the mix can issue (largest first), then
the stream's first `ramp_ticks` ticks, in which the slab reaches its
largest batch bucket and each decode graph is captured.  The window then
runs ticks until `seconds` have passed; requests sent in it are drained
afterwards (at most `drain_s`), and a seeded sample of them, the longest
among them, is judged against the plain reference.

Each tick is timed on the host around `Scheduler.step()`, which ends in
the transfer of the step's tokens to the host.  A token is returned to
its client at the end of the tick that made it.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np

from pbcore import judge
from pbcore.stats import percentile


# ------------------------------------------------------------- traffic
def request_pool(traffic: dict, vocab: int, seed: int):
    """[(prompt token ids, max_new)].  The pool is `pool / block` blocks
    of `block` requests; a block holds one prompt length from each of its
    `block` quantile strata of the log-uniform law and one output length
    from each stratum of the uniform law (block j at offset frac((j +
    1/2) / golden ratio) inside its strata), the two lists shuffled apart.
    The lengths and their order are the same for every seed, so every
    seed's window serves the same mix in the same ticks; the prompt token
    ids come from the seed."""
    n, b = traffic["pool"], traffic["block"]
    pl, ol = traffic["prompt_tokens"], traffic["output_tokens"]
    if pl["dist"] != "loguniform" or ol["dist"] != "uniform":
        raise ValueError("serve_stream draws log-uniform prompts and "
                         "uniform outputs")
    order = np.random.default_rng(traffic["order_seed"])
    prompt, out = [], []
    for j in range(n // b):
        q = (np.arange(b) + ((j + 0.5) * 0.6180339887498949) % 1.0) / b
        prompt.append(order.permutation(
            np.rint(pl["lo"] * (pl["hi"] / pl["lo"]) ** q).astype(int)))
        out.append(order.permutation(
            (ol["lo"] + np.floor(q * (ol["hi"] - ol["lo"] + 1))).astype(int)))
    prompt, out = np.concatenate(prompt), np.concatenate(out)
    ids = np.random.default_rng(seed).integers(0, vocab, int(prompt.sum()))
    cuts = np.cumsum(prompt)[:-1]
    return [(toks, int(m)) for toks, m in zip(np.split(ids, cuts), out)]


# --------------------------------------------------------- the program
def port_config(c: dict):
    """The port's `ModelConfig` for configuration file `c`: the registry's
    entry with the file's values.  Every key of `reduced` differs from the
    registry, and every other key that differs is one of `assumed` (a
    size the source does not give, set by the file)."""
    from repro_torch.configs.base import get_config
    base = get_config(c["arch"])
    over, differ = {}, set()
    for f in dataclasses.fields(base):
        if f.name not in c or f.name == "name":
            continue
        val = c[f.name]
        if isinstance(getattr(base, f.name), tuple):
            val = tuple(val)
        over[f.name] = val
        if val != getattr(base, f.name):
            differ.add(f.name)
    if not set(c["reduced"]) <= differ <= set(c["reduced"]) | set(
            c.get("assumed", ())):
        raise ValueError(f"{c['arch']}: keys differing from the registry "
                         f"{sorted(differ)}; reduced {c['reduced']}, "
                         f"assumed {sorted(c.get('assumed', ()))}")
    return dataclasses.replace(base, **over)


@dataclasses.dataclass
class _Req:
    rid: int
    prompt: np.ndarray
    max_new: int
    t_send: float
    in_window: bool
    seen: int = 0
    t_first: float | None = None
    t_last: float | None = None
    tokens: tuple | None = None


class _Stream:
    """The clients' side: sends, token arrivals, per-tick records."""

    def __init__(self, sched, pool, trace: bool):
        from repro_torch.serve.sched.queue import Request
        self.Request = Request
        self.sched = sched
        self.pool = pool
        self.next_i = 0
        self.inflight: dict[int, _Req] = {}
        self.done: dict[int, _Req] = {}
        self.gaps: list[tuple[float, float]] = []     # (t token, gap s)
        self.keys = 0           # cached keys the tick's decode rows read
        self.trace = trace

    def send(self, t: float, in_window: bool) -> None:
        toks, max_new = self.pool[self.next_i % len(self.pool)]
        rid = self.next_i
        self.next_i += 1
        self.sched.submit(self.Request(rid=rid, tokens=tuple(toks.tolist()),
                                       max_new=max_new,
                                       arrival=self.sched.clock.now))
        self.inflight[rid] = _Req(rid, toks, max_new, t, in_window)

    def _arrive(self, r: _Req, n: int, t: float) -> int:
        new = n - r.seen
        if new <= 0:
            return 0
        # token j >= 1 comes from a decode step over P + j cached keys
        self.keys += sum(len(r.prompt) + j for j in range(max(r.seen, 1), n))
        k = new
        if r.seen == 0:
            r.t_first = t
            k -= 1
        else:
            self.gaps.append((t, t - r.t_last))
            k -= 1
        self.gaps.extend((t, 0.0) for _ in range(k))
        r.seen, r.t_last = n, t
        return new

    def tick(self) -> tuple[dict, list[_Req]]:
        """One `Scheduler.step()`, timed, and what it returned."""
        import contextlib

        from torch.profiler import record_function
        sched = self.sched
        admits = bool(len(sched.queue)) and \
            sched.policy.admit_budget(sched.n_live) > 0
        kind = "prefill" if admits else "decode"
        span = record_function if self.trace else \
            (lambda _: contextlib.nullcontext())
        t0 = time.perf_counter()
        with span(f"tick.{kind}"):
            sched.step()
        t1 = time.perf_counter()
        with span("harness.bookkeeping"):
            tokens, first, finished = 0, [], []
            self.keys = 0
            for lv in sched.live.values():
                r = self.inflight[lv.req.rid]
                was = r.seen
                tokens += self._arrive(r, len(lv.generated), t1)
                if was == 0:
                    first.append(len(r.prompt))
            for rid in [rid for rid in self.inflight
                        if rid in sched.results]:
                r = self.inflight.pop(rid)
                was = r.seen
                r.tokens = sched.results.pop(rid)["tokens"]
                tokens += self._arrive(r, len(r.tokens), t1)
                if was == 0:
                    first.append(len(r.prompt))
                self.done[rid] = r
                finished.append(r)
        rec = {"kind": kind, "t0": t0, "t1": t1, "tokens": tokens,
               "admitted": first, "decode_rows": tokens - len(first),
               "decode_keys": self.keys}
        return rec, finished


def _prefill_pairs(table, policy, lens) -> list[tuple[int, int]]:
    """(batch bucket, prompt bucket) pairs a prefill group can take,
    largest first."""
    most = min(policy.max_live, policy.max_admit_per_tick)
    batches = [b for b in table.batch_buckets
               if b <= table.batch_bucket(most)]
    prompts = sorted({table.prompt_bucket(int(n)) for n in lens})
    return sorted(((b, p) for b in batches for p in prompts),
                  key=lambda bp: (-bp[0] * bp[1], -bp[1]))


def run(ctx) -> dict:
    """Set up, measure, drain and judge one run (see the module doc)."""
    import torch

    from repro_torch.core import config as mmcfg
    from repro_torch.guard import health
    from repro_torch.serve import engine
    from repro_torch.serve.sched import (AdmissionPolicy, BucketTable,
                                         Scheduler, assert_covered,
                                         build_tuned_cache,
                                         capture_gemm_specs)
    from repro_torch.tune import runtime as tune_runtime

    c, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    setup = ctx.setup
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def mark(name, t0):
        sync()
        setup[name] = time.perf_counter() - t0
        return time.perf_counter()

    t = time.perf_counter()
    pcfg = port_config(c)
    if cuda:
        from repro_torch.kernels import build as kbuild
        kbuild.build_all()
    t = mark("build_s", t)
    weights = ctx.ref.make_weights(c, ctx.seed, dev)
    pool = request_pool(tr, c["vocab_size"], ctx.seed)
    t = mark("weights_s", t)
    lens = [len(p) for p, _ in pool]
    outs = [m for _, m in pool]
    table = BucketTable.for_workload(
        max_batch=tr["max_batch"], max_prompt=max(lens),
        max_new=max(outs), min_prompt=min(lens))
    specs = capture_gemm_specs(weights, pcfg, table)
    t = mark("capture_s", t)
    cache = build_tuned_cache(weights, pcfg, table)
    assert_covered(cache, specs)
    t = mark("tune_s", t)

    out: dict = {}
    with tune_runtime.use_cache(cache), mmcfg.mm_config(plan_mode="tuned"):
        policy = AdmissionPolicy(max_live=table.batch_buckets[-1],
                                 max_admit_per_tick=tr["max_admit_per_tick"])
        sched = Scheduler(weights, pcfg, table, policy=policy)
        gen = torch.Generator(device="cpu")
        gen.manual_seed(int(ctx.seed) % (1 << 63))
        for b, p in _prefill_pairs(table, sched.policy, lens):
            toks = torch.randint(0, c["vocab_size"], (b, p), generator=gen)
            last = torch.full((b,), p - 1, dtype=torch.long)
            engine.prefill(weights, pcfg, toks.to(dev),
                           max_len=table.max_len, last_index=last.to(dev))
            sync()
        t = mark("warm_s", t)

        stream = _Stream(sched, pool, ctx.trace)
        now = time.perf_counter()
        for _ in range(tr["clients"]):
            stream.send(now, False)
        for _ in range(tr["ramp_ticks"]):
            _, fin = stream.tick()
            now = time.perf_counter()
            for _ in fin:
                stream.send(now, False)
        setup["ramp_s"] = time.perf_counter() - t
        setup["graph_captures_ms"] = [round(g["ms"], 3)
                                      for g in sched.captures]
        out.update(_window(ctx, stream, health))
        out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                    if cuda else 0)
    done = [r for r in stream.done.values() if r.in_window]
    sample = _sample(done, tr["sample"], ctx.seed)
    del sched, stream.sched, cache
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    gaps = judge.gaps_of(ctx.ref, c, weights,
                             [r.prompt.tolist() for r in sample],
                             [list(r.tokens) for r in sample]) \
        if sample else torch.zeros(0)
    out["judge_s"] = time.perf_counter() - t
    got = judge.summary(gaps) if sample else {"widest": float("inf"),
                                              "mean": float("inf")}
    short = sum(len(r.tokens) != r.max_new for r in done)
    out["checks"] = judge.checks(c["correct"], got, short, out["failed"])
    out["correct"] = judge.passes(out["checks"])
    out["sample"] = {"requests": len(sample), "gaps": got,
                     "served_tokens": int(gaps.numel()),
                     "longest": max((len(r.prompt) + len(r.tokens)
                                     for r in sample), default=0)}
    out["weights"], out["sample_reqs"] = weights, sample
    return out


def _window(ctx, stream: _Stream, health) -> dict:
    """The measured window, then the drain."""
    import contextlib

    import torch
    prof = None
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if ctx.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        win_rng = record_function("portbench.window")
    else:
        win_rng = contextlib.nullcontext()
    h0 = health.snapshot()
    ticks = []
    t_w0 = time.perf_counter()
    ctx.setup["setup_s"] = t_w0 - ctx.t_proc0
    deadline = t_w0 + ctx.seconds
    with win_rng:
        while True:
            rec, fin = stream.tick()
            ticks.append(rec)
            if rec["t1"] >= deadline:
                break
            now = time.perf_counter()
            for _ in fin:
                stream.send(now, True)
    t_w1 = ticks[-1]["t1"]
    h1 = health.snapshot()
    t_tr = time.perf_counter()
    if prof is not None:
        from pbcore.devtrace import DeviceTrace
        prof.__exit__(None, None, None)
        dtrace = DeviceTrace.from_profiler(prof)
        del prof
    else:
        dtrace = None
    trace_s = time.perf_counter() - t_tr
    # drain: no new sends; wait for every request sent in the window
    t_d = time.perf_counter()
    while any(r.in_window for r in stream.inflight.values()) and \
            time.perf_counter() - t_d < ctx.traffic["drain_s"]:
        stream.tick()
    sent = [r for r in list(stream.done.values())
            + list(stream.inflight.values()) if r.in_window]
    failed = sum(r.rid in stream.inflight for r in sent)
    window_s = t_w1 - t_w0
    ttft = [r.t_first - r.t_send for r in sent if r.t_first is not None]
    itl = [g for t, g in stream.gaps if t_w0 < t <= t_w1]
    tok = sum(rec["tokens"] for rec in ticks)
    health_delta = {k: v - h0.get(k, 0) for k, v in h1.items()}
    return {
        "attempted": len(sent), "failed": failed,
        "metrics": {"serve_tok_s": tok / window_s,
                    "ttft_p90_ms": 1e3 * percentile(ttft, 90),
                    "itl_p95_ms": 1e3 * percentile(itl, 95)},
        "layer_ctx": {"ticks": ticks, "window_s": window_s,
                      "health": health_delta, "trace": dtrace},
        "counts": {"ticks": len(ticks),
                   "prefill_ticks": sum(r["kind"] == "prefill"
                                        for r in ticks),
                   "tokens": tok, "sent": len(sent),
                   "ttft_samples": len(ttft), "itl_samples": len(itl),
                   "drain_s": time.perf_counter() - t_d,
                   "trace_s": trace_s,
                   "ttft_p50_ms": 1e3 * percentile(ttft, 50),
                   "ttft_p95_ms": 1e3 * percentile(ttft, 95),
                   "itl_p50_ms": 1e3 * percentile(itl, 50)},
    }


def _sample(done: list[_Req], spec: dict, seed: int) -> list[_Req]:
    """The longest finished request, then others in a seeded order until
    `min_served_tokens` served tokens or `max_requests` requests."""
    if not done:
        return []
    done = sorted(done, key=lambda r: r.rid)
    longest = max(done, key=lambda r: (len(r.prompt) + len(r.tokens), -r.rid))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([seed, 1]).permutation(len(rest))
    out, served = [longest], len(longest.tokens)
    for i in order:
        if served >= spec["min_served_tokens"] or \
                len(out) >= spec["max_requests"]:
            break
        out.append(rest[i])
        served += len(rest[i].tokens)
    return out
