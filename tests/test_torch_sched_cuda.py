"""The continuous-batching scheduler on the card (`cuda`-marked: these tests
skip where there is no CUDA device, and fail under
``REPRO_TORCH_REQUIRE_CUDA=1``).  No JAX in this file: the card's machine
has none.

    REPRO_TORCH_REQUIRE_CUDA=1 PYTHONPATH=src \\
        python -m pytest -q -m cuda tests/test_torch_sched_cuda.py

At phi4-mini's `reduced()` config in bf16, under plan_mode="tuned" with
the modeled covering cache:

* the scheduler decoding through one CUDA graph per batch bucket and the
  same scheduler decoding eagerly give equal results and telemetry, every
  logit row bitwise equal (the same kernels in the same order) and equal
  health ledgers (the graph adds its capture's host counters per replay);
* join and leave: every row the scheduler computed equals, bitwise, a
  teacher-forced solo run of its request (batch 1, fed the scheduler's
  tokens, the same graphed route), where the solo call and the batched
  one plan every site alike (at this size the modeled cache plans batch
  1 to 4 alike, so rows decoded beside other requests are held too);
* a slab growth captures a new graph against the grown slab, and the
  graph captured against the old slab is never replayed again;
* a NaN from the model with no fault scope armed raises `NumericFault`
  from the graphed and the eager route, and nothing is scrubbed;
* a capture that fails (a host sync inside the step) raises instead of
  decoding eagerly.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch import guard
from repro_torch.configs.base import get_config
from repro_torch.core.config import mm_config
from repro_torch.guard import health
from repro_torch.guard.fallback import NumericFault
from repro_torch.kernels import ops
from repro_torch.models.model import build_model
from repro_torch.serve import engine, graphs
from repro_torch.serve.sched import (BucketTable, Scheduler,
                                     build_tuned_cache, scripted_trace)
from repro_torch.tune import runtime as tune_runtime

ENTRIES = [(0, 3, 4), (0, 5, 3), (1, 9, 4), (2, 2, 3), (2, 12, 4),
           (3, 7, 2)]
TABLE = dict(max_batch=4, max_prompt=16, max_new=4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        if os.environ.get("REPRO_TORCH_REQUIRE_CUDA") == "1":
            pytest.fail("REPRO_TORCH_REQUIRE_CUDA=1 but no CUDA device")
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    guard.reset()
    yield torch.device("cuda")
    guard.reset()


def _setup(dev):
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b").reduced(),
                              dtype="bfloat16")
    params = build_model(cfg, dev).init(2)
    table = BucketTable.for_workload(**TABLE)
    cache = build_tuned_cache(params, cfg, table)
    return cfg, params, table, cache


def _run(cfg, params, table, cache, *, graphed, entries=ENTRIES):
    guard.reset()
    sched = Scheduler(params, cfg, table, trace_logits=True,
                      decode_graphs=graphed)
    with tune_runtime.use_cache(cache), mm_config(plan_mode="tuned"):
        sched.run(scripted_trace(entries, vocab_size=cfg.vocab_size,
                                 seed=4))
    torch.cuda.synchronize()
    return sched, health.snapshot()


@pytest.mark.cuda
def test_graphed_scheduler_equals_eager_bitwise(dev):
    cfg, params, table, cache = _setup(dev)
    g, gsnap = _run(cfg, params, table, cache, graphed=True)
    e, esnap = _run(cfg, params, table, cache, graphed=False)
    assert g.decode_graphs and not e.decode_graphs and not e.captures
    assert len(g.results) == len(ENTRIES)
    assert g.results == e.results
    assert g.telemetry.summary() == e.telemetry.summary()
    assert gsnap == esnap and gsnap["tuned_hits"] > 0
    assert not gsnap.get("tuned_misses")
    for rid, rows in g.logit_trace.items():
        assert len(rows) == len(e.logit_trace[rid])
        for x, y in zip(rows, e.logit_trace[rid]):
            np.testing.assert_array_equal(x, y)


def _plan_sig(log):
    return [(c.plan.schedule, c.plan.bm, c.plan.bk, c.plan.bn,
             c.plan.batch_grid) for c in log]


@pytest.mark.cuda
def test_join_leave_rows_equal_a_solo_run_where_plans_match(dev):
    from repro_torch.serve.sched.buckets import step_plans

    cfg, params, table, cache = _setup(dev)
    g, _ = _run(cfg, params, table, cache, graphed=True)
    assert max(b for v in g.logit_batches.values() for b in v) > 1
    n_rows = 0
    with tune_runtime.use_cache(cache), mm_config(plan_mode="tuned"):
        for r in scripted_trace(ENTRIES, vocab_size=cfg.vocab_size, seed=4):
            pb = table.prompt_bucket(r.prompt_len)
            toks = torch.zeros((1, pb), dtype=torch.long, device=dev)
            toks[0, :r.prompt_len] = torch.tensor(r.tokens, device=dev)
            solo, lg = engine.prefill(
                params, cfg, toks, max_len=table.max_len,
                last_index=torch.tensor([r.prompt_len - 1], device=dev))
            want = [lg[0].float().cpu().numpy()]
            graph = graphs.DecodeGraph(params, cfg, solo, 1,
                                       per_row_pos=True)
            for j, tok in enumerate(g.results[r.rid]["tokens"][:-1]):
                out = graph.step(
                    torch.tensor([tok], device=dev),
                    torch.tensor([r.prompt_len + j], dtype=torch.int32,
                                 device=dev))
                want.append(out[0].float().cpu().numpy())
            for j, (x, y) in enumerate(zip(g.logit_trace[r.rid], want)):
                b = g.logit_batches[r.rid][j]
                prompt = pb if j == 0 else None
                same = _plan_sig(step_plans(
                    params, cfg, b, table.max_len, prompt=prompt)) == \
                    _plan_sig(step_plans(params, cfg, 1, table.max_len,
                                         prompt=prompt))
                assert same, (r.rid, j, b)
                np.testing.assert_array_equal(x, y)
                n_rows += 1
    assert n_rows == sum(e[2] for e in ENTRIES)


@pytest.mark.cuda
def test_slab_growth_recaptures_and_drops_the_stale_graph(dev, monkeypatch):
    cfg, params, table, cache = _setup(dev)
    stepped = []
    real_step = graphs.DecodeGraph.step

    def step(self, tok, pos):
        stepped.append(self)
        return real_step(self, tok, pos)

    monkeypatch.setattr(graphs.DecodeGraph, "step", step)
    # one request, then three more: the slab grows 1 -> 4 mid-run
    g, _ = _run(cfg, params, table, cache, graphed=True,
                entries=[(0, 5, 4), (1, 3, 3), (1, 9, 3), (1, 2, 2)])
    assert g.slab_history == [1, 4]
    assert [c["batch"] for c in g.captures] == [1, 4]
    graphs_seen = list(dict.fromkeys(stepped))
    assert len(graphs_seen) == 2
    first, second = graphs_seen
    assert first.graph is not None and second.graph is not None
    assert first.tok.shape[0] == 1 and second.tok.shape[0] == 4
    # after the second graph's first replay the first never replays
    cut = stepped.index(second)
    assert all(x is second for x in stepped[cut:])
    assert g._graph is second and second.cache is g._slab


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["prefill", "decode"])
@pytest.mark.parametrize("graphed", [True, False])
def test_a_nan_with_nothing_armed_raises(dev, graphed, stage, monkeypatch):
    cfg, params, table, cache = _setup(dev)
    if stage == "prefill":
        params = dict(params, final_norm=torch.full_like(
            params["final_norm"], float("nan")))
    else:
        decode_step = engine.decode_step

        def poisoned(*args, **kwargs):
            logits, c = decode_step(*args, **kwargs)
            return logits * float("nan"), c

        monkeypatch.setattr(engine, "decode_step", poisoned)
    guard.reset()
    sched = Scheduler(params, cfg, table, decode_graphs=graphed)
    with pytest.raises(NumericFault, match=stage):
        sched.run(scripted_trace(ENTRIES[:2], vocab_size=cfg.vocab_size,
                                 seed=4))
    snap = health.snapshot()
    assert not snap.get("scrubbed_batches") and not snap.get("faults_caught")
    assert not sched.results


@pytest.mark.cuda
def test_a_failed_capture_raises(dev, monkeypatch):
    cfg, params, table, cache = _setup(dev)
    step = engine.decode_step

    def syncing_step(*args, **kwargs):
        logits, c = step(*args, **kwargs)
        logits[0, 0].item()              # a host sync: no capture holds it
        return logits, c

    monkeypatch.setattr(engine, "decode_step", syncing_step)
    ops.reset_launch_counts()
    sched = Scheduler(params, cfg, table)
    assert sched.decode_graphs
    with pytest.raises(RuntimeError):
        sched.run(scripted_trace(ENTRIES[:2], vocab_size=cfg.vocab_size,
                                 seed=4))
    assert not sched.captures and not sched.results
