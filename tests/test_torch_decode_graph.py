"""The graph-captured decode step (`repro_torch.serve.graphs`).

On the CPU the `DecodeGraph` object runs `engine.decode_step` on its
static buffers after a warm-up on a scratch copy of the cache; these tests
hold its plumbing: its step loop equals the eager `decode_step` loop
bitwise over 8 steps (phi4-mini, recurrentgemma, mamba2 and gemma2 at
`reduced()`; gemma2's local rings of 64 slots wrap), the warm-up leaves
the served cache bitwise unchanged, and `decode_step` with a 0-d or (B,)
tensor position equals the one with int positions.  The same functions run
in the same order on the same inputs, so the comparisons are exact.

The tests marked `cuda` capture a real graph on the card and skip here;
run them there with

    REPRO_TORCH_REQUIRE_CUDA=1 PYTHONPATH=src \
        python -m pytest -q -m cuda tests/test_torch_decode_graph.py

They hold graphed decode bitwise equal to eager decode (the same kernels
in the same order), the launch counts and the host counters (tuned
lookups) a replay adds equal to an eager step's, and a capture that meets
a host sync raising instead of decoding eagerly.  On the CPU the graph
object's construction records no host counter and each of its steps
records what an eager step records.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.config import mm_config
from repro_torch.kernels import ops
from repro_torch.models.model import build_model
from repro_torch.serve import engine, graphs

ARCHS = ["phi4-mini-3.8b", "recurrentgemma-9b", "mamba2-2.7b", "gemma2-27b"]
STEPS = 8
# gemma2's prompt ends 4 short of its reduced window (64): decode wraps.
PROMPT = {"gemma2-27b": 60}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _same(a, b) -> bool:
    la, lb = list(_leaves(a)), list(_leaves(b))
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _model(arch, device, dtype=None):
    cfg = get_config(arch).reduced()
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return cfg, build_model(cfg, device).init(4)


def _prefill(cfg, params, batch=2, prompt=None):
    prompt = prompt or PROMPT.get(cfg.name.removesuffix("-smoke"), 12)
    dev = params["embed"].device
    toks = torch.tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (batch, prompt)), device=dev)
    cache, logits = engine.prefill(params, cfg, toks,
                                   max_len=prompt + STEPS)
    return cache, logits, prompt


def _graph_and_eager(cfg, params, steps=STEPS):
    """Greedy decode of one prompt through a DecodeGraph and through the
    eager decode_step loop, from two copies of one prefilled cache."""
    cache, logits, s = _prefill(cfg, params)
    eager_cache = graphs.clone_cache(cache)
    graph = graphs.DecodeGraph(params, cfg, cache, logits.shape[0])
    tok_g = tok_e = torch.argmax(logits, -1)
    out = []
    for i in range(steps):
        lg = graph.step(tok_g, s + i).clone()
        le, _ = engine.decode_step(params, cfg, eager_cache, tok_e, s + i)
        out.append((lg, le))
        tok_g, tok_e = torch.argmax(lg, -1), torch.argmax(le, -1)
    return out, cache, eager_cache, graph


@pytest.mark.parametrize("arch", ARCHS)
def test_graph_step_loop_equals_eager_bitwise(arch):
    cfg, params = _model(arch, "cpu")
    out, cache, eager_cache, _ = _graph_and_eager(cfg, params)
    for i, (lg, le) in enumerate(out):
        assert torch.equal(lg, le), f"step {i}"
    assert _same(cache, eager_cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_warmup_leaves_the_served_cache_unchanged(arch):
    cfg, params = _model(arch, "cpu")
    cache, logits, _ = _prefill(cfg, params)
    before = graphs.clone_cache(cache)
    graph = graphs.DecodeGraph(params, cfg, cache, logits.shape[0])
    assert _same(cache, before)
    assert graph.cache is cache
    assert tuple(graph.logits.shape) == tuple(logits.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_pos_equals_int_pos(arch):
    cfg, params = _model(arch, "cpu")
    cache, logits, s = _prefill(cfg, params)
    other = graphs.clone_cache(cache)
    tok = torch.argmax(logits, -1)
    by_int, _ = engine.decode_step(params, cfg, cache, tok, s)
    by_tensor, _ = engine.decode_step(
        params, cfg, other, tok, torch.tensor(s, dtype=torch.int32))
    assert torch.equal(by_int, by_tensor)
    assert _same(cache, other)


def test_per_row_positions_through_the_graph_object():
    """(B,) positions: the graph object's static (B,) position tensor."""
    cfg, params = _model("phi4-mini-3.8b", "cpu")
    cache, logits, s = _prefill(cfg, params)
    other = graphs.clone_cache(cache)
    graph = graphs.DecodeGraph(params, cfg, cache, 2, per_row_pos=True)
    assert tuple(graph.pos.shape) == (2,)
    pos = torch.tensor([s, s], dtype=torch.int32)
    tok = torch.argmax(logits, -1)
    got = graph.step(tok, pos)
    want, _ = engine.decode_step(params, cfg, other, tok, pos)
    assert torch.equal(got, want)


def test_graph_steps_under_the_matmul_config_of_its_construction():
    """The capture bakes the plans of the config active at construction
    in, so the CPU path keeps that config too."""
    cfg, params = _model("phi4-mini-3.8b", "cpu")
    cache, logits, s = _prefill(cfg, params)
    other = graphs.clone_cache(cache)
    with mm_config(backend="torch"):
        graph = graphs.DecodeGraph(params, cfg, cache, 2)
    assert graph.mm.backend == "torch"
    tok = torch.argmax(logits, -1)
    got = graph.step(tok, s)
    with mm_config(backend="torch"):
        want, _ = engine.decode_step(params, cfg, other, tok, s)
    assert torch.equal(got, want)


def test_graph_object_leaves_the_ledger_of_eager_steps():
    """Building the graph object records nothing (its warm-up runs with
    host records off); each of its steps records what one eager step
    records."""
    from repro_torch.guard import health
    from repro_torch.tune.cache import TuneCache
    from repro_torch.tune.runtime import use_cache

    cfg, params = _model("phi4-mini-3.8b", "cpu")
    cache, logits, s = _prefill(cfg, params)
    other = graphs.clone_cache(cache)
    tok = torch.argmax(logits, -1)
    with use_cache(TuneCache()), mm_config(plan_mode="tuned"):
        health.reset()
        graph = graphs.DecodeGraph(params, cfg, cache, 2)
        assert health.snapshot() == {}
        assert graph.host_per_step == {}
        engine.decode_step(params, cfg, other, tok, s)
        eager = health.snapshot()
        health.reset()
        for i in range(3):
            graph.step(tok, s + i)
        graphed = health.snapshot()
    health.reset()
    assert eager["tuned_misses"] > 0
    assert graphed == {k: 3 * v for k, v in eager.items()}


# ------------------------------------------------------------ on the card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        if os.environ.get("REPRO_TORCH_REQUIRE_CUDA") == "1":
            pytest.fail("REPRO_TORCH_REQUIRE_CUDA=1 but no CUDA device")
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_graphed_decode_equals_eager_on_the_card(dev, arch):
    cfg, params = _model(arch, dev, dtype="bfloat16")
    out, cache, eager_cache, graph = _graph_and_eager(cfg, params)
    assert graph.graph is not None
    for i, (lg, le) in enumerate(out):
        assert torch.equal(lg, le), f"step {i}"
    assert _same(cache, eager_cache)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "dbrx-132b",
                                  "mamba2-2.7b"])
def test_replay_launch_counts_equal_an_eager_step(dev, arch):
    cfg, params = _model(arch, dev, dtype="bfloat16")
    cache, logits, s = _prefill(cfg, params)
    tok = torch.argmax(logits, -1)
    ops.reset_launch_counts()
    engine.decode_step(params, cfg, graphs.clone_cache(cache), tok, s)
    eager = {k: v for k, v in ops.launch_counts().items() if v}
    ops.reset_launch_counts()
    graph = graphs.DecodeGraph(params, cfg, cache, 2)
    # the warm-up's launches ran; the capture's are taken back
    assert {k: v for k, v in ops.launch_counts().items() if v} == eager
    assert graph.launches_per_step == eager
    ops.reset_launch_counts()
    for i in range(3):
        graph.step(tok, s + i)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        k: 3 * v for k, v in eager.items()}


@pytest.mark.cuda
def test_replays_add_the_host_counters_of_an_eager_step(dev):
    """A replay makes no tuned lookup: the warm-up records nothing, the
    capture's lookups stand for the first replay's and every later replay
    adds them, so the ledger counts what eager steps count."""
    from repro_torch.guard import health
    from repro_torch.tune.cache import TuneCache
    from repro_torch.tune.runtime import use_cache

    cfg, params = _model("phi4-mini-3.8b", dev, dtype="bfloat16")
    cache, logits, s = _prefill(cfg, params)
    tok = torch.argmax(logits, -1)
    with use_cache(TuneCache()), mm_config(plan_mode="tuned"):
        health.reset()
        engine.decode_step(params, cfg, graphs.clone_cache(cache), tok, s)
        eager = health.snapshot()
        health.reset()
        graph = graphs.DecodeGraph(params, cfg, cache, 2)
        assert graph.graph is not None and health.snapshot() == eager
        assert graph.host_per_step == eager
        for i in range(3):
            graph.step(tok, s + i)
        torch.cuda.synchronize()
        graphed = health.snapshot()
    health.reset()
    assert graphed == {k: 3 * v for k, v in eager.items()}


@pytest.mark.cuda
def test_capture_meeting_a_host_sync_raises(dev, monkeypatch):
    cfg, params = _model("phi4-mini-3.8b", dev, dtype="bfloat16")
    cache, logits, _ = _prefill(cfg, params)
    step = engine.decode_step

    def syncing_step(*args, **kwargs):
        logits, c = step(*args, **kwargs)
        logits[0, 0].item()              # a host sync
        return logits, c

    monkeypatch.setattr(engine, "decode_step", syncing_step)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError):
        graphs.DecodeGraph(params, cfg, cache, 2)
    per_step = sum(v for v in ops.launch_counts().values())
    monkeypatch.setattr(engine, "decode_step", step)
    ops.reset_launch_counts()
    engine.decode_step(params, cfg, graphs.clone_cache(cache),
                       torch.argmax(logits, -1), 1)
    # only the warm-up's launches stay counted
    assert per_step == sum(v for v in ops.launch_counts().values())
