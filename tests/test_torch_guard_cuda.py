"""The guard and the obs clock on the card (`cuda`-marked: they skip where
there is no CUDA device, and fail under ``REPRO_TORCH_REQUIRE_CUDA=1``).
No JAX here: the file runs on the card's machine, which has none.

* While a CUDA graph is captured the scrub records the oracle
  substitution without a host read, and the wall clock measures nothing.
* A disarmed guarded dispatch launches the kernel and never the oracle.
* A binding's error propagates through the ladder and the explicit
  envelope; no rung moves.
* A kernel's own non-finite output (no fault injected) raises
  `NumericFault` through the ladder and the explicit envelope at every
  matmul site, and through `guarded_decode_step`; no rung moves and the
  oracle is never run.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch import guard
from repro_torch.core.costmodel import BlockPlan
from repro_torch.guard import fallback, faults, health, validate
from repro_torch.kernels import ops, ref


@pytest.fixture(autouse=True)
def _clean_guard_state():
    guard.reset()
    yield
    guard.reset()


def _mats(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.tensor(rng.normal(size=(m, k)) * 0.5, dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(k, n)) * 0.5, dtype=torch.float32)
    return a, b


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        if os.environ.get("REPRO_TORCH_REQUIRE_CUDA") == "1":
            pytest.fail("REPRO_TORCH_REQUIRE_CUDA=1 but no CUDA device")
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_scrub_and_wall_clock_inside_a_graph_capture(dev):
    """While a CUDA graph is captured, the poison hook records its fills,
    the scrub records the oracle substitution (no host read) and the wall
    clock measures nothing (no synchronise); the replay returns the
    oracle's values."""
    from repro_torch.obs import WallClock

    a, b = (t.to(dev) for t in _mats(64, 64, 64))
    want = ref.matmul_epilogue_ref(a, b)
    clock = WallClock()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with faults.fault_scope():
        with torch.cuda.stream(side):
            ref.matmul_epilogue_ref(a, b)     # warm the allocator
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.cuda.graph(graph):
            poisoned, injected = faults.maybe_poison(torch.matmul(a, b), "s")
            out = validate.scrub(poisoned, "s", injected=injected,
                                 ref_fn=lambda: ref.matmul_epilogue_ref(a, b))
            measured, us = clock.measure(lambda: out * 1.0)
    assert us is None
    graph.replay()
    torch.cuda.synchronize()
    assert torch.allclose(out, want, rtol=1e-6, atol=1e-6)
    assert torch.allclose(measured, want, rtol=1e-6, atol=1e-6)
    assert health.get("scrub_substituted") == 1
    assert health.get("faults_caught") == health.get("faults_injected") == 2


@pytest.mark.cuda
def test_disarmed_dispatch_launches_the_kernel_never_the_oracle(dev,
                                                                monkeypatch):
    from repro_torch.obs import SimClock, trace_scope

    calls = []
    real = ref.matmul_epilogue_ref
    monkeypatch.setattr(ref, "matmul_epilogue_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    a, b = (t.to(dev).to(torch.bfloat16) for t in _mats(8, 256, 512))
    ops.reset_launch_counts()
    with trace_scope(clock=SimClock()) as tr:
        ops.skew_matmul(a, b, plan=BlockPlan(64, 64, 128))
        ops.skew_matmul(a, b)
    torch.cuda.synchronize()
    assert ops.launch_counts()["skew_matmul_k_inner"] == 2
    assert calls == []
    rungs = [sp.attrs["rung"] for sp in tr.spans() if sp.kind == "dispatch"]
    assert rungs == ["explicit", "modeled"]
    assert fallback.max_floor() == 0


@pytest.mark.cuda
def test_binding_error_propagates_through_the_ladder(dev):
    """A launch the binding refuses (mismatched dtypes) raises through the
    ladder and the explicit envelope under an armed scope; no rung moves
    and the oracle is not run."""
    a = torch.ones((8, 64), device=dev, dtype=torch.bfloat16)
    b = torch.ones((64, 64), device=dev, dtype=torch.float32)
    with faults.fault_scope(kinds=("nan_output",)):
        with pytest.raises((TypeError, ValueError, RuntimeError)):
            ops.skew_matmul(a, b)
        with pytest.raises((TypeError, ValueError, RuntimeError)):
            ops.skew_matmul(a, b, plan=BlockPlan(64, 64, 64))
    assert fallback.max_floor() == 0
    assert "fallbacks" not in health.snapshot()


def _nan_sites(dev):
    """Each matmul site on CUDA operands whose lhs is all NaN, so the
    kernel itself returns non-finite values."""
    from repro_torch.core.config import mm_config
    from repro_torch.sparse.layout import BlockSparseLayout

    bf = torch.bfloat16
    a = torch.full((64, 128), float("nan"), device=dev, dtype=bf)
    b = torch.ones((128, 128), device=dev, dtype=bf)
    ga = torch.full((4, 16, 128), float("nan"), device=dev, dtype=bf)
    gb = torch.ones((4, 128, 128), device=dev, dtype=bf)
    lay = BlockSparseLayout.dense(64, 128, (32, 128))

    def grouped(**kw):
        with mm_config(backend="cuda"):
            return ops.grouped_matmul(ga, gb, **kw)

    return {
        "dense_ladder": lambda: ops.skew_matmul(a, b),
        "dense_explicit": lambda: ops.skew_matmul(
            a, b, plan=BlockPlan(64, 64, 64)),
        "batched_explicit": lambda: ops.skew_matmul_batched(
            a[None], b, plan=BlockPlan(64, 64, 64)),
        "sparse_ladder": lambda: ops.sparse_matmul(a, b, lay),
        "grouped_ladder": grouped,
        "grouped_explicit": lambda: grouped(plan=BlockPlan(64, 64, 64)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["dense_ladder", "dense_explicit",
                                  "batched_explicit", "sparse_ladder",
                                  "grouped_ladder", "grouped_explicit"])
def test_real_nan_raises_and_never_reaches_the_oracle(dev, site,
                                                      monkeypatch):
    """A scope is armed (so the scrub is engaged) with no kind that fires
    at a kernel: the NaN the kernel returns is real, and on the card it
    raises instead of moving a rung."""
    calls = []
    for name in ("matmul_epilogue_ref", "block_sparse_matmul_ref",
                 "grouped_matmul_ref"):
        real = getattr(ref, name)
        monkeypatch.setattr(ref, name, lambda *a, _r=real, **k:
                            calls.append(1) or _r(*a, **k))
    call = _nan_sites(dev)[site]
    ops.reset_launch_counts()
    with faults.fault_scope(kinds=("tuner_outlier",)):
        with pytest.raises(fallback.NumericFault) as ei:
            call()
    assert not ei.value.injected
    assert sum(ops.launch_counts().values()) >= 1
    assert calls == []
    assert fallback.max_floor() == 0
    assert "fallbacks" not in health.snapshot()


@pytest.mark.cuda
def test_guarded_decode_step_raises_on_a_real_nan(dev):
    """With nothing armed, non-finite logits raise `NumericFault`; the
    step is not re-run on the "torch" backend."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve import engine

    cfg = get_config("mamba2-2.7b").reduced()
    params = build_model(cfg, dev).init(0)
    cache, _ = engine.prefill(params, cfg, torch.zeros(
        (2, 8), dtype=torch.long, device=dev), max_len=16)
    params = dict(params, final_norm=torch.full_like(params["final_norm"],
                                                     float("nan")))
    ops.reset_launch_counts()
    with pytest.raises(fallback.NumericFault, match="no fault injected"):
        engine.guarded_decode_step(
            params, cfg, cache, torch.zeros((2,), dtype=torch.long,
                                            device=dev), 8)
    assert sum(ops.launch_counts().values()) >= 1
    assert health.snapshot() == {}
