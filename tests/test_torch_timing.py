"""`bench.timing.measure` times every call to the end of its work.

The reference (`repro.bench.timing.measure`) blocks on the output of every
call.  The port finds the card to wait on by walking the arguments and
the warm-up call's result (dicts, lists, tuples, dataclass fields): with a
CUDA tensor there it brackets each call with CUDA events on that device;
with none it keeps the host clock and synchronizes the current device
after each call once CUDA is initialised.  The CPU tests hold the walker
and `measure`'s contract; the `cuda` tests show on the card that a closure
with no arguments, and a dict of CUDA tensors, are timed to the end of a
known device sleep.
"""

import dataclasses
import os

import pytest
import torch

from repro_torch.bench import timing


@dataclasses.dataclass
class _State:
    step: int
    cache: dict
    extra: tuple = ()


def _walk(obj):
    return [id(t) for t in timing.iter_tensors(obj)]


# ------------------------------------------------------------------ CPU
@pytest.mark.parametrize("where", ["plain", "dict", "list", "tuple",
                                   "dataclass", "nested"])
def test_walker_finds_nested_tensors(where):
    t = torch.ones(3)
    obj = {"plain": t,
           "dict": {"a": 1, "b": t},
           "list": [None, "x", t],
           "tuple": (0.5, (t,)),
           "dataclass": _State(step=3, cache={"k": t}),
           "nested": [{"s": _State(0, {}, extra=({"deep": [t]},))}]}[where]
    assert _walk(obj) == [id(t)]


def test_walker_yields_every_tensor_in_order_and_skips_the_rest():
    a, b, c = torch.ones(1), torch.zeros(2), torch.arange(3)
    obj = ({"x": a, "y": [b, 7, "s"]}, _State(1, {"z": c}), None, 2.0)
    assert _walk(obj) == [id(a), id(b), id(c)]
    assert _walk(_State) == []          # a dataclass type, not an instance
    assert _walk(({}, [], (), "abc", 5)) == []


def test_cuda_device_is_none_for_cpu_tensors_in_args_and_result():
    state = _State(0, {"k": torch.ones(2)})
    assert timing.cuda_device((state,), {"out": [torch.zeros(1)]}) is None
    assert timing.cuda_device() is None


def test_measure_keeps_its_timing_fields_and_counts_calls():
    calls = []

    def run(state):
        calls.append(state.step)
        return {"logits": [state.cache["k"] * 2]}

    t = timing.measure(run, _State(1, {"k": torch.ones(4)}), iters=3,
                       repeats=4)
    assert len(calls) == 1 + 3 * 4           # one untimed warm-up call
    assert isinstance(t, timing.Timing)
    assert {f.name for f in dataclasses.fields(t)} == {
        "median_us", "iqr_us", "repeats", "iters", "outliers"}
    assert t.repeats == 4 and t.iters == 3 and t.outliers >= 0
    assert t.median_us > 0 and t.iqr_us >= 0
    assert t.us_per_call == t.median_us


def test_measure_times_a_closure_with_no_arguments_on_the_host_clock():
    t = timing.measure(lambda: torch.ones(8).sum(), iters=2, repeats=3)
    assert t.median_us > 0 and t.repeats == 3


@pytest.mark.parametrize("iters,repeats", [(0, 5), (3, 0), (-1, 1)])
def test_measure_refuses_fewer_than_one_call(iters, repeats):
    with pytest.raises(ValueError, match="must be >= 1"):
        timing.measure(lambda: None, iters=iters, repeats=repeats)


# ------------------------------------------------------------------ card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        if os.environ.get("REPRO_TORCH_REQUIRE_CUDA") == "1":
            pytest.fail("REPRO_TORCH_REQUIRE_CUDA=1 but no CUDA device")
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _sleep(dev, ms: float = 5.0) -> tuple[int, float]:
    """GPU clock cycles for a `torch.cuda._sleep` of about `ms`, and the
    microseconds that sleep takes alone, timed by CUDA events."""
    cycles = int(ms * torch.cuda.get_device_properties(dev).clock_rate)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(cycles)                 # warm-up
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles, start.elapsed_time(end) * 1e3


@pytest.mark.cuda
def test_measure_waits_for_a_closure_with_no_arguments(dev):
    cycles, sleep_us = _sleep(dev)
    x = torch.ones(4, device=dev)

    def run():
        torch.cuda._sleep(cycles)
        return x + 1

    t = timing.measure(run, iters=2, repeats=3)
    assert t.median_us >= 0.9 * sleep_us, (t, sleep_us)


@pytest.mark.cuda
def test_measure_waits_for_a_closure_that_returns_nothing(dev):
    cycles, sleep_us = _sleep(dev)             # CUDA is initialised
    t = timing.measure(lambda: torch.cuda._sleep(cycles), iters=2,
                       repeats=3)
    assert t.median_us >= 0.9 * sleep_us, (t, sleep_us)


@pytest.mark.cuda
def test_measure_times_a_dict_of_cuda_tensors_by_events(dev, monkeypatch):
    cycles, sleep_us = _sleep(dev)
    cache = {"k": torch.ones(4, device=dev), "v": [torch.zeros(2, device=dev)]}
    assert timing.cuda_device((cache,)) == cache["k"].device
    made = []
    real = torch.cuda.Event

    def event(*a, **kw):
        made.append(kw.get("enable_timing"))
        return real(*a, **kw)

    monkeypatch.setattr(torch.cuda, "Event", event)

    def run(c):
        torch.cuda._sleep(cycles)
        c["k"].add_(1)

    t = timing.measure(run, cache, iters=2, repeats=3)
    assert made == [True, True]               # one start, one end event
    assert t.median_us >= 0.9 * sleep_us, (t, sleep_us)
