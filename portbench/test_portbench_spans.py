"""The per-layer metrics that read the program's own spans and counters.

A traced run of each cell at its CPU cut (`pbcore/tiny.py`): over the
window, each counter the scheduler keeps inside equals the harness's own
reckoning from outside (prompt tokens of the ticks' admissions, the
ticks' `decode_keys`, one `repro_torch.prefill` range a prefill group);
the counter readers and `group_ms.prefill` read a number, the device-idle
readers nothing (the CPU trace holds no device event).  The readers also
return nothing for a program that opens no such range and keeps no such
counter, and `spanread.idle_share` is held on a hand-made trace."""

import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

from pbcore import manifest, spanread  # noqa: E402
from pbcore.tiny import tiny_cell  # noqa: E402

SEED = 2 ** 33 + 7
COUNTER_METRICS = ("queue_wait_ms", "prefill_pad_util", "kv_slot_util")
SPAN_METRICS = ("group_ms.prefill", "device_idle.prefill",
                "device_idle.decode")


def _traced_run(cell: str):
    """(layer context of a traced run at the CPU cut, its bucket table)."""
    from repro_torch.serve.sched import BucketTable
    man, w, cfg, traffic = tiny_cell(cell)
    ref = manifest.load_module("reference", cfg["reference"])
    drv = manifest.load_module("drivers", traffic["driver"])
    ctx = SimpleNamespace(cell=w, cfg=cfg, traffic=traffic, seed=SEED,
                          seconds=3.0, trace=True,
                          device=torch.device("cpu"),
                          t_proc0=time.perf_counter(), setup={}, ref=ref)
    res = drv.run(ctx)
    pool = drv.request_pool(traffic, cfg["vocab_size"], SEED)
    lens = [len(p) for p, _ in pool]
    table = BucketTable.for_workload(
        max_batch=traffic["max_batch"], max_prompt=max(lens),
        max_new=max(m for _, m in pool), min_prompt=min(lens))
    return res["layer_ctx"], table


@pytest.mark.parametrize("cell", ["phi4-chat", "dbrx-chat"])
def test_inside_counts_equal_the_harness_counts(cell):
    lctx, table = _traced_run(cell)
    h, ticks, trace = lctx["health"], lctx["ticks"], lctx["trace"]
    admitted = [n for t in ticks for n in t["admitted"]]
    assert admitted and sum(t["decode_keys"] for t in ticks)
    assert h["serve_prefill_tokens"] == sum(admitted)
    assert h["serve_queue_waits"] == len(admitted)
    assert h["serve_decode_keys"] == sum(t["decode_keys"] for t in ticks)
    groups = sum(len({table.prompt_bucket(n) for n in t["admitted"]})
                 for t in ticks)
    assert len(spanread.ranges(trace, "prefill")) == groups
    assert h["serve_prefill_slots"] >= h["serve_prefill_tokens"]
    assert h["serve_kv_slots"] >= h["serve_decode_keys"]
    decode_steps = sum(t["decode_rows"] > 0 for t in ticks)
    assert len(spanread.ranges(trace, "decode")) == decode_steps
    read = {m: manifest.load_module("metrics", m).read(dict(lctx))
            for m in COUNTER_METRICS + SPAN_METRICS}
    for m in COUNTER_METRICS + ("group_ms.prefill",):
        assert isinstance(read[m], float) and read[m] > 0, m
    assert 0 < read["prefill_pad_util"] <= 100
    assert 0 < read["kv_slot_util"] <= 100
    assert read["device_idle.prefill"] is None
    assert read["device_idle.decode"] is None


class _Trace:
    """Two prefill ranges (0-10 and 20-40 ns) and one decode range
    (50-60), device work at 2-4, 3-6, 25-30 and 55-70."""

    device = [(2, 4, "k"), (3, 6, "k"), (25, 30, "k"), (55, 70, "k")]

    def ranges(self, prefix):
        rs = [(0, 10, "repro_torch.prefill"), (20, 40, "repro_torch.prefill"),
              (50, 60, "repro_torch.decode"), (0, 100, "tick.prefill")]
        return [r for r in rs if r[2].startswith(prefix)]


def test_span_readers_on_a_hand_made_trace():
    tr = _Trace()
    assert spanread.idle_share(tr, "prefill") == pytest.approx(
        100 * (30 - 4 - 5) / 30)
    assert spanread.idle_share(tr, "decode") == pytest.approx(50.0)
    assert spanread.mean_ms(tr, "prefill") == pytest.approx(15e-6)
    ctx = {"trace": tr}
    assert manifest.load_module("metrics", "device_idle.decode").read(ctx) \
        == pytest.approx(50.0)


@pytest.mark.parametrize("metric", COUNTER_METRICS + SPAN_METRICS)
def test_readers_return_nothing_without_the_program_s_records(metric):
    """A program without the spans and counters (the trace holds only the
    harness's ranges, the health delta no such counter) reads nothing."""
    class Bare(_Trace):
        def ranges(self, prefix):
            return [(0, 100, "tick.prefill")] \
                if "tick.prefill".startswith(prefix) else []

    reader = manifest.load_module("metrics", metric)
    for trace in (Bare(), None):
        assert reader.read({"trace": trace, "health": {"tuned_hits": 3},
                            "ticks": []}) is None
