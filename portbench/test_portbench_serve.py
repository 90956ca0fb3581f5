"""The rest of a serving run without a card, at the CPU cut of each cell
(`pbcore/tiny.py`): the result line, the per-layer readers, and
`correct` coming out false with a token altered where it is produced and
for the reference computed in float8 (the control)."""

import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

from pbcore import manifest  # noqa: E402
from pbcore.tiny import TINY_WIDEST_GAP, tiny_cell  # noqa: E402

SEED = 2 ** 33 + 5


def _run_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location("portbench_run",
                                                  BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _execute(cell: str, trace: int = 0, seed: int = SEED):
    man, w, cfg, traffic = tiny_cell(cell)
    args = SimpleNamespace(seed=seed, seconds=1.0, trace=trace)
    run = _run_module()
    # other test files load JAX into this process; the look for it is
    # held in a fresh process by test_portbench_isolation.py
    run.forbidden_modules = lambda: []
    return run.execute(man, w, cfg, traffic, args, torch.device("cpu"),
                       time.perf_counter(), {})


def test_sound_run_is_correct_and_reports_the_cell_metrics():
    line = _execute("phi4-chat")
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"serve_tok_s", "ttft_p90_ms",
                                    "itl_p95_ms", "setup_s"}
    assert list(line)[-1] == "checks"
    assert line["checks"]["widest_gap"]["limit"] == TINY_WIDEST_GAP


def test_traced_run_reads_the_host_metrics():
    """On the CPU the trace holds no device event: the device readers
    return nothing, the host ones a number."""
    line = _execute("phi4-chat", trace=1)
    assert line["correct"] is True
    got = set(line["metrics"])
    assert {"tick_ms.decode", "tick_ms.prefill", "serve_mfu",
            "tick_mfu.prefill"} <= got
    assert not {"gemm_roofline.decode", "attn_roofline.decode",
                "device_idle.serve"} & got
    assert line["device"]["busy_s"] == 0.0


@pytest.mark.parametrize("cell", ["phi4-chat", "dbrx-chat"])
def test_altered_token_is_not_correct(cell, monkeypatch):
    """A token altered where it is produced: every decode step's argmax
    moved to the next id."""
    from repro_torch.serve.sched import loop
    real = loop.Scheduler._argmax

    def shifted(self, logits, what):
        tok = real(self, logits, what)
        return (tok + 1) % logits.shape[-1] if what == "decode step" \
            else tok

    monkeypatch.setattr(loop.Scheduler, "_argmax", shifted)
    monkeypatch.setattr(loop.Scheduler, "_decode_step", _graphless_step)
    line = _execute(cell)
    assert line["correct"] is False
    assert line["checks"]["widest_gap"]["value"] > TINY_WIDEST_GAP


def _graphless_step(self):
    """The CPU decode step routed through `_argmax` (as the card's graphed
    step is), so that the fault above reaches it."""
    from repro_torch.serve import engine
    tok = torch.from_numpy(self._tokens).to(self.device)
    pos = torch.from_numpy(self._pos).to(self.device)
    logits, self._slab = engine.decode_step(self.params, self.cfg,
                                            self._slab, tok, pos)
    return logits, self._argmax(logits, "decode step")


@pytest.mark.parametrize("seed", [1, 2, SEED])
def test_control_fails_the_limit(seed):
    """The reference in float8 in the program's place, held by the run's
    own check (`controls/serve_control.control_reading`), is not correct
    on the same prompts and served tokens; the program is."""
    man, w, cfg, traffic = tiny_cell("phi4-chat")
    ref = manifest.load_module("reference", cfg["reference"])
    ctx = SimpleNamespace(cell=w, cfg=cfg, traffic=traffic, seed=seed,
                          seconds=1.0, trace=False,
                          device=torch.device("cpu"),
                          t_proc0=time.perf_counter(), setup={}, ref=ref)
    res = manifest.load_module("drivers", traffic["driver"]).run(ctx)
    reqs = res["sample_reqs"]
    control = manifest.load_module("controls", "serve_control") \
        .control_reading(ref, cfg, res["weights"],
                         [r.prompt.tolist() for r in reqs],
                         [list(r.tokens) for r in reqs])
    assert res["correct"] is True
    assert control["correct"] is False
    assert control["checks"]["widest_gap"]["value"] > TINY_WIDEST_GAP


def test_decode_rows_count_their_cached_keys():
    """A prompt of 10 tokens: its first token comes from the prefill, and
    its tokens 1 and 2 from decode steps over 11 and 12 cached keys."""
    import numpy as np
    drv = manifest.load_module("drivers", "serve_stream")
    stream = drv._Stream(sched=None, pool=[], trace=False)
    r = drv._Req(0, np.zeros(10, dtype=np.int64), 5, 0.0, True)
    assert stream._arrive(r, 1, 1.0) == 1 and stream.keys == 0
    assert stream._arrive(r, 3, 2.0) == 2 and stream.keys == 23


class _Trace:
    """Two decode ticks' host ranges, 2 ms of attention kernels in each."""

    def ranges(self, prefix):
        return [(0, 1, "tick.decode"), (2, 3, "tick.decode")] \
            if prefix == "tick.decode" else []

    def device_s_in(self, ranges, patterns):
        return [2e-3 if "gemvx" in patterns else 0.0 for _ in ranges]


def test_attention_roofline_reads_least_over_device_time():
    man = manifest.load_manifest()
    cfg = manifest.load_config(man, "phi4-mini-3.8b")
    work = manifest.load_module("work", cfg["work"])
    ticks = [{"kind": "decode", "decode_rows": 32, "decode_keys": 12_800},
             {"kind": "decode", "decode_rows": 32, "decode_keys": 6_400},
             {"kind": "prefill", "decode_rows": 4, "decode_keys": 900}]
    ctx = {"trace": _Trace(), "ticks": ticks, "cfg": cfg, "work": work,
           "families": manifest.kernel_families()}
    reader = manifest.load_module("metrics", "attn_roofline.decode")
    least = work.decode_attn_least_s(cfg, 32, 12_800) + \
        work.decode_attn_least_s(cfg, 32, 6_400)
    assert reader.read(ctx) == pytest.approx(100 * least / 4e-3, rel=1e-12)
    assert reader.read(dict(ctx, trace=None)) is None
    assert reader.read(dict(ctx, families={})) is None
