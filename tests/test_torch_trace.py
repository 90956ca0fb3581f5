"""`python -m repro_torch.launch.trace` on the CPU: the matmul workload's
trace-smoke gate passes under the sim and wall clocks, the Chrome
document it writes validates, and `--mode serve` traces the serving
scheduler and passes the same gate."""

import json

import pytest

from repro_torch import guard
from repro_torch.launch import trace
from repro_torch.obs import validate_chrome


@pytest.fixture(autouse=True)
def _clean_state():
    guard.reset()
    yield
    guard.reset()


@pytest.mark.parametrize("clock", ["sim", "wall"])
def test_check_passes_on_the_cpu(clock, capsys):
    rc = trace.main(["--mode", "matmul", "--clock", clock, "--size", "64",
                     "--skew", "4", "--device", "cpu", "--check"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[trace] check ok" in out
    assert "[trace] dispatch:4/plan:4/total:8" in out
    if clock == "sim":
        assert "max_abs_log=0.0000 accepted=True" in out
        assert out.count("[trace] drift m") == 4


def test_tuned_mode_needs_the_tune_key(capsys):
    rc = trace.main(["--size", "64", "--skew", "4", "--device", "cpu",
                     "--plan-mode", "tuned", "--check", "--quiet"])
    assert rc == 0
    assert "tune:4" in capsys.readouterr().out


def test_out_writes_a_valid_chrome_document(tmp_path):
    path = tmp_path / "t.json"
    assert trace.main(["--size", "64", "--skew", "4", "--device", "cpu",
                       "--quiet", "--out", str(path)]) == 0
    doc = json.loads(path.read_text())
    validate_chrome(doc)
    assert len(doc["traceEvents"]) == 8


def test_check_flags_missing_attribution():
    from repro_torch.obs import span, trace_scope

    with trace_scope() as tr:
        with span("dispatch", "dense"):
            pass
    problems = trace.check_trace(tr, tuned=True)
    assert len(problems) == 1
    for field in ("rung", "tune_key", "modeled_us", "measured_us"):
        assert field in problems[0]


def test_serve_mode_names_the_missing_scheduler(capsys):
    """`--mode serve` once exited naming the missing scheduler; now that
    the scheduler is ported it traces a scripted serve run and passes the
    trace-smoke gate, the tune key on every dispatch included."""
    rc = trace.main(["--mode", "serve", "--device", "cpu", "--check",
                     "--quiet"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[trace] check ok" in out
    assert ("[trace] admit:3/decode:2/dispatch:40/plan:40/prefill:3/"
            "tick:3/total:131/tune:40") in out


@pytest.mark.parametrize("clock,calls", [("sim", 4), ("wall", 8)])
def test_wall_clock_warms_up_untraced(clock, calls, monkeypatch):
    """Under the wall clock every shape runs once untraced before the
    traced pass, so no traced dispatch is a cold first call; the trace
    holds the traced pass alone."""
    from repro_torch.core import skewmm

    seen = []
    real = skewmm.matmul
    monkeypatch.setattr(skewmm, "matmul",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    args = type("Args", (), {"size": 64, "skew": 4, "device": "cpu",
                             "clock": clock})
    tr = trace.run_matmul(args)
    assert len(seen) == calls
    assert tr.digest() == {"dispatch": 4, "plan": 4, "total": 8}
