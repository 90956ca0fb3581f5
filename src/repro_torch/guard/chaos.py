"""The guard suite's chaos scenarios: seeded fault injection through the
real dispatch path (the JAX package's `tab_guard_chaos`).

Each scenario runs one failure under `fault_scope` (deterministic seeded
draws — the same counters on every host and on the CPU and the card) and
returns the guard health ledger: injections must equal catches (zero
silent escapes), the degradation ladder must land on the expected level,
and the output must still match the oracle.

  all_faults          every fault kind at once, plan_mode="tuned" over an
                      empty cache: the ladder walks down to the reference
  transient_recovers  two transient raises absorbed by the retry loop:
                      no degradation latched
  amp_overflow        a squeezed AMP budget rejects the modeled plan; the
                      conservative rung's minimum-granule plan delivers
  cache_quarantine    a truncated tune cache is moved aside
  decode_scrub        poisoned decode logits re-run on the reference

`run` returns a `ChaosRun` (output, metrics in the JAX rows' names, the
counters string); `guard_runs` runs the five at the dense site and, given
a `bench.suite.Recorder`, records them as the JAX suite's rows (inside
the scenario, so each row's provenance carries its ledger), comparable
with the JAX baselines under ``benchmarks/baselines/``.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable

import torch

from repro_torch import guard
from repro_torch.core.config import mm_config
from repro_torch.guard import fallback, faults, health

SCENARIOS = ("all_faults", "transient_recovers", "amp_overflow",
             "cache_quarantine", "decode_scrub")


@dataclasses.dataclass
class ChaosRun:
    """One scenario's result: its output (None where it has none), the
    health snapshot, the deepest ladder floor and the row metrics."""

    out: Any
    snapshot: dict[str, int]
    floor: int
    metrics: dict[str, float]

    @property
    def counters(self) -> str:
        return "/".join(f"{k}:{v}" for k, v in sorted(self.snapshot.items()))

    @property
    def balanced(self) -> bool:
        return (self.snapshot.get("faults_injected", 0)
                == self.snapshot.get("faults_caught", 0))


def run(body: Callable[[], tuple[Any, dict]],
        record: Callable[[ChaosRun], None] | None = None) -> ChaosRun:
    """Run `body` (-> (output, extra metrics)) on a clean guard state and
    read its ledger (`record` sees it before the state is cleared); the
    guard is reset again afterwards either way."""
    guard.reset()
    try:
        out, extra = body()
        snap = health.snapshot()
        floor = fallback.max_floor()
        injected = snap.get("faults_injected", 0)
        caught = snap.get("faults_caught", 0)
        metrics = {
            "faults_injected": injected,
            "faults_caught": caught,
            "ledger_balanced": int(injected == caught),
            "fallback_level": floor,
            "retries": snap.get("retries", 0),
            **extra,
        }
        result = ChaosRun(out, snap, floor, metrics)
        if record is not None:
            record(result)
        return result
    finally:
        guard.reset()


def all_faults(call: Callable[[], torch.Tensor]) -> torch.Tensor:
    """Every fault kind armed at once, plan_mode="tuned" so the cache path
    is live (an empty cache: the corrupt-lookup injection fires on the
    miss)."""
    from repro_torch.tune import runtime as tune_runtime
    from repro_torch.tune.cache import TuneCache

    with tune_runtime.use_cache(TuneCache()), mm_config(plan_mode="tuned"), \
            faults.fault_scope(seed=7):
        return call()


def transient_recovers(call: Callable[[], torch.Tensor]) -> torch.Tensor:
    """Two transient raises, the default retry budget of two: the retry
    loop absorbs both and the preferred level still answers."""
    with faults.fault_scope(seed=11, kinds=("transient_raise",),
                            max_transient=2):
        return call()


def amp_overflow(call: Callable[[], torch.Tensor]) -> torch.Tensor:
    """A squeezed AMP budget: the modeled plan is re-costed pre-dispatch
    and rejected unless it is the minimum-granule floor; the conservative
    rung's floor plan is always admissible, so the ladder lands there."""
    with faults.fault_scope(seed=23, kinds=("amp_overflow",),
                            amp_squeeze=1e6):
        return call()


def cache_quarantine() -> dict:
    """A truncated on-disk tune cache is moved aside to <path>.corrupt and
    replaced by an empty cache, never an exception."""
    from repro_torch.tune.cache import load_or_quarantine

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "tune_cache.json")
        with open(path, "w") as fh:
            fh.write('{"schema_version":')
        cache, problem = load_or_quarantine(path)
        return {
            "quarantined": int(problem is not None),
            "quarantine_moved": int(os.path.exists(path + ".corrupt")),
            "cache_entries": len(cache.entries),
        }


def decode_scrub(params, cfg, cache, tokens, pos) -> torch.Tensor:
    """Poisoned decode logits: the serving boundary detects the non-finite
    batch and re-runs the step on the "torch" reference backend."""
    from repro_torch.serve import engine

    with faults.fault_scope(seed=5, kinds=("nan_output", "inf_output")):
        logits, _ = engine.guarded_decode_step(params, cfg, cache, tokens,
                                               pos)
    return logits


def _allclose(out: torch.Tensor, oracle: torch.Tensor) -> int:
    return int(bool(torch.allclose(out.float(), oracle.float(), rtol=1e-4,
                                   atol=1e-4)))


def guard_runs(a: torch.Tensor, b: torch.Tensor,
               decode: Callable[[], tuple], rec=None) -> dict[str, ChaosRun]:
    """The five scenarios of the guard suite, as the JAX package runs them:
    the dense site `ops.skew_matmul(a, b)` (its oracle ``a @ b`` in fp32),
    and `decode()` -> (params, cfg, cache, tokens, pos) for the decode
    scrub (a fresh cache: the step updates it in place).  With `rec` (a
    `bench.suite.Recorder`) each becomes the row ``guard_<scenario>``."""
    from repro_torch.kernels import ops

    def recorder(name):
        if rec is None:
            return None
        return lambda r: rec(f"guard_{name}", axes={"scenario": name},
                             metrics=r.metrics,
                             info={"counters": r.counters})

    oracle = torch.matmul(a.float(), b.float())

    def dense(scenario):
        def body():
            out = scenario(lambda: ops.skew_matmul(a, b))
            extra = {"outputs_ok": _allclose(out, oracle)}
            if scenario is amp_overflow:
                extra["plans_rejected"] = health.get("plans_rejected")
            return out, extra
        return body

    def scrub():
        logits = decode_scrub(*decode())
        return logits, {
            "scrubbed": health.get("scrubbed_batches"),
            "outputs_ok": int(bool(torch.isfinite(logits).all())),
        }

    bodies = {
        "all_faults": dense(all_faults),
        "transient_recovers": dense(transient_recovers),
        "amp_overflow": dense(amp_overflow),
        "cache_quarantine": lambda: (None, cache_quarantine()),
        "decode_scrub": scrub,
    }
    return {name: run(bodies[name], recorder(name)) for name in SCENARIOS}
