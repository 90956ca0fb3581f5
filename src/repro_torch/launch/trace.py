"""Trace explorer — run one traced workload, print the span tree.

  PYTHONPATH=src python -m repro_torch.launch.trace --mode matmul --skew 64
  PYTHONPATH=src python -m repro_torch.launch.trace --clock wall --check
  PYTHONPATH=src python -m repro_torch.launch.trace --mode serve --check

Arms `repro_torch.obs.trace_scope` around a small real workload and shows
what the instrumented stack emits: the deterministic text tree on
stdout, the Chrome-trace JSON at ``--out`` (load it in Perfetto /
chrome://tracing).  ``--clock sim`` (default) measures every dispatch
at exactly its modeled time, so the trace is host-independent and the
drift report comes back identically zero; ``--clock wall`` stamps real
timestamps (each dispatch timed on the card by a pair of CUDA events,
read when the scope closes, with no synchronise inside the dispatch) so
the same tree shows where the wall time went, and the drift report shows
how far the cost model is from the card, per shape class (after one untraced
warm-up pass, so no dispatch is a cold first call).

``--check`` turns the run into a smoke gate: the Chrome document must
schema-validate, its event count must equal the span-tree total, and
every dispatch span must carry the attribution fields (ladder rung,
modeled_us, measured_us — plus the tune cache key under
``--mm-plan-mode tuned``).  Exits non-zero on any violation.

``--mode serve`` traces a tiny scripted serve run of the scheduler
(`serve.sched`) on a reduced config under ``plan_mode="tuned"`` (the
covering cache tuned by the cost model outside the scope), decoding
eagerly so that every decode step's dispatches are in the tree.

The workload runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import config as mmcfg
from repro_torch.obs import (
    SimClock,
    WallClock,
    drift_report,
    to_chrome,
    trace_scope,
    validate_chrome,
)

def _make_clock(name: str):
    return SimClock() if name == "sim" else WallClock()


def matmul_shapes(size: int, skew: int) -> list[tuple[int, int, int]]:
    """The workload's (m, k, n): squared, left- and right-skewed, and a
    decode GEMV row."""
    return [
        (size, size, size),
        (size * skew, size, size),
        (size, size, size * skew),
        (1, size, size),
    ]


def run_matmul(args):
    """A handful of skewed dense dispatches through `skewmm.matmul`.
    Under the wall clock one untraced pass over the shapes goes first, so
    no traced dispatch pays a first call's set-up."""
    from repro_torch.core import skewmm

    operands = [
        (torch.ones((m, k), dtype=torch.float32, device=args.device),
         torch.ones((k, n), dtype=torch.float32, device=args.device))
        for m, k, n in matmul_shapes(args.size, args.skew)]
    if args.clock == "wall":
        for a, b in operands:
            skewmm.matmul(a, b)
    with trace_scope(clock=_make_clock(args.clock)) as tr:
        for a, b in operands:
            skewmm.matmul(a, b)
    return tr


def run_serve(args):
    """A tiny scripted serve run under plan_mode=tuned (the obs-suite
    workload): cache built outside the scope, scheduler inside, decode
    eager."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.sched import (
        BucketTable,
        Scheduler,
        assert_covered,
        build_tuned_cache,
        capture_gemm_specs,
        scripted_trace,
    )
    from repro_torch.tune import runtime as tune_runtime

    cfg = get_config(args.arch).reduced()
    table = BucketTable.for_workload(max_batch=2, max_prompt=8, max_new=2)
    params = build_model(cfg, args.device).init(0)
    specs = capture_gemm_specs(params, cfg, table)
    cache = build_tuned_cache(params, cfg, table)
    assert_covered(cache, specs)
    reqs = scripted_trace(
        [(0, 3, 2), (1, 5, 1), (2, 7, 2)], vocab_size=cfg.vocab_size, seed=3
    )
    with tune_runtime.use_cache(cache), mmcfg.mm_config(plan_mode="tuned"):
        with trace_scope(clock=_make_clock(args.clock)) as tr:
            sched = Scheduler(params, cfg, table, decode_graphs=False)
            results = sched.run(reqs, max_ticks=50)
    if len(results) != len(reqs):
        raise SystemExit(
            f"serve run incomplete: {len(results)}/{len(reqs)} requests"
        )
    return tr


def check_trace(tr, *, tuned: bool) -> list[str]:
    """The trace-smoke contract; returns human-readable violations."""
    problems = []
    doc = to_chrome(tr)
    try:
        validate_chrome(doc)
    except ValueError as e:
        problems.append(f"chrome schema: {e}")
    digest = tr.digest()
    n_events = len(doc["traceEvents"])
    if n_events != digest["total"]:
        problems.append(
            f"chrome event count {n_events} != span total {digest['total']}"
        )
    dispatches = [sp for sp in tr.spans() if sp.kind == "dispatch"]
    if not dispatches:
        problems.append("no dispatch spans emitted")
    for sp in dispatches:
        missing = []
        if "rung" not in sp.attrs:
            missing.append("rung")
        if tuned and "tune_key" not in sp.attrs:
            missing.append("tune_key")
        if sp.modeled_us is None:
            missing.append("modeled_us")
        if sp.measured_us is None:
            missing.append("measured_us")
        if missing:
            problems.append(
                f"dispatch span {sp.name!r} missing {missing} "
                f"(attrs: {sorted(sp.attrs)})"
            )
    return problems


def drift_lines(report: dict) -> list[str]:
    """One line per shape class of a `drift_report()`."""
    return [f"[trace] drift {cls}: count={c['count']} "
            f"geomean_ratio={c['geomean_ratio']:.4f} "
            f"max_abs_log={c['max_abs_log']:.4f} accepted={c['accepted']}"
            for cls, c in report["classes"].items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=("matmul", "serve"), default="matmul")
    ap.add_argument("--clock", choices=("sim", "wall"), default="sim",
                    help="sim: measured == modeled exactly "
                         "(host-independent); wall: CUDA events around "
                         "each dispatch on the card, perf_counter off it")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the Chrome-trace JSON here")
    ap.add_argument("--size", type=int, default=128,
                    help="matmul mode: base dimension")
    ap.add_argument("--skew", type=int, default=8,
                    help="matmul mode: skew ratio for the long sides")
    ap.add_argument("--arch", default="phi4-mini-3.8b",
                    help="serve mode: model config (reduced)")
    ap.add_argument("--device", default="cuda",
                    help="where the operands and weights live (default: "
                         "the card)")
    ap.add_argument("--check", action="store_true",
                    help="validate the trace-smoke contract (chrome "
                         "schema, event counts, dispatch attribution) "
                         "and exit non-zero on violations")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the span-tree dump")
    mmcfg.add_cli_args(ap)
    args = ap.parse_args(argv)

    with mmcfg.scope_from_args(args):
        tuned = args.mode == "serve" or mmcfg.resolve().plan_mode == "tuned"
        tr = run_matmul(args) if args.mode == "matmul" else run_serve(args)

    if not args.quiet:
        print(tr.render().rstrip("\n"))
    digest = tr.digest()
    print("[trace] " + "/".join(f"{k}:{v}" for k, v in sorted(digest.items())))
    drift = drift_report()
    print(f"[trace] drift: classes={drift['classes_total']} "
          f"max_abs_log={drift['max_abs_log']:.4f} "
          f"accepted={drift['accepted']}")
    for line in drift_lines(drift):
        print(line)
    if args.out:
        tr.export_chrome(args.out)
        print(f"[trace] wrote {args.out}")

    if args.check:
        problems = check_trace(tr, tuned=tuned)
        if problems:
            for p in problems:
                print(f"[trace] CHECK FAIL: {p}")
            return 1
        print("[trace] check ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
