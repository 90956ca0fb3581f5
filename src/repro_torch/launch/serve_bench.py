"""Continuous-batching scheduler bench: a scripted trace end to end.

  PYTHONPATH=src python -m repro_torch.launch.serve_bench --ticks 50 --tiny

Builds the bucket table for the workload envelope, tunes a cache
covering every shape the scheduler can issue (modeled measurer —
deterministic, no wall-clock), then replays a deterministic arrival
trace under ``plan_mode="tuned"`` and reports: queue/TTFT percentiles,
tokens per tick, the tuned hit/miss ledger (misses must be zero — the
bucket table's contract), MoE capacity-slot utilization when the arch
routes experts, and the modeled gc200-vs-rtx2080ti tokens/sec ratio —
the paper's skew verdict at the serving level.

Runs on the CUDA card unless ``--device cpu`` is given; weights are drawn
from seed 0.  On the card the scheduler decodes through one CUDA graph
per batch bucket; ``--trace`` decodes eagerly instead, so that every
decode step's dispatches land in the span tree (a replay emits none).
"""

from __future__ import annotations

import argparse

from repro_torch.configs.base import get_config
from repro_torch.core import config as mmcfg
from repro_torch.guard import health
from repro_torch.models.model import build_model
from repro_torch.serve.sched import (
    BucketTable,
    Scheduler,
    assert_covered,
    build_tuned_cache,
    capture_gemm_specs,
    modeled_step_seconds,
    scripted_trace,
)
from repro_torch.serve.sched.buckets import (decode_gemm_specs,
                                             gemv_decode_coverage)
from repro_torch.tune import runtime as tune_runtime


def build_trace(args, cfg):
    """Deterministic staggered arrivals covering every prompt bucket."""
    entries = []
    for i in range(args.requests):
        arrival = i // 2
        prompt_len = 3 + (5 * i) % (args.max_prompt - 2)
        max_new = 1 + i % args.max_new
        entries.append((arrival, prompt_len, max_new))
    return scripted_trace(entries, vocab_size=cfg.vocab_size, seed=args.seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config + small trace (CI smoke)")
    ap.add_argument("--ticks", type=int, default=50)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-prompt", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-scale", action="store_true",
                    help="with --tiny: widen the reduced config to "
                         "decode-scale weights (K >= 1024) so decode "
                         "GEMMs sit in the GEMV regime — the reduced "
                         "shapes are grid-overhead-bound and every chip "
                         "correctly stays dense on them")
    ap.add_argument("--expect-gemv", action="store_true",
                    help="assert decode steps resolve measured split-K "
                         "(GEMV) tuned-cache entries — exits non-zero if "
                         "no decode class tuned to the split-K family or "
                         "no split-K plan was hit during the run (pair "
                         "with --decode-scale: the reduced shapes are "
                         "grid-overhead-bound and stay dense)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="arm structured tracing (repro_torch.obs, sim "
                         "clock; decode runs eagerly) "
                         "around the scheduler run and write the "
                         "Chrome-trace JSON here; decode-step dispatch "
                         "spans carry tune key, rung, modeled_us and "
                         "measured_us")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    mmcfg.add_cli_args(ap)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.tiny:
        cfg = cfg.reduced()
        args.requests = min(args.requests, 8)
    if args.decode_scale:
        # Decode-scale weights on the reduced layer count: K >= 1024 puts
        # the decode-step GEMMs inside the GEMV regime (the reduced dims
        # are one grid step for *any* schedule, so dense correctly wins
        # there and --expect-gemv could never pass).
        cfg = cfg.decode_scale()
    params = build_model(cfg, args.device).init(0)

    table = BucketTable.for_workload(
        max_batch=args.max_batch,
        max_prompt=args.max_prompt,
        max_new=args.max_new,
    )
    with mmcfg.scope_from_args(args):
        specs = capture_gemm_specs(params, cfg, table)
        cache = build_tuned_cache(params, cfg, table)
        assert_covered(cache, specs)
        print(f"[serve_bench] {args.arch}: {len(specs)} GEMM shape classes, "
              f"{len(cache.entries)} tuned entries")
        cov = gemv_decode_coverage(cache, decode_gemm_specs(params, cfg,
                                                            table))
        print(f"[serve_bench] decode classes: {cov['decode_classes']} "
              f"({cov['gemv_classes']} split-K, "
              f"{cov['dense_classes']} dense)")

        trace = build_trace(args, cfg)
        health.reset()
        span_tr = None
        with tune_runtime.use_cache(cache), mmcfg.mm_config(plan_mode="tuned"):
            if args.trace:
                # Cache/spec capture stayed outside the scope: the trace
                # is the serve run, not the tuning sweep.
                from repro_torch.obs import SimClock, trace_scope

                with trace_scope(clock=SimClock()) as span_tr:
                    sched = Scheduler(params, cfg, table,
                                      decode_graphs=False)
                    results = sched.run(trace, max_ticks=args.ticks)
            else:
                sched = Scheduler(params, cfg, table)
                results = sched.run(trace, max_ticks=args.ticks)
        if span_tr is not None:
            span_tr.export_chrome(args.trace)
            digest = span_tr.digest()
            print("[serve_bench] trace " + args.trace + " "
                  + "/".join(f"{k}:{v}" for k, v in sorted(digest.items())))

        summary = sched.telemetry.summary()
        line = ", ".join(f"{k}={v:g}" for k, v in sorted(summary.items()))
        print(f"[serve_bench] {line}")
        snap = health.snapshot()
        hits, misses = snap.get("tuned_hits", 0), snap.get("tuned_misses", 0)
        gemv_hits = snap.get("tuned_hits_gemv", 0)
        print(f"[serve_bench] tuned lookups: {hits} hits, {misses} misses "
              f"({gemv_hits} split-K)")
        if snap.get("moe_slots_total"):
            util = snap["moe_slots_filled"] / snap["moe_slots_total"]
            print(f"[serve_bench] moe capacity-slot utilization: {util:.3f} "
                  f"(underfilled: {snap.get('moe_slots_underfilled', 0)})")

        batch = sched.slab_batch or table.batch_buckets[-1]
        rows = {
            chip: batch / modeled_step_seconds(
                params, cfg, batch, table.max_len, chip=chip)
            for chip in ("ipu_gc200", "gpu_rtx2080ti")
        }
        ratio = rows["ipu_gc200"] / rows["gpu_rtx2080ti"]
        print(f"[serve_bench] modeled decode tokens/s at batch {batch}: "
              + ", ".join(f"{c}={v:.0f}" for c, v in rows.items())
              + f" (gc200/rtx2080ti = {ratio:.2f}x)")

    if len(results) != len(trace):
        print(f"[serve_bench] ERROR: {len(trace) - len(results)} requests "
              f"did not complete within {args.ticks} ticks")
        return 1
    if misses:
        print("[serve_bench] ERROR: tuned lookups missed — bucket table "
              "does not cover the served shapes")
        return 1
    if args.expect_gemv:
        if not cov["gemv_classes"]:
            print("[serve_bench] ERROR: --expect-gemv but no decode class "
                  "tuned to the split-K family (wrong --chip? HBM chips "
                  "stay dense)")
            return 1
        if not gemv_hits:
            print("[serve_bench] ERROR: --expect-gemv but no split-K "
                  "tuned-cache entry was resolved during the run")
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
