"""Measured autotuning CLI — fill the tuned-plan cache on the card.

Times the modeled top-K candidate plans for a suite of shapes with
`repro_torch.bench.timing.measure` (CUDA events, every call waited for,
median over repeats), records the winners as `TuneEntry`s, fits per-chip
calibration corrections from the measured / modeled ratios, and — with
``--update-cache`` — writes everything to the versioned JSON cache that
``mm_config(plan_mode="tuned")`` consults.

Suites (as in the JAX package's CLI):

  fig5    — dense skew sweep (the paper's aspect-ratio axis): A holds
            ``--total``^2 elements at m / k in {1/16, 1/4, 1, 4, 16},
            n = ``--total``;
  sparse  — block-sparse layouts ``BlockSparseLayout.random(total, total,
            (32, 128), d)`` for d in (0.25, 0.5), n = ``--total``; every
            candidate runs the block-sparse kernel;
  decode  — the GEMV decode classes (m in {1, 4, 8} exact against a
            K = N = ``--total`` weight).

``--budget-s`` bounds wall time: at least one shape is always tuned, and
the loop stops at the first shape that would start past the budget.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.tune --suite sparse \\
      --total 4096 --update-cache [--cache PATH] [--chip C] [--amp A]

Runs on the CUDA card unless ``--device cpu`` is given; with no card it
raises.  After writing, the cache file is loaded again and
schema-validated.
"""

from __future__ import annotations

import argparse
import math
import os
import time

from repro_torch import resolve_device
from repro_torch.core import config as mmcfg
from repro_torch.sparse.layout import BlockSparseLayout
from repro_torch.tune import calibrate
from repro_torch.tune.cache import TuneCache
from repro_torch.tune.runtime import default_cache_path
from repro_torch.tune.shapeclass import decode_classes
from repro_torch.tune.tuner import tune_dense, tune_sparse

SUITES = ("fig5", "sparse", "decode")

# The fig5 aspect-ratio axis, power-of-two so shape classes map to
# themselves (tuning representatives, not neighbours).
FIG5_RATIOS = (1.0 / 16, 1.0 / 4, 1.0, 4.0, 16.0)
SPARSE_DENSITIES = (0.25, 0.5)
SPARSE_BLOCK = (32, 128)


def fig5_shapes(total_side: int) -> list[tuple[int, int, int]]:
    total = total_side * total_side
    out = []
    for r in FIG5_RATIOS:
        m = max(1, int(round((total * r) ** 0.5)))
        k = max(1, int(round((total / r) ** 0.5)))
        out.append((m, k, total_side))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--suite", choices=SUITES, default="fig5",
                    help="which shape family to tune")
    ap.add_argument("--budget-s", type=float, default=60.0,
                    help="wall-clock budget; at least one shape always runs")
    ap.add_argument("--update-cache", action="store_true",
                    help="write winners (and fitted corrections) to --cache")
    ap.add_argument("--cache", default=None, metavar="PATH",
                    help=f"cache file (default: {default_cache_path()})")
    ap.add_argument("--total", type=int, default=256,
                    help="problem scale: dense shapes hold m*k = total^2 "
                         "with n = total")
    ap.add_argument("--top", type=int, default=4,
                    help="how many modeled candidates to time per shape")
    ap.add_argument("--dtype-bytes", type=int, default=2, choices=(2, 4),
                    help="element width to tune for (2 = bf16, 4 = fp32); "
                         "part of the cache key")
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="device the benches run on (default: the card)")
    mmcfg.add_cli_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cache_path = args.cache or default_cache_path()
    cache = (TuneCache.load(cache_path) if os.path.exists(cache_path)
             else TuneCache())
    deadline = time.monotonic() + args.budget_s
    kw = dict(dtype_bytes=args.dtype_bytes, top=args.top, iters=args.iters,
              repeats=args.repeats, device=device)

    entries = []
    with mmcfg.scope_from_args(args):
        cfg = mmcfg.resolve()
        chip = cfg.chip_spec
        print(f"# tuning suite={args.suite} chip={chip.name} "
              f"amp={cfg.amp:g} total={args.total} top={args.top} "
              f"device={device} budget={args.budget_s:g}s -> {cache_path}")
        if args.suite == "fig5":
            work = [("dense", s) for s in fig5_shapes(args.total)]
        elif args.suite == "decode":
            work = [("dense", cls.dims)
                    for cls in decode_classes(args.total, args.total)]
        else:
            work = [("sparse", d) for d in SPARSE_DENSITIES]
        for i, (kind, item) in enumerate(work):
            if i > 0 and time.monotonic() > deadline:
                print(f"# budget exhausted after {i}/{len(work)} shapes")
                break
            t0 = time.monotonic()
            if kind == "dense":
                m, k, n = item
                entry = tune_dense(m, k, n, **kw)
            else:
                layout = BlockSparseLayout.random(args.total, args.total,
                                                  SPARSE_BLOCK, item)
                entry = tune_sparse(layout, args.total, **kw)
            entries.append(entry)
            cache.put(entry)
            print(f"{entry.key},{entry.measured_us:.1f},"
                  f"modeled={entry.modeled_us:.4g};"
                  f"sched={entry.schedule};"
                  f"plan={'x'.join(str(b) for b in entry.blocks)};"
                  f"agree={entry.agreement};speedup={entry.speedup:.3f} "
                  f"({time.monotonic() - t0:.1f}s)")

        # ---- calibration: fold measured / modeled ratios into corrections.
        chip_entries = [e for e in cache.entries.values()
                        if e.chip == chip.name]
        if chip_entries:
            corr = calibrate.fit_corrections(chip_entries, chip)
            cache.corrections[chip.name] = corr.to_json()
            gather = ("datasheet" if corr.sparse_gather_frac is None
                      else f"{corr.sparse_gather_frac:g}")
            if corr.accepted:
                corrected = calibrate.apply_corrections(chip, corr)
                print(f"# calibration {chip.name}: "
                      f"time_frac={corr.time_frac:g} "
                      f"sparse_gather_frac={gather} "
                      f"(n_dense={corr.n_dense} n_sparse={corr.n_sparse}) -> "
                      f"corrected peak "
                      f"{corrected.peak_bf16_flops / 1e12:.1f} "
                      f"TFLOP/s; absorb via hw.register_chip")
            else:
                print(f"# calibration {chip.name}: REJECTED "
                      f"(cross-shape spread {math.exp(corr.log_spread):.2f}x"
                      f" > {math.exp(calibrate.MAX_LOG_SPREAD):.0f}x, "
                      f"n_dense={corr.n_dense}); corrections recorded but "
                      f"not absorbable")

    agree = sum(1 for e in entries if e.agreement)
    print(f"# tuned {len(entries)} shape classes; "
          f"agreement {agree}/{len(entries)}")
    if args.update_cache:
        cache.save(cache_path)
        # Load again and schema-validate what was written, so a malformed
        # cache fails here, not at the first tuned plan lookup.
        reloaded = TuneCache.load(cache_path)
        print(f"# wrote {cache_path} ({len(reloaded.entries)} entries, "
              f"schema ok)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
