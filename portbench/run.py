"""The benchmark of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The cell's entry in `BENCHMARK.json`
names a configuration file and a traffic file; the traffic file names the
driver that generates the load (`portbench/drivers/<driver>.py`), the
configuration its plain reference and its work model.  With `--trace 0`
the last line of standard output is the cell's end-to-end metrics; with
`--trace 1` the window runs under `torch.profiler` and the line carries
the per-layer metrics (`portbench/metrics/<name>.py`, each a reader of
the run's records), the device's busy time and a breakdown.  Set-up
details and the numbers compared for `correct` are printed to standard
error before it.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), and when JAX or the JAX package is loaded once
the window has closed.  Kernel builds go to `build/` inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """`time.perf_counter()` at the moment the process was created
    (from /proc; the start of this file where /proc is missing)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        started = int(Path("/proc/self/stat").read_text()
                      .rsplit(")", 1)[1].split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.perf_counter() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return T_START


def say(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    t_proc0 = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches at fixed paths inside the checkout
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(ROOT / "src"))
    from pbcore import manifest

    man = manifest.load_manifest(ROOT)
    cell = manifest.workload(man, args.workload)
    cfg = manifest.load_config(man, cell["config"], ROOT)
    traffic = manifest.load_traffic(cell["traffic"])

    t = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        say("torch.cuda.is_available() is False: no result")
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        say(f"{torch.cuda.device_count()} cards, the cell asks for "
            f"{cell['chips']}: no result")
        return 3
    import repro_torch  # noqa: F401  (the program under test)
    setup = {"import_s": time.perf_counter() - t}
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line = execute(man, cell, cfg, traffic, args, device, t_proc0, setup)
    if line is None:
        return 4
    print(json.dumps(line), flush=True)
    return 0


def execute(man, cell, cfg, traffic, args, device, t_proc0, setup):
    """Everything of a run after the look for a card: the driver's run,
    the metric readers, the checks.  The result line, or None when JAX
    or the JAX package was loaded."""
    import torch

    from pbcore import manifest
    torch.set_num_threads(1)
    e2e, per_layer = manifest.cell_metrics(man, cell["name"])
    ctx = SimpleNamespace(
        cell=cell, cfg=cfg, traffic=traffic, seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace), device=device,
        t_proc0=t_proc0, setup=setup,
        ref=manifest.load_module("reference", cfg["reference"]))
    driver = manifest.load_module("drivers", traffic["driver"])
    res = driver.run(ctx)

    bad = forbidden_modules()
    if bad:
        say(f"modules of JAX or the JAX package loaded: {bad}: no result")
        return None
    metrics = {}
    if not args.trace:
        for m in e2e:
            val = setup["setup_s"] if m["name"] == "setup_s" \
                else res["metrics"][m["name"]]
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    else:
        lctx = dict(res["layer_ctx"], cfg=cfg, cell=cell["name"],
                    work=manifest.load_module("work", cfg["work"]),
                    families=manifest.kernel_families())
        for m in per_layer:
            val = manifest.load_module("metrics", m["name"]).read(lctx)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    cuda = device.type == "cuda"
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": cell["chips"],
                   "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": bool(res["correct"]), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics,
            "device": device_info}
    trace = res["layer_ctx"]["trace"]
    if trace is not None:
        device_info["busy_s"] = trace.busy_s
        device_info["window_s"] = trace.window_s
        line["breakdown"] = {"device_ops": trace.top_ops(10),
                             "idle_gaps": trace.idle_gaps(10)}
    say("setup " + json.dumps(setup))
    say(f"build_s {setup.get('build_s', 0.0):.3f} of setup_s "
        f"{setup['setup_s']:.3f} (a checkout's first run builds build/)")
    say("counts " + json.dumps(res["counts"]))
    say("sample " + json.dumps(res["sample"]) + f" judge_s "
        f"{res['judge_s']:.3f}")
    for name, v, lim in res["checks"]:
        say(f"check {name} {v} limit {lim}")
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in res["checks"]}
    return line


if __name__ == "__main__":
    raise SystemExit(main())
