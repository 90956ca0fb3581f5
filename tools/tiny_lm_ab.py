#!/usr/bin/env python3
"""Time the tiny LM example's training step for two source trees on one
card, in rounds whose order turns, with a third arm that runs this tree's
example without its process group.

    python3 tools/tiny_lm_ab.py OTHER_DIR [--rounds 6] [--steps 20]
    python3 tools/tiny_lm_ab.py --in-process [--rounds 6] [--steps 20]

OTHER_DIR is an unpacked `git archive <commit> src examples` (say, the
parent commit):

    mkdir -p build/ab/parent
    git archive <parent> src examples | tar -x -C build/ab/parent
    python3 tools/tiny_lm_ab.py build/ab/parent

The arms are OTHER_DIR's `examples/train_tiny_lm_torch.py`, this tree's,
and this tree's with `make_host_mesh` replaced by a function that forms
no process group and returns no mesh (so the trainer and loader get
`mesh=None`): a control for the one-rank NCCL group the example forms.
Each run is its own process, with an emptied checkpoint directory
under build/ab, and `--steps` steps at the example's defaults (12 x 768,
fp32, 4 x 256, 2 microbatches) on the card.  Round r starts at arm r
mod 3, so each arm runs first, second and third equally often.  Each run
prints one JSON line (arm, ms a step: the example's median of its steps
after the first, the final loss, the process's wall s); the last line is
a JSON summary: each arm's ms in run order, its least, median and most,
and whether every run of each other arm lies inside OTHER_DIR's spread.

With `--in-process` (no OTHER_DIR) one process runs this tree's example
`train()` in rounds of two arms, the order turning: with its one-rank
process group (formed and destroyed by each run) and without one.  The
step code is the same in both (a world of one places nothing), so the
pair isolates what the group itself costs a step, free of the spread
between processes.  The summary has each arm's ms and each round's
ratio, group over no group.

Needs one CUDA card.
"""

import argparse
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
EXAMPLE = Path("examples") / "train_tiny_lm_torch.py"


def no_group_child(argv: list) -> None:
    """Run this tree's example with no process group and no mesh."""
    mod = load_example()
    mod.make_host_mesh = lambda **kw: None
    mod.main(argv)


def load_example():
    spec = importlib.util.spec_from_file_location("tiny_lm", ROOT / EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def in_process(rounds: int, steps: int) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    mod = load_example()
    from repro_torch import resolve_device
    dev, cfg = resolve_device(None), mod.tiny_lm_config()
    real, ckpt = mod.make_host_mesh, ROOT / "build" / "ab" / "ckpt"
    arms = ["group", "no-group"]
    out = {a: [] for a in arms}
    for r in range(rounds):
        for k in range(len(arms)):
            arm = arms[(r + k) % len(arms)]
            mod.make_host_mesh = real if arm == "group" else \
                (lambda **kw: None)
            shutil.rmtree(ckpt, ignore_errors=True)
            res = mod.train(cfg, dev, steps=steps, ckpt_dir=str(ckpt))
            shutil.rmtree(ckpt, ignore_errors=True)
            ms = statistics.median(res["step_ms"][1:])
            print(json.dumps({"arm": arm, "ms": ms, "round": r,
                              "final_loss": res["final_loss"]}), flush=True)
            out[arm].append(ms)
    print(json.dumps({
        "ms": out,
        "spread": {a: [min(v), statistics.median(v), max(v)]
                   for a, v in out.items()},
        "ratio_each_round": [g / n for g, n in zip(out["group"],
                                                   out["no-group"])]}))


def run(arm: str, tree: Path, steps: int, ckpt: Path) -> dict:
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--steps", str(steps), "--ckpt-dir", str(ckpt)]
    cmd = ([sys.executable, str(Path(__file__).resolve()), "--no-group-child"]
           if arm == "no-group" else [sys.executable, str(tree / EXAMPLE)])
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd + argv, env=env, cwd=tree, text=True,
                          capture_output=True)
    wall = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    if proc.returncode != 0:
        sys.exit(f"{arm}: rc {proc.returncode}: {proc.stderr[-2000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    return {"arm": arm, "ms": res["step_ms"], "final_loss": res["final_loss"],
            "wall_s": wall}


def main() -> None:
    if sys.argv[1:2] == ["--no-group-child"]:
        no_group_child(sys.argv[2:])
        return
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?")
    ap.add_argument("--in-process", action="store_true")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if args.in_process:
        in_process(args.rounds, args.steps)
        return
    other = Path(args.other).resolve()
    arms = [("other", other), ("this", ROOT), ("no-group", ROOT)]
    out = {a: [] for a, _ in arms}
    losses = set()
    for r in range(args.rounds):
        for k in range(len(arms)):
            arm, tree = arms[(r + k) % len(arms)]
            res = run(arm, tree, args.steps, ROOT / "build" / "ab" / "ckpt")
            print(json.dumps(dict(res, round=r)), flush=True)
            out[arm].append(res["ms"])
            losses.add(res["final_loss"])
    lo, hi = min(out["other"]), max(out["other"])
    print(json.dumps({
        "ms": out,
        "spread": {a: [min(v), statistics.median(v), max(v)]
                   for a, v in out.items()},
        "inside_other_spread": {a: all(lo <= x <= hi for x in v)
                                for a, v in out.items() if a != "other"},
        "final_losses": sorted(losses)}))


if __name__ == "__main__":
    main()
