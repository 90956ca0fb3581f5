"""Readings that set a serving cell's limits, on the card at the cell's
own size: for each seed, a run of the cell (its set-up, a short window at
its own load, the drain) and then, on the same sampled prompts and served
tokens, the reference in float32 read three ways:

  program   the served tokens (what a benchmark run compares);
  control   the tokens the reference computed in float8 e4m3 puts first
            (the control: the nearest precision below the configuration's
            bf16);
  witness   the tokens the program's own one-sequence forward puts first
            (`transformer.forward_hidden` + `unembed`, bf16, one request
            a call: no padding, no other rows in its MoE capacity slots).

    python3 portbench/controls/serve_control.py --workload dbrx-chat \
        --seconds 10 --seeds 11 12 13

Program and control are each held to the configuration's limits by the
check a benchmark run makes (`judge.checks`), and each reading carries
its `correct` and its checks; the control, which computes a token at
every position asked, has no short or unfinished request.  One JSON line
a seed on standard output.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    import gc

    import torch

    from pbcore import judge, manifest
    man = manifest.load_manifest(ROOT)
    cell = manifest.workload(man, args.workload)
    cfg = manifest.load_config(man, cell["config"], ROOT)
    traffic = manifest.load_traffic(cell["traffic"])
    device = torch.device("cuda", 0)
    ref = manifest.load_module("reference", cfg["reference"])
    driver = manifest.load_module("drivers", traffic["driver"])
    for seed in args.seeds:
        ctx = SimpleNamespace(cell=cell, cfg=cfg, traffic=traffic, seed=seed,
                              seconds=args.seconds, trace=False,
                              device=device, t_proc0=time.perf_counter(),
                              setup={}, ref=ref)
        res = driver.run(ctx)
        w, reqs = res.pop("weights"), res.pop("sample_reqs")
        prompts = [r.prompt.tolist() for r in reqs]
        served = [list(r.tokens) for r in reqs]
        out = {"seed": seed, "served_tokens": res["sample"]["served_tokens"],
               "program": dict(res["sample"]["gaps"],
                               correct=res["correct"],
                               checks=_named(res["checks"])),
               "control": control_reading(ref, cfg, w, prompts, served),
               "witness": judge.summary(judge.gaps_of(
                   ref, cfg, w, prompts, served,
                   _witness_picks(driver, cfg, w, prompts, served, device)))}
        print(json.dumps(out), flush=True)
        del w, res, reqs
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def control_reading(ref, cfg: dict, w: dict, prompts, served) -> dict:
    """The control's gaps on the run's sampled prompts and served tokens,
    held to the configuration's limits: its summary, `correct` and
    checks."""
    from pbcore import judge
    got = judge.summary(judge.control_gaps(ref, cfg, w, prompts, served))
    held = judge.checks(cfg["correct"], got, 0, 0)
    return dict(got, correct=judge.passes(held), checks=_named(held))


def _named(rows) -> dict:
    return {name: {"value": v, "limit": lim} for name, v, lim in rows}


def _witness_picks(driver, cfg, w, prompts, served, device):
    import torch

    from repro_torch.models import transformer
    pcfg = driver.port_config(cfg)
    picks = []
    with torch.no_grad():
        for p, t in zip(prompts, served):
            seq = torch.tensor(list(p) + list(t[:-1]), device=device)
            h, _ = transformer.forward_hidden(w, pcfg, seq[None])
            rows = h[0, len(p) - 1:len(p) - 1 + len(t)]
            picks.append(transformer.unembed(w, pcfg, rows).argmax(-1))
    return torch.cat(picks)


if __name__ == "__main__":
    raise SystemExit(main())
