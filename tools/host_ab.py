#!/usr/bin/env python3
"""Time the host side of the port's dispatch for one source tree, to
compare two trees on one card (the cost of the guard and obs hooks when
nothing is armed).

    python3 tools/host_ab.py SRC_DIR

SRC_DIR holds a `repro_torch` package (`src` of a checkout, or of an
unpacked `git archive <commit> src`).  Host clocks vary more than device
clocks, so compare two trees inside one call, in turns:

    mkdir -p build/ab/parent && git archive <parent> src | tar -x -C build/ab/parent
    for t in build/ab/parent/src src src build/ab/parent/src; do
        python3 tools/host_ab.py $t; done

Each run builds the tree's kernels into build/ab/<tree> and prints one
JSON line: host us a call (perf_counter over 2000 calls after 50
warm-ups, ending in a synchronise) of `ops.skew_matmul(plan=(64, 64,
128))` and of the kernel wrapper `skew_matmul.skew_matmul` alone at 8 x
256 x 512 bf16, and of `ops.grouped_matmul` with no plan (the guard
ladder where the tree has one, as dbrx's experts run) at 16 x 8 x 256 x
512 bf16; then phi4-mini-3.8b at full width (seeded bf16 weights,
batch 4 x prompt 128): one eager prefill (ms), 16 eager decode steps (ms
a token) and `launch.serve.serve`'s graphed decode (ms a token, 16
tokens), each on the host clock ending in a synchronise.  Where the tree
has the guard's explicit envelope, the eager decode is also timed in
the same process in turns with the envelope and with it replaced by a
direct kernel call (three of each), a control free of the spread
between processes.  Needs one CUDA card.
"""

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CALLS = 2000


def host_us(torch, fn) -> float:
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / CALLS * 1e6


def main() -> None:
    src = Path(sys.argv[1]).resolve()
    tag = "_".join(src.relative_to(ROOT).parts) if src.is_relative_to(
        ROOT) else src.name
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "ab" / tag)
    sys.path.insert(0, str(src))
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.costmodel import BlockPlan
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import skew_matmul as mm
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.model import build_model
    from repro_torch.serve import engine

    build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a = torch.randn((8, 256), generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn((256, 512), generator=gen, device=dev).to(torch.bfloat16)
    plan = BlockPlan(64, 64, 128)
    out = {"tree": tag,
           "ops_us": host_us(torch, lambda: ops.skew_matmul(a, b, plan=plan)),
           "wrapper_us": host_us(torch, lambda: mm.skew_matmul(
               a, b, bm=64, bk=64, bn=128, out_dtype=torch.bfloat16))}
    ga = torch.randn((16, 8, 256), generator=gen, device=dev).to(
        torch.bfloat16)
    gb = torch.randn((16, 256, 512), generator=gen, device=dev).to(
        torch.bfloat16)
    out["grouped_us"] = host_us(torch, lambda: ops.grouped_matmul(ga, gb))

    cfg = get_config("phi4-mini-3.8b")
    params = build_model(cfg, dev).init(0)
    rng = np.random.default_rng(0)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 128)),
                        dtype=torch.long, device=dev)
    engine.prefill(params, cfg, toks, max_len=144)     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, logits = engine.prefill(params, cfg, toks, max_len=144)
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    first = torch.argmax(logits, -1)

    def decode_ms() -> float:
        tok = first
        t0 = time.perf_counter()
        for i in range(16):
            lg, _ = engine.decode_step(params, cfg, cache, tok, 128 + i)
            tok = torch.argmax(lg, -1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 16 * 1e3

    out["eager_decode_ms"] = decode_ms()
    envelope = getattr(ops, "_run_guarded_explicit", None)
    if envelope is not None:
        # in-process control: the same steps with the explicit envelope
        # replaced by a direct kernel call, in turns
        runs = {"envelope": [], "bypassed": []}
        for turn in ("envelope", "bypassed") * 3:
            ops._run_guarded_explicit = envelope if turn == "envelope" \
                else (lambda site, run, ref_fn, strict=False: run())
            runs[turn].append(decode_ms())
        ops._run_guarded_explicit = envelope
        out.update({f"eager_decode_{k}_ms": v for k, v in runs.items()})
    res = serve_mod.serve(cfg=cfg, params=params, batch=4, prompt_len=128,
                          gen=16, seed=0)
    out["graphed_decode_ms"] = res["decode_s_per_token"] * 1e3
    out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
