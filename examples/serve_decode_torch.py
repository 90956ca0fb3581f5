"""Batched serving on the PyTorch/CUDA port: prefill a prompt batch, then
decode with the model's cache.

    PYTHONPATH=src python examples/serve_decode_torch.py --arch gemma2-27b
    PYTHONPATH=src python examples/serve_decode_torch.py --arch mamba2-2.7b

Demonstrates the three cache families (ring / local KV for gemma2,
compressed MLA latents for deepseek-v3-671b, O(1) SSM state for mamba2)
behind one interface, at each config's `reduced()` size with weights drawn
from seed 0.  Each decode step is one replay of `serve.graphs.DecodeGraph`
(a CUDA graph on the card, captured once), and the next token is sampled
outside it with an explicit `torch.Generator`.  On the card the prefill
runs K7 (flash attention) and the matmuls K1 / K3 / K4, an MoE arch's
experts K5, mamba2's scan K8.  Runs on the card unless ``--device cpu`` is
given.  The last line is a JSON summary (token ids, whether every logit
was finite, the times, the kernel launches of the run).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.kernels import ops
from repro_torch.models.model import build_model
from repro_torch.serve import engine, graphs, kvcache


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cfg, params, *, batch: int = 4, prompt_len: int = 64,
        gen: int = 48) -> dict:
    """Prefill a numpy-seeded prompt batch on `params`' device, then decode
    `gen` tokens: the first greedy, the rest sampled from the softmax."""
    dev = params["embed"].device
    rng = np.random.default_rng(0)
    max_len = prompt_len + gen
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
                        dtype=torch.long, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    cache, logits = engine.prefill(params, cfg, toks, max_len=max_len)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    nbytes = kvcache.cache_bytes(cache)
    print(f"[serve] prefill({batch}x{prompt_len}) {prefill_s:.3f}s; cache = "
          f"{nbytes / 2**20:.1f} MiB ({cfg.kv_cache_kind}/{cfg.family})")
    prefill_logits = logits
    finite = torch.isfinite(logits).all()

    step = graphs.DecodeGraph(params, cfg, cache, batch)
    sampler = torch.Generator(device=dev)
    sampler.manual_seed(1)
    out = [torch.argmax(logits, -1)]
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(gen):
        logits = step.step(out[-1], prompt_len + i)
        finite = finite & torch.isfinite(logits).all()
        out.append(torch.multinomial(torch.softmax(logits, -1), 1,
                                     generator=sampler)[:, 0])
    _sync(dev)
    decode_s = time.perf_counter() - t0
    tokens = torch.stack(out, 1).cpu()
    rate = batch * gen / decode_s if decode_s > 0 else float("inf")
    print(f"[serve] {gen} decode steps in {decode_s:.3f}s ({rate:.1f} tok/s "
          f"on {dev.type})")
    print("[serve] sample token ids:", tokens[0, :12].tolist())
    return dict(prefill_logits=prefill_logits, tokens=tokens,
                logits_finite=bool(finite), prefill_s=prefill_s,
                decode_s=decode_s, tok_per_s=rate, cache_bytes=nbytes)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-27b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    params = build_model(cfg, dev).init(0)
    ops.reset_launch_counts()
    res = run(cfg, params, batch=args.batch, prompt_len=args.prompt_len,
              gen=args.gen)
    print(json.dumps(dict(
        example="serve_decode", arch=args.arch, vocab=cfg.vocab_size,
        tokens=res["tokens"].tolist(), logits_finite=res["logits_finite"],
        prefill_s=res["prefill_s"], decode_s=res["decode_s"],
        tok_per_s=res["tok_per_s"], cache_bytes=res["cache_bytes"],
        launches={k: v for k, v in ops.launch_counts().items() if v})))
    return res


if __name__ == "__main__":
    main()
