"""Serving launcher: batched prefill + decode loop on seeded weights.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
      --batch 4 --prompt-len 128 --gen 16

``--arch`` takes every config of the registry: phi4-mini-3.8b,
gemma2-27b, granite-34b, command-r-35b, dbrx-132b, deepseek-v3-671b,
recurrentgemma-9b, mamba2-2.7b, internvl2-1b, seamless-m4t-large-v2 and
paper-skewmm (``--reduced`` for the small config).  internvl2-1b is
served without an image prefix, as the JAX launcher serves it (the
prefix goes through `engine.prefill(prefix_embeds=)`); seamless-m4t's
encoder takes ``frontend_len`` seeded frame embeddings in its stub
frontend's place and `serve.encdec_engine` serves it.

Runs on the CUDA card unless ``--device cpu`` is given.  The published
weights are not in the repository: weights are drawn from ``--seed``.
Prefill runs eagerly; every decode step on the card is one replay of a
CUDA graph captured once per run (`serve.graphs.DecodeGraph`, the
counterpart of the JAX launcher's `jax.jit`), and sampling stays outside
the graph.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import config as mmcfg
from repro_torch.models.model import build_model
from repro_torch.serve import encdec_engine, engine, graphs


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str = "phi4-mini-3.8b", *, reduced: bool = False,
          batch: int = 4, prompt_len: int = 64, gen: int = 32,
          temperature: float = 0.8, seed: int = 0, device=None,
          cfg=None, params=None) -> dict:
    """Prefill a seeded random prompt batch, then decode `gen` tokens.

    Returns the generated tokens (B, gen), the prefill, first-decode and
    last-decode logits, whether every logit was finite, the decode
    graph's launches per step and warm-up steps, and host-clock times that
    end in a device synchronise: the prefill, the graph's warm-up and
    capture (`decode_setup_s`) and the decode per token.  `cfg` / `params`
    reuse an already built model (its device wins over `device`).
    """
    if cfg is None:
        cfg = get_config(arch)
        if reduced:
            cfg = cfg.reduced()
    if params is None:
        params = build_model(cfg, device).init(seed)
    dev = params["embed"].device
    max_len = prompt_len + gen
    rng = np.random.default_rng(seed)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
                        dtype=torch.long, device=dev)
    frames = None
    if cfg.family == "encdec":
        frames = torch.tensor(
            rng.normal(size=(batch, cfg.frontend_len, cfg.d_model)),
            dtype=torch.float32, device=dev)
    sampler = torch.Generator(device=dev)
    sampler.manual_seed(seed + 1)

    _sync(dev)
    t0 = time.perf_counter()
    if frames is not None:
        cache, logits = encdec_engine.prefill(params, cfg, frames, toks,
                                              max_len=max_len)
    else:
        cache, logits = engine.prefill(params, cfg, toks, max_len=max_len)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    prefill_logits = logits
    finite = torch.isfinite(logits).all()

    out_tokens = []
    first_decode_logits = last_decode_logits = None
    tok = torch.argmax(logits, -1)
    t0 = time.perf_counter()
    step = graphs.DecodeGraph(params, cfg, cache, batch)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(gen):
        out_tokens.append(tok)
        logits = step.step(tok, prompt_len + i)
        if first_decode_logits is None:
            first_decode_logits = logits.clone()
        finite = finite & torch.isfinite(logits).all()
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=sampler)[:, 0]
        else:
            tok = torch.argmax(logits, -1)
    if gen:
        last_decode_logits = logits.clone()
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return dict(
        cfg=cfg, tokens=torch.stack(out_tokens, 1).cpu(),
        prefill_logits=prefill_logits,
        first_decode_logits=first_decode_logits,
        last_decode_logits=last_decode_logits,
        logits_finite=bool(finite), prefill_s=prefill_s,
        decode_setup_s=setup_s, decode_warmup_steps=graphs.WARMUP_STEPS,
        decode_launches_per_step=step.launches_per_step,
        decode_s_per_token=decode_s / max(gen, 1),
        tok_per_s=batch * gen / decode_s if decode_s > 0 else float("inf"),
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    mmcfg.add_cli_args(ap)
    args = ap.parse_args(argv)

    with mmcfg.scope_from_args(args):
        res = serve(args.arch, reduced=args.reduced, batch=args.batch,
                    prompt_len=args.prompt_len, gen=args.gen,
                    temperature=args.temperature, seed=args.seed,
                    device=args.device)
    gen = res["tokens"]
    print(f"[serve] generated {tuple(gen.shape)} tokens: prefill "
          f"{res['prefill_s'] * 1e3:.1f} ms, decode "
          f"{res['decode_s_per_token'] * 1e3:.2f} ms/token "
          f"({res['tok_per_s']:.1f} tok/s), finite={res['logits_finite']}")
    print(gen[:, :16])
    return res


if __name__ == "__main__":
    main()
