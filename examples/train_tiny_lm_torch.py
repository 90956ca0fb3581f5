"""End-to-end training on the PyTorch/CUDA port: a ~100M-param LM for a
few hundred steps.

    PYTHONPATH=src python examples/train_tiny_lm_torch.py --steps 300
    PYTHONPATH=src python examples/train_tiny_lm_torch.py --steps 20 \
        --device cpu

The config is the JAX example's scaled gemma2-family model (12L x 768,
GQA kv=4, 32k vocab, 100.7M params, fp32), big enough to exercise every
substrate layer: the data pipeline, the chunked loss, microbatches, the
warmup-cosine schedule, a checkpoint every 100 steps and the resume from
the newest one (``--ckpt-dir``, default ``build/tiny-lm``; its data
restarts at the restored step).  Training runs on the "torch" rung (the
hand-written kernels are forward-only) over `make_host_mesh()`, as the
JAX example does; on a world of one rank the state and batches stay plain
tensors and a step is the one-device step, as XLA's program over a
one-device mesh is the one-device program.
Runs on the card unless ``--device cpu`` is given.  The last line is a
JSON summary (the logged losses, ms a step, tokens a second, the kernel
launches).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.core.config import mm_config
from repro_torch.data.pipeline import DataLoader, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import build_model, count_params_active
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.train_step import TrainStepConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def tiny_lm_config():
    base = get_config("gemma2-27b")
    return dataclasses.replace(
        base, name="tiny-lm-100m", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32768,
        local_window=256, dtype="float32")


def train(cfg, device=None, *, steps: int = 300, batch: int = 4,
          seq: int = 256, microbatches: int = 2, log_every: int = 10,
          ckpt_dir: str = "build/tiny-lm") -> dict:
    """Train `cfg` for `steps` steps (resuming from `ckpt_dir`) over the
    host mesh; returns the trainer's result plus the synchronised wall ms
    of each step run."""
    bundle = build_model(cfg, device)
    own_group = not dist.is_initialized()
    try:
        mesh = make_host_mesh(device=bundle.device)
        return _train(bundle, cfg, mesh, steps, batch, seq, microbatches,
                      log_every, ckpt_dir)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def _train(bundle, cfg, mesh, steps, batch, seq, microbatches, log_every,
           ckpt_dir) -> dict:
    trainer = Trainer(
        bundle, AdamW(lr=warmup_cosine(6e-4, 50, steps)),
        TrainStepConfig(n_microbatches=microbatches, loss_chunk=128),
        TrainerConfig(total_steps=steps, ckpt_every=100,
                      log_every=log_every, ckpt_dir=ckpt_dir), mesh=mesh)
    step_ms = []
    step_fn = trainer.step_fn

    def timed_step(state, batch_):
        t0 = time.perf_counter()
        out = step_fn(state, batch_)
        if bundle.device.type == "cuda":
            torch.cuda.synchronize(bundle.device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    trainer.step_fn = timed_step
    loader = DataLoader(SyntheticLM(cfg.vocab_size), batch, seq,
                        device=bundle.device, mesh=mesh,
                        start_step=trainer.ckpt.latest_step() or 0)
    try:
        with mm_config(backend="torch"):
            out = trainer.run(loader)
    finally:
        loader.close()
    return dict(out, step_ms=step_ms)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default="build/tiny-lm")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = tiny_lm_config()
    n_params = count_params_active(cfg)[0]
    print(f"[tiny-lm] {n_params / 1e6:.1f}M params")
    ops.reset_launch_counts()
    out = train(cfg, dev, steps=args.steps, batch=args.batch, seq=args.seq,
                microbatches=args.microbatches, ckpt_dir=args.ckpt_dir)
    # the first step run also pays for the allocator's warm-up
    ms = statistics.median(out["step_ms"][1:] or out["step_ms"] or [0.0])
    rate = args.batch * args.seq / ms * 1e3 if ms else 0.0
    final = ("none (nothing left to train)" if out["final_loss"] is None
             else f"{out['final_loss']:.3f}")
    print(f"[tiny-lm] done, final loss {final}, {ms:.1f} ms a step "
          f"({rate:.0f} tokens/s on {dev.type}; checkpoints in "
          f"{args.ckpt_dir})")
    print(json.dumps(dict(
        example="train_tiny_lm", params=n_params,
        history=out["history"],
        final_loss=out["final_loss"], step_ms=ms, tokens_per_s=rate,
        launches={k: v for k, v in ops.launch_counts().items() if v})))
    return out


if __name__ == "__main__":
    main()
