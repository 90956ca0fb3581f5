"""Quickstart on the PyTorch/CUDA port: the skew-aware planner, then a
short end-to-end training run.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The planner section prices four shapes on the port's default chip
(gpu_h100).  Training is 20 steps of gemma2-27b's `reduced()` config
through `train.trainer.Trainer` over `launch.mesh.make_host_mesh()`, as
the JAX quickstart trains (on more than one rank the state is `DTensor`s
placed by the sharding rules; on one rank it stays plain tensors and a
step is the one-device step), on the "torch" rung: the hand-written
kernels are forward-only.  Checkpoints go to
``build/quickstart`` (``--ckpt-dir``); a run that finds one there resumes
from it.  Runs on the card unless ``--device cpu`` is given.  The last
line is a JSON summary (the logged losses, the kernel launches of the
run).
"""

from __future__ import annotations

import argparse
import json

import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.core import hw
from repro_torch.core.config import mm_config
from repro_torch.core.planner import plan_matmul
from repro_torch.data.pipeline import DataLoader, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.train.train_step import TrainStepConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

SHAPES = {
    "square   ": (4096, 4096, 4096),
    "vocab-proj (right-skew)": (8192, 4608, 256000),
    "decode GEMV": (8, 8192, 8192),
    "expert GEMM (deepseek)": (4096, 7168, 2048),
}


def demo_planner() -> None:
    print("=== the paper's mechanism: plans adapt to skew ===")
    for name, (m, k, n) in SHAPES.items():
        c = plan_matmul(m, k, n)
        print(f"{name:<26} {c.explain()}")
        print(f"{'':<26} h100 roofline fraction: "
              f"{c.roofline_fraction(hw.get_chip('gpu_h100')):.3f}")


def demo_train(device=None, *, steps: int = 20, log_every: int = 5,
               ckpt_dir: str = "build/quickstart") -> dict:
    """`steps` training steps of reduced gemma2 on a host mesh; returns the
    trainer's result (the logged (step, loss) history, the final loss)."""
    print(f"\n=== {steps} training steps of a reduced gemma2 on this host ===")
    cfg = get_config("gemma2-27b").reduced()
    bundle = build_model(cfg, device)
    own_group = not dist.is_initialized()
    mesh = make_host_mesh(device=bundle.device)
    try:
        trainer = Trainer(bundle, AdamW(lr=1e-3), TrainStepConfig(
            loss_chunk=16), TrainerConfig(total_steps=steps, ckpt_every=10,
                                          log_every=log_every,
                                          ckpt_dir=ckpt_dir), mesh=mesh)
        loader = DataLoader(SyntheticLM(cfg.vocab_size), 2, 64, mesh=mesh,
                            start_step=trainer.ckpt.latest_step() or 0)
        try:
            with mm_config(backend="torch"):
                out = trainer.run(loader)
        finally:
            loader.close()
    finally:
        if own_group:
            dist.destroy_process_group()
    if out["final_loss"] is None:
        print(f"nothing to train: {ckpt_dir} already holds step {steps}")
    else:
        print(f"final loss: {out['final_loss']:.3f}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default="build/quickstart")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ops.reset_launch_counts()
    demo_planner()
    out = demo_train(dev, ckpt_dir=args.ckpt_dir)
    print(json.dumps(dict(
        example="quickstart", history=out["history"],
        final_loss=out["final_loss"],
        launches={k: v for k, v in ops.launch_counts().items() if v})))
    return out


if __name__ == "__main__":
    main()
