"""Training launcher CLI.

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
      --reduced --steps 200 --batch 8 --seq 128 [--device cpu]

Trains on the card unless ``--device`` says otherwise; ``--reduced``
trains the smoke-sized config.  Matmul planning is session-scoped:
--amp / --chip / --mm-backend / --plan-mode push one mm_config layer over
the whole run (`repro_torch.core.config`).  ``--mm-backend`` defaults to
"torch", the reference rung that autograd trains through (the JAX
launcher's "xla"); the kernels of "cuda" are forward-only and refuse a
training step.  A run that finds a checkpoint in ``--ckpt-dir`` resumes
from it, its data at the restored step.

The run is over `launch.mesh.make_host_mesh(model=N)` (``--model-parallel
N``, default 1; the world of the launcher's environment, one rank when
there is none), or over the 16 x 16 production mesh (256 ranks) with
``--production-mesh``, as the JAX launcher's.  On more than one rank the
state and batches are `DTensor`s placed by the sharding rules; on one rank
they stay plain tensors and the step is the one-device step
(`distributed.sharding.distributes`).  A process group the launcher forms
it destroys at the end.
"""

from __future__ import annotations

import argparse

import torch.distributed as dist

from repro_torch.configs.base import get_config
from repro_torch.core import config as mmcfg
from repro_torch.data.pipeline import DataLoader, MemmapTokens, SyntheticLM
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.train_step import TrainStepConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--data", default=None, help="memmap token file")
    ap.add_argument("--ckpt-dir", default="build/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="train over a (world / N, N) host mesh")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    mmcfg.add_cli_args(ap)
    ap.set_defaults(mm_backend="torch")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    bundle = build_model(cfg, args.device)
    own_group = not dist.is_initialized()
    try:
        mesh = (make_production_mesh(device=bundle.device)
                if args.production_mesh else
                make_host_mesh(model=args.model_parallel,
                               device=bundle.device))
        out = _train(args, cfg, bundle, mesh)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()
    print(f"[train] done: final_loss={out['final_loss']}")
    return out


def _train(args, cfg, bundle, mesh) -> dict:
    opt = AdamW(lr=warmup_cosine(args.lr, args.warmup, args.steps))
    ts_cfg = TrainStepConfig(n_microbatches=args.microbatches,
                             loss_chunk=min(512, args.seq),
                             compress_grads=args.compress_grads)
    trainer = Trainer(bundle, opt, ts_cfg,
                      TrainerConfig(total_steps=args.steps,
                                    ckpt_every=args.ckpt_every,
                                    ckpt_dir=args.ckpt_dir),
                      mesh=mesh)
    source = (MemmapTokens(args.data, cfg.vocab_size) if args.data
              else SyntheticLM(cfg.vocab_size))
    loader = DataLoader(source, args.batch, args.seq, device=bundle.device,
                        start_step=trainer.ckpt.latest_step() or 0,
                        mesh=mesh)
    try:
        with mmcfg.scope_from_args(args):
            return trainer.run(loader)
    finally:
        loader.close()


if __name__ == "__main__":
    main()
