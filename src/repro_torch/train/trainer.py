"""Trainer: composes the step function, data, checkpointing and fault
tolerance, on the bundle's device.  Placing the state over a device mesh
waits for the distributed slice."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.distributed.fault_tolerance import StepGuard, retry_step
from repro_torch.models.model import ModelBundle
from repro_torch.optim.adamw import AdamW
from repro_torch.train.train_step import (TrainStepConfig, init_train_state,
                                          make_train_step)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "build/ckpt"
    ckpt_keep: int = 3
    log_every: int = 10
    seed: int = 0


class Trainer:
    def __init__(self, bundle: ModelBundle, opt: AdamW,
                 ts_cfg: TrainStepConfig = TrainStepConfig(),
                 cfg: TrainerConfig = TrainerConfig(),
                 log_fn: Callable[[str], None] = print):
        self.bundle, self.opt = bundle, opt
        self.ts_cfg, self.cfg, self.log = ts_cfg, cfg, log_fn
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.ckpt_keep)
        self.guard = StepGuard()
        self.state = init_train_state(bundle, opt, cfg.seed, ts_cfg)
        self.step_fn = make_train_step(bundle, opt, ts_cfg)

    # ------------------------------------------------------------ resume
    def maybe_restore(self) -> int:
        step = self.ckpt.latest_step()
        if step is None:
            return 0
        self.state = self.ckpt.restore(self.state, step=step)
        self.log(f"[trainer] restored step {step} from {self.cfg.ckpt_dir}")
        return step

    # --------------------------------------------------------------- run
    def run(self, loader) -> dict:
        start = self.maybe_restore()
        metrics_hist = []
        t0 = time.time()
        for step in range(start, self.cfg.total_steps):
            batch = next(loader)

            def one_step():
                return retry_step(self.step_fn, self.state, batch)

            (self.state, metrics), straggled = self.guard.run(one_step)
            if straggled:
                self.log(f"[trainer] step {step}: straggler detected "
                         "(would re-form mesh on real fleet)")
            if (step + 1) % self.cfg.log_every == 0 or step == start:
                loss = float(metrics["loss"])
                rate = (step + 1 - start) / (time.time() - t0)
                self.log(f"[trainer] step {step + 1} "
                         f"loss={loss:.4f} steps/s={rate:.2f}")
                metrics_hist.append((step + 1, loss))
            if (step + 1) % self.cfg.ckpt_every == 0:
                self.ckpt.save(int(step + 1), self.state)
        self.ckpt.save(self.cfg.total_steps, self.state, blocking=True)
        return {"history": metrics_hist,
                "final_loss": metrics_hist[-1][1] if metrics_hist else None}
