"""Trainer: composes the step function, data, checkpointing and fault
tolerance, on the bundle's device, or over a `DeviceMesh`.

With ``mesh=``, the state is placed as `DTensor`s by the sharding rules:
params by `tree_param_specs`, the AdamW moments ZeRO-1 over "data"
(`tree_optstate_specs`), the error-feedback residual like the params.  The
step runs on those global views (plain tensors made inside it read as
replicated) with the mesh as the annotation mesh, each gradient reduces to
its param's placements, and the new state is put back on its specs: the
counterpart of the JAX package's ``jit(out_shardings=)``."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.fault_tolerance import StepGuard, retry_step
from repro_torch.models.model import ModelBundle
from repro_torch.optim.adamw import AdamW
from repro_torch.train.train_step import (TrainState, TrainStepConfig,
                                          init_train_state, make_train_step)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "build/ckpt"
    ckpt_keep: int = 3
    log_every: int = 10
    seed: int = 0


def state_specs(state: TrainState, mesh) -> TrainState:
    """The spec tree of a TrainState on `mesh` (None: left as it is)."""
    p_specs = shd.tree_param_specs(state.params, mesh)
    mu_specs = shd.tree_optstate_specs(p_specs, state.opt.mu, mesh)
    opt_specs = type(state.opt)(step=None, mu=mu_specs, nu=mu_specs)
    ef_specs = (None if state.ef is None else
                type(state.ef)(residual=p_specs))
    return TrainState(params=p_specs, opt=opt_specs, ef=ef_specs, rng=None)


def mesh_step(step_fn, specs: TrainState, mesh):
    """`step_fn` on the global-view state: run under implicit replication
    and the annotation mesh, the new state redistributed to `specs` and
    the metrics made whole."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    def redistribute(x, spec):
        return x if spec is None else \
            x.redistribute(mesh, shd.to_placements(spec, mesh))

    def step(state, batch):
        prev = shd.annotation_mesh()
        shd.set_annotation_mesh(mesh)
        try:
            with implicit_replication():
                new_state, metrics = step_fn(state, batch)
        finally:
            shd.set_annotation_mesh(prev)
        new_state = shd.map_specs(redistribute, new_state, specs)
        metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                   for k, v in metrics.items()}
        return new_state, metrics

    return step


class Trainer:
    def __init__(self, bundle: ModelBundle, opt: AdamW,
                 ts_cfg: TrainStepConfig = TrainStepConfig(),
                 cfg: TrainerConfig = TrainerConfig(),
                 log_fn: Callable[[str], None] = print, *, mesh=None):
        self.bundle, self.opt, self.mesh = bundle, opt, mesh
        self.ts_cfg, self.cfg, self.log = ts_cfg, cfg, log_fn
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.ckpt_keep)
        self.guard = StepGuard()
        state = init_train_state(bundle, opt, cfg.seed, ts_cfg)
        self.step_fn = make_train_step(bundle, opt, ts_cfg)
        self.state_specs = None
        if mesh is not None:
            self.state_specs = state_specs(state, mesh)
            state = shd.shard_like(state, self.state_specs, mesh)
            self.step_fn = mesh_step(self.step_fn, self.state_specs, mesh)
        self.state = state

    # ------------------------------------------------------------ resume
    def maybe_restore(self) -> int:
        step = self.ckpt.latest_step()
        if step is None:
            return 0
        self.state = self.ckpt.restore(self.state, step=step,
                                       specs=self.state_specs,
                                       mesh=self.mesh)
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
