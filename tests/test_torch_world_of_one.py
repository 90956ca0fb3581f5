"""A world of one rank places nothing: `Trainer` and `DataLoader` given
`make_host_mesh()` on the CPU (a one-rank gloo group on an in-process
store) keep the state and the batches plain tensors, and a run is the
meshless run bit for bit, as XLA's program over a one-device mesh is the
one-device program.  A dense arch (phi4-mini `reduced()`) and an MoE arch
(dbrx-132b `reduced()`, whose MoE layers then take the plain path: no
`moe_mlp_shardmap` call), and a restore from a checkpoint onto the
one-rank mesh.  `sharding.distributes` is the one predicate.
"""

import shutil

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint.ckpt import flatten
from repro_torch.configs.base import get_config
from repro_torch.core.config import mm_config
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import DataLoader, SyntheticLM
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.train.train_step import TrainStepConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

STEPS, BATCH, SEQ = 3, 2, 32


@pytest.fixture
def mesh():
    """The host mesh of a one-rank gloo world, taken down after."""
    own_group = not dist.is_initialized()
    m = make_host_mesh(device="cpu")
    yield m
    if own_group:
        dist.destroy_process_group()


def _train(cfg, ckpt_dir, mesh, steps=STEPS):
    """(trainer, logged losses, the batches it was given) of `steps`
    steps from the trainer's seeded init, resuming from `ckpt_dir`."""
    trainer = Trainer(build_model(cfg, "cpu"), AdamW(lr=1e-3),
                      TrainStepConfig(loss_chunk=16),
                      TrainerConfig(total_steps=steps, ckpt_every=2,
                                    log_every=1, ckpt_dir=str(ckpt_dir)),
                      log_fn=lambda _m: None, mesh=mesh)
    loader = DataLoader(SyntheticLM(cfg.vocab_size), BATCH, SEQ,
                        device="cpu", mesh=mesh,
                        start_step=trainer.ckpt.latest_step() or 0)
    batches = []
    step_fn = trainer.step_fn

    def seen(state, batch):
        batches.append(batch["tokens"])
        return step_fn(state, batch)

    trainer.step_fn = seen
    try:
        with mm_config(backend="torch"):
            hist = trainer.run(loader)["history"]
    finally:
        loader.close()
    return trainer, [loss for _, loss in hist], batches


def _assert_plain_and_equal(got: Trainer, want: Trainer):
    assert got.state_specs is None
    assert not any(isinstance(x, DTensor) for x in leaves(got.state))
    a, b = flatten(got.state), flatten(want.state)
    assert set(a) == set(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and (a[k] == b[k]).all(), k


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "dbrx-132b"])
def test_world_of_one_trains_as_the_meshless_trainer(mesh, tmp_path, arch):
    assert tuple(mesh.shape) == (1, 1) and not shd.distributes(mesh)
    cfg = get_config(arch).reduced()
    plain, plain_l, _ = _train(cfg, tmp_path / "meshless", None)
    moe.reset_ep_counts()
    one, one_l, batches = _train(cfg, tmp_path / "mesh", mesh)
    assert moe.ep_counts()["shardmap_calls"] == 0
    assert one.mesh is mesh
    assert len(one_l) == STEPS and one_l == plain_l
    assert len(batches) == STEPS
    assert all(type(t) is torch.Tensor and t.shape == (BATCH, SEQ)
               for t in batches)
    _assert_plain_and_equal(one, plain)


def test_world_of_one_restores_plain(mesh, tmp_path):
    """Step 2 of a meshless run, restored by a trainer on the one-rank
    mesh: plain tensors, and step 3 bit for bit the meshless resume's."""
    cfg = get_config("phi4-mini-3.8b").reduced()
    _train(cfg, tmp_path / "first", None, steps=2)
    for name in ("meshless", "mesh"):
        shutil.copytree(tmp_path / "first", tmp_path / name)
    plain, plain_l, _ = _train(cfg, tmp_path / "meshless", None)
    one, one_l, batches = _train(cfg, tmp_path / "mesh", mesh)
    assert len(one_l) == 1 and one_l == plain_l
    assert len(batches) == 1 and type(batches[0]) is torch.Tensor
    _assert_plain_and_equal(one, plain)
