"""The port's data pipeline, checkpoints, fault tolerance, trainer and
training launcher, on the CPU, against the JAX package where it has a
counterpart.

  * SyntheticLM / MemmapTokens batches and the DataLoader's first batches
    bitwise equal to JAX's, and its `start_step` resume;
  * JAX's CheckpointManager cases on the port, and checkpoints written by
    either package restored by the other, bitwise, fp32 and bf16 (a whole
    TrainState among them: JAX's path keys, a stage's per-layer list as
    one stacked leaf);
  * JAX's fault-tolerance cases, and test_guard.py's two training-step
    cases, on the port; a failed attempt leaves the state bitwise
    untouched and its retry equals a clean step;
  * JAX's three end-to-end trainer tests on the port (the resumed losses
    and state bitwise equal to an uninterrupted run's);
  * `launch.train.main` on the CPU, its refusal under ``--mm-backend
    cuda`` and its default device.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointManager as JCheckpointManager
from repro.checkpoint.ckpt import _flatten as jflatten
from repro.configs.base import get_config as jget_config
from repro.data import pipeline as jpipeline
from repro.models.model import build_model as jbuild_model
from repro.optim.adamw import AdamW as JAdamW
from repro.train.train_step import TrainStepConfig as JTrainStepConfig
from repro.train.train_step import init_train_state as jinit_train_state
from repro_torch.checkpoint.ckpt import CheckpointManager, flatten
from repro_torch.configs.base import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.config import mm_config
from repro_torch.data.pipeline import DataLoader, MemmapTokens, SyntheticLM
from repro_torch.distributed.fault_tolerance import (StepFailed, StepGuard,
                                                     plan_elastic_restart,
                                                     retry_step)
from repro_torch.guard import fallback, health
from repro_torch.launch import train as train_cli
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.train.train_step import (TrainStepConfig, init_train_state,
                                          make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig


@pytest.fixture(autouse=True)
def _clean_ledger():
    health.reset()
    fallback.reset_ladders()
    yield
    health.reset()
    fallback.reset_ladders()


def _quiet(_msg):
    pass


# ------------------------------------------------------------- pipeline
def test_synthetic_and_memmap_batches_equal_jax(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(2).integers(0, 5000, 20000).astype(
        np.int32).tofile(path)
    for ours, theirs in ((SyntheticLM(1000, seed=7),
                          jpipeline.SyntheticLM(1000, seed=7)),
                         (MemmapTokens(path, 5000),
                          jpipeline.MemmapTokens(path, 5000))):
        for step in (0, 1, 42, 977):
            a = ours.batch(step, 4, 16)
            assert a.dtype == np.int32 and a.shape == (4, 16)
            np.testing.assert_array_equal(a, theirs.batch(step, 4, 16))


def test_loader_first_batches_equal_jax_and_resume():
    src = SyntheticLM(512, seed=3)
    loader = DataLoader(src, 2, 8, device="cpu")
    jloader = jpipeline.DataLoader(jpipeline.SyntheticLM(512, seed=3), 2, 8)
    try:
        for _ in range(5):
            got, want = next(loader)["tokens"], next(jloader)["tokens"]
            assert got.dtype == torch.int32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert loader.step == 5
    finally:
        loader.close()
        jloader.close()
    resumed = DataLoader(src, 2, 8, device="cpu", start_step=3)
    try:
        for step in (3, 4):
            np.testing.assert_array_equal(next(resumed)["tokens"].numpy(),
                                          src.batch(step, 2, 8))
    finally:
        resumed.close()
    assert not resumed._thread.is_alive()


def test_deterministic_data_resume():
    """JAX's `test_deterministic_data_resume` on the port."""
    src = SyntheticLM(1000, seed=7)
    a = src.batch(step=42, batch_size=4, seq_len=16)
    np.testing.assert_array_equal(a, src.batch(step=42, batch_size=4,
                                               seq_len=16))
    assert not np.array_equal(a, src.batch(step=43, batch_size=4,
                                           seq_len=16))


def test_memmap_pipeline(tmp_path):
    """JAX's `test_memmap_pipeline` on the port."""
    path = str(tmp_path / "tokens.bin")
    np.arange(10000, dtype=np.int32).tofile(path)
    b0 = MemmapTokens(path, vocab_size=10000).batch(0, 2, 8)
    assert b0.shape == (2, 8)
    np.testing.assert_array_equal(b0[0], np.arange(8))


def test_loader_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DataLoader(SyntheticLM(10), 1, 4)


# ----------------------------------------------------------- checkpoint
def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(2, dtype=torch.bfloat16)}}


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    mgr.save(1, tree, blocking=True)
    out = mgr.restore({"a": torch.zeros(3, 4),
                       "b": {"c": torch.zeros(2, dtype=torch.bfloat16)}})
    assert out["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"]["c"], tree["b"]["c"])


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(), blocking=True)
    assert mgr.all_steps() == [3, 4]


def test_atomic_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(7, _tree(), blocking=True)
    assert all(not n.startswith(".tmp") for n in os.listdir(tmp_path))
    assert mgr.latest_step() == 7
    assert sorted(os.listdir(tmp_path / "step-000000007")) == [
        "meta.json", "state.npz"]


def test_restore_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=True)
    bad = {"a": torch.zeros(2, 2), "b": {"c": torch.zeros(2)}}
    with pytest.raises(ValueError, match="mismatch"):
        mgr.restore(bad)
    layers = {"stage0": [{"w": torch.zeros(3)} for _ in range(2)]}
    mgr.save(2, layers, blocking=True)
    with pytest.raises(ValueError, match="mismatch"):
        mgr.restore({"stage0": [{"w": torch.zeros(3)} for _ in range(3)]})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_restore_between_packages(tmp_path, dtype):
    """A tree with a stage's per-layer list (JAX: one stacked leaf), saved
    by one package and restored by the other, both ways, bitwise."""
    rng = np.random.default_rng(9)
    w = rng.normal(size=(3, 4, 5)).astype(np.float32)
    e = rng.normal(size=(7, 4)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    port = {"embed": torch.tensor(e).to(tdt),
            "stage0": [{"b0": {"w": torch.tensor(w[r]).to(tdt)}}
                       for r in range(3)],
            "step": torch.tensor(5, dtype=torch.int32)}
    jtree = {"embed": jnp.asarray(e, jdt), "stage0": {"b0": {
        "w": jnp.asarray(w, jdt)}}, "step": jnp.asarray(5, jnp.int32)}

    CheckpointManager(str(tmp_path / "p")).save(1, port, blocking=True)
    got = JCheckpointManager(str(tmp_path / "p")).restore(
        jax.tree.map(np.zeros_like, jtree))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))

    JCheckpointManager(str(tmp_path / "j")).save(1, jtree, blocking=True)
    back = CheckpointManager(str(tmp_path / "j")).restore(
        {"embed": torch.zeros(7, 4, dtype=tdt),
         "stage0": [{"b0": {"w": torch.zeros(4, 5, dtype=tdt)}}
                    for _ in range(3)],
         "step": torch.tensor(0, dtype=torch.int32)})
    assert back["embed"].dtype == tdt
    for k, v in flatten(back).items():
        np.testing.assert_array_equal(v, flatten(port)[k])


def test_train_state_checkpoint_crosses_packages(tmp_path):
    """JAX's TrainState (deepseek reduced: MLA, MoE, MTP, the residual) in
    a JAX checkpoint restores into the port's state equal to
    `state_from_numpy` of it, and the port's save restores in JAX."""
    jcfg = jget_config("deepseek-v3-671b").reduced()
    ts = JTrainStepConfig(compress_grads=True)
    jstate = jinit_train_state(jbuild_model(jcfg), JAdamW(),
                               jax.random.PRNGKey(4), ts)
    jnp_state = jax.tree.map(np.asarray, jstate)
    JCheckpointManager(str(tmp_path / "j")).save(3, jstate, blocking=True)
    like = init_train_state(build_model(get_config(
        "deepseek-v3-671b").reduced(), "cpu"), AdamW(), 0,
        TrainStepConfig(compress_grads=True))
    got = CheckpointManager(str(tmp_path / "j")).restore(like)
    want = flatten(state_from_numpy(jnp_state, "cpu"))
    for k, v in flatten(got).items():
        np.testing.assert_array_equal(v, want[k])
        assert v.dtype == want[k].dtype
    restacked = flatten(state_to_numpy(got))      # JAX's leaves again
    for k, v in jflatten(jnp_state).items():
        np.testing.assert_array_equal(restacked[k], v)

    CheckpointManager(str(tmp_path / "p")).save(3, got, blocking=True)
    back = JCheckpointManager(str(tmp_path / "p")).restore(
        jax.tree.map(np.zeros_like, jnp_state))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jnp_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------ fault tolerance
def test_retry_step_recovers():
    calls = {"n": 0}

    def flaky(state, batch):
        calls["n"] += 1
        if calls["n"] < 3:
            raise StepFailed("injected")
        return state + batch

    assert retry_step(flaky, 1, 2, max_retries=3) == 3 and calls["n"] == 3


def test_retry_step_exhausts():
    def always_fails(state, batch):
        raise StepFailed("boom")

    with pytest.raises(StepFailed):
        retry_step(always_fails, 0, 0, max_retries=1)


def test_straggler_guard_flags_slow_step():
    import time
    guard = StepGuard(deadline_factor=5.0, min_history=3)
    for _ in range(4):
        _, s = guard.run(lambda: time.sleep(0.01))
        assert not s
    _, straggled = guard.run(lambda: time.sleep(0.3))
    assert straggled


def test_elastic_plan():
    plan = plan_elastic_restart((16, 16), surviving_chips=192, model_axis=16)
    assert plan.new_mesh == (12, 16) and plan.reshard and plan.chips == 192
    plan = plan_elastic_restart((16, 16), surviving_chips=256, model_axis=16)
    assert plan.new_mesh == (16, 16) and not plan.reshard
    with pytest.raises(ValueError):
        plan_elastic_restart((16, 16), surviving_chips=8, model_axis=16)


def test_step_failed_is_a_guard_transient():
    assert issubclass(StepFailed, fallback.TransientFault)
    assert issubclass(StepFailed, fallback.GuardError)
    assert isinstance(StepGuard(), fallback.StragglerGuard)


def test_retry_step_counts_in_health_ledger():
    calls = []

    def step(state, batch):
        calls.append(1)
        if len(calls) < 2:
            raise StepFailed("flaky step", injected=True)
        return state + batch

    assert retry_step(step, 1, 2, max_retries=3) == 3
    assert health.get("retries") == 1
    assert health.get("faults_caught") == 1


def _phi4(device="cpu"):
    cfg = get_config("phi4-mini-3.8b").reduced()
    return cfg, build_model(cfg, device)


def test_failed_attempt_leaves_state_untouched_and_retry_equals_clean():
    """A step that fails after computing its update (a torn attempt) leaves
    the state bitwise as it was; the retry equals a clean step."""
    cfg, bundle = _phi4()
    ts = TrainStepConfig(loss_chunk=16, compress_grads=True)
    state = init_train_state(bundle, AdamW(), 1, ts)
    step = make_train_step(bundle, AdamW(), ts)
    batch = {"tokens": torch.tensor(SyntheticLM(cfg.vocab_size).batch(
        0, 2, 32))}
    before = flatten(state)
    attempts = []

    def flaky(s, b):
        out = step(s, b)
        attempts.append(out)
        if len(attempts) == 1:
            raise StepFailed("after the update", injected=True)
        return out

    with mm_config(backend="torch"):
        new, metrics = retry_step(flaky, state, batch)
        clean, clean_metrics = step(state, batch)
    for k, v in flatten(state).items():
        np.testing.assert_array_equal(v, before[k])
    want = flatten(clean)
    for k, v in flatten(new).items():
        np.testing.assert_array_equal(v, want[k])
    assert float(metrics["loss"]) == float(clean_metrics["loss"])
    assert health.get("retries") == 1


# -------------------------------------------------------------- trainer
def test_end_to_end_training_learns(tmp_path):
    """JAX's `test_end_to_end_training_learns` on the port: loader ->
    step -> checkpoint; the loss must drop."""
    cfg, bundle = _phi4()
    trainer = Trainer(bundle, AdamW(lr=2e-3), TrainStepConfig(loss_chunk=16),
                      TrainerConfig(total_steps=30, ckpt_every=15,
                                    log_every=5, ckpt_dir=str(tmp_path)),
                      log_fn=_quiet)
    loader = DataLoader(SyntheticLM(cfg.vocab_size, seed=1), 4, 64,
                        device="cpu")
    try:
        with mm_config(backend="torch"):
            out = trainer.run(loader)
    finally:
        loader.close()
    first, last = out["history"][0][1], out["history"][-1][1]
    assert last < first - 0.3, (first, last)
    assert trainer.ckpt.latest_step() == 30


def _dense_internvl():
    cfg = dataclasses.replace(get_config("internvl2-1b").reduced(),
                              frontend=None, family="dense")
    return cfg, build_model(cfg, "cpu")


def test_gradient_compression_training_converges(tmp_path):
    """JAX's `test_gradient_compression_training_converges` on the
    port."""
    cfg, bundle = _dense_internvl()
    losses = {}
    for compress in (False, True):
        trainer = Trainer(bundle, AdamW(lr=2e-3), TrainStepConfig(
            loss_chunk=16, compress_grads=compress),
            TrainerConfig(total_steps=20, ckpt_every=100, log_every=5,
                          ckpt_dir=str(tmp_path / str(compress))),
            log_fn=_quiet)
        loader = DataLoader(SyntheticLM(cfg.vocab_size, seed=3), 4, 32,
                            device="cpu")
        try:
            with mm_config(backend="torch"):
                losses[compress] = trainer.run(loader)["final_loss"]
        finally:
            loader.close()
    assert abs(losses[True] - losses[False]) < 0.25, losses


def _run(bundle, cfg, tc: TrainerConfig):
    trainer = Trainer(bundle, AdamW(lr=1e-3), TrainStepConfig(loss_chunk=16),
                      tc, log_fn=_quiet)
    loader = DataLoader(SyntheticLM(cfg.vocab_size), 2, 32, device="cpu",
                        start_step=trainer.ckpt.latest_step() or 0)
    try:
        with mm_config(backend="torch"):
            out = trainer.run(loader)
    finally:
        loader.close()
    return trainer, out


def test_trainer_resume_after_interrupt(tmp_path):
    """JAX's `test_trainer_resume_after_interrupt` on the port, and the
    resumed run bitwise equal to an uninterrupted one: losses of steps 4-6
    and the final state."""
    cfg, bundle = _dense_internvl()
    trainer, _ = _run(bundle, cfg, TrainerConfig(
        total_steps=6, ckpt_every=3, log_every=2, ckpt_dir=str(tmp_path)))
    assert trainer.ckpt.latest_step() == 6
    trainer2 = Trainer(bundle, AdamW(lr=1e-3), TrainStepConfig(loss_chunk=16),
                       TrainerConfig(total_steps=8, ckpt_every=4,
                                     ckpt_dir=str(tmp_path)), log_fn=_quiet)
    assert trainer2.maybe_restore() == 6
    assert int(trainer2.state.opt.step) == 6

    whole, out = _run(bundle, cfg, TrainerConfig(
        total_steps=6, ckpt_every=3, log_every=1,
        ckpt_dir=str(tmp_path / "whole")))
    _run(bundle, cfg, TrainerConfig(total_steps=3, ckpt_every=3, log_every=1,
                                    ckpt_dir=str(tmp_path / "cut")))
    resumed, out2 = _run(bundle, cfg, TrainerConfig(
        total_steps=6, ckpt_every=3, log_every=1,
        ckpt_dir=str(tmp_path / "cut")))
    assert [s for s, _ in out2["history"]] == [4, 5, 6]
    assert out2["history"] == out["history"][3:]
    want = flatten(whole.state)
    for k, v in flatten(resumed.state).items():
        np.testing.assert_array_equal(v, want[k])


# --------------------------------------------------------------- launch
def _argv(tmp_path, *extra):
    return ["--arch", "phi4-mini-3.8b", "--reduced", "--steps", "3",
            "--batch", "2", "--seq", "16", "--warmup", "1", "--ckpt-every",
            "2", "--ckpt-dir", str(tmp_path), *extra]


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    out = train_cli.main(_argv(tmp_path, "--device", "cpu"))
    assert np.isfinite(out["final_loss"])
    assert "[train] done: final_loss=" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 3]


def test_train_launcher_trains_over_the_host_mesh(tmp_path, monkeypatch):
    """No mesh flag: a one-row batch trained over `make_host_mesh(model=1)`,
    as the JAX launcher trains; a world of one places nothing (the state
    stays plain tensors) and the one-rank group the launcher formed is
    taken down after."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.core.tree import leaves
    made, trainers = [], []
    real_mesh = train_cli.make_host_mesh

    def host_mesh(**kw):
        made.append(kw)
        return real_mesh(**kw)

    class Seen(train_cli.Trainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            trainers.append(self)

    monkeypatch.setattr(train_cli, "make_host_mesh", host_mesh)
    monkeypatch.setattr(train_cli, "Trainer", Seen)
    assert not dist.is_initialized()
    out = train_cli.main(["--arch", "phi4-mini-3.8b", "--reduced",
                          "--device", "cpu", "--batch", "1", "--steps", "1",
                          "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert np.isfinite(out["final_loss"])
    assert made == [{"model": 1, "device": torch.device("cpu")}]
    (trainer,) = trainers
    assert tuple(trainer.mesh.shape) == (1, 1)
    assert trainer.state_specs is None
    assert not any(isinstance(x, DTensor) for x in leaves(trainer.state))
    assert not dist.is_initialized()


def test_train_launcher_refuses_the_cuda_backend(tmp_path):
    with pytest.raises(RuntimeError, match="K1-K9 are forward-only"):
        train_cli.main(_argv(tmp_path, "--device", "cpu", "--mm-backend",
                             "cuda"))
    assert health.snapshot() == {} and fallback.max_floor() == 0


def test_train_launcher_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(_argv(tmp_path))
