"""The port's four examples (`examples/*_torch.py`) against the JAX
package, on the CPU at small sizes, in this process:

  * the planner demo's modeled sections at ``--chip tpu_v5e`` equal, row
    for row, what the JAX package's `plan_matmul`, `sweep_aspect_ratios`,
    `paper_vertex_table` and AMP `plan_capture` give for that chip,
    formatted as the JAX demo formats them (exact: the planner is pure
    arithmetic; the vertex rows in the port's `VertexStats.row`, which
    prints vmem in KiB; the JAX demo's interpret-mode kernel section is
    not run);
  * `serve_decode_torch.run` on reduced gemma2-27b and mamba2-2.7b with the
    JAX example's ``PRNGKey(0)`` weights (drawn under `jax.jit`, within an
    ulp of the example's eager draw; `convert.params_from_numpy`):
    prefill logits within 1e-4 of the largest magnitude of JAX's
    `engine.prefill` and the greedy first token equal;
  * the quickstart's and the tiny LM's trainers, 3 steps from JAX's
    initial state (a step-0 checkpoint of JAX's `Trainer`, restored by the
    port's), losses within 1e-4 of JAX's `Trainer` on the same batches
    (fp32; the tiny LM at a narrow width; both over the host mesh, as
    the JAX examples train);
  * every example's `main` raises without a card unless given
    ``--device cpu``.
"""

import dataclasses
import importlib.util
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import get_config as jget_config
from repro.core import hw as jhw
from repro.core import skewmm as jskewmm
from repro.core.config import mm_config as jmm_config
from repro.core.planner import plan_matmul as jplan_matmul
from repro.core.planner import sweep_aspect_ratios as jsweep
from repro.core.vertexstats import paper_vertex_table as jvertex_table
from repro.data.pipeline import DataLoader as JDataLoader
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.models.model import build_model as jbuild_model
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.schedule import warmup_cosine as jwarmup_cosine
from repro.serve import engine as jengine
from repro.train.train_step import TrainStepConfig as JTrainStepConfig
from repro.train import trainer as jtrainer_mod
from repro.train.train_step import init_train_state as jinit_train_state
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.vertexstats import VertexStats

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "examples")
TOL = 1e-4


def _load(name: str):
    path = os.path.join(EXAMPLES, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ex():
    return {n: _load(n) for n in (
        "skewmm_planner_demo_torch", "quickstart_torch",
        "serve_decode_torch", "train_tiny_lm_torch")}


@pytest.fixture
def no_group():
    """The trainers form (and take down) their own one-rank group."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    assert not dist.is_initialized()


# ------------------------------------------------------------ the demo
RATIOS = [2.0 ** i for i in range(-8, 9, 2)]


def _jax_demo_rows() -> dict:
    """The JAX demo's modeled rows at its default chip (tpu_v5e), in its
    own formats."""
    chip = jhw.TPU_V5E
    fig4 = []
    for n in (1024, 2048, 3584, 4096, 8192):
        nv = jplan_matmul(n, n, n, mode='naive')
        pl = jplan_matmul(n, n, n)
        fig4.append(f"{n:>6} {nv.roofline_fraction(chip):>7.3f} "
                    f"{pl.roofline_fraction(chip):>8.3f}  "
                    f"({pl.plan.bm},{pl.plan.bk},{pl.plan.bn})")
    fig5 = [f"{r['ratio']:>10.4g} {r['naive_fraction']:>7.3f} "
            f"{r['planned_fraction']:>8.3f} {r['naive_grid']:>7} "
            f"{r['planned_grid']:>7}"
            for r in jsweep(4096 * 4096, RATIOS)]
    chips = []
    for name in ("ipu_gc200", "gpu_rtx2080ti", "tpu_v5e"):
        with jmm_config(chip=name):
            rows = jsweep(4096 * 4096, RATIOS)
        nv = [r["naive_fraction"] for r in rows]
        pl = [r["planned_fraction"] for r in rows]
        chips.append(f"{name:>14} {min(nv):>10.3f} "
                     f"{max(nv) - min(nv):>13.3f} "
                     f"{max(pl) - min(pl):>15.3f}")
    # the port's row prints vmem in KiB (an H100 CTA's shared memory):
    # JAX's stats, field for field, in the port's row
    vertex = [f"{label:>7}: {VertexStats(**dataclasses.asdict(row)).row()}"
              for label, row in zip(("left", "square", "right"),
                                    jvertex_table())]
    a = jax.ShapeDtypeStruct((512, 4096), jnp.bfloat16)
    b = jax.ShapeDtypeStruct((4096, 4096), jnp.bfloat16)
    amp = []
    for knob in (0.1, 0.45, 0.9):
        with jmm_config(amp=knob), jskewmm.plan_capture() as log:
            # a new function each time: eval_shape caches a trace by
            # function, and the plan is recorded while tracing
            jax.eval_shape(lambda x, y: jskewmm.matmul(x, y), a, b)
        c = log[0]
        amp.append(f"amp={knob:<4}: plan=({c.plan.bm},{c.plan.bk},"
                   f"{c.plan.bn}) vmem={c.vmem_bytes / 2**20:.1f}MiB "
                   f"frac={c.roofline_fraction(chip):.3f}")
    return {"fig4": fig4, "fig5": fig5, "chips": chips, "vertex": vertex,
            "amp": amp}


def test_demo_modeled_rows_equal_jax(ex, capsys):
    res = ex["skewmm_planner_demo_torch"].main(
        ["--chip", "tpu_v5e", "--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    want = _jax_demo_rows()
    assert set(res["rows"]) == set(want)
    for section, rows in want.items():
        assert res["rows"][section] == rows, section
        assert all(row in printed for row in rows), section
    # the kernel section ran the plain version here: no launch
    assert res["k1_err"] <= TOL and res["k1_epilogue_err"] <= TOL
    assert res["launches"] == {} and res["k1_us"] is None


# ---------------------------------------------------------- serving
@pytest.mark.parametrize("arch", ["gemma2-27b", "mamba2-2.7b"])
def test_serve_prefill_matches_jax(ex, arch):
    """The JAX example's weights (PRNGKey(0)) and prompts (numpy seed 0,
    batch 4 x 64); two decode steps keep the run short."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jp = jax.jit(jbuild_model(jcfg).init)(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batch, prompt, gen = 4, 64, 2
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                             (batch, prompt))
    _, jlogits = jengine.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                 max_len=prompt + gen)
    want = np.asarray(jlogits, np.float32)
    res = ex["serve_decode_torch"].run(cfg, params, batch=batch,
                                       prompt_len=prompt, gen=gen)
    got = res["prefill_logits"].numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    np.testing.assert_array_equal(res["tokens"][:, 0].numpy(),
                                  want.argmax(-1))
    assert res["logits_finite"] and res["tokens"].shape == (batch, gen + 1)


# --------------------------------------------------------- training
def _jax_losses(jcfg, opt, ts_cfg, steps, batch, seq, tmp_path,
                monkeypatch, copies=("port",)) -> list:
    """JAX's Trainer from its initial state, saved first as step 0 into
    each of `copies` (where the port's runs restore it); the logged
    losses.  The
    initial state is made under `jax.jit` (the same values, in a fraction
    of the eager time)."""
    def jitted(bundle, opt_, key, ts):
        return jax.jit(lambda k: jinit_train_state(bundle, opt_, k, ts))(key)

    monkeypatch.setattr(jtrainer_mod, "init_train_state", jitted)
    mesh = jmake_host_mesh()
    trainer = JTrainer(jbuild_model(jcfg), opt, mesh, ts_cfg,
                       JTrainerConfig(total_steps=steps, ckpt_every=100,
                                      log_every=1,
                                      ckpt_dir=str(tmp_path / "jax")),
                       log_fn=lambda _m: None)
    trainer.ckpt.save(0, trainer.state, blocking=True)
    for name in copies:
        shutil.copytree(tmp_path / "jax", tmp_path / name)
    loader = JDataLoader(JSyntheticLM(jcfg.vocab_size), batch, seq,
                         mesh=mesh)
    try:
        hist = trainer.run(loader)["history"]
    finally:
        loader.close()
    return [loss for _, loss in hist]


def test_quickstart_trainer_matches_jax(ex, tmp_path, no_group,
                                        monkeypatch):
    """The quickstart's settings: AdamW(1e-3), loss_chunk 16, 2 x 64."""
    jcfg = jget_config("gemma2-27b").reduced()
    want = _jax_losses(jcfg, JAdamW(lr=1e-3), JTrainStepConfig(
        loss_chunk=16), 3, 2, 64, tmp_path, monkeypatch)
    out = ex["quickstart_torch"].demo_train(
        "cpu", steps=3, log_every=1, ckpt_dir=str(tmp_path / "port"))
    assert [s for s, _ in out["history"]] == [1, 2, 3]
    np.testing.assert_allclose([loss for _, loss in out["history"]], want,
                               rtol=0, atol=TOL)


def _jax_tiny_lm_config():
    path = os.path.join(EXAMPLES, "train_tiny_lm.py")
    spec = importlib.util.spec_from_file_location("_jax_tiny_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.tiny_lm_config()


NARROW = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
              d_ff=128, vocab_size=512, local_window=16)


def test_tiny_lm_trainer_matches_jax(ex, tmp_path, no_group, monkeypatch):
    """The tiny LM's trainer (microbatches 2, warmup-cosine to 6e-4 over
    50 steps, loss_chunk 128) at a narrow width, 4 x 32 tokens, over the
    host mesh as the example's default path trains (a world of one here:
    the state stays plain tensors), and the one-rank group it formed
    taken down after."""
    mod = ex["train_tiny_lm_torch"]
    full, jfull = mod.tiny_lm_config(), _jax_tiny_lm_config()
    assert full.__dict__ == jfull.__dict__
    cfg = dataclasses.replace(full, **NARROW)
    jcfg = dataclasses.replace(jfull, **NARROW)
    steps, batch, seq = 3, 4, 32
    want = _jax_losses(jcfg, JAdamW(lr=jwarmup_cosine(6e-4, 50, steps)),
                       JTrainStepConfig(n_microbatches=2, loss_chunk=128),
                       steps, batch, seq, tmp_path, monkeypatch)
    out = mod.train(cfg, "cpu", steps=steps, batch=batch, seq=seq,
                    microbatches=2, log_every=1,
                    ckpt_dir=str(tmp_path / "port"))
    assert [s for s, _ in out["history"]] == [1, 2, 3]
    np.testing.assert_allclose([loss for _, loss in out["history"]],
                               want, rtol=0, atol=TOL)
    assert len(out["step_ms"]) == steps


# ---------------------------------------------------------- devices
@pytest.mark.parametrize("name,argv", [
    ("skewmm_planner_demo_torch", []),
    ("quickstart_torch", []),
    ("serve_decode_torch", ["--gen", "1"]),
    ("train_tiny_lm_torch", ["--steps", "1"]),
])
def test_examples_default_to_the_card(ex, monkeypatch, name, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ex[name].main(argv)
