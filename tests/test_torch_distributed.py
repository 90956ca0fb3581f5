"""The port's collectives and mesh paths in gloo worlds on the CPU, held
against the JAX package (8 forced host devices in a subprocess, as
tests/test_int8_ring.py runs it) and against the port's own meshless
paths.

Each world is a subprocess that spawns its ranks (`python
tests/test_torch_distributed.py <world> <model> <dir> <case>...`; no JAX
in it), rendezvouses on a FileStore in the test's temp directory and
forms its ("data", "model") mesh with `launch.mesh.make_host_mesh`.  Rank
0 writes what the tests read.  The worlds run once, in a module fixture:

  * (1, 2): the int8 ring at n = 2, expert-parallel MoE (forward and
    gradients), the loader, a checkpoint saved from this mesh, a JAX
    checkpoint restored sharded, and the trainer (also at one-row
    batches: batch 1, and batch 2 in two microbatches of one row);
  * (2, 1): the loader, the (1, 2) checkpoint restored, and the trainer
    (also with two microbatches and int8 error feedback, and at one-row
    batches);
  * (1, 1): MoE, the (1, 2) checkpoint restored, and the trainer at
    one-row batches (a world of one: the state stays plain tensors);
  * (1, 4): MoE, the ring over a subgroup of 3 ranks (1000 elements
    padded to 1002), the row-split products and attention with one kv
    head; (2, 2): MoE, the loader, the row-split products and attention
    with one kv head;
  * 8 ranks: the int8 ring.

Tolerances: the ring is the numpy emulation of JAX's source bit for bit,
and JAX's result at n = 2, 3 (at 8 XLA's CPU rewrites move a few scales
by an ulp: named and bounded); MoE 1e-5 of JAX's (fp32, no-drop
capacity; test_moe.py allows 2e-3) and bitwise to the port's meshless
path on (1, 1), its gradients 1e-4 of the meshless path's; the trainer's
losses 1e-5 of the meshless port run's and of JAX's `Trainer` on
`make_host_mesh()`, from JAX's initial state (at batch 4, and at batch 1
for the one-row runs; on a world of one bitwise the meshless run's).

In this process: a one-rank gloo mesh, a one-row batch placed by
`batch_spec` and reduced phi4's forward on `DTensor`s placed by
`sharding.place`, against the plain forward.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
SRC = os.path.join(ROOT, "src")

RING_NS = (2, 3, 8)
MOE_MESHES = ((1, 1), (1, 2), (1, 4), (2, 2))
MOE_ARCHS = ("dbrx-132b", "deepseek-v3-671b")
TRAIN_STEPS = 3


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    env.pop("XLA_FLAGS", None)
    return env


def _moe_cfg(arch):
    """test_moe.py's no-drop config: 8 experts, top-2, capacity 8x."""
    import dataclasses

    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(arch).reduced(), n_experts=8,
                               n_experts_per_tok=2, capacity_factor=8.0)


def _moe_input():
    return (np.random.default_rng(23).normal(size=(4, 16, 128)) * 0.3
            ).astype(np.float32)


def _ring_input():
    return (np.random.default_rng(0).normal(size=(8, 1000)) * 1e-3
            ).astype(np.float32)


# ------------------------------------------------------ the JAX reference
_JAX_SCRIPT = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs.base import get_config
from repro.distributed import sharding as shd
from repro.models import moe
from repro.optim.compression import int8_ring_allreduce
shard_map = jax.shard_map
out = {}
devs = jax.devices()
x = jnp.asarray(np.random.default_rng(0).normal(size=(8, 1000)) * 1e-3,
                jnp.float32)
for n in %(ring)s:
    mesh = Mesh(np.array(devs[:n]), ("pod",))
    body = lambda xl: int8_ring_allreduce(xl[0], "pod")[None]
    got = jax.jit(shard_map(body, mesh=mesh, in_specs=P("pod", None),
                            out_specs=P("pod", None)))(x[:n])
    out[f"ring{n}"] = np.asarray(got)
xm = jnp.asarray((np.random.default_rng(23).normal(size=(4, 16, 128)) * 0.3
                  ).astype(np.float32))
params = np.load(sys.argv[2])
for arch in %(archs)s:
    cfg = dataclasses.replace(get_config(arch).reduced(), n_experts=8,
                              n_experts_per_tok=2, capacity_factor=8.0)
    p = {}
    for k in params.files:
        if k.startswith(arch + "/"):
            *outer, leaf = k[len(arch) + 1:].split("/")
            d = p
            for o in outer:
                d = d.setdefault(o, {})
            d[leaf] = jnp.asarray(params[k])
    for d, m in ((0, 0),) + %(meshes)s:
        mesh = None if d == 0 else Mesh(
            np.array(devs[:d * m]).reshape(d, m), ("data", "model"))
        shd.set_annotation_mesh(mesh)
        try:
            y, aux = jax.jit(lambda xx, pp: moe.moe_mlp(xx, pp, cfg))(xm, p)
        finally:
            shd.set_annotation_mesh(None)
        wid = "meshless" if d == 0 else f"{d}x{m}"
        out[f"{arch}/{wid}/y"] = np.asarray(y)
        out[f"{arch}/{wid}/aux"] = np.asarray(aux)
np.savez(sys.argv[1], **out)
print("JAX_REF_OK")
"""


def _moe_params(path):
    """JAX's init_moe of each MoE config, as {arch/key path: array}."""
    import jax

    from repro.configs.base import get_config as jget_config
    from repro.models import moe as jmoe
    out = {}
    for arch in MOE_ARCHS:
        import dataclasses
        cfg = dataclasses.replace(jget_config(arch).reduced(), n_experts=8,
                                  n_experts_per_tok=2, capacity_factor=8.0)
        p = jmoe.init_moe(jax.random.PRNGKey(0), cfg)
        for k, v in jax.tree_util.tree_flatten_with_path(p)[0]:
            out[arch + "/" + "/".join(str(getattr(e, "key", e))
                                      for e in k)] = np.asarray(v)
    np.savez(path, **out)


def _start_jax_reference(tmp):
    script = _JAX_SCRIPT % {"ring": RING_NS, "archs": MOE_ARCHS,
                            "meshes": MOE_MESHES}
    return subprocess.Popen(
        [sys.executable, "-c", script, str(tmp / "ref.npz"),
         str(tmp / "params.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env(), cwd=ROOT)


def _jax_training(tmp, batch: int = 4, name: str = "jax") -> list:
    """JAX's Trainer on make_host_mesh() (one device in this process):
    its initial state saved as step 0 (the port's runs start from the
    copy in "jax0"), then TRAIN_STEPS steps of `batch` x 32; returns the
    losses."""
    import jax  # noqa: F401

    from repro.configs.base import get_config as jget_config
    from repro.data.pipeline import DataLoader as JDataLoader
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro.launch.mesh import make_host_mesh as jmake_host_mesh
    from repro.models.model import build_model as jbuild_model
    from repro.optim.adamw import AdamW as JAdamW
    from repro.train.train_step import TrainStepConfig as JTrainStepConfig
    from repro.train.trainer import Trainer as JTrainer
    from repro.train.trainer import TrainerConfig as JTrainerConfig
    cfg = jget_config("phi4-mini-3.8b").reduced()
    mesh = jmake_host_mesh()
    trainer = JTrainer(jbuild_model(cfg), JAdamW(lr=1e-3), mesh,
                       JTrainStepConfig(loss_chunk=16),
                       JTrainerConfig(total_steps=TRAIN_STEPS,
                                      ckpt_every=100, log_every=1,
                                      ckpt_dir=str(tmp / name)),
                       log_fn=lambda _m: None)
    trainer.ckpt.save(0, trainer.state, blocking=True)
    if not (tmp / "jax0").exists():
        shutil.copytree(tmp / name, tmp / "jax0")
    loader = JDataLoader(JSyntheticLM(cfg.vocab_size), batch, 32, mesh=mesh)
    try:
        hist = trainer.run(loader)["history"]
    finally:
        loader.close()
    return [loss for _, loss in hist]


# ------------------------------------------------------------ the worlds
WORLDS = [  # (data, model, cases); the (1, 2) world saves the checkpoint
    (1, 2, ("ring", "moe", "loader", "save", "restore_jax", "train",
            "train_1row")),
    (2, 1, ("loader", "restore", "train", "train_mb", "train_1row")),
    (1, 1, ("moe", "restore", "train_1row")),
    (1, 4, ("moe", "ring3", "rowsplit", "mqa")),
    (2, 2, ("moe", "loader", "rowsplit", "mqa")),
    (8, 1, ("ring",)),
]
RING_WORLD = {2: "1x2", 3: "1x4", 8: "8x1"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every world once, beside the JAX reference subprocess: {world id:
    rank 0's results}, the reference and JAX's training losses."""
    tmp = tmp_path_factory.mktemp("dist")
    _moe_params(tmp / "params.npz")
    jax_ref = _start_jax_reference(tmp)
    try:
        jax_losses = _jax_training(tmp)
        jax_losses_1row = _jax_training(tmp, batch=1, name="jax_1row")
        results = {}
        for d, m, cases in WORLDS:
            wid = f"{d}x{m}"
            wdir = tmp / wid
            wdir.mkdir()
            out = subprocess.run(
                [sys.executable, HERE, str(d * m), str(m), str(wdir),
                 str(tmp), *cases], capture_output=True, text=True,
                env=_env(), cwd=ROOT, timeout=600)
            assert out.returncode == 0, (wid, out.stdout[-2000:],
                                         out.stderr[-4000:])
            with open(wdir / "result.json") as f:
                res = json.load(f)
            with np.load(wdir / "arrays.npz") as data:
                res["arrays"] = dict(data)
            results[wid] = res
        stdout, stderr = jax_ref.communicate(timeout=600)
    finally:
        if jax_ref.poll() is None:
            jax_ref.kill()
            jax_ref.wait()
    assert "JAX_REF_OK" in stdout, stderr[-3000:]
    with np.load(tmp / "ref.npz") as data:
        ref = dict(data)
    return {"ref": ref, "jax_losses": jax_losses,
            "jax_losses_1row": jax_losses_1row, "worlds": results}


# ----------------------------------------------------------------- ring
def _ring_emulated(n: int, xla: bool) -> np.ndarray:
    """The ring on `_ring_input()[:n]` in numpy, rank by rank (every rank
    ends with the same result).  xla=True applies the two rewrites XLA
    makes on the CPU: the dequantize-add contracted into one fused
    multiply-add, and the division by 127 turned into a multiplication by
    the fp32 reciprocal."""
    x = _ring_input()[:n]
    f32 = np.float32

    def quant(g):
        amax = np.maximum(np.abs(g).max(), f32(1e-12)).astype(f32)
        scale = amax * f32(1 / 127) if xla else amax / f32(127)
        q = np.clip(np.round(g / scale), -127, 127).astype(np.int8)
        return q, f32(scale)

    def deq_add(q, s, local):
        if xla:     # one rounding: the product is exact in fp64
            return (q.astype(np.float64) * np.float64(s)
                    + local.astype(np.float64)).astype(f32)
        return q.astype(f32) * s + local

    pad = (-x.shape[1]) % n
    chunks = np.pad(x, ((0, 0), (0, pad))).reshape(n, n, -1)
    carry = [quant(np.zeros(chunks.shape[2], f32))] * n
    for c in range(n - 1):
        sent = [quant(deq_add(*carry[r], chunks[r, (r - c - 1) % n]))
                for r in range(n)]
        carry = [sent[(r - 1) % n] for r in range(n)]
    owned = [quant(deq_add(*carry[r], chunks[r, r])) for r in range(n)]
    whole = np.concatenate([q.astype(f32) * s for q, s in owned])
    return np.broadcast_to(whole[:x.shape[1]], x.shape)


@pytest.mark.parametrize("n", RING_NS)
def test_int8_ring_equals_jax_and_ships_int8(run, n):
    """Every rank's sum equal; equal to the numpy emulation of the JAX
    source; JAX's own result is that emulation with XLA's two CPU
    rewrites.  At n = 2 and 3 they change no bit and the port equals JAX
    bit for bit; at n = 8 a few chunks' scales differ by an ulp, well
    inside JAX's bound amax * 8 / 127."""
    res = run["worlds"][RING_WORLD[n]]
    got = res["arrays"][f"ring{n}_all"]          # (n, 1000): every rank's
    for r in range(n):
        np.testing.assert_array_equal(got[r], got[0])
    want = run["ref"][f"ring{n}"]
    np.testing.assert_array_equal(got, _ring_emulated(n, xla=False))
    np.testing.assert_array_equal(want, _ring_emulated(n, xla=True))
    if n < 8:
        np.testing.assert_array_equal(got, want)
    else:
        assert not np.array_equal(got, want)
    exact = _ring_input()[:n].sum(0)
    bound = np.abs(exact).max() * 8 / 127
    assert np.abs(got[0] - exact).max() < bound
    assert np.abs(got - want).max() < bound / 1000
    # only int8 codes and one fp32 scale per hop crossed the wire
    pad = 1000 + (-1000) % n
    hops = 2 * (n - 1)
    assert res[f"ring{n}_wire"] == \
        [["torch.int8", pad // n], ["torch.float32", 4]] * hops


# ------------------------------------------------------------------ moe
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("mesh", MOE_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_moe_shardmap_equals_jax(run, arch, mesh):
    wid = f"{mesh[0]}x{mesh[1]}"
    arrays = run["worlds"][wid]["arrays"]
    y, aux = arrays[f"{arch}/y"], arrays[f"{arch}/aux"]
    np.testing.assert_allclose(y, run["ref"][f"{arch}/{wid}/y"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux, run["ref"][f"{arch}/{wid}/aux"],
                               rtol=1e-5)
    # the meshless port on the whole batch, and JAX's fallback
    np.testing.assert_allclose(y, arrays[f"{arch}/meshless_y"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(arrays[f"{arch}/meshless_y"],
                               run["ref"][f"{arch}/meshless/y"], rtol=1e-5,
                               atol=1e-5)
    if mesh == (1, 1):          # one rank: the same math, bit for bit
        np.testing.assert_array_equal(y, arrays[f"{arch}/meshless_y"])
    # plain tensors (read as replicated) give the DTensor path's result
    np.testing.assert_array_equal(arrays[f"{arch}/plain_y"], y)
    counts = run["worlds"][wid][f"{arch}/ep_counts"]
    assert counts == {"shardmap_calls": 2, "all_reduce": 4}, counts


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("mesh", MOE_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_moe_shardmap_gradients_equal_meshless(run, arch, mesh):
    """The expert-parallel path's gradients (tokens, router, experts, the
    shared expert) within 1e-4 of each one's largest magnitude of the
    meshless path's (fp32 sums over up to four ranks in another order; the
    router's terms cancel, ~1.2e-5 at (2, 2)): a weight's gradient sums
    over the data ranks, the router's and the tokens' over the model ranks
    too, aux's counts once.  A gradient counted once per model rank would
    be off by 1 (model 2) or 3 (model 4)."""
    err = run["worlds"][f"{mesh[0]}x{mesh[1]}"]["arrays"][f"{arch}/grad_err"]
    assert err.max() < 1e-4, err


# ----------------------------------------------------- row-split products
@pytest.mark.parametrize("wid", ["1x4", "2x2"])
def test_row_split_gradients_equal_meshless(run, wid):
    """`wo` and `w_down` (the MLP's down projection with its residual) of
    phi4-mini `reduced()` on the rules' placements in a gloo world of 4:
    the outputs and the gradients of the inputs, the weights and the
    residual within 1e-5 of each one's largest magnitude of the meshless
    products' (fp32; the four ranks' partial sums add in another order),
    and each of the two products taken on the ranks' blocks
    (`sharding.on_local_blocks` with a pending-sum output)."""
    got = run["worlds"][wid]
    err = got["arrays"]["rowsplit/err"]
    assert err.max() < 1e-5, err
    assert got["rowsplit_local_calls"] == 2


@pytest.mark.parametrize("wid", ["1x4", "2x2"])
def test_one_kv_head_attention_splits_q_heads(run, wid):
    """`attention.per_head` with one kv head (recurrentgemma's MQA) and
    four q heads in a gloo world of 4: q's heads stay split over "model"
    and each rank attends with the kv head its q heads share, as XLA
    splits the grouped product (the kv head is not split, so heads were
    once run whole on every "model" rank).  The output and the q, k, v
    gradients within 1e-5 of each one's largest magnitude of the meshless
    attention's (fp32; k's and v's gradients sum over the "model" ranks
    in another order)."""
    got = run["worlds"][wid]
    err = got["arrays"]["mqa/err"]
    assert err.max() < 1e-5, err
    assert got["mqa_q_heads_local"] == 4 // int(wid.split("x")[1])


# --------------------------------------------------------------- loader
@pytest.mark.parametrize("wid", ["1x2", "2x1", "2x2"])
def test_loader_local_batches_are_global_slices(run, wid):
    assert run["worlds"][wid]["loader"] == "ok"


# --------------------------------------------------------------- restore
@pytest.mark.parametrize("wid", ["2x1", "1x1"])
def test_elastic_restore_onto_another_mesh(run, wid):
    """A state saved from the (1, 2) mesh restores onto `wid` placed by
    its specs, bytes equal."""
    assert run["worlds"][wid]["restore"] == "ok"


def test_jax_checkpoint_restores_sharded(run):
    assert run["worlds"]["1x2"]["restore_jax"] == "ok"


# --------------------------------------------------------------- trainer
@pytest.mark.parametrize("wid", ["2x1", "1x2"])
def test_trainer_on_a_mesh_equals_meshless_and_jax(run, wid):
    res = run["worlds"][wid]
    mesh_l, plain_l = res["train_mesh"], res["train_meshless"]
    assert len(mesh_l) == TRAIN_STEPS
    np.testing.assert_allclose(mesh_l, plain_l, rtol=1e-5)
    np.testing.assert_allclose(mesh_l, run["jax_losses"], rtol=1e-5)
    assert res["train_placed"] == "ok"


def test_trainer_on_a_mesh_microbatched_with_error_feedback(run):
    """(2, 1): two microbatches summed in fp32 and int8 error feedback on
    the mesh, the port's meshless run's losses within 1e-5 (the same
    seeded init: both start from the trainer's own)."""
    res = run["worlds"]["2x1"]
    assert len(res["mb_train_mesh"]) == TRAIN_STEPS
    np.testing.assert_allclose(res["mb_train_mesh"],
                               res["mb_train_meshless"], rtol=1e-5)
    assert res["mb_train_placed"] == "ok"


ONE_ROW = {"batch1": "row1_", "batch2_mb2": "row1mb_"}


@pytest.mark.parametrize("run_id", list(ONE_ROW))
@pytest.mark.parametrize("wid", ["1x2", "2x1", "1x1"])
def test_trainer_trains_one_row_batches(run, wid, run_id):
    """A (micro)batch of one row: batch 1, and batch 2 in two microbatches
    of one row, TRAIN_STEPS steps from JAX's initial state.  Where the
    data axes span one rank (1, 2) the rows were once split over them and
    DTensor's view rule refused the step; (2, 1) trained already.  Losses
    within 1e-5 of the meshless port run's, and at batch 1 of JAX's
    `Trainer` on `make_host_mesh()`; on a world of one the state stays
    plain tensors and the run is the meshless run, bit for bit."""
    res = run["worlds"][wid]
    prefix = ONE_ROW[run_id]
    mesh_l, plain_l = res[prefix + "train_mesh"], res[prefix + "train_meshless"]
    assert len(mesh_l) == TRAIN_STEPS
    np.testing.assert_allclose(mesh_l, plain_l, rtol=1e-5)
    if run_id == "batch1":
        np.testing.assert_allclose(mesh_l, run["jax_losses_1row"], rtol=1e-5)
    if wid == "1x1":
        assert mesh_l == plain_l
        assert res[prefix + "train_placed"] == "plain"
    else:
        assert res[prefix + "train_placed"] == "ok"


def test_one_row_batch_on_a_one_rank_mesh_forward():
    """In this process, a one-rank gloo mesh: a (1, 32, D) batch placed by
    `batch_spec` (dim 0 named for "data", as JAX's rule names it) holds
    no split over the one-rank axis and reshapes, and reduced phi4's
    forward on a one-row token batch placed the same way, with the params
    placed by the rules (`sharding.place`, the explicit DTensor path),
    gives the plain forward's logits (1e-5 of their largest magnitude)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs.base import get_config
    from repro_torch.core.config import mm_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    own_group = not dist.is_initialized()
    mesh = make_host_mesh(device="cpu")         # a HashStore world of one
    try:
        cfg = get_config("phi4-mini-3.8b").reduced()
        rng = np.random.default_rng(41)
        h = torch.from_numpy(rng.normal(size=(1, 32, cfg.d_model)).astype(
            np.float32))
        spec = shd.batch_spec(tuple(h.shape), mesh)
        assert tuple(spec) == ("data", None, None)
        hd = shd.place(h, spec, mesh)
        assert tuple(hd.placements) == (Replicate(), Replicate())
        assert torch.equal(hd.reshape(32, cfg.d_model).full_tensor(),
                           h.reshape(32, cfg.d_model))
        bundle = build_model(cfg, "cpu")
        params = bundle.init(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 32)))

        def forward(p, t):
            return bundle.logits_fn(p, bundle.hidden_fn(p, {"tokens": t})[0])

        with mm_config(backend="torch"):
            want = forward(params, toks)
            got = shd.on_mesh(forward, mesh)(
                shd.shard_like(params, shd.tree_param_specs(params, mesh),
                               mesh),
                shd.place(toks, shd.batch_spec((1, 32), mesh), mesh))
        assert isinstance(got, DTensor)
        got = got.full_tensor()
        assert got.shape == want.shape == (1, 32, cfg.vocab_size)
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    finally:
        if own_group:
            dist.destroy_process_group()


# ============================================================ rank side
def _ring(n, arrays, res):
    """The ring over ranks 0..n-1 (a subgroup when the world is larger)."""
    import torch.distributed as dist

    from repro_torch.optim import compression
    world, rank = dist.get_world_size(), dist.get_rank()
    group = None if n == world else dist.new_group(list(range(n)))
    y = torch.zeros(1000)
    if rank < n:
        x = torch.from_numpy(_ring_input()[rank])
        with compression.wire_capture() as wire:
            y = compression.int8_ring_allreduce(x, group)
        if rank == 0:
            res[f"ring{n}_wire"] = [[str(dt), nbytes] for dt, nbytes in wire]
    everyone = [torch.empty_like(y) for _ in range(world)]
    dist.all_gather(everyone, y)
    arrays[f"ring{n}_all"] = torch.stack(everyone[:n]).numpy()


def _case_ring(mesh, d, tmp, arrays, res):
    import torch.distributed as dist
    _ring(dist.get_world_size(), arrays, res)


def _case_ring3(mesh, d, tmp, arrays, res):
    _ring(3, arrays, res)


def _case_moe(mesh, d, tmp, arrays, res):
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import moe
    ref = np.load(os.path.join(tmp, "params.npz"))
    x = torch.from_numpy(_moe_input())
    for arch in MOE_ARCHS:
        cfg = _moe_cfg(arch)
        flat = {k[len(arch) + 1:]: torch.from_numpy(ref[k])
                for k in ref.files if k.startswith(arch + "/")}
        p = {k: v for k, v in flat.items() if "/" not in k}
        if cfg.n_shared_experts:
            p["shared"] = {k.split("/", 1)[1]: v for k, v in flat.items()
                           if k.startswith("shared/")}
        y0, _ = moe.moe_mlp(x, p, cfg)
        arrays[f"{arch}/meshless_y"] = y0.numpy()
        specs = shd.tree_param_specs(p, mesh)
        dp = shd.shard_like(p, specs, mesh)
        dx = shd.place(x, shd.batch_spec(tuple(x.shape), mesh), mesh)
        moe.reset_ep_counts()
        shd.set_annotation_mesh(mesh)
        try:
            y, aux = moe.moe_mlp(dx, dp, cfg)
            py, _ = moe.moe_mlp(x, p, cfg)
        finally:
            shd.set_annotation_mesh(None)
        res[f"{arch}/ep_counts"] = moe.ep_counts()
        arrays[f"{arch}/y"] = y.full_tensor().numpy()
        arrays[f"{arch}/aux"] = aux.full_tensor().numpy()
        arrays[f"{arch}/plain_y"] = py.numpy()
        _moe_grads(arch, cfg, mesh, x, p, arrays)


def _moe_grads(arch, cfg, mesh, x, p, arrays):
    """Gradients of sum(y * w) + aux with respect to x and every weight,
    through the expert-parallel path on `mesh` and the meshless one."""
    from repro_torch.core.config import mm_config
    from repro_torch.core.tree import leaves, unflatten
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import moe
    w = torch.from_numpy(np.random.default_rng(7).normal(
        size=tuple(x.shape)).astype(np.float32))

    def grads(xx, pp, mesh_on):
        live = [t.detach().requires_grad_(True) for t in [xx, *leaves(pp)]]
        shd.set_annotation_mesh(mesh if mesh_on else None)
        try:
            with mm_config(backend="torch"):
                y, aux = moe.moe_mlp(live[0], unflatten(pp, live[1:]), cfg)
            ww = shd.place(w, shd.batch_spec(tuple(w.shape), mesh), mesh) \
                if mesh_on else w
            loss = (y * ww).sum() + aux
        finally:
            shd.set_annotation_mesh(None)
        gs = torch.autograd.grad(loss, live)
        return [g.full_tensor() if hasattr(g, "full_tensor") else g
                for g in gs]

    want = grads(x, p, False)
    got = grads(shd.place(x, shd.batch_spec(tuple(x.shape), mesh), mesh),
                shd.shard_like(p, shd.tree_param_specs(p, mesh), mesh), True)
    arrays[f"{arch}/grad_err"] = np.array([
        float((a - b).abs().max() / max(b.abs().max(), 1e-30))
        for a, b in zip(got, want)])


def _case_rowsplit(mesh, d, tmp, arrays, res):
    """The row-split products on `mesh` against the meshless ones."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import skewmm
    from repro_torch.core.config import mm_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers
    cfg = get_config("phi4-mini-3.8b").reduced()
    rng = np.random.default_rng(31)
    b, s, hd = 4, 16, cfg.n_heads * cfg.head_dim

    def draw(*shape):
        return torch.from_numpy((rng.normal(size=shape) * 0.3).astype(
            np.float32))

    acts = {"ctx": draw(b, s, hd), "h": draw(b, s, cfg.d_model),
            "resid": draw(b, s, cfg.d_model)}
    weights = {"wo": draw(hd, cfg.d_model),
               "w_gate": draw(cfg.d_model, cfg.d_ff),
               "w_up": draw(cfg.d_model, cfg.d_ff),
               "w_down": draw(cfg.d_ff, cfg.d_model)}
    cot = draw(b, s, cfg.d_model)
    calls = []
    local = shd.on_local_blocks

    def counted(*args, **kwargs):
        if kwargs.get("out_sum"):
            calls.append(1)
        return local(*args, **kwargs)

    def products(a, w, c):
        names = list(a) + list(w)
        live = [t.detach().requires_grad_(True) for t in
                list(a.values()) + list(w.values())]
        v = dict(zip(names, live))
        with mm_config(backend="torch"):
            y1 = skewmm.matmul(v["ctx"], v["wo"])
            y2 = layers.mlp(v["h"], {k: v[k] for k in
                                     ("w_gate", "w_up", "w_down")}, cfg,
                            residual=v["resid"])
        grads = torch.autograd.grad(((y1 + y2) * c).sum(), live)
        return [t.full_tensor() if hasattr(t, "full_tensor") else t
                for t in (y1, y2, *grads)]

    want = products(acts, weights, cot)
    specs = shd.tree_param_specs(weights, mesh)
    placed_w = shd.shard_like(weights, specs, mesh)
    placed_a = {"ctx": shd.place(acts["ctx"], shd.P("data", None, "model"),
                                 mesh),
                **{k: shd.place(acts[k], shd.batch_spec((b, s, 1), mesh),
                                mesh) for k in ("h", "resid")}}
    shd.on_local_blocks = counted
    try:
        got = products(placed_a, placed_w, shd.place(
            cot, shd.batch_spec((b, s, 1), mesh), mesh))
    finally:
        shd.on_local_blocks = local
    res["rowsplit_local_calls"] = len(calls)
    arrays["rowsplit/err"] = np.array([
        float((g - w).abs().max() / max(w.abs().max(), 1e-30))
        for g, w in zip(got, want)])


def _case_mqa(mesh, d, tmp, arrays, res):
    """Attention with one kv head on `mesh` against the meshless one."""
    from repro_torch.core.config import mm_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import attention, layers
    rng = np.random.default_rng(37)
    b, s, hq, hd = 4, 16, 4, 8

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    q, k, v, cot = (draw(b, s, hq, hd), draw(b, s, 1, hd),
                    draw(b, s, 1, hd), draw(b, s, hq, hd))
    heads = []

    def attend(qb, kb, vb):
        heads.append(qb.shape[2])
        return layers.blockwise_attention(
            qb.transpose(1, 2), kb.transpose(1, 2), vb.transpose(1, 2),
            causal=True, q_chunk=8, kv_chunk=8).transpose(1, 2)

    def run(*args):
        live = [t.detach().requires_grad_(True) for t in args[:3]]
        with mm_config(backend="torch"):
            out = attention.per_head(attend, *live)
        grads = torch.autograd.grad((out * args[3]).sum(), live)
        return [t.full_tensor() if hasattr(t, "full_tensor") else t
                for t in (out, *grads)]

    want = run(q, k, v, cot)
    heads.clear()
    split = shd.P("data", None, "model", None)
    whole = shd.P("data", None, None, None)
    got = run(shd.place(q, split, mesh), shd.place(k, whole, mesh),
              shd.place(v, whole, mesh), shd.place(cot, split, mesh))
    res["mqa_q_heads_local"] = heads[0]
    arrays["mqa/err"] = np.array([
        float((g - w).abs().max() / max(w.abs().max(), 1e-30))
        for g, w in zip(got, want)])


def _case_loader(mesh, d, tmp, arrays, res):
    from repro_torch.data.pipeline import DataLoader, SyntheticLM
    src = SyntheticLM(1000, seed=5)
    loader = DataLoader(src, 8, 16, device="cpu", mesh=mesh)
    try:
        for step in range(2):
            tokens = next(loader)["tokens"]
            whole = src.batch(step, 8, 16)
            rows = 8 // d
            i = mesh.get_local_rank("data")
            assert tuple(tokens.shape) == (8, 16)
            np.testing.assert_array_equal(
                tokens.to_local().numpy(), whole[i * rows:(i + 1) * rows])
            np.testing.assert_array_equal(tokens.full_tensor().numpy(),
                                          whole)
    finally:
        loader.close()
    res["loader"] = "ok"


def _phi4_state(opt=None):
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_step import TrainStepConfig, init_train_state
    bundle = build_model(get_config("phi4-mini-3.8b").reduced(), "cpu")
    return init_train_state(bundle, opt or AdamW(), 0,
                            TrainStepConfig(compress_grads=True))


def _check_placed(state, specs, mesh):
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as shd

    def one(x, spec):
        if spec is None:
            assert not isinstance(x, DTensor)
        else:
            assert isinstance(x, DTensor), spec
            assert tuple(x.placements) == shd.to_placements(spec, mesh)
        return x
    shd.map_specs(one, state, specs)


def _case_save(mesh, d, tmp, arrays, res):
    from repro_torch.checkpoint.ckpt import CheckpointManager, flatten
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.trainer import state_specs
    state = _phi4_state()
    # a state that is not the init: every leaf moved by a seeded draw
    gen = torch.Generator().manual_seed(4)
    from repro_torch.core.tree import tree_map
    state = state._replace(params=tree_map(
        lambda t: t + torch.randn(t.shape, generator=gen).to(t.dtype),
        state.params))
    specs = state_specs(state, mesh)
    placed = shd.shard_like(state, specs, mesh)
    _check_placed(placed, specs, mesh)
    mgr = CheckpointManager(os.path.join(tmp, "ckpt12"))
    mgr.save(7, placed, blocking=True)
    np.savez(os.path.join(tmp, "saved12.npz"), **flatten(state))


def _restore_into(mesh, ckpt_dir, step, want: dict):
    from repro_torch.checkpoint.ckpt import CheckpointManager, flatten
    from repro_torch.train.trainer import state_specs
    like = _phi4_state()
    specs = state_specs(like, mesh)
    got = CheckpointManager(ckpt_dir).restore(like, step=step, specs=specs,
                                              mesh=mesh)
    _check_placed(got, specs, mesh)
    flat = flatten(got)
    assert set(flat) == set(want), set(flat) ^ set(want)
    for k, v in want.items():
        assert flat[k].dtype == v.dtype, k
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


def _case_restore(mesh, d, tmp, arrays, res):
    with np.load(os.path.join(tmp, "1x2", "saved12.npz")) as data:
        want = dict(data)
    _restore_into(mesh, os.path.join(tmp, "1x2", "ckpt12"), 7, want)
    res["restore"] = "ok"


def _case_restore_jax(mesh, d, tmp, arrays, res):
    """JAX's initial state (written by JAX's CheckpointManager as step 0,
    fp32 at reduced size) restored sharded, bytes equal."""
    path = os.path.join(tmp, "jax0")
    with np.load(os.path.join(path, "step-000000000", "state.npz")) as data:
        want = {k: v for k, v in data.items()}
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_step import init_train_state
    from repro_torch.train.trainer import state_specs
    bundle = build_model(get_config("phi4-mini-3.8b").reduced(), "cpu")
    like = init_train_state(bundle, AdamW(), 0)
    specs = state_specs(like, mesh)
    got = CheckpointManager(path).restore(like, step=0, specs=specs,
                                          mesh=mesh)
    _check_placed(got, specs, mesh)
    from repro_torch.checkpoint.ckpt import flatten
    flat = flatten(got)
    assert set(flat) == set(want), set(flat) ^ set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    res["restore_jax"] = "ok"


def _case_train_mb(mesh, d, tmp, arrays, res):
    """Two microbatches and int8 error feedback: the mesh against the
    meshless port (no JAX run: int8 ties may differ there)."""
    _case_train(mesh, d, tmp, arrays, res, prefix="mb_",
                ts=dict(n_microbatches=2, compress_grads=True),
                jax_init=False)


def _case_train_1row(mesh, d, tmp, arrays, res):
    """One-row (micro)batches from JAX's initial state: batch 1, and
    batch 2 in two microbatches."""
    _case_train(mesh, d, tmp, arrays, res, prefix=ONE_ROW["batch1"],
                batch=1)
    _case_train(mesh, d, tmp, arrays, res, prefix=ONE_ROW["batch2_mb2"],
                batch=2, ts=dict(n_microbatches=2))


def _check_plain(state):
    """Every leaf a plain tensor: a world of one places nothing."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core.tree import leaves
    assert not any(isinstance(x, DTensor) for x in leaves(state))


def _case_train(mesh, d, tmp, arrays, res, prefix="", ts=None, batch=4,
                jax_init=True):
    """TRAIN_STEPS steps (from JAX's initial state if `jax_init`), on the
    mesh and without it, on the same batches of `batch` x 32."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.config import mm_config
    from repro_torch.data.pipeline import DataLoader, SyntheticLM
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_step import TrainStepConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config("phi4-mini-3.8b").reduced()
    bundle = build_model(cfg, "cpu")
    for name, m in ((prefix + "train_mesh", mesh),
                    (prefix + "train_meshless", None)):
        ckpt = os.path.join(tmp, f"{mesh.shape[0]}x{mesh.shape[1]}",
                            name)
        if torch.distributed.get_rank() == 0 and jax_init:
            shutil.copytree(os.path.join(tmp, "jax0"), ckpt)
        torch.distributed.barrier()
        trainer = Trainer(bundle, AdamW(lr=1e-3),
                          TrainStepConfig(loss_chunk=16, **(ts or {})),
                          TrainerConfig(total_steps=TRAIN_STEPS,
                                        ckpt_every=100, log_every=1,
                                        ckpt_dir=ckpt),
                          log_fn=lambda _m: None, mesh=m)
        loader = DataLoader(SyntheticLM(cfg.vocab_size), batch, 32,
                            device="cpu", mesh=m)
        try:
            with mm_config(backend="torch"):
                hist = trainer.run(loader)["history"]
        finally:
            loader.close()
        res[name] = [loss for _, loss in hist]
        if shd.distributes(m):
            _check_placed(trainer.state, trainer.state_specs, mesh)
            res[prefix + "train_placed"] = "ok"
        elif m is not None:
            assert trainer.state_specs is None
            _check_plain(trainer.state)
            res[prefix + "train_placed"] = "plain"


_CASES = {"ring": _case_ring, "ring3": _case_ring3, "moe": _case_moe,
          "rowsplit": _case_rowsplit, "mqa": _case_mqa, "train_mb": _case_train_mb,
          "loader": _case_loader,
          "save": _case_save, "restore": _case_restore,
          "restore_jax": _case_restore_jax, "train": _case_train,
          "train_1row": _case_train_1row}


def _rank_main(rank, world, model, wdir, tmp, cases):
    import warnings
    warnings.filterwarnings("ignore")
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(model=model, device="cpu",
                          init_method=f"file://{wdir}/store")
    assert dist.get_backend() == "gloo"
    d = world // model
    arrays, res = {}, {"mesh": [d, model]}
    for case in cases:
        _CASES[case](mesh, d, tmp if case != "save" else wdir, arrays, res)
    dist.barrier()
    if rank == 0:
        np.savez(os.path.join(wdir, "arrays.npz"), **arrays)
        with open(os.path.join(wdir, "result.json"), "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    world, model = int(sys.argv[1]), int(sys.argv[2])
    wdir, tmp, cases = sys.argv[3], sys.argv[4], sys.argv[5:]
    torch.multiprocessing.spawn(_rank_main,
                                args=(world, model, wdir, tmp, cases),
                                nprocs=world)
