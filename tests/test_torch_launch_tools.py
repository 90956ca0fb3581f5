"""The port's `launch/dryrun` and `launch/costprobe` against the JAX
package.

Held equal, in this process (no process group): `input_specs` (shapes,
dtypes, partition specs) for every arch and shape on both production
meshes, JAX's built on `AbstractMesh` in the (sizes, names) form;
`_flash_traffic_bytes` at JAX's 2048-row q tile for every arch, attention
kind, shape and mesh; the `ProbeCost` arithmetic over seeded draws.

The block probe's FLOPs (one block forward + backward at b 2 x s 256,
single-trip attention, one device, traced on fake tensors) against XLA's
`cost_analysis()` of the same JAX block: within [0.99, 1.0] at full width
(phi4-mini, gemma2-27b) and [0.95, 1.0] at `reduced()` for each block kind
of one arch of every family.  Both count GEMMs, attention and elementwise
ops (the port's `roofline.pointwise_flops` gives each aten op XLA's count
for the same function, held equal op class by op class in
`test_torch_roofline.py`).  The recurrent and SSM blocks run in fp32 in
both packages (XLA on the CPU has no bf16 x bf16 -> fp32 dot).

Two subprocesses run once, together, in a module fixture: JAX's
`_use_fsdp` for every arch (JAX's `eval_shape` of deepseek-v3 takes ~60
s), and the port's `run_cell` and `CellProber.run` at `reduced()` for one
arch of each family on a (2, 2) fake mesh (`python
tests/test_torch_launch_tools.py <out.json>`: the fake process group is
process-wide).  That subprocess shrinks the shape cells to a global batch
of 8 and 64 positions: every record has JAX's keys, and every train cell
counts a collective.  A third subprocess runs JAX's own `CellProber` on
the same reduced cells over a (2, 2) mesh of 4 forced host devices, and
the whole cells are held against it: the port's costprobe and dryrun
FLOPs a device within [0.95, 1.0] of JAX's costprobe, and the costprobe's
collective bytes and counts equal to JAX's.  Where the two differ, the
ratio (port / JAX) is pinned, so that a change shows, and the gap is
logged in ROADMAP queue 3 with its cause; three dryrun serve cells whose
total holds elementwise work the composed probes leave out keep their
GEMM and attention FLOPs in the band.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
SRC = os.path.join(ROOT, "src")

ARCHS = ["phi4-mini-3.8b", "gemma2-27b", "granite-34b", "command-r-35b",
         "dbrx-132b", "deepseek-v3-671b", "recurrentgemma-9b",
         "mamba2-2.7b", "internvl2-1b", "seamless-m4t-large-v2"]
# one arch of each family for the traced runs
FAMILY_ARCHS = ["phi4-mini-3.8b", "dbrx-132b", "deepseek-v3-671b",
                "recurrentgemma-9b", "mamba2-2.7b", "internvl2-1b",
                "seamless-m4t-large-v2"]
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
TINY = {"train_4k": (64, 8, "train"), "prefill_32k": (64, 8, "prefill"),
        "decode_32k": (64, 8, "decode")}

# the keys run_cell adds to the report (JAX dryrun.py:192-199, and the
# port's `gemm_flops`) and the one CellProber.run adds (costprobe.py:505)
DRYRUN_KEYS = ("lower_s", "compile_s", "temp_bytes_per_device",
               "arg_bytes_per_device", "out_bytes_per_device",
               "alias_bytes_per_device", "code_bytes", "gemm_flops")
PROBE_KEYS = ("probe_s",)


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    env.pop("XLA_FLAGS", None)
    return env


@contextlib.contextmanager
def _jax_tools():
    """JAX's dryrun and costprobe modules, imported without their import
    effects: both set XLA_FLAGS (512 host devices) and costprobe sets
    `layers.CHUNK_OVERRIDE` for the rest of the process."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.models import layers as jax_layers
    chunk = jax_layers.CHUNK_OVERRIDE
    try:
        from repro.launch import costprobe, dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
        jax_layers.CHUNK_OVERRIDE = chunk
    yield dryrun, costprobe


def _cells():
    from repro_torch.configs.base import get_config
    from repro_torch.launch import shapes
    return shapes.cells(ARCHS, get_config)


# ------------------------------------------------------------ input specs
def _spec_tuple(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in tuple(spec))


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", _cells())
def test_input_specs_equal_jax(arch, shape, mesh_kind):
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh

    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun
    sizes, names = MESHES[mesh_kind]
    with _jax_tools() as (jdryrun, _):
        want = jdryrun.input_specs(arch, shape, AbstractMesh(sizes, names))
    got = dryrun.input_specs(arch, shape, sharding.MeshShape(sizes, names))
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == tuple(w.shape)
        assert str(g.dtype).replace("torch.", "") == jnp.dtype(w.dtype).name
        assert _spec_tuple(g.spec) == _spec_tuple(w.sharding.spec)


# ------------------------------------------------------------- flash bytes
def _attn_kinds(cfg):
    return sorted({k for unit, _ in cfg.stage_list() for k in unit
                   if k.startswith("attn")})


def _jax_flash_bytes(costprobe, jcfg, mesh, kind, b, s):
    """JAX's `_flash_traffic_bytes` on a prober that holds only what the
    method reads (its constructor forms the 256 / 512-device mesh)."""
    from types import SimpleNamespace

    from repro.distributed import sharding as jshd
    prober = SimpleNamespace(cfg=jcfg, mesh=mesh, dp=jshd.dp_axes(mesh),
                             _FLASH_BQ=costprobe.CellProber._FLASH_BQ)
    prober._attn_dims = lambda k: costprobe.CellProber._attn_dims(prober, k)
    return costprobe.CellProber._flash_traffic_bytes(prober, kind, b, s)


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_flash_traffic_bytes_equal_jax_at_2048(arch, mesh_kind):
    from jax.sharding import AbstractMesh

    from repro.configs.base import get_config as jax_get_config
    from repro_torch.distributed import sharding
    from repro_torch.launch import costprobe, shapes
    sizes, names = MESHES[mesh_kind]
    jmesh = AbstractMesh(sizes, names)
    jcfg = jax_get_config(arch)
    assert costprobe.JAX_FLASH_BQ == 2048
    checked = 0
    with _jax_tools() as (_, jcostprobe):
        assert jcostprobe.CellProber._FLASH_BQ == costprobe.JAX_FLASH_BQ
        for shape, cell in shapes.SHAPES.items():
            prober = costprobe.CellProber(
                arch, shape, mesh_kind, mesh=sharding.MeshShape(sizes, names),
                device="cpu")
            b = cell.global_batch // prober.n_micro
            for kind in _attn_kinds(prober.cfg):
                for s in (cell.seq_len, 1, 4096):
                    got = prober._flash_traffic_bytes(
                        kind, b, s, costprobe.JAX_FLASH_BQ)
                    assert got == _jax_flash_bytes(jcostprobe, jcfg, jmesh,
                                                   kind, b, s)
                    checked += 1
    assert checked or not _attn_kinds(jcfg)


def test_k7_q_tile_is_the_kernels():
    from repro_torch.kernels import flash_attention
    from repro_torch.launch import costprobe
    prober = costprobe.CellProber("phi4-mini-3.8b", "prefill_32k", "pod",
                                  mesh=None, device="cpu")
    assert prober.flash_bq("attn_global") == 128 == \
        flash_attention.tiles(prober.dtype, 128)[0]


# ------------------------------------------------------- chunk override
@pytest.mark.parametrize("override", [None, (1 << 30, 1 << 30), (256, 384)])
def test_chunk_override_scope_equals_jax(override):
    """Inside `chunk_override` the port's `blockwise_attention` walks the
    chunks JAX's walks under `CHUNK_OVERRIDE`; outside it, the caller's."""
    import jax.numpy as jnp
    import torch

    from repro.models import layers as jax_layers
    from repro_torch.models import layers
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(1, 4, 1100, 16)).astype(np.float32)
               for _ in range(3))
    k, v = k[:, :2], v[:, :2]
    prev = jax_layers.CHUNK_OVERRIDE
    jax_layers.CHUNK_OVERRIDE = override
    try:
        want = np.asarray(jax_layers.blockwise_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=300,
            softcap=30.0))
    finally:
        jax_layers.CHUNK_OVERRIDE = prev
    args = [torch.from_numpy(t) for t in (q, k, v)]
    scope = (contextlib.nullcontext() if override is None
             else layers.chunk_override(*override))
    with scope:
        got = layers.blockwise_attention(*args, window=300, softcap=30.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the scope is left: the default chunks again
    plain = layers.blockwise_attention(*args, window=300, softcap=30.0)
    ref = layers.blockwise_attention(*args, window=300, softcap=30.0,
                                     q_chunk=512, kv_chunk=1024)
    assert torch.equal(plain, ref)


# ------------------------------------------------------------- ProbeCost
@pytest.mark.parametrize("seed", range(4))
def test_probe_cost_arithmetic_equal(seed):
    from repro_torch.launch import costprobe
    rng = np.random.default_rng(seed)

    def draw(cls):
        r = np.random.default_rng(rng.integers(1 << 30))
        return cls(float(r.uniform(0, 1e15)), float(r.uniform(0, 1e12)),
                   float(r.uniform(0, 1e10)),
                   {k: int(r.integers(0, 9)) for k in
                    r.choice(["all-gather", "all-reduce", "reduce-scatter"],
                             size=2, replace=False)})

    with _jax_tools() as (_, jcp):
        state = rng.bit_generator.state
        a, b = draw(costprobe.ProbeCost), draw(costprobe.ProbeCost)
        rng.bit_generator.state = state
        ja, jb = draw(jcp.ProbeCost), draw(jcp.ProbeCost)
        k = float(rng.uniform(0, 100))
        for got, want in ((a + b, ja + jb), (k * a, k * ja), (a * k, ja * k),
                          (costprobe.ZERO + a, jcp.ZERO + ja),
                          (2 * (a + b) + a, 2 * (ja + jb) + ja)):
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


# --------------------------------------------------- block FLOPs vs XLA
def _jax_block_hlo(arch, cfg_fn, kind, b, s):
    """XLA's FLOPs for one block's forward + backward, and the optimised
    HLO they count."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config
    from repro.models import blocks
    from repro.models import layers as jax_layers
    cfg = cfg_fn(get_config(arch))
    p = jax.eval_shape(lambda k: blocks.init_block(k, cfg, kind),
                       jax.ShapeDtypeStruct((2,), jnp.uint32))
    x = jax.ShapeDtypeStruct((b, s, cfg.d_model), jnp.dtype(cfg.dtype))
    pos = jnp.arange(s, dtype=jnp.int32)

    def f(p, x):
        out, aux = blocks.block_fwd(x, p, cfg, kind, pos)
        return jnp.sum(out.astype(jnp.float32)) + aux

    prev = jax_layers.CHUNK_OVERRIDE
    jax_layers.CHUNK_OVERRIDE = (1 << 30, 1 << 30)
    try:
        compiled = jax.jit(lambda p, x: jax.value_and_grad(f)(p, x)).lower(
            p, x).compile()
    finally:
        jax_layers.CHUNK_OVERRIDE = prev
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    return float(ca["flops"]), compiled.as_text()


def _port_block_flops(arch, cfg_fn, kind, b, s):
    from repro_torch.configs.base import get_config
    from repro_torch.core import config
    from repro_torch.launch import costprobe
    prober = costprobe.CellProber(arch, "train_4k", "pod", mesh=None,
                                  cfg=cfg_fn(get_config(arch)), device="cpu")
    with prober._scope(), config.mm_config(backend="torch"):
        f, args, scale = prober.block_train_step(kind, b, s)
        assert scale == 1.0
        return prober._measure(f, *args).flops


# Reduced blocks whose ratio falls below 0.95, each because XLA's program
# holds work the port's does not run; not a fault of the port (ROADMAP
# queue 3's deliberate differences).  Op by op: each instruction of
# `_jax_block_hlo`'s optimised HLO text (its FLOPs as XLA's cost analysis
# counts them, on the source line of its stack frame) beside the ops
# `roofline.ProgramCounter` counts for the port's block; the totals are
# this test's, the dots `OUTSIDE_HLO`'s.  A bare file:line is the JAX
# package's (src/repro/models/, core/ for skewmm.py and epilogue.py);
# ssd_scan.py is the port's kernels/ssd_scan.py.
#
# recurrentgemma-9b attn_local, s 256, XLA 689887616, port 643915552, gap
# 45972064.  Both walk one q chunk and one kv chunk with the same masks
# (kv >= 0, causal, window; scores -1e30 and p 0 where masked).  JAX
# checkpoints its kv step (layers.py:196) whatever the walk's length; XLA
# merges the recompute with the forward for every other attention block
# and the port (`models.remat`) checkpoints only walks of two or more.
# Here XLA keeps it: the rematted score dot `dot_general.17` (op name
# ".../checkpoint/rematted_computation/bhqd,bhkd->bhqk") reads K through
# `%bitcast_broadcast_fusion` (K's one kv head broadcast over the four q
# heads after a layout copy), the forward's `dot_general.15` through
# `%bitcast_broadcast_fusion.3` (no copy): two instructions, so XLA's CSE
# cannot merge the dots.  The gap: that third (2, 4, 256, 256) score dot
# 33554432; the kv step's elementwise work around it and XLA's
# duplicated fusions (layers.py:174-209) +8265728; reductions XLA
# emits without a source line (the softmax's row max / sum and the loss
# sum as reduce-windows) +2990048; the gate's silu epilogue
# (epilogue.py:43-44) +655360; g * u (layers.py:100) +262144; the
# matmuls' epilogue adds (skewmm.py:211) +196608; rope (layers.py:45-64)
# +102144; rmsnorm (layers.py:35-38) -54400.
#
# mamba2-2.7b ssm, s 32 (one chunk), XLA 55595752, port 52592160, gap
# 3003592.  The port's chunk step runs every dot of JAX's chunk_step.
# (a) The final state update (ssm.py:103-107): JAX's scan transpose
# gives the unused final state a zero cotangent and XLA runs its
# backward, two (2, 8, 32, 32) dots (bqhs,bqhp->bhsp transposed) and
# their elementwise work, 2177552 in all with the forward products they
# read; XLA drops the forward update itself as dead, which the port runs
# (ssd_scan.py:173-176, 1098240): net +1079312, the one more dot.  (b)
# Inside the step, XLA's fusions recompute their producers (the decay
# mask select 4x, y_intra + y_inter 3x, ...; ssm.py:69-109) +346192, and
# the log-depth cumsum's shifted adds (ssm.py:45) against torch.cumsum
# +12200.  (c) Outside the scan, elementwise only (the matmuls' FLOPs are
# equal): silu of x (ssm.py:191) +688128, the two rmsnorms and the loss
# sum with XLA's reduce-window rewrites (layers.py:35-38) +602688, the
# silu(z) gate and its product (ssm.py:208-214) +131072, silu of B / C
# (ssm.py:192) +96256, the causal convs (ssm.py:27) +46720, softplus of
# dt (ssm.py:195) +1024.
OUTSIDE = {("recurrentgemma-9b", "attn_local"): 0.9334,
           ("mamba2-2.7b", "ssm"): 0.9460}
# what each pin's HLO must hold: (op name fragment, output shape, count)
OUTSIDE_HLO = {
    ("recurrentgemma-9b", "attn_local"): (
        "checkpoint/rematted_computation/bhqd,bhkd->bhqk", "f32[2,4,256,256]",
        1),
    ("mamba2-2.7b", "ssm"): (
        "transpose(jvp())/while/body/closed_call/bqhs,bqhp->bhsp",
        "f32[2,8,32,32]", 2),
}


def _hlo_dots(text: str, fragment: str, shape: str) -> int:
    return sum(1 for line in text.splitlines()
               if f"= {shape}" in line and " dot(" in line
               and fragment in line)


def _fp32_recurrent(cfg):
    return dataclasses.replace(cfg, dtype="float32") \
        if cfg.family in ("hybrid", "ssm") else cfg


def _block_cases():
    from repro_torch.configs.base import get_config
    cases = [(a, "full", k) for a in ("phi4-mini-3.8b", "gemma2-27b")
             for k in sorted({k for u, _ in get_config(a).stage_list()
                              for k in u})]
    cases += [(a, "reduced", k) for a in FAMILY_ARCHS
              for k in sorted({k for u, _ in
                               get_config(a).reduced().stage_list()
                               for k in u})]
    return cases


@pytest.mark.parametrize("arch,width,kind", _block_cases())
def test_block_probe_flops_against_xla(arch, width, kind):
    from repro_torch.configs.base import get_config

    def cfg_fn(cfg):
        return _fp32_recurrent(cfg.reduced() if width == "reduced" else cfg)
    s = 256
    if kind == "ssm":             # the probe's own length: one SSD chunk
        s = min(s, cfg_fn(get_config(arch)).ssm_chunk)
    flops, text = _jax_block_hlo(arch, cfg_fn, kind, 2, s)
    ratio = _port_block_flops(arch, cfg_fn, kind, 2, s) / flops
    assert ratio <= 1.0, ratio
    if (arch, kind) in OUTSIDE:
        # held at its value so a change shows, and the HLO holding the
        # extra dots the comment above names
        assert ratio == pytest.approx(OUTSIDE[arch, kind], abs=5e-4)
        fragment, shape, count = OUTSIDE_HLO[arch, kind]
        assert _hlo_dots(text, fragment, shape) == count
        if kind == "ssm":       # the forward state update is gone
            assert _hlo_dots(text, "jvp()/while/body/closed_call/"
                             "bqhs,bqhp->bhsp", shape) == 0
        return
    lo = 0.99 if width == "full" else 0.95
    assert lo <= ratio, ratio


# -------------------------------------------- traced cells in subprocesses
@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch")
    port_out, jax_out = str(d / "port.json"), str(d / "jax.json")
    cells_out = str(d / "jax_cells.json")
    env = _env()
    procs = [subprocess.Popen([sys.executable, HERE, port_out], env=env),
             subprocess.Popen([sys.executable, HERE, "--jax-fsdp", jax_out],
                              env=env),
             subprocess.Popen([sys.executable, HERE, "--jax-cells",
                               cells_out], env=env)]
    for p in procs:
        assert p.wait(timeout=600) == 0
    with open(port_out) as f, open(jax_out) as g, open(cells_out) as h:
        return json.load(f), json.load(g), json.load(h)


@pytest.mark.parametrize("arch", ARCHS)
def test_use_fsdp_equal_jax(traced, arch):
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun
    assert dryrun._use_fsdp(get_config(arch)) == traced[1][arch]


def _jax_report_keys():
    from repro.core import roofline as jax_roofline
    rep = jax_roofline.RooflineReport(
        arch="a", shape="s", mesh="m", chips=1, hlo_flops=0.0, hlo_bytes=0.0,
        collective_bytes=0.0, compute_s=0.0, memory_s=0.0,
        collective_s=0.0, model_flops=0.0, peak_flops=1.0,
        bytes_per_device=0, collective_counts={})
    return set(rep.to_json())


@pytest.mark.parametrize("tool", ["dryrun", "costprobe"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_traced_cells_have_jax_keys(traced, arch, tool):
    extra = DRYRUN_KEYS if tool == "dryrun" else PROBE_KEYS
    want = _jax_report_keys() | set(extra)
    recs = traced[0][tool][arch]
    assert set(recs) == set(TINY)
    for shape, rec in recs.items():
        assert set(rec) == want, shape
        assert rec["chips"] == 4 and rec["hlo_flops"] > 0
        if TINY[shape][2] == "train":
            assert sum(rec["collective_counts"].values()) >= 1
    if tool == "dryrun":
        for rec in recs.values():
            assert rec["bytes_per_device"] >= rec["arg_bytes_per_device"] > 0
            assert rec["alias_bytes_per_device"] == 0 == rec["code_bytes"]


# Whole cells against JAX's costprobe (ratios port / JAX, ROADMAP queue 3):
#  - the dryrun's train cells run the step, which recomputes each unit's
#    forward in the backward (`models.remat`, as JAX's step does), where
#    JAX's costprobe composes block probes that hold no unit checkpoint;
#    its train probes also leave out the VLM prefix and the encoder
#    (internvl2, seamless), and its encoder-decoder decode recomputes the
#    cross-attention K / V each step (seamless 0.2927).
FLOPS_GAPS = {
    ("dryrun", "phi4-mini-3.8b", "train_4k"): 1.1970,
    ("dryrun", "dbrx-132b", "train_4k"): 1.2511,
    ("dryrun", "deepseek-v3-671b", "train_4k"): 1.1499,
    ("dryrun", "recurrentgemma-9b", "train_4k"): 1.2521,
    ("dryrun", "mamba2-2.7b", "train_4k"): 1.1971,
    ("dryrun", "internvl2-1b", "train_4k"): 1.4895,
    ("dryrun", "seamless-m4t-large-v2", "train_4k"): 1.7417,
    ("dryrun", "seamless-m4t-large-v2", "decode_32k"): 0.2927,
}
# Dryrun serve cells whose GEMM and attention FLOPs a device (the record's
# `gemm_flops`) are held to the band, and whose total is pinned: the real
# step's elementwise work outside the blocks that JAX's composed probes
# leave out (internvl2's prefix, run whole where the probe scales its
# blocks by (1 + prefix / s); seamless's encoder; deepseek's decode
# bookkeeping around the MLA cache).
COMPOSED = {
    ("dryrun", "deepseek-v3-671b", "decode_32k"): 1.0035,
    ("dryrun", "internvl2-1b", "prefill_32k"): 1.0224,
    ("dryrun", "seamless-m4t-large-v2", "prefill_32k"): 1.0023,
}
# Collective bytes where the port's differ from JAX's (the other six cells,
# the dense, VLM and encoder-decoder serve cells, are equal in bytes and
# counts).  Train: DTensor reduce-scatters gradients and all-gathers FSDP /
# ZeRO-1 weights one op at a time, where XLA's partitioner picks
# all-reduces, permutes and all-to-alls of its own, and XLA's step
# all-gathers more than the port's (every train row but mamba2's under
# 1.0); MoE, MLA, the recurrent and SSD blocks: DTensor's redistributes
# around the rank-local ops (`sharding.on_local_blocks`) against XLA's
# own resharding.
COLLECTIVE_GAPS = {
    ("phi4-mini-3.8b", "train_4k"): 0.6794,
    ("dbrx-132b", "train_4k"): 0.4949,
    ("dbrx-132b", "prefill_32k"): 1.0417,
    ("dbrx-132b", "decode_32k"): 1.0451,
    ("deepseek-v3-671b", "train_4k"): 0.5645,
    ("deepseek-v3-671b", "prefill_32k"): 1.2153,
    ("deepseek-v3-671b", "decode_32k"): 0.9141,
    ("recurrentgemma-9b", "train_4k"): 0.5834,
    ("recurrentgemma-9b", "prefill_32k"): 0.9764,
    ("recurrentgemma-9b", "decode_32k"): 0.9896,
    ("mamba2-2.7b", "train_4k"): 1.5258,
    ("mamba2-2.7b", "prefill_32k"): 0.9987,
    ("mamba2-2.7b", "decode_32k"): 0.9987,
    ("internvl2-1b", "train_4k"): 0.6794,
    ("seamless-m4t-large-v2", "train_4k"): 0.7758,
}


@pytest.mark.parametrize("shape", list(TINY))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("tool", ["costprobe", "dryrun"])
def test_cell_flops_against_jax_costprobe(traced, tool, arch, shape):
    rec = traced[0][tool][arch][shape]
    want = traced[2][arch][shape]["hlo_flops"]
    ratio = rec["hlo_flops"] / want
    if (tool, arch, shape) in COMPOSED:
        assert 0.95 <= rec["gemm_flops"] / want <= 1.0, rec["gemm_flops"]
        assert ratio == pytest.approx(COMPOSED[tool, arch, shape], abs=5e-4)
    elif (tool, arch, shape) in FLOPS_GAPS:
        assert ratio == pytest.approx(FLOPS_GAPS[tool, arch, shape],
                                      abs=5e-4)
    else:
        assert 0.95 <= ratio <= 1.0, ratio


@pytest.mark.parametrize("shape", list(TINY))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cell_collectives_against_jax_costprobe(traced, arch, shape):
    got, want = traced[0]["costprobe"][arch][shape], traced[2][arch][shape]
    assert got["chips"] == want["chips"] == 4
    # DTensor emits these three kinds only; XLA also permutes and
    # all-to-alls.  Both reduce every model-split contraction.
    assert set(got["collective_counts"]) <= {"all-gather", "all-reduce",
                                             "reduce-scatter"}
    assert got["collective_counts"]["all-reduce"] > 0
    assert want["collective_counts"]["all-reduce"] > 0
    ratio = got["collective_bytes"] / want["collective_bytes"]
    if (arch, shape) in COLLECTIVE_GAPS:
        assert ratio == pytest.approx(COLLECTIVE_GAPS[arch, shape], abs=5e-4)
    else:
        assert got["collective_bytes"] == want["collective_bytes"]
        assert got["collective_counts"] == pytest.approx(
            want["collective_counts"])


DEPTHS = (2, 4)


def test_dryrun_bytes_a_layer_are_a_hidden_state_and_its_state(traced):
    """phi4-mini `reduced()` train_4k (8 x 64 on the (2, 2) fake mesh) at 2
    and at 4 layers: each layer added raises the peak bytes a device by no
    more than one hidden state on a rank (4 x 64 x 128 fp32, the unit's
    checkpointed input) plus that layer's state there.  The slack: the
    state is counted as 7 fp32 copies of the layer's parameters at their
    "model" split (parameter, gradient, the two moments, and the update's
    new parameter and moments), ZeRO-1's split of the moments over "data"
    ignored.  A layer adds 722948 bytes; without the unit checkpoint
    (every activation of its backward kept) it added 2728960, over the
    bound."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding
    from repro_torch.models import blocks
    cfg = get_config("phi4-mini-3.8b").reduced()
    recs = traced[0]["depth"]
    grow = (recs[str(DEPTHS[1])]["bytes_per_device"]
            - recs[str(DEPTHS[0])]["bytes_per_device"]) / (
                DEPTHS[1] - DEPTHS[0])
    hidden = 8 // 2 * 64 * cfg.d_model * 4
    mesh = sharding.MeshShape((2, 2), ("data", "model"))
    shapes = blocks.init_block(None, cfg, "attn_global", "meta")
    specs = sharding.tree_param_specs(shapes, mesh)

    def state_bytes(tree, spec):
        if isinstance(tree, dict):
            return sum(state_bytes(tree[k], spec[k]) for k in tree)
        split = 2 ** sum(e == "model" for e in tuple(spec))
        return 7 * tree.numel() * 4 // split

    state = state_bytes(shapes, specs)
    assert 0 < grow <= hidden + state, (grow, hidden, state)


def test_bench_record_equals_jax(traced):
    from repro_torch.launch import costprobe
    rec = traced[0]["costprobe"]["phi4-mini-3.8b"]["train_4k"]
    with _jax_tools() as (_, jcp):
        want = jcp._bench_record(rec).to_json()
    got = costprobe._bench_record(rec).to_json()
    for key in ("name", "suite", "axes", "metrics", "info", "us_per_call",
                "us_iqr", "repeats"):
        assert got[key] == want[key], key


def test_import_forms_no_process_group():
    import torch.distributed as dist

    import repro_torch.core.roofline  # noqa: F401
    import repro_torch.launch.costprobe  # noqa: F401
    import repro_torch.launch.dryrun  # noqa: F401
    import repro_torch.launch.shapes  # noqa: F401
    assert not dist.is_initialized()


def test_cuda_backend_is_refused(capsys):
    from repro_torch.launch import costprobe, dryrun
    for main in (dryrun.main, costprobe.main):
        with pytest.raises(SystemExit):
            main(["--arch", "phi4-mini-3.8b", "--shape", "train_4k",
                  "--device", "cpu", "--mm-backend", "cuda"])
        assert "--mm-backend cuda" in capsys.readouterr().err


# ------------------------------------------------------------ subprocesses
def _port_world(out: str) -> None:
    """Every family's reduced arch through run_cell and CellProber.run on
    a (2, 2) fake mesh, at tiny cells."""
    import tempfile

    from repro_torch.configs.base import get_config
    from repro_torch.launch import costprobe, dryrun, shapes
    for name, (seq, batch, mode) in TINY.items():
        shapes.SHAPES[name] = shapes.ShapeCell(name, seq, batch, mode)
    res = {"dryrun": {}, "costprobe": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for arch in FAMILY_ARCHS:
            cfg = get_config(arch).reduced()
            res["dryrun"][arch] = {
                shape: dryrun.run_cell(arch, shape, "pod", tmp, cfg=cfg,
                                       mesh_dims=(2, 2), device="cpu")
                for shape in TINY}
            mesh = dryrun.cell_mesh("pod", "cpu", (2, 2))
            res["costprobe"][arch] = {
                shape: costprobe.CellProber(arch, shape, "pod", mesh=mesh,
                                            cfg=cfg, device="cpu").run()
                for shape in TINY}
        cfg = get_config("phi4-mini-3.8b").reduced()
        res["depth"] = {
            n: dryrun.run_cell("phi4-mini-3.8b", "train_4k", "pod", tmp,
                               cfg=dataclasses.replace(cfg, n_layers=n),
                               mesh_dims=(2, 2), device="cpu")
            for n in DEPTHS}
    with open(out, "w") as f:
        json.dump(res, f, default=float)


def _jax_fsdp(out: str) -> None:
    from repro.configs.base import get_config
    with _jax_tools() as (jdryrun, _):
        res = {a: bool(jdryrun._use_fsdp(get_config(a))) for a in ARCHS}
    with open(out, "w") as f:
        json.dump(res, f)


def _jax_cells(out: str) -> None:
    """JAX's `CellProber.run` for every family's reduced arch at the tiny
    cells on a (2, 2) mesh of 4 forced host devices, with the published
    arch's FSDP choice (the port's `_use_fsdp`, held equal to JAX's
    above)."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    assert len(jax.devices()) == 4
    from repro.compat import make_mesh
    from repro.configs.base import get_config
    from repro.launch import shapes
    from repro_torch.configs.base import get_config as port_get_config
    from repro_torch.launch import dryrun
    with _jax_tools() as (_, jcp):
        for name, (seq, batch, mode) in TINY.items():
            shapes.SHAPES[name] = shapes.ShapeCell(name, seq, batch, mode)
        jcp.make_production_mesh = lambda multi_pod=False: make_mesh(
            (2, 2), ("data", "model"))
        jcp.layers_mod.CHUNK_OVERRIDE = (1 << 30, 1 << 30)
        res = {}
        for arch in FAMILY_ARCHS:
            cfg = get_config(arch).reduced()
            jcp.get_config = lambda _, cfg=cfg: cfg
            res[arch] = {}
            for shape in TINY:
                prober = jcp.CellProber(arch, shape, "pod")
                prober.fsdp = dryrun._use_fsdp(port_get_config(arch))
                res[arch][shape] = prober.run()
    with open(out, "w") as f:
        json.dump(res, f, default=float)


if __name__ == "__main__":
    if sys.argv[1] == "--jax-fsdp":
        _jax_fsdp(sys.argv[2])
    elif sys.argv[1] == "--jax-cells":
        _jax_cells(sys.argv[2])
    else:
        _port_world(sys.argv[1])
