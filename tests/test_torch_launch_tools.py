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
of one arch of every family.  The port counts GEMMs and attention only;
XLA also counts elementwise ops.  The recurrent and SSM blocks run in fp32
in both packages (XLA on the CPU has no bf16 x bf16 -> fp32 dot).

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
logged in ROADMAP queue 3 with its cause.
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

# the keys run_cell adds to the report (JAX dryrun.py:192-199) and the one
# CellProber.run adds (costprobe.py:505)
DRYRUN_KEYS = ("lower_s", "compile_s", "temp_bytes_per_device",
               "arg_bytes_per_device", "out_bytes_per_device",
               "alias_bytes_per_device", "code_bytes")
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
def _jax_block_flops(arch, cfg_fn, kind, b, s):
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
    return float((ca[0] if isinstance(ca, (list, tuple)) else ca)["flops"])


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


# reduced blocks whose ratio falls below 0.95 (ROADMAP queue 3): the
# scans' and the causal conv's multiply-adds run as elementwise ops, which
# the port's count leaves out and XLA's counts; at reduced widths they are
# a larger share
OUTSIDE = {("recurrentgemma-9b", "attn_local"): 0.9120,
           ("recurrentgemma-9b", "rec"): 0.9426,
           ("mamba2-2.7b", "ssm"): 0.9124}


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
    ratio = (_port_block_flops(arch, cfg_fn, kind, 2, s)
             / _jax_block_flops(arch, cfg_fn, kind, 2, s))
    assert ratio <= 1.0, ratio
    if (arch, kind) in OUTSIDE:
        # logged in ROADMAP queue 3; held at its value so a change shows
        assert ratio == pytest.approx(OUTSIDE[arch, kind], abs=5e-4)
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
#  - train costprobe cells above 1.0: the loss's logits GEMM runs 4 times
#    (torch.utils.checkpoint recomputes it; XLA's module runs it 3 times),
#    and DTensor's rule for the row-split o / down projection's backward
#    gathers its input and computes the weight and input gradients whole
#    on each "model" rank, where XLA's partitioner keeps them split;
#  - mamba2's serve cells: the SSD scan's multiply-adds are elementwise,
#    which XLA counts and the port's GEMM-and-attention count leaves out;
#  - the dryrun traces the real step, which JAX's costprobe composes from
#    probes: its train probes leave out the VLM prefix and the encoder
#    (internvl2, seamless), its encoder-decoder decode recomputes the
#    cross-attention K / V each step (seamless 0.2861); phi4's train step
#    has a fifth logits-sized GEMM the probes do not (not yet traced).
FLOPS_GAPS = {
    ("costprobe", "phi4-mini-3.8b", "train_4k"): 1.0569,
    ("costprobe", "deepseek-v3-671b", "train_4k"): 1.0724,
    ("costprobe", "recurrentgemma-9b", "train_4k"): 1.0476,
    ("costprobe", "mamba2-2.7b", "prefill_32k"): 0.9355,
    ("costprobe", "mamba2-2.7b", "decode_32k"): 0.8881,
    ("costprobe", "internvl2-1b", "train_4k"): 1.0563,
    ("costprobe", "seamless-m4t-large-v2", "train_4k"): 1.0601,
    ("dryrun", "phi4-mini-3.8b", "train_4k"): 1.1099,
    ("dryrun", "deepseek-v3-671b", "train_4k"): 1.0861,
    ("dryrun", "recurrentgemma-9b", "train_4k"): 1.0659,
    ("dryrun", "mamba2-2.7b", "train_4k"): 1.0541,
    ("dryrun", "mamba2-2.7b", "prefill_32k"): 0.9355,
    ("dryrun", "mamba2-2.7b", "decode_32k"): 0.8881,
    ("dryrun", "internvl2-1b", "train_4k"): 1.3593,
    ("dryrun", "seamless-m4t-large-v2", "train_4k"): 1.7232,
    ("dryrun", "seamless-m4t-large-v2", "decode_32k"): 0.2861,
}
# Collective bytes where the port's differ from JAX's (the other six cells,
# the dense, VLM and encoder-decoder serve cells, are equal in bytes and
# counts).  Train: DTensor reduce-scatters gradients and all-gathers FSDP /
# ZeRO-1 weights one op at a time, where XLA's partitioner picks
# all-reduces, permutes and all-to-alls of its own; MoE, MLA, the
# recurrent and SSD blocks: DTensor's redistributes around the rank-local
# ops (`sharding.on_local_blocks`) against XLA's own resharding.
COLLECTIVE_GAPS = {
    ("phi4-mini-3.8b", "train_4k"): 0.7936,
    ("dbrx-132b", "train_4k"): 0.5890,
    ("dbrx-132b", "prefill_32k"): 1.0417,
    ("dbrx-132b", "decode_32k"): 1.0451,
    ("deepseek-v3-671b", "train_4k"): 0.7007,
    ("deepseek-v3-671b", "prefill_32k"): 1.2153,
    ("deepseek-v3-671b", "decode_32k"): 0.9141,
    ("recurrentgemma-9b", "train_4k"): 0.6167,
    ("recurrentgemma-9b", "prefill_32k"): 1.0394,
    ("recurrentgemma-9b", "decode_32k"): 1.0104,
    ("mamba2-2.7b", "train_4k"): 1.6326,
    ("mamba2-2.7b", "prefill_32k"): 0.9987,
    ("mamba2-2.7b", "decode_32k"): 0.9987,
    ("internvl2-1b", "train_4k"): 0.7936,
    ("seamless-m4t-large-v2", "train_4k"): 0.8933,
}


@pytest.mark.parametrize("shape", list(TINY))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("tool", ["costprobe", "dryrun"])
def test_cell_flops_against_jax_costprobe(traced, tool, arch, shape):
    ratio = (traced[0][tool][arch][shape]["hlo_flops"]
             / traced[2][arch][shape]["hlo_flops"])
    if (tool, arch, shape) in FLOPS_GAPS:
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
