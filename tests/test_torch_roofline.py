"""The port's `launch/shapes` and `core/roofline` against the JAX package.

Shapes: the four cells, the long-context rule, `cells(all_arch_ids())`
and `microbatches_for` for every arch and shape, equal.  The report
arithmetic (`dominant`, `step_s`, `roofline_fraction`, `useful_ratio`,
`to_json`, `row`) equal over seeded draws; the wire table and dtype table
equal; `analyze`'s three terms equal to the JAX `analyze` on the same
FLOPs, bytes and collective bytes, and priced against GC200's 10 links or
an explicit 4 (the case of tests/test_shardplan.py, rewritten: that file
fails at collection under jax 0.9).

The collective counter runs in a subprocess (`python
tests/test_torch_roofline.py <out.json>`: a fake process group of 4 ranks
is process-wide): an all-gather whose local output is bf16 (1024, 1024)
counts JAX's `collective_stats("%ag = bf16[1024,1024]{1,0}
all-gather(%x)")` bytes, and likewise all-reduce, reduce-scatter and
all-to-all; a functional collective's wait counts nothing more; a
redistribute and a view count no FLOPs.

The elementwise census: for each op class (add, mul, div, where, max,
exp, tanh, rsqrt, the integer powers, sums, max and mean over an axis,
convert, cumsum at three lengths, and the fused activations, softmax and
logsumexp) `ProgramCounter`'s FLOPs of the torch op equal XLA's
`cost_analysis()["flops"]` of the same jitted JAX function.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
SRC = os.path.join(ROOT, "src")

# HLO kind -> the HLO text whose output operand is bf16[1024,1024]
HLO_LINES = {
    "all-gather": "%ag = bf16[1024,1024]{1,0} all-gather(%x)",
    "all-reduce": "%ar = bf16[1024,1024]{1,0} all-reduce(%x)",
    "reduce-scatter": "%rs = bf16[1024,1024]{1,0} reduce-scatter(%x)",
    "all-to-all": "%aa = bf16[1024,1024]{1,0} all-to-all(%x)",
}


# ------------------------------------------------------------- shapes
def test_shape_cells_equal():
    from repro.launch import shapes as jax_shapes
    from repro_torch.launch import shapes
    assert {k: vars(v) for k, v in shapes.SHAPES.items()} == \
        {k: vars(v) for k, v in jax_shapes.SHAPES.items()}
    assert shapes._LONG_OK == jax_shapes._LONG_OK


def test_cells_equal():
    from repro.configs import base as jax_base
    from repro.launch import shapes as jax_shapes
    from repro_torch.configs import base
    from repro_torch.launch import shapes
    ids = jax_base.all_arch_ids()
    assert sorted(base.all_arch_ids()) == sorted(ids)
    assert shapes.cells(ids, base.get_config) == \
        jax_shapes.cells(ids, jax_base.get_config)


@pytest.mark.parametrize("arch", [
    "phi4-mini-3.8b", "gemma2-27b", "granite-34b", "command-r-35b",
    "dbrx-132b", "deepseek-v3-671b", "recurrentgemma-9b", "mamba2-2.7b",
    "internvl2-1b", "seamless-m4t-large-v2", "paper-skewmm"])
def test_microbatches_and_applicable_equal(arch):
    from repro.configs import base as jax_base
    from repro.launch import shapes as jax_shapes
    from repro_torch.configs import base
    from repro_torch.launch import shapes
    cfg, jcfg = base.get_config(arch), jax_base.get_config(arch)
    for name, cell in shapes.SHAPES.items():
        jcell = jax_shapes.SHAPES[name]
        assert shapes.microbatches_for(cfg, cell) == \
            jax_shapes.microbatches_for(jcfg, jcell)
        assert shapes.applicable(arch, cfg, name) == \
            jax_shapes.applicable(arch, jcfg, name)


# ------------------------------------------------------ report arithmetic
def _draw(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    zero = seed % 5 == 0          # the zero-division guards
    return dict(
        arch=f"a{seed}", shape="train_4k", mesh=["pod", "multipod"][seed % 2],
        chips=int(rng.choice([1, 4, 256, 512])),
        hlo_flops=0.0 if zero else float(rng.uniform(1e9, 1e15)),
        hlo_bytes=float(rng.uniform(1e6, 1e13)),
        collective_bytes=float(rng.uniform(0, 1e11)),
        compute_s=0.0 if zero else float(rng.uniform(1e-6, 10)),
        memory_s=0.0 if zero else float(rng.uniform(1e-6, 10)),
        collective_s=0.0 if zero else float(rng.uniform(0, 10)),
        model_flops=float(rng.uniform(1e9, 1e18)),
        peak_flops=float(rng.choice([197e12, 989e12, 250e12])),
        bytes_per_device=int(rng.integers(0, 1 << 36)),
        collective_counts={"all-gather": int(rng.integers(0, 9)),
                           "all-reduce": int(rng.integers(0, 9))})


@pytest.mark.parametrize("seed", range(10))
def test_report_arithmetic_equal(seed):
    from repro.core import roofline as jax_roofline
    from repro_torch.core import roofline
    fields = _draw(seed)
    rep = roofline.RooflineReport(**fields)
    jrep = jax_roofline.RooflineReport(**fields)
    assert rep.to_json() == jrep.to_json()
    assert rep.row() == jrep.row()
    for prop in ("dominant", "step_s", "roofline_fraction", "useful_ratio"):
        assert getattr(rep, prop) == getattr(jrep, prop)


def test_save_report_round_trips(tmp_path):
    from repro_torch.core import roofline
    rep = roofline.RooflineReport(**_draw(3))
    path = str(tmp_path / "r.json")
    roofline.save_report(rep, path)
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(rep.to_json()))


def test_wire_and_dtype_tables_equal():
    from repro.core import roofline as jax_roofline
    from repro_torch.core import roofline
    assert roofline._WIRE_FACTOR == jax_roofline._WIRE_FACTOR
    assert roofline._DTYPE_BYTES == jax_roofline._DTYPE_BYTES
    kinds = {k for k, _ in roofline._COLLECTIVES.values()}
    assert kinds == set(jax_roofline._WIRE_FACTOR)


# --------------------------------------------------------------- analyze
class _Compiled:
    """A compiled executable's two analyses, for the JAX `analyze`."""

    def __init__(self, flops, nbytes):
        self.ca = {"flops": flops, "bytes accessed": nbytes}

    def memory_analysis(self):
        class MA:
            argument_size_in_bytes = 0
            output_size_in_bytes = 0
            alias_size_in_bytes = 0
            temp_size_in_bytes = 0
        return MA()

    def cost_analysis(self):
        return self.ca


@pytest.mark.parametrize("chip", ["tpu_v5e", "ipu_gc200", "gpu_a30"])
@pytest.mark.parametrize("links", [None, 4])
def test_analyze_terms_equal(chip, links):
    from repro.core import hw as jax_hw
    from repro.core import roofline as jax_roofline
    from repro_torch.core import hw, roofline
    hlo = HLO_LINES["all-gather"]
    wire = jax_roofline.collective_stats(hlo).total_bytes
    cost = roofline.ProgramCost(flops=3.2e12, bytes=7.5e10,
                                collective_bytes=wire,
                                collective_counts={"all-gather": 1},
                                bytes_per_device=0)
    rep = roofline.analyze(cost, arch="t", shape="s", mesh="m", chips=2,
                           model_flops=1e13, ici_links=links,
                           chip=hw.get_chip(chip))
    jrep = jax_roofline.analyze(_Compiled(3.2e12, 7.5e10), hlo, arch="t",
                                shape="s", mesh="m", chips=2,
                                model_flops=1e13, ici_links=links,
                                chip=jax_hw.get_chip(chip))
    assert rep.to_json() == jrep.to_json()


def test_analyze_defaults_to_chip_links():
    """analyze prices collectives against ChipSpec.ici_links (GC200: 10
    IPU-Links of 32 GB/s); an explicit override still wins."""
    from repro_torch.core import hw, roofline
    gc200 = hw.get_chip("ipu_gc200")
    assert gc200.ici_links == 10 and gc200.ici_bw_per_link == 32e9
    wire = 1024 * 1024 * 2
    cost = roofline.ProgramCost(0.0, 0.0, float(wire), {"all-gather": 1}, 0)
    rep = roofline.analyze(cost, arch="t", shape="s", mesh="m", chips=2,
                           model_flops=0.0, chip=gc200)
    assert rep.collective_s == pytest.approx(wire / (32e9 * 10))
    rep4 = roofline.analyze(cost, arch="t", shape="s", mesh="m", chips=2,
                            model_flops=0.0, chip=gc200, ici_links=4)
    assert rep4.collective_s == pytest.approx(wire / (32e9 * 4))


def test_analyze_chip_defaults_to_mm_config():
    from repro_torch.core import config, roofline
    cost = roofline.ProgramCost(1e12, 1e9, 0.0, {}, 0)
    rep = roofline.analyze(cost, arch="t", shape="s", mesh="m", chips=1,
                           model_flops=0.0)
    assert rep.peak_flops == 989e12                     # gpu_h100, bf16
    with config.mm_config(chip="tpu_v5e"):
        rep = roofline.analyze(cost, arch="t", shape="s", mesh="m",
                               chips=1, model_flops=0.0)
    assert rep.peak_flops == 197e12


# ------------------------------------------------------ collective counter
@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("coll") / "coll.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "1"
    subprocess.run([sys.executable, HERE, out], check=True, env=env,
                   timeout=300)
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("kind", sorted(HLO_LINES))
def test_collective_bytes_equal_hlo_parser(collectives, kind):
    from repro.core import roofline as jax_roofline
    want = jax_roofline.collective_stats(HLO_LINES[kind])
    got = collectives[kind]
    assert got["counts"] == want.counts
    assert got["bytes"] == want.bytes_by_kind


def test_counter_counts_local_flops_and_peak(collectives):
    """A matmul on rank 0's block: (256 x 1024) @ (1024 x 1024) local."""
    got = collectives["mm"]
    assert got["flops"] == 2 * 256 * 1024 * 1024
    assert got["peak"] >= got["inputs"] > 0


def test_redistribute_and_view_count_no_flops(collectives):
    """A `DTensor` all-gathered and a pending sum all-reduced (the sum is
    the collective's, as XLA's all-reduce is not an elementwise op here),
    and a view: no FLOPs."""
    got = collectives["redistribute"]
    assert got["flops"] == 0
    assert got["counts"] == {"all-gather": 1, "all-reduce": 1}


def _counter_world(out: str) -> None:
    """Rank 0 of a fake world of 4: each collective of a bf16 local
    output of (1024, 1024) under its own counter."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.core import roofline
    from repro_torch.launch import dryrun

    mesh = dryrun.cell_mesh("pod", "cpu", (4,))
    group = dist.group.WORLD
    res = {}
    with dryrun.fake_mode():
        local = torch.empty((256, 1024), dtype=torch.bfloat16)
        whole = torch.empty((1024, 1024), dtype=torch.bfloat16)
        wide = torch.empty((4096, 1024), dtype=torch.bfloat16)
        runs = {
            "all-gather": lambda: funcol.all_gather_tensor(local, 0, group),
            "all-reduce": lambda: funcol.all_reduce(whole, "sum", group),
            "reduce-scatter": lambda: funcol.reduce_scatter_tensor(
                wide, "sum", 0, group),
            "all-to-all": lambda: funcol.all_to_all_single(
                whole, None, None, group),
        }
        for kind, fn in runs.items():
            c = roofline.ProgramCounter()
            with c:
                funcol.wait_tensor(fn())
            res[kind] = {"counts": c.collectives.counts,
                         "bytes": c.collectives.bytes_by_kind}
        a = distribute_tensor(torch.empty((1024, 1024)), mesh, [Shard(0)],
                              src_data_rank=None)
        b = torch.empty((1024, 1024))
        c = roofline.ProgramCounter((a, b))
        with c:
            a @ torch.distributed.tensor.DTensor.from_local(
                b, mesh, [Replicate()], run_check=False)
        cost = c.cost()
        res["mm"] = {"flops": cost.flops, "peak": cost.bytes_per_device,
                     "inputs": 256 * 1024 * 4 + 1024 * 1024 * 4}
        from torch.distributed.tensor import Partial
        part = torch.distributed.tensor.DTensor.from_local(
            torch.empty((256, 1024)), mesh, [Partial()], run_check=False)
        c = roofline.ProgramCounter((a, part))
        with c:
            a.redistribute(mesh, [Replicate()])
            part.redistribute(mesh, [Replicate()])
            a.view(1024, 16, 64)
        res["redistribute"] = {"flops": c.cost().flops,
                               "counts": c.collectives.counts}
    with open(out, "w") as f:
        json.dump(res, f)


# ---------------------------------------------------- elementwise census
def _census_cases():
    """op class -> (JAX function, torch function, input shapes): one
    jitted JAX function a class, the same function in torch."""
    import jax
    import jax.numpy as jnp
    import torch
    import torch.nn.functional as F
    return {
        "add": (lambda x, y: x + y, lambda x, y: x + y, [(4, 8), (4, 8)]),
        "mul": (lambda x, y: x * y, lambda x, y: x * y, [(4, 8), (4, 8)]),
        "mul_scalar": (lambda x: x * 3.0, lambda x: x * 3.0, [(4, 8)]),
        "div": (lambda x, y: x / y, lambda x, y: x / y, [(4, 8), (4, 8)]),
        "where": (lambda x, y: jnp.where(x > y, x, y),
                  lambda x, y: torch.where(x > y, x, y), [(4, 8), (4, 8)]),
        "max": (jnp.maximum, torch.maximum, [(4, 8), (4, 8)]),
        "exp": (jnp.exp, torch.exp, [(4, 8)]),
        "tanh": (jnp.tanh, torch.tanh, [(4, 8)]),
        "rsqrt": (jax.lax.rsqrt, torch.rsqrt, [(4, 8)]),
        "square": (jnp.square, torch.square, [(4, 8)]),
        "cube": (lambda x: x ** 3, lambda x: x ** 3, [(4, 8)]),
        "sum_axis": (lambda x: jnp.sum(x, axis=-1),
                     lambda x: torch.sum(x, dim=-1), [(4, 8)]),
        "sum_all": (jnp.sum, torch.sum, [(4, 8)]),
        "amax_axis": (lambda x: jnp.max(x, axis=-1),
                      lambda x: torch.amax(x, dim=-1), [(4, 8)]),
        "mean_axis": (lambda x: jnp.mean(x, axis=-1),
                      lambda x: torch.mean(x, dim=-1), [(4, 8)]),
        "convert": (lambda x: x.astype(jnp.bfloat16),
                    lambda x: x.to(torch.bfloat16), [(4, 8)]),
        "cumsum_8": (lambda x: jnp.cumsum(x, axis=-1),
                     lambda x: torch.cumsum(x, dim=-1), [(3, 8)]),
        "cumsum_100": (lambda x: jnp.cumsum(x, axis=-1),
                       lambda x: torch.cumsum(x, dim=-1), [(3, 100)]),
        "cumsum_1000": (lambda x: jnp.cumsum(x, axis=1),
                        lambda x: torch.cumsum(x, dim=1), [(2, 1000, 3)]),
        "sigmoid": (jax.nn.sigmoid, torch.sigmoid, [(4, 8)]),
        "silu": (jax.nn.silu, F.silu, [(4, 8)]),
        "gelu": (jax.nn.gelu, lambda x: F.gelu(x, approximate="tanh"),
                 [(4, 8)]),
        "softplus": (jax.nn.softplus, F.softplus, [(4, 8)]),
        "softmax": (lambda x: jax.nn.softmax(x, axis=-1),
                    lambda x: torch.softmax(x, dim=-1), [(4, 8)]),
        "logsumexp": (lambda x: jax.scipy.special.logsumexp(x, axis=-1),
                      lambda x: torch.logsumexp(x, dim=-1), [(4, 8)]),
        "view": (lambda x: x.reshape(8, 4), lambda x: x.view(8, 4),
                 [(4, 8)]),
    }


CENSUS = ["add", "mul", "mul_scalar", "div", "where", "max", "exp", "tanh",
          "rsqrt", "square", "cube", "sum_axis", "sum_all", "amax_axis",
          "mean_axis", "convert", "cumsum_8", "cumsum_100", "cumsum_1000",
          "sigmoid", "silu", "gelu", "softplus", "softmax", "logsumexp",
          "view"]


@pytest.mark.parametrize("case", CENSUS)
def test_pointwise_flops_equal_xla(case):
    """Each op class's FLOPs as `ProgramCounter` counts the torch op (fp32
    on the CPU) equal to XLA's `cost_analysis()["flops"]` of the jitted
    JAX function: arithmetic, compares, selects and converts one an
    element, reductions one an input folded, transcendentals none (XLA
    counts them apart), the cumulative sum as XLA's rewrite of it, the
    fused activations as XLA's expansion."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro_torch.core import roofline
    jfn, tfn, shapes = _census_cases()[case]
    rng = np.random.default_rng(3)
    xs = [rng.uniform(0.5, 2.0, size=s).astype(np.float32) for s in shapes]
    ca = jax.jit(jfn).lower(*[jnp.asarray(x) for x in xs]).compile(
        ).cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    _, cost = roofline.measure(tfn, *[torch.tensor(x) for x in xs])
    assert cost.flops == float(ca.get("flops", 0.0)), (cost.flops, ca)


if __name__ == "__main__":
    _counter_world(sys.argv[1])
