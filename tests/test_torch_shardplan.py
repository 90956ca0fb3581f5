"""The port's sharded planning against the JAX package's: the joint
(schedule x blocks x ShardSpec) search, the shard candidates, the
collective terms and the mesh knobs of `mm_config`, all equal (==) on the
four reference chips; and the port's modeled shard rows against the JAX
package's committed `benchmarks/baselines/shard.json`.

No device mesh is made: sharded planning is cost-model arithmetic.
"""

import dataclasses
import math
import os
import random

import pytest

from repro.core import config as jconfig
from repro.core import costmodel as jcm
from repro.core import planner as jplanner
from repro_torch.bench import compare, io as bench_io
from repro_torch.bench.suite import Recorder
from repro_torch.core import config, costmodel, hw, planner

REF_CHIPS = ["tpu_v5e", "ipu_gc200", "gpu_a30", "gpu_rtx2080ti"]
MESH_DEVICES = [2, 4, 8]
MODES = ["skew_aware", "skew_aware", "dense", "k_inner", "naive"]
DRAWS_PER_CASE = 170            # x 4 chips x 3 meshes = 2040 draws
BASELINES = os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks",
                         "baselines")


def _dim(rng: random.Random, top: int) -> int:
    return rng.randint(1, 2 ** rng.randint(0, top))


def _draw(rng: random.Random):
    return dict(m=_dim(rng, 11), k=_dim(rng, 11), n=_dim(rng, 11),
                batch=rng.choice([1, 1, 1, 2, 3, 4]),
                dtype_bytes=rng.choice([2, 4]))


def _spec_fields(spec):
    return None if spec is None else dataclasses.asdict(spec)


def _assert_same_cost(got, want, ctx):
    p, q = got.plan, want.plan
    assert (p.bm, p.bk, p.bn, p.schedule, p.batch_grid) == (
        q.bm, q.bk, q.bn, q.schedule, q.batch_grid), ctx
    assert _spec_fields(got.sharding) == _spec_fields(want.sharding), ctx
    assert dataclasses.asdict(got.dims) == dataclasses.asdict(want.dims), ctx
    assert (None if got.global_dims is None
            else dataclasses.asdict(got.global_dims)) == (
        None if want.global_dims is None
        else dataclasses.asdict(want.global_dims)), ctx
    # exact: the same float arithmetic in the same order
    for f in ("total_s", "compute_s", "memory_s", "overhead_s",
              "collective_s", "hidden_collective_s", "collective_bytes",
              "hbm_bytes", "vmem_bytes", "grid_steps", "mxu_utilization"):
        assert getattr(got, f) == getattr(want, f), (f, ctx)
    assert got.bound == want.bound, ctx
    assert got.explain() == want.explain().replace(
        f"vmem={want.vmem_bytes / 2**20:.2f}MiB",
        f"vmem={got.vmem_bytes / 2**10:.1f}KiB"), ctx


@pytest.mark.parametrize("devices", MESH_DEVICES)
@pytest.mark.parametrize("chip", REF_CHIPS)
def test_sharded_auto_plans_equal_reference(chip, devices):
    rng = random.Random(f"{chip}/{devices}")
    for _ in range(DRAWS_PER_CASE):
        kw = _draw(rng)
        mode = rng.choice(MODES)
        ctx = (chip, devices, mode, kw)
        want = jplanner.plan_matmul(chip=chip, mode=mode,
                                    mesh_shape=(devices,), sharding="auto",
                                    **kw)
        got = planner.plan_matmul(chip=chip, mode=mode,
                                  mesh_shape=(devices,), sharding="auto",
                                  **kw)
        _assert_same_cost(got, want, ctx)
        assert got.sharding is not None
        assert got.sharding.devices <= devices


def _random_spec(rng, pkg, devices: int, kw):
    """A random factorization of `devices` over (batch, m, k, n), with
    random partials and zero3 (an explicit spec may over-shard a dim)."""
    counts = [1, 1, 1, 1]
    left = devices
    while left > 1:
        i = rng.randrange(4)
        counts[i] *= 2
        left //= 2
    b, m, k, n = counts
    return pkg.ShardSpec(m=m, k=k, n=n, batch=b,
                         partials=rng.choice(["all_reduce",
                                              "reduce_scatter"]),
                         zero3=rng.random() < 0.3)


@pytest.mark.parametrize("chip", REF_CHIPS)
def test_sharded_explicit_spec_plans_equal_reference(chip):
    rng = random.Random(f"explicit/{chip}")
    for _ in range(120):
        kw = _draw(rng)
        devices = rng.choice(MESH_DEVICES)
        mode = rng.choice(MODES)
        state = rng.getstate()
        jspec = _random_spec(rng, jcm, devices, kw)
        rng.setstate(state)
        spec = _random_spec(rng, costmodel, devices, kw)
        assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
        assert spec.describe() == jspec.describe()
        assert spec.devices == jspec.devices == devices
        ctx = (chip, mode, spec, kw)
        want = jplanner.plan_matmul(chip=chip, mode=mode,
                                    mesh_shape=(devices,), sharding=jspec,
                                    **kw)
        got = planner.plan_matmul(chip=chip, mode=mode,
                                  mesh_shape=(devices,), sharding=spec, **kw)
        _assert_same_cost(got, want, ctx)
        assert got.sharding == spec


def test_shard_candidates_equal_reference():
    rng = random.Random(3)
    for devices in range(1, 17):
        for _ in range(20):
            m, k, n = _dim(rng, 6), _dim(rng, 6), _dim(rng, 6)
            batch = rng.randint(1, 8)
            got = planner.shard_candidates(devices, m, k, n, batch)
            want = jplanner.shard_candidates(devices, m, k, n, batch)
            assert [dataclasses.asdict(s) for s in got] == [
                dataclasses.asdict(s) for s in want]
            d = costmodel.MatmulDims(m=m, k=k, n=n, batch=batch)
            assert planner._naive_shard(devices, d) == costmodel.ShardSpec(
                **dataclasses.asdict(jplanner._naive_shard(
                    devices, jcm.MatmulDims(m=m, k=k, n=n, batch=batch))))


@pytest.mark.parametrize("chip", REF_CHIPS + ["gpu_h100"])
def test_collective_terms_field_by_field(chip):
    """collective_terms and cost_sharded_matmul, term by term, on random
    problems, plans and specs (gpu_h100 priced with the JAX package's
    arithmetic on the port's chip numbers)."""
    from repro.core import hw as jhw
    rng = random.Random(f"coll/{chip}")
    spec_t = hw.get_chip(chip)
    spec_j = jhw.ChipSpec(**dataclasses.asdict(spec_t))
    for _ in range(300):
        kw = _draw(rng)
        devices = rng.choice([2, 4, 8, 16])
        blocks = (rng.choice([8, 64, 128, 256]), rng.choice([64, 128, 512]),
                  rng.choice([64, 128, 512]))
        sched = rng.choice(costmodel.ALL_SCHEDULES)
        bg = sched == "k_inner" and kw["batch"] > 1 and rng.random() < 0.5
        state = rng.getstate()
        jspec = _random_spec(rng, jcm, devices, kw)
        rng.setstate(state)
        spec = _random_spec(rng, costmodel, devices, kw)
        d = costmodel.MatmulDims(**kw)
        jd = jcm.MatmulDims(**kw)
        p = costmodel.BlockPlan(*blocks, schedule=sched, batch_grid=bg)
        jp = jcm.BlockPlan(*blocks, schedule=sched, batch_grid=bg)
        got = costmodel.collective_terms(d, p, spec_t, spec)
        want = jcm.collective_terms(jd, jp, spec_j, jspec)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.total_bytes == want.total_bytes
        for group in (1, 2, 3, 8):
            assert costmodel._ring_wire(12345, group, 2.0) == \
                jcm._ring_wire(12345, group, 2.0)
        if chip == "gpu_h100" and sched == "splitk":
            continue        # the H100's own split-K working-set term
        cg = costmodel.cost_sharded_matmul(d, p, spec_t, spec)
        cw = jcm.cost_sharded_matmul(jd, jp, spec_j, jspec)
        _assert_same_cost(cg, cw, (chip, kw, blocks, sched, spec))
        assert cg.plan_provenance() == {
            **cw.plan_provenance(), "blocks": tuple(blocks)}
        assert cg.roofline_fraction(spec_t) == cw.roofline_fraction(spec_j)


def test_mesh_config_resolution_matches_reference():
    """The mesh knobs resolve, validate and describe themselves as in the
    JAX package; a context layer plans as the kwargs do."""
    for mesh in ((4,), (2, 2), (4, 2), (1,)):
        for sharding in (None, "auto", costmodel.ShardSpec(m=2, n=2)):
            got = config.resolve(mesh_shape=mesh, sharding=sharding)
            jsh = (jcm.ShardSpec(**dataclasses.asdict(sharding))
                   if isinstance(sharding, costmodel.ShardSpec)
                   else sharding)
            want = jconfig.resolve(mesh_shape=mesh, sharding=jsh)
            assert got.mesh_devices == want.mesh_devices == math.prod(mesh)
            assert got.mesh_shape == want.mesh_shape
            prov = {**want.provenance(), "chip": "gpu_h100",
                    "backend": "cuda"}
            assert got.provenance() == prov
    assert config.resolve().provenance() == {
        "chip": "gpu_h100", "amp": 0.45, "backend": "cuda",
        "plan_mode": "skew_aware"}
    assert config.current() == config.resolve()
    for bad in (dict(mesh_shape=()), dict(mesh_shape=(0, 2)),
                dict(sharding="rows"), dict(sharding=(2, 2))):
        with pytest.raises(ValueError):
            config.resolve(**bad)
        with pytest.raises(ValueError):
            jconfig.resolve(**bad)
    with config.mm_config(chip="tpu_v5e", mesh_shape=(2, 2),
                          sharding="auto") as cfg:
        assert cfg.mesh_devices == 4
        ctx_plan = planner.plan_matmul(256, 65536, 4096)
    kw_plan = planner.plan_matmul(256, 65536, 4096, chip="tpu_v5e",
                                  mesh_shape=(4,))
    assert ctx_plan == kw_plan
    assert kw_plan.sharding.describe() == "m1k4n1b1/all_reduce"
    single = config.resolve(mesh_shape=(1,))
    assert single.mesh_devices == 1
    assert planner.plan_matmul(512, 512, 512, mesh_shape=(1,)) == \
        planner.plan_matmul(512, 512, 512)
    assert config.resolve().replace(amp=0.3).amp == 0.3


def test_mesh_cli_flag_matches_reference():
    import argparse
    for text in (None, "", "4", "4,2", " 2 , 8"):
        assert config.parse_mesh(text) == jconfig.parse_mesh(text)
    with pytest.raises(ValueError, match="--mm-mesh"):
        config.parse_mesh("4x2")
    ap = argparse.ArgumentParser()
    config.add_cli_args(ap)
    args = ap.parse_args(["--chip", "ipu_gc200", "--mm-mesh", "4,2"])
    with config.scope_from_args(args) as cfg:
        assert cfg.mesh_shape == (4, 2) and cfg.mesh_devices == 8
        assert cfg.provenance()["mesh"] == "4x2"
        with config.scope(cfg.replace(amp=0.3)) as inner:
            assert inner.mesh_shape == (4, 2) and inner.amp == 0.3
    assert config.resolve().mesh_shape is None


def _shard_rows(rec) -> None:
    """The JAX shard suite's rows (benchmarks/run.py `shard_skewed_mm`),
    built from the port's planner: the paper's constant-|A| skew family on
    4-, 16- and 64-chip pods of each reference chip."""
    ratios = [2.0 ** i for i in (-8, -4, 0, 4, 8)]
    chips = ("tpu_v5e", "ipu_gc200", "gpu_rtx2080ti")
    total = 4096 * 4096
    spreads = {}
    for pod in (4, 16, 64):
        for name in chips:
            chip = hw.get_chip(name)
            fracs, naive_fracs, floor_all = [], [], 1
            for ratio in ratios:
                m = max(1, int(round(math.sqrt(total * ratio))))
                k = max(1, int(round(math.sqrt(total / ratio))))
                n = 4096
                single = planner.plan_matmul(m, k, n, dtype_bytes=2,
                                             chip=chip)
                with config.mm_config(chip=chip, mesh_shape=(pod,),
                                      sharding="auto"):
                    planned = planner.plan_matmul(m, k, n, dtype_bytes=2)
                    naive = planner.plan_matmul(m, k, n, dtype_bytes=2,
                                                mode="naive")
                local_s = (max(planned.compute_s, planned.memory_s)
                           + planned.overhead_s)
                floor_ok = int(planned.total_s + 1e-18 >= local_s)
                floor_all &= floor_ok
                frac = planned.roofline_fraction(chip)
                nfrac = naive.roofline_fraction(chip)
                fracs.append(frac)
                naive_fracs.append(nfrac)
                rec(f"shard_{name}_p{pod}_skew_{ratio:g}",
                    axes={"chip": name, "pod": pod, "ratio": ratio, "m": m,
                          "k": k, "n": n},
                    metrics={"planned_frac": frac, "naive_frac": nfrac,
                             "coll_frac": planned.collective_s
                             / planned.total_s,
                             "scale_speedup": single.total_s
                             / planned.total_s,
                             "devices": planned.sharding.devices,
                             "floor_ok": floor_ok},
                    info={"schedule": planned.plan.schedule,
                          "sharding": planned.sharding.describe(),
                          "bound": planned.bound},
                    plan=planned)
            spread = max(fracs) - min(fracs)
            spreads[(name, pod)] = spread
            rec(f"shard_{name}_p{pod}_spread",
                axes={"chip": name, "pod": pod},
                metrics={"planned_min": min(fracs),
                         "planned_spread": spread,
                         "naive_min": min(naive_fracs),
                         "naive_spread": max(naive_fracs) - min(naive_fracs),
                         "floor_ok": floor_all})
        if pod >= 16:
            gc, rtx = spreads[("ipu_gc200", pod)], spreads[
                ("gpu_rtx2080ti", pod)]
            rec(f"shard_p{pod}_verdict", axes={"pod": pod},
                metrics={"verdict": int(gc < rtx), "gc200_spread": gc,
                         "rtx2080ti_spread": rtx})


def test_shard_rows_pass_the_committed_baseline():
    """Every row of the JAX package's shard baseline, rebuilt by the port,
    passes `compare` with no gated failure, and the plans' provenance
    (schedule, blocks, ShardSpec) equals the baseline's.  Rows are
    recorded outside the chip's `mm_config` layer, as in the JAX suite,
    so their provenance chip is the run's default: tpu_v5e in the
    baseline, gpu_h100 here."""
    records = []
    _shard_rows(Recorder("shard", records))
    _, base = bench_io.read_baselines(BASELINES)
    base = [r for r in base if r.suite == "shard"]
    assert len(records) == len(base) == 56
    report = compare.compare(records, base)
    assert report.ok, report.summary()
    assert report.counts() == {"ok": len(report.entries)}
    by_name = {r.name: r for r in base}
    for r in records:
        want = by_name[r.name].provenance
        for f in ("amp", "plan_mode", "schedule", "blocks", "grid_steps",
                  "sharding"):
            assert getattr(r.provenance, f) == getattr(want, f), (r.name, f)
        assert (want.chip, r.provenance.chip) == ("tpu_v5e", "gpu_h100")
        assert r.provenance.mesh is None and want.mesh is None
