"""The port's planner against the JAX package's: identical plans and
identical modeled seconds on the four reference chips (exact equality —
both are pure Python float arithmetic in the same order), plus the
gpu_h100 planning decision's invariants."""

import math

import pytest
import torch

from repro.core import planner as jplanner
from repro_torch.configs.base import get_config
from repro_torch.core import config, costmodel, hw, planner
from repro_torch.core.costmodel import MatmulDims
from repro_torch.kernels.gemv_splitk import SMEM_MAX as SPLITK_SMEM
from repro_torch.kernels.gemv_splitk import reduce_strip
from repro_torch.kernels.skew_matmul import SMEM_MAX, smem_bytes

REF_CHIPS = ["tpu_v5e", "ipu_gc200", "gpu_a30", "gpu_rtx2080ti"]
MODES = ["skew_aware", "dense", "k_inner", "naive"]


def _fig5_shapes():
    """benchmarks/run.py fig5: both skew families at 4096^2 elements,
    ratios 2^-8..2^8, plus the decode tail m in {1, 4, 8} against a
    4096 x 32768 weight."""
    shapes = []
    for i in range(-8, 9, 2):
        r = 2.0 ** i
        m = max(1, int(round(math.sqrt(4096 * 4096 * r))))
        other = max(1, int(round(math.sqrt(4096 * 4096 / r))))
        shapes.append((m, other, 4096))      # vary="a_aspect"
        shapes.append((m, 4096, other))      # vary="output"
    shapes += [(m, 4096, 32768) for m in (1, 4, 8)]
    return shapes


def _key(cost):
    p = cost.plan
    return (p.bm, p.bk, p.bn, p.schedule, p.batch_grid)


@pytest.mark.parametrize("chip", REF_CHIPS)
@pytest.mark.parametrize("mode", MODES)
def test_plan_equals_reference(chip, mode):
    for m, k, n in _fig5_shapes():
        for dtype_bytes in (2, 4):
            for batch in (1, 4):
                kw = dict(dtype_bytes=dtype_bytes, chip=chip, mode=mode,
                          batch=batch)
                want = jplanner.plan_matmul(m, k, n, **kw)
                got = planner.plan_matmul(m, k, n, **kw)
                assert _key(got) == _key(want), (m, k, n, kw)
                # exact, not approximate: same arithmetic, same order
                assert got.total_s == want.total_s, (m, k, n, kw)
                assert got.grid_steps == want.grid_steps
                assert got.hbm_bytes == want.hbm_bytes


def test_reference_chips_copied_unchanged():
    from repro.core import hw as jhw
    for name in REF_CHIPS:
        assert hw.get_chip(name).__dict__ == jhw.get_chip(name).__dict__


def test_default_chip_is_h100():
    cfg = config.resolve()
    assert cfg.chip_spec.name == "gpu_h100"
    assert cfg.backend == "cuda"
    c = planner.plan_matmul(512, 3072, 3072)
    assert c == planner.plan_matmul(512, 3072, 3072, chip="gpu_h100")


def _phi4_shapes():
    cfg = get_config("phi4-mini-3.8b")
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    kvd = cfg.n_kv_heads * cfg.head_dim
    out = []
    for rows, batch in ((128, 4), (1, 4), (1, 1), (512, 1), (4, 1)):
        for k, n in ((d, d), (d, kvd), (d, f), (f, d)):
            out.append((rows, k, n, batch))
    out += [(4, d, v, 1), (1, d, v, 1)]
    return out


@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_h100_plans_are_launchable(dtype_bytes):
    """A plan block is one CTA tile: blocks are 64-granular and the
    kernels' shared memory fits the card for every plan at phi4 shapes."""
    chip = hw.get_chip("gpu_h100")
    budget = int(0.45 * chip.vmem_bytes)
    tdt = {2: torch.bfloat16, 4: torch.float32}[dtype_bytes]
    for m, k, n, batch in _phi4_shapes():
        for mode in MODES:
            c = planner.plan_matmul(m, k, n, dtype_bytes=dtype_bytes,
                                    batch=batch, mode=mode)
            p = c.plan
            assert p.bm % 16 == 0 and p.bk % 16 == 0 and p.bn % 16 == 0
            if mode != "naive":
                assert c.vmem_bytes <= budget
                assert p.bm % 64 == 0 and p.bk % 64 == 0 and p.bn % 64 == 0
            assert smem_bytes(tdt, p.bm, p.bk, p.bn) <= SMEM_MAX


@pytest.mark.parametrize("m", [1, 4, 8, 63, 64])
def test_h100_family_switch_iff_modeled_win(m):
    """Split-K is chosen exactly when its best candidate out-ranks the
    dense argmin; it is only searched below the 64-row lane width."""
    chip = hw.get_chip("gpu_h100")
    k, n = 3072, 200064
    got = planner.plan_matmul(m, k, n, dtype_bytes=2)
    if not planner.gemv_applicable(m, 1, chip):
        assert got.plan.schedule != "splitk"
        return
    budget = int(0.45 * chip.vmem_bytes)
    d = MatmulDims(m=m, k=k, n=n, dtype_bytes=2)
    gemv = planner._search_gemv(d, chip, budget)
    dense = planner.plan_matmul(m, k, n, dtype_bytes=2, mode="dense")
    switch = gemv is not None and (
        planner._plan_order(gemv) < planner._plan_order(dense))
    assert (got.plan.schedule == "splitk") == switch


def test_h100_splitk_never_fits_phi4_lm_head():
    """The reference's split-K working set holds the whole (gk, bm, bn)
    slab for pass 2; under that term no split-K plan fits the ~104 KB H100
    budget at the phi4-mini LM head (k = 3072).  The H100's own term
    counts the strip K4 stages instead (see the tests below)."""
    chip = hw.get_chip("gpu_h100")
    budget = int(0.45 * chip.vmem_bytes)
    for m in (1, 4):
        d = MatmulDims(m=m, k=3072, n=200064, dtype_bytes=2)
        cands = [c for c in planner._gemv_costs(d, chip, 10**12)]
        assert cands
        assert all(c.plan.vmem_bytes(d) > budget for c in cands)


def test_splitk_stage_bytes_mirror_reduce_strip():
    """The H100 pass-2 term is K4's strip: gk x reduce_strip(gk) fp32
    partials, and past the depth where no strip fits, the strip of the
    depth the device-memory folds leave."""
    assert costmodel.SPLITK_STRIP_SMEM == {"gpu_h100": SPLITK_SMEM}
    for gk in list(range(1, 2000)) + [14527, 14528, 14529, 30000, 100000]:
        got = costmodel._reduce_stage_bytes(gk, 4, SPLITK_SMEM)
        depth = gk
        while reduce_strip(depth) == 0:
            depth = (depth + 1) // 2
        assert got == depth * reduce_strip(depth) * 4, gk
        assert got <= SPLITK_SMEM


@pytest.mark.parametrize("chip", REF_CHIPS)
def test_splitk_term_leaves_reference_chips_unchanged(chip):
    """Only gpu_h100 counts K4's strip: on the reference chips a split-K
    plan's working set is the reference's, and decode plans at phi4's
    shapes equal the JAX package's."""
    from repro.core.costmodel import BlockPlan as JBlockPlan
    from repro.core.costmodel import MatmulDims as JDims
    spec = hw.get_chip(chip)
    for m, k, n, batch in _phi4_shapes():
        for bk, bn in ((64, 64), (128, 256), (512, 1024)):
            p = planner.BlockPlan(8, bk, bn, schedule="splitk")
            jp = JBlockPlan(8, bk, bn, schedule="splitk")
            d = MatmulDims(m=m, k=k, n=n, batch=batch)
            assert p.vmem_bytes(d, spec) == jp.vmem_bytes(
                JDims(m=m, k=k, n=n, batch=batch))
        want = jplanner.plan_matmul(m, k, n, chip=chip, batch=batch)
        got = planner.plan_matmul(m, k, n, chip=chip, batch=batch)
        assert _key(got) == _key(want) and got.total_s == want.total_s


# phi4-mini's decode down projection and LM head at batch 4.
PHI4_DOWN, PHI4_LM_HEAD = (4, 8192, 3072), (4, 3072, 200064)


@pytest.mark.parametrize("shape", [PHI4_DOWN, PHI4_LM_HEAD])
def test_h100_splitk_fits_phi4_decode(shape):
    """On gpu_h100 split-K candidates now pass the budget at phi4's
    decode down projection and LM head."""
    chip = hw.get_chip("gpu_h100")
    budget = int(0.45 * chip.vmem_bytes)
    d = MatmulDims(*shape)
    best = planner._search_gemv(d, chip, budget)
    assert best is not None
    assert best.vmem_bytes <= budget
    assert best.plan.vmem_bytes(d) > budget        # the slab term would not
    assert any(c.plan.schedule == "splitk" for c in planner.enumerate_plans(
        *shape, chip="gpu_h100", top=10**6))


# (split-K plan, its device-memory bytes, k_inner plan, its bytes) as the
# model prices them on gpu_h100: both memory-bound, so bytes decide.
H100_DECODE_CHOICE = {
    PHI4_DOWN: ((64, 128, 64), 59_793_408, (64, 64, 128), 51_929_088),
    PHI4_LM_HEAD: ((64, 128, 64), 1_461_267_456, (64, 64, 128),
                   1_269_206_016),
}


@pytest.mark.parametrize("shape", [PHI4_DOWN, PHI4_LM_HEAD])
def test_h100_decode_choice_pinned(shape):
    """The model still picks k_inner at both shapes, and the memory term
    decides it: split-K re-reads A once per 64-wide n block and writes and
    reads back its fp32 partial slab (2 x gk x m x n x 4 bytes), which the
    model prices at device-memory rate."""
    sk_blocks, sk_bytes, ki_blocks, ki_bytes = H100_DECODE_CHOICE[shape]
    chip = hw.get_chip("gpu_h100")
    m, k, n = shape
    d = MatmulDims(*shape)
    gemv = planner._search_gemv(d, chip, int(0.45 * chip.vmem_bytes))
    dense = planner.plan_matmul(*shape, mode="dense")
    got = planner.plan_matmul(*shape)
    assert (gemv.plan.bm, gemv.plan.bk, gemv.plan.bn) == sk_blocks
    assert (dense.plan.bm, dense.plan.bk, dense.plan.bn) == ki_blocks
    assert gemv.hbm_bytes == sk_bytes and dense.hbm_bytes == ki_bytes
    for c in (gemv, dense):
        assert c.bound == "memory"
        assert c.total_s == c.hbm_bytes / chip.hbm_bw
    gk = -(-k // sk_blocks[1])
    gn_sk, gn_ki = -(-n // sk_blocks[2]), -(-n // ki_blocks[2])
    slab = 2 * gk * m * n * 4
    assert sk_bytes - ki_bytes == slab + m * k * 2 * (gn_sk - gn_ki)
    assert got.plan.schedule == "k_inner" and got == dense
    assert gemv.total_s > dense.total_s
