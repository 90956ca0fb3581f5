"""The port's planned-matmul ops (plain versions on the CPU) against the JAX
package's ops in Pallas interpret mode: same explicit plans, every
schedule and split-K, the epilogues on the model path.

Tolerances: fp32 throughout, rtol = atol = 1e-5 (both sum the same k
blocks in fp32, in the same order; only the inner dot's order differs).
Split-K with integer-valued inputs is compared bitwise.  Interpret mode
costs seconds per call, so the JAX side runs about a dozen calls.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.costmodel import BlockPlan as JPlan
from repro.core.epilogue import Epilogue as JEpilogue
from repro.kernels import ops as jops
from repro_torch.core import epilogue as ep_mod
from repro_torch.core.config import mm_config
from repro_torch.core.costmodel import BlockPlan
from repro_torch.core.epilogue import Epilogue
from repro_torch.kernels import gemv_splitk, ops, ref
from repro_torch.kernels import grouped_matmul as gmm
from repro_torch.kernels import skew_matmul as mm

RNG = np.random.default_rng(21)
RTOL = ATOL = 1e-5


def _arr(*shape, scale=0.3):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _eps(spec, bias, res):
    """The same epilogue for both packages from numpy operands."""
    if spec is None:
        return None, None
    act = next((t for t in spec.split("_") if t in ("gelu", "silu")), None)
    kw = {}
    if "bias" in spec:
        kw["bias"] = bias
    if "residual" in spec:
        kw["residual"] = res
    j = JEpilogue(act=act, **{k: jnp.asarray(v) for k, v in kw.items()})
    t = Epilogue(act=act, **{k: torch.tensor(v) for k, v in kw.items()})
    return j, t


# (schedule, blocks, (m, k, n), epilogue)
DENSE_CASES = [
    ("k_inner", (8, 128, 128), (20, 384, 200), None),
    ("k_inner", (8, 128, 128), (20, 384, 200), "bias_gelu"),
    ("a_resident", (8, 128, 128), (20, 384, 200), "silu"),
    ("a_resident", (8, 384, 128), (20, 384, 200), "residual"),
    ("b_resident", (8, 128, 128), (20, 384, 200), "gelu"),
    ("splitk", (24, 128, 128), (5, 384, 200), "bias_gelu"),
    ("splitk", (8, 128, 128), (5, 384, 200), "residual"),
]


@pytest.mark.parametrize("schedule,blocks,dims,spec", DENSE_CASES)
def test_skew_matmul_matches_jax_interpret(schedule, blocks, dims, spec):
    m, k, n = dims
    a, b = _arr(m, k), _arr(k, n)
    bias, res = _arr(n), _arr(m, n)
    jep, tep = _eps(spec, bias, res)
    want = jops.skew_matmul(jnp.asarray(a), jnp.asarray(b),
                            plan=JPlan(*blocks, schedule=schedule),
                            epilogue=jep, interpret=True)
    # Plan under the reference chip so the granule clipping (8 / 128)
    # gives both packages the same blocks, hence the same k blocks.
    with mm_config(chip="tpu_v5e"):
        got = ops.skew_matmul(torch.tensor(a), torch.tensor(b),
                              plan=BlockPlan(*blocks, schedule=schedule),
                              epilogue=tep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_batched_matches_jax_interpret():
    nb, m, k, n = 3, 20, 256, 130
    a, b, res = _arr(nb, m, k), _arr(k, n), _arr(nb, m, n)
    jep, tep = _eps("silu_residual", None, res)
    want = jops.skew_matmul_batched(
        jnp.asarray(a), jnp.asarray(b),
        plan=JPlan(8, 128, 128, batch_grid=True), epilogue=jep,
        interpret=True)
    with mm_config(chip="tpu_v5e"):
        got = ops.skew_matmul_batched(
            torch.tensor(a), torch.tensor(b),
            plan=BlockPlan(8, 128, 128, batch_grid=True), epilogue=tep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_splitk_bitwise_equal_to_jax_for_integer_inputs():
    m, k, n = 8, 512, 128
    a = RNG.integers(-8, 8, (m, k)).astype(np.float32)
    b = RNG.integers(-8, 8, (k, n)).astype(np.float32)
    want = jops.skew_matmul(jnp.asarray(a), jnp.asarray(b),
                            plan=JPlan(8, 128, 128, schedule="splitk"),
                            interpret=True)
    for bk in (64, 128, 256, 512):
        with mm_config(chip="tpu_v5e"):
            got = ops.skew_matmul(torch.tensor(a), torch.tensor(b),
                                  plan=BlockPlan(8, bk, 128, "splitk"))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------- port-only
@pytest.mark.parametrize("n_splits", list(range(1, 71)))
def test_tree_sum_matches_reference_order(n_splits):
    from repro.kernels.gemv_splitk import tree_sum as jtree
    parts = _arr(n_splits, 3, 5)
    got = gemv_splitk.tree_sum(torch.tensor(parts)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jtree(jnp.asarray(parts))))


@pytest.mark.parametrize("spec", [None, "silu", "gelu", "bias_gelu",
                                  "residual", "silu_residual"])
@pytest.mark.parametrize("schedule", ["k_inner", "a_resident", "b_resident",
                                      "splitk"])
def test_ops_match_oracle_at_h100_blocks(schedule, spec):
    """The gpu_h100 granules (64) with ragged dims: the plain versions
    against the one-matmul oracle."""
    m, k, n = (4 if schedule == "splitk" else 70), 200, 150
    a, b = torch.tensor(_arr(m, k)), torch.tensor(_arr(k, n))
    bias, res = torch.tensor(_arr(n)), torch.tensor(_arr(m, n))
    ep = Epilogue.parse(spec, bias=bias, residual=res)
    got = ops.skew_matmul(a, b, plan=BlockPlan(64, 64, 128, schedule),
                          epilogue=ep)
    want = ref.matmul_epilogue_ref(a, b, epilogue=ep)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("batched", [False, True])
def test_ops_plan_themselves_when_no_plan_is_given(batched):
    """plan=None plans through the mm_config stack (gpu_h100 by default);
    CPU tensors run the plain versions and launch nothing."""
    ops.reset_launch_counts()
    shape = (3, 5, 96) if batched else (5, 96)
    a, b = torch.tensor(_arr(*shape)), torch.tensor(_arr(96, 80))
    fn = ops.skew_matmul_batched if batched else ops.skew_matmul
    got = fn(a, b, epilogue="silu")
    want = ref.matmul_epilogue_ref(a, b, epilogue="silu")
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert not any(ops.launch_counts().values())


def test_gelu_is_the_tanh_approximation():
    import jax
    z = np.linspace(-6, 6, 101).astype(np.float32)
    got = ep_mod.apply_spec(torch.tensor(z), (("gelu", None),), {})
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.nn.gelu(z)),
                               rtol=1e-6, atol=1e-6)


def test_cuda_wrappers_refuse_cpu_tensors_never_fall_back():
    """A kernel wrapper given CPU tensors does not quietly compute: the
    CUDA entry raises, while the dispatching
    wrapper takes the plain version only because the tensor is on the
    CPU."""
    a, b = torch.zeros(4, 64), torch.zeros(64, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mm.skew_matmul_cuda(a, b, bm=64, bk=64, bn=64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gemv_splitk.gemv_splitk_partial_cuda(a, b, bm=64, bk=64, bn=64)
    out = mm.skew_matmul(a, b, bm=64, bk=64, bn=64)
    assert out.device.type == "cpu"
    assert mm.LAUNCHES["skew_matmul_k_inner"] == 0


def test_epilogue_parse_validation():
    with pytest.raises(ValueError):
        Epilogue.parse("bias_gelu")
    with pytest.raises(ValueError):
        ep_mod.normalize_spec("gelu_silu")
    assert Epilogue.parse("silu").spec == (("silu", None),)


# ---------------------------------------------------------- grouped (K5)
# (blocks, epilogue): g 3, m 20, k 200, n 130 — ragged against every
# block.  The first three plans cover a whole group (one grid step per
# group in interpret mode); the last splits k in two.
GROUPED_CASES = [
    ((24, 256, 256), None),
    ((24, 256, 256), "gelu"),
    ((24, 256, 256), "residual"),
    ((24, 128, 256), "scale"),
]


@pytest.mark.parametrize("blocks,spec", GROUPED_CASES)
def test_grouped_matmul_matches_jax_interpret(blocks, spec):
    g, m, k, n = 3, 20, 200, 130
    a, b, res = _arr(g, m, k), _arr(g, k, n), _arr(g, m, n)
    kw = {"residual": res} if spec == "residual" else {}
    if spec == "scale":
        kw = {"scale": 0.5}
    act = spec if spec == "gelu" else None
    jep = JEpilogue(act=act, **{key: jnp.asarray(v) if key == "residual"
                                else v for key, v in kw.items()})
    tep = Epilogue(act=act, **{key: torch.tensor(v) if key == "residual"
                               else v for key, v in kw.items()})
    want = jops.grouped_matmul(jnp.asarray(a), jnp.asarray(b),
                               plan=JPlan(*blocks), backend="pallas",
                               epilogue=jep, out_dtype=jnp.float32,
                               interpret=True)
    # Under the reference chip the granule clipping (8 / 128) gives both
    # packages the same blocks, hence the same k blocks.
    with mm_config(chip="tpu_v5e", backend="cuda"):
        got = ops.grouped_matmul(torch.tensor(a), torch.tensor(b),
                                 plan=BlockPlan(*blocks), epilogue=tep,
                                 out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("spec", [None, "gelu", "silu", "residual",
                                  "silu_residual"])
def test_grouped_ops_match_oracle_at_h100_blocks(backend, spec):
    """Planned under gpu_h100 (64 granules) with ragged m, k, n: both
    backends against the one-product oracle; each call records its plan
    into the capture and launches nothing on the CPU."""
    from repro_torch.core import skewmm
    from repro_torch.sparse.costmodel import SparseMatmulCost
    ops.reset_launch_counts()
    g, m, k, n = 4, 40, 300, 150
    a, b = torch.tensor(_arr(g, m, k)), torch.tensor(_arr(g, k, n))
    res = torch.tensor(_arr(g, m, n))
    ep = Epilogue.parse(spec, residual=res)
    with skewmm.plan_capture() as log, mm_config(backend=backend):
        got = ops.grouped_matmul(a, b, epilogue=ep)
    want = ref.grouped_matmul_ref(a, b, epilogue=ep)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert len(log) == 1 and isinstance(log[0], SparseMatmulCost)
    assert log[0].layout.groups == g and log[0].n == n
    assert ops.launch_counts()["grouped_matmul"] == 0


def test_grouped_plain_sums_k_blocks_in_order():
    """The plain version is the kernel's arithmetic: fp32 partial products
    over k blocks of width bk, added in order."""
    a, b = torch.tensor(_arr(2, 5, 150)), torch.tensor(_arr(2, 150, 70))
    got = gmm.grouped_matmul_plain(a, b, bk=64)
    want = (a[..., :64] @ b[:, :64] + a[..., 64:128] @ b[:, 64:128]) \
        + a[..., 128:] @ b[:, 128:]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_grouped_refuses_bias_and_cpu_tensors_in_the_kernel_entry():
    a, b = torch.zeros(2, 8, 64), torch.zeros(2, 64, 64)
    with pytest.raises(ValueError, match="bias"):
        ops.grouped_matmul(a, b, epilogue=Epilogue(bias=torch.zeros(64)))
    with pytest.raises(ValueError, match="mismatch"):
        ops.grouped_matmul(a, torch.zeros(3, 64, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        gmm.grouped_matmul_cuda(a, b, bm=64, bk=64, bn=64)
    out = gmm.grouped_matmul(a, b, bm=64, bk=64, bn=64)
    assert out.device.type == "cpu" and out.shape == (2, 8, 64)
    assert gmm.LAUNCHES["grouped_matmul"] == 0


def test_grouped_explicit_plan_records_nothing():
    """As in the JAX package, only a call that plans records a plan."""
    from repro_torch.core import skewmm
    a, b = torch.tensor(_arr(2, 8, 64)), torch.tensor(_arr(2, 64, 64))
    with skewmm.plan_capture() as log:
        ops.grouped_matmul(a, b, plan=BlockPlan(64, 64, 64))
    assert log == []
