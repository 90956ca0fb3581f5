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
@pytest.mark.parametrize("n_splits", [1, 2, 3, 5, 7, 8])
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
