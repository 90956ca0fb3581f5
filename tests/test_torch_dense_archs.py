"""The dense configs gemma2-27b, granite-34b, command-r-35b and
paper-skewmm in the port, against the JAX package.

Each config is the JAX one field for field (published and `reduced()`).
At `reduced()` sizes, with the JAX parameters carried over by
`repro_torch.convert`, prefill and six greedy decode steps of the port's
engine agree with `repro.serve.engine` on the "torch" and "cuda" backends
(the latter takes the kernels' plain versions on the CPU).  gemma2's
prompt (72) is longer than its reduced local window (64), so the window
masks bite at prefill and the local layers' 64-slot rings wrap at decode.

Tolerance (fp32 logits): rtol = atol = 1e-4, as in test_torch_serve.py —
both packages sum contractions of at most a few thousand terms in fp32 in
different orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.config import mm_config as jmm_config
from repro.models.model import build_model as jbuild_model
from repro.serve import engine as jengine
from repro_torch.configs.base import ARCH_IDS, all_arch_ids, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.config import mm_config
from repro_torch.launch import serve as serve_mod
from repro_torch.serve import engine

RTOL = ATOL = 1e-4
ARCHS = ["gemma2-27b", "granite-34b", "command-r-35b", "paper-skewmm"]
PROMPT = {"gemma2-27b": 72}        # past the reduced window of 64
STEPS = 6


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax_field_for_field(arch):
    assert arch in ARCH_IDS
    for jcfg, cfg in ((jget_config(arch), get_config(arch)),
                      (jget_config(arch).reduced(),
                       get_config(arch).reduced())):
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    if arch == "gemma2-27b":
        assert get_config(arch).reduced().local_window == 64


def test_all_arch_ids_leave_out_the_paper_config():
    assert "paper-skewmm" in ARCH_IDS
    assert "paper-skewmm" not in all_arch_ids()
    assert set(all_arch_ids()) | {"paper-skewmm"} == set(ARCH_IDS)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_jax(arch, backend):
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    b, s = 2, PROMPT.get(arch, 16)
    max_len = s + STEPS
    toks = np.random.default_rng(21).integers(0, cfg.vocab_size, (b, s))
    with jmm_config(backend="xla"):
        jcache, jlogits = jengine.prefill(jp, jcfg,
                                          jnp.asarray(toks, jnp.int32),
                                          max_len=max_len)
    with mm_config(backend=backend):
        cache, logits = engine.prefill(tp, cfg, torch.tensor(toks),
                                       max_len=max_len)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=RTOL,
                               atol=ATOL)
    tok = np.argmax(_np(jlogits), -1)
    for i in range(STEPS):
        with jmm_config(backend="xla"):
            jlogits, jcache = jengine.decode_step(
                jp, jcfg, jcache, jnp.asarray(tok, jnp.int32),
                jnp.asarray(s + i, jnp.int32))
        with mm_config(backend=backend):
            logits, cache = engine.decode_step(
                tp, cfg, cache, torch.tensor(tok),
                torch.tensor(s + i, dtype=torch.int32))
        np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=RTOL,
                                   atol=ATOL)
        tok = np.argmax(_np(jlogits), -1)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["stage0"]["b0"][name].numpy(),
                                   _np(jcache["stage0"]["b0"][name]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_launcher_serves_every_arch_on_cpu(arch):
    res = serve_mod.main(["--arch", arch, "--reduced", "--batch", "2",
                          "--prompt-len", "6", "--gen", "3",
                          "--device", "cpu"])
    assert tuple(res["tokens"].shape) == (2, 3)
    assert res["logits_finite"]
    assert tuple(res["last_decode_logits"].shape) == (
        2, get_config(arch).reduced().vocab_size)
    assert res["decode_launches_per_step"] == {}
