"""The port stands alone: importing every module of `repro_torch` loads no
JAX and nothing of the JAX package, and the default-device entry points
refuse to run on the CPU when CUDA is absent."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as serve_mod
from repro_torch.models.model import build_model

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "repro."))
             or m == "repro")
print(len(names), bad)
assert not bad, bad
"""


def test_importing_the_port_loads_no_jax_and_no_repro():
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src)
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count = int(proc.stdout.split()[0])
    assert count >= 20          # every module was imported


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.resolve_device("cuda")
    assert repro_torch.resolve_device("cpu").type == "cpu"


def test_build_model_defaults_to_the_card(no_cuda):
    cfg = get_config("phi4-mini-3.8b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    assert build_model(cfg, "cpu").device.type == "cpu"


def test_serve_launcher_defaults_to_the_card(no_cuda):
    argv = ["--arch", "phi4-mini-3.8b", "--reduced", "--batch", "1",
            "--prompt-len", "4", "--gen", "1"]
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_mod.main(argv)


def test_params_from_numpy_defaults_to_the_card(no_cuda):
    tree = {"embed": np.zeros((4, 2), np.float32)}
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy(tree)
    assert params_from_numpy(tree, "cpu")["embed"].device.type == "cpu"


def test_mamba2_serve_defaults_to_the_card(no_cuda):
    """The SSM slice's entry point refuses the CPU unless asked, like the
    others; `ops.ssd_scan` on a CPU tensor is the plain version, counted
    as no launch."""
    from repro_torch.kernels import ops
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_mod.serve(arch="mamba2-2.7b", reduced=True, batch=1,
                        prompt_len=4, gen=1)
    ops.reset_launch_counts()
    x = torch.zeros((1, 3, 2, 4))
    y = ops.ssd_scan(x, torch.ones((1, 3, 2)), torch.zeros(2),
                     torch.zeros((1, 3, 1, 4)), torch.zeros((1, 3, 1, 4)))
    assert y.shape == x.shape and ops.launch_counts()["ssd_scan"] == 0


def test_tuner_modules_load_without_jax():
    """The tuner, the timing helper, the health counters and the
    block-sparse path load without JAX, and `repro_torch.sparse` can be
    the first module a process imports (no import cycle through core)."""
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src)
    code = (
        "import sys\n"
        "from repro_torch.sparse.layout import BlockSparseLayout\n"
        "import repro_torch.launch.tune, repro_torch.tune.calibrate\n"
        "import repro_torch.bench.timing, repro_torch.guard.health\n"
        "import repro_torch.kernels.block_sparse_matmul\n"
        "bad = [m for m in sys.modules if m == 'jax' or m == 'repro'\n"
        "       or m.startswith(('jax.', 'jaxlib', 'repro.'))]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_tune_launcher_and_benches_default_to_the_card(no_cuda, tmp_path):
    """`launch.tune` and the wall-clock benches of every `tune_*` run on the
    card unless told otherwise, and raise without one."""
    from repro_torch.launch import tune as tune_cli
    from repro_torch.sparse.layout import BlockSparseLayout
    from repro_torch.tune import tuner
    path = str(tmp_path / "c.json")
    with pytest.raises(RuntimeError, match="CUDA"):
        tune_cli.main(["--suite", "decode", "--total", "64", "--cache", path])
    lay = BlockSparseLayout.random(64, 256, (32, 128), 0.5)
    for call in (lambda **kw: tuner.tune_dense(64, 64, 64, **kw),
                 lambda **kw: tuner.tune_decode(64, 64, **kw),
                 lambda **kw: tuner.tune_sparse(lay, 64, **kw),
                 lambda **kw: tuner.tune_grouped(2, 64, 64, 64, **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call(top=1)
        entry = call(top=1, device="cpu")
        first = entry[0] if isinstance(entry, list) else entry
        assert first.measured_us > 0


def test_make_host_mesh_defaults_to_the_card(no_cuda):
    from repro_torch.launch import mesh
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_host_mesh()
    # the production mesh needs its 256 ranks: refused before any group
    with pytest.raises(ValueError, match="256 ranks"):
        mesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        mesh.make_production_mesh(multi_pod=True, device="cpu")
