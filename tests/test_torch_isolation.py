"""The port stands alone: importing every module of `repro_torch` loads no
JAX and nothing of the JAX package, and the default-device entry points
refuse to run on the CPU when CUDA is absent."""

import os
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.configs.base import get_config
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
