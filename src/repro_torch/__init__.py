"""PyTorch/CUDA port of the skew-aware planned-matmul system.

The package mirrors `repro` module for module: `configs` (architecture
registry), `core` (chip models, cost model, planner, matmul config,
epilogues, the planned `matmul`), `kernels` (hand-written Hopper kernels,
each beside its plain PyTorch version), `models`, `serve` and `launch`.

It imports `torch` and numpy only.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``; asking for CUDA where there is
none raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: the card unless told otherwise.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and no CUDA device is present — nothing silently falls back.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev
