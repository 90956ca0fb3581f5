"""`build_model`: family dispatch and parameter bytes."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    device: torch.device
    # init(seed) -> params drawn from a torch.Generator seeded with `seed`
    init: Callable[[int], Any]
    # hidden_fn(params, batch) -> hidden (B, T, D)
    hidden_fn: Callable[[Any, dict], torch.Tensor]
    # logits_fn(params, hidden) -> fp32 logits
    logits_fn: Callable[[Any, torch.Tensor], torch.Tensor]


def build_model(cfg: ModelConfig | str, device=None) -> ModelBundle:
    """Bundle for a dense decoder LM.  `device` defaults to the card and
    raises when CUDA is absent (pass device="cpu" to run on the CPU)."""
    if isinstance(cfg, str):
        cfg = get_config(cfg)
    if cfg.family not in ("dense",):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    dev = resolve_device(device)

    def init(seed: int = 0):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return transformer.init_lm(cfg, gen, dev)

    return ModelBundle(
        cfg=cfg, device=dev, init=init,
        hidden_fn=lambda p, batch: transformer.forward_hidden(
            p, cfg, batch["tokens"]),
        logits_fn=lambda p, h: transformer.unembed(p, cfg, h),
    )


def param_bytes(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return sum(param_bytes(v) for v in params)
