"""`build_model`: family dispatch, parameter bytes and counts, and the
MODEL_FLOPS accounting."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.models import encdec, transformer


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    device: torch.device
    # init(seed) -> params drawn from a torch.Generator seeded with `seed`
    init: Callable[[int], Any]
    # hidden_fn(params, batch) -> (hidden (B, T, D), aux_loss)
    hidden_fn: Callable[[Any, dict], tuple[torch.Tensor, torch.Tensor]]
    # logits_fn(params, hidden) -> fp32 logits
    logits_fn: Callable[[Any, torch.Tensor], torch.Tensor]


def _init_fn(cfg: ModelConfig):
    return encdec.init_encdec if cfg.family == "encdec" else \
        transformer.init_lm


def build_model(cfg: ModelConfig | str, device=None) -> ModelBundle:
    """Bundle for every family: a decoder LM (dense, MoE with GQA or MLA
    attention, the RG-LRU hybrid, the Mamba-2 SSM, or the VLM backbone,
    whose batch may carry ``prefix_embeds`` (B, F, D)) or the
    encoder-decoder (its batch carries ``frames`` (B, F, D)).  `device`
    defaults to the card and raises when CUDA is absent (pass
    device="cpu" to run on the CPU)."""
    if isinstance(cfg, str):
        cfg = get_config(cfg)
    dev = resolve_device(device)
    init_fn = _init_fn(cfg)

    def init(seed: int = 0):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return init_fn(cfg, gen, dev)

    if cfg.family == "encdec":
        def hidden_fn(params, batch):
            return encdec.forward_hidden(params, cfg, batch["tokens"],
                                         batch["frames"])
    else:
        def hidden_fn(params, batch):
            return transformer.forward_hidden(
                params, cfg, batch["tokens"],
                prefix_embeds=batch.get("prefix_embeds"))

    return ModelBundle(
        cfg=cfg, device=dev, init=init, hidden_fn=hidden_fn,
        logits_fn=lambda p, h: transformer.unembed(p, cfg, h),
    )


def param_bytes(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return sum(param_bytes(v) for v in params)


# ------------------------------------------------------------- accounting
def count_params(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return sum(count_params(v) for v in params)


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree on the meta device: shapes and dtypes, nothing
    allocated."""
    return _init_fn(cfg)(cfg, None, "meta")


def _stacked_leaves(tree, names: tuple = ()):
    """(key path, elements, ndim) of every leaf as the JAX package's tree
    holds it: a per-layer list is one stacked leaf per key path, its
    elements summed over the layers and one dim added for the layer
    axis."""
    if isinstance(tree, torch.Tensor):
        yield names, tree.numel(), tree.dim()
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _stacked_leaves(v, names + (k,))
    else:
        per_layer = [list(_stacked_leaves(t, names)) for t in tree]
        for same in zip(*per_layer):
            yield same[0][0], sum(n for _, n, _ in same), same[0][2] + 1


def count_params_active(cfg: ModelConfig, shapes=None) -> tuple[int, int]:
    """(total_params, active_params): MoE expert stacks count k/E active.
    An expert stack is a ``w_gate`` / ``w_up`` / ``w_down`` leaf of three
    or more dims (layer axis included) under a ``moe`` key, as in the JAX
    package's tree."""
    shapes = shapes if shapes is not None else param_shapes(cfg)
    total = active = 0
    ratio = (cfg.n_experts_per_tok / cfg.n_experts) if cfg.n_experts else 1.0
    for names, n, ndim in _stacked_leaves(shapes):
        total += n
        is_expert = any(nm in ("w_gate", "w_up", "w_down") for nm in names) \
            and ndim >= 3 and "moe" in names
        active += int(n * ratio) if is_expert else n
    return total, active


def model_flops(cfg: ModelConfig, *, tokens: int, mode: str = "train",
                shapes=None) -> float:
    """MODEL_FLOPS: 6*N*D train (N active for MoE), 2*N*D for a forward or
    decode pass; the embedding lookup is left out, a tied LM head's
    (d x V) matmul counted once."""
    total, active = count_params_active(cfg, shapes)
    embed = cfg.vocab_size * cfg.d_model
    n = active - embed
    mult = 6.0 if mode == "train" else 2.0
    n = n + (0 if not cfg.tie_embeddings else embed)
    return mult * n * tokens
