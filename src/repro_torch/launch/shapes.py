"""The assigned input-shape cells and per-cell applicability rules."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    mode: str              # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# long_500k runs ONLY for sub-quadratic archs (SSM / hybrid) per the brief.
_LONG_OK = {"mamba2-2.7b", "recurrentgemma-9b"}


def applicable(arch: str, cfg: ModelConfig, shape: str) -> bool:
    if shape == "long_500k":
        return arch in _LONG_OK
    return True


def cells(arch_ids: list[str], get_config) -> list[tuple[str, str]]:
    out = []
    for a in arch_ids:
        cfg = get_config(a)
        for s in SHAPES:
            if applicable(a, cfg, s):
                out.append((a, s))
    return out


def microbatches_for(cfg: ModelConfig, cell: ShapeCell) -> int:
    """Grad-accum count for train cells: target <= ~128k global tokens per
    microbatch (activation-memory budget at 4k seq)."""
    if cell.mode != "train":
        return 1
    tokens = cell.seq_len * cell.global_batch
    target = 128 * 1024
    return max(1, tokens // target)
