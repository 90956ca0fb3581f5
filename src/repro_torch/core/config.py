"""Context-scoped matmul configuration — the AMP knob set once for a block.

Poplar's ``availableMemoryProportion`` is an engine option: set once,
every matmul is planned under it.  This module gives the port's
planner the same API:

    with mm_config(amp=0.3, backend="torch"):
        logits = model(params, batch)        # every matmul re-planned

`MatmulConfig` is a frozen dataclass of the knobs every planned matmul
resolves (`backend`, `amp`, `chip`, `plan_mode`, `out_dtype`).  Resolution
is layered, innermost wins:

    defaults  <  REPRO_TORCH_MM_BACKEND env var  <  mm_config stack
              <  explicit per-call kwargs

Backends: "cuda" runs the hand-written kernels (the counterpart of the JAX
package's "pallas"); "torch" is the plain PyTorch reference rung (the
counterpart of "xla").  The default backend is "cuda" and the default chip
`gpu_h100`.  The stack is thread-local; contexts nest field-wise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Any, Iterator

from repro_torch.core import hw

BACKENDS = ("torch", "cuda")
PLAN_MODES = ("skew_aware", "dense", "k_inner", "naive", "tuned")

_ENV_BACKEND = "REPRO_TORCH_MM_BACKEND"


@dataclasses.dataclass(frozen=True)
class MatmulConfig:
    """The fully-resolved settings one planned matmul runs under.

    out_dtype=None means "the lhs dtype".  `chip` is normalized to a
    ChipSpec at construction so the planner's cache keys stay canonical.
    """

    backend: str = "cuda"
    amp: float = 0.45
    chip: hw.ChipSpec | str = "gpu_h100"
    plan_mode: str = "skew_aware"
    out_dtype: Any = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown matmul backend {self.backend!r}; "
                             f"must be one of {BACKENDS}")
        if self.plan_mode not in PLAN_MODES:
            raise ValueError(f"unknown plan_mode {self.plan_mode!r}; "
                             f"must be one of {PLAN_MODES}")
        if not 0.0 < self.amp <= 1.0:
            raise ValueError(f"amp must be in (0, 1], got {self.amp}")
        object.__setattr__(self, "chip", hw.get_chip(self.chip))

    @property
    def chip_spec(self) -> hw.ChipSpec:
        return self.chip


_FIELDS = frozenset(f.name for f in dataclasses.fields(MatmulConfig))

_TLS = threading.local()


def _layers() -> list[dict]:
    stack = getattr(_TLS, "layers", None)
    if stack is None:
        stack = _TLS.layers = []
    return stack


def _env_layer() -> dict:
    backend = os.environ.get(_ENV_BACKEND)
    return {"backend": backend} if backend else {}


def _check_fields(fields) -> None:
    bad = set(fields) - _FIELDS
    if bad:
        raise TypeError(f"unknown matmul config fields {sorted(bad)}; "
                        f"known: {sorted(_FIELDS)}")


def resolve(**explicit) -> MatmulConfig:
    """Resolve the active config, innermost layer winning field-wise.
    None values mean "unset, fall through to the context"."""
    _check_fields(explicit)
    merged = _env_layer()
    for layer in _layers():
        merged.update(layer)
    merged.update({k: v for k, v in explicit.items() if v is not None})
    return MatmulConfig(**merged)


@contextlib.contextmanager
def mm_config(**overrides) -> Iterator[MatmulConfig]:
    """Push a configuration layer for the dynamic extent of the block.
    Only the fields named (and not None) are overridden."""
    _check_fields(overrides)
    layers = _layers()
    layers.append({k: v for k, v in overrides.items() if v is not None})
    try:
        yield resolve()           # validates the merged config eagerly
    finally:
        layers.pop()


@contextlib.contextmanager
def scope(cfg: MatmulConfig | None) -> Iterator[MatmulConfig | None]:
    """Run a block under a pre-built MatmulConfig (no-op for None)."""
    if cfg is None:
        yield None
        return
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)}
    with mm_config(**fields) as resolved:
        yield resolved


# ------------------------------------------------------------------- CLI
def add_cli_args(ap) -> None:
    """Attach the shared matmul-config flags to an argparse parser."""
    ap.add_argument("--amp", type=float, default=None,
                    help="availableMemoryProportion analogue in (0, 1]")
    ap.add_argument("--chip", default=None,
                    help=f"chip to plan for: {', '.join(hw.list_chips())}")
    ap.add_argument("--mm-backend", default=None, choices=BACKENDS,
                    help="matmul backend (default: env var, then cuda)")
    ap.add_argument("--plan-mode", default=None, choices=PLAN_MODES,
                    help="planner search mode")


def scope_from_args(args):
    """mm_config(...) layer built from `add_cli_args` flags."""
    return mm_config(amp=getattr(args, "amp", None),
                     chip=getattr(args, "chip", None),
                     backend=getattr(args, "mm_backend", None),
                     plan_mode=getattr(args, "plan_mode", None))
