"""Context-scoped matmul configuration — the AMP knob set once for a block.

Poplar's ``availableMemoryProportion`` is an engine option: set once,
every matmul is planned under it.  This module gives the port's
planner the same API:

    with mm_config(amp=0.3, backend="torch"):
        logits = model(params, batch)        # every matmul re-planned

`MatmulConfig` is a frozen dataclass of the knobs every planned matmul
resolves (`backend`, `amp`, `chip`, `plan_mode`, `out_dtype`, and the
sharded-planning axis `mesh_shape` / `sharding`).  Resolution is layered,
innermost wins:

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
from repro_torch.core.costmodel import ShardSpec

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
    # Sharded planning: `mesh_shape` is the device mesh (a tuple of axis
    # sizes; its product is the chip count) and `sharding` how the planner
    # splits each matmul over it: "auto" (or None) searches (schedule x
    # blocks x ShardSpec) jointly, a `ShardSpec` pins the split.
    # mesh_shape=None is single-chip planning.
    mesh_shape: tuple | None = None
    sharding: Any = None

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
        if self.mesh_shape is not None:
            ms = tuple(int(s) for s in self.mesh_shape)
            if not ms or any(s < 1 for s in ms):
                raise ValueError(f"mesh_shape must be a non-empty tuple of "
                                 f"positive ints, got {self.mesh_shape!r}")
            object.__setattr__(self, "mesh_shape", ms)
        if self.sharding is not None and self.sharding != "auto" \
                and not isinstance(self.sharding, ShardSpec):
            raise ValueError(f"sharding must be None, 'auto', or a ShardSpec,"
                             f" got {self.sharding!r}")

    @property
    def chip_spec(self) -> hw.ChipSpec:
        return self.chip

    @property
    def mesh_devices(self) -> int:
        """Total chips in the configured mesh (1 when unsharded)."""
        n = 1
        for s in self.mesh_shape or ():
            n *= s
        return n

    def replace(self, **kw) -> "MatmulConfig":
        return dataclasses.replace(self, **kw)

    def provenance(self) -> dict:
        """The resolved planning knobs as a flat record-friendly dict
        (`bench.record.Provenance`); only sharded configs carry "mesh"."""
        out = {"chip": self.chip_spec.name, "amp": self.amp,
               "backend": self.backend, "plan_mode": self.plan_mode}
        if self.mesh_shape is not None:
            out["mesh"] = "x".join(str(s) for s in self.mesh_shape)
        return out


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


def current() -> MatmulConfig:
    """The config a kwarg-less matmul would resolve right now."""
    return resolve()


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
    ap.add_argument("--mm-mesh", default=None, metavar="SHAPE",
                    help="device mesh for sharded planning, comma-separated "
                         "axis sizes (e.g. 4 or 4,2); default: single-chip")


def parse_mesh(mesh: str | None) -> tuple[int, ...] | None:
    """'4,2' -> (4, 2); None / '' fall through to the context."""
    if not mesh:
        return None
    try:
        return tuple(int(s) for s in str(mesh).split(","))
    except ValueError:
        raise ValueError(f"--mm-mesh must be comma-separated ints, "
                         f"got {mesh!r}") from None


def scope_from_args(args):
    """mm_config(...) layer built from `add_cli_args` flags."""
    return mm_config(amp=getattr(args, "amp", None),
                     chip=getattr(args, "chip", None),
                     backend=getattr(args, "mm_backend", None),
                     plan_mode=getattr(args, "plan_mode", None),
                     mesh_shape=parse_mesh(getattr(args, "mm_mesh", None)))
