"""Roofline terms of a traced program.

Per the reproduction brief, for one device:

    compute term    = FLOPs / peak_FLOP/s
    memory term     = bytes / HBM_bw
    collective term = collective_bytes / (link_bw * links)

The JAX package reads FLOPs and bytes from a compiled XLA executable
(`cost_analysis()` of the per-device SPMD module) and parses collectives
out of its HLO text.  The port has no compiled module: `measure` runs the
program under `ProgramCounter`, one dispatch mode that sees what rank 0
runs.  Under `FakeTensorMode` on a fake process group nothing is computed
or sent, so a 256- or 512-rank mesh is priced on one host.

`ProgramCounter` lets each `DTensor` op desugar first (it returns
NotImplemented to the subclass, as `CommDebugMode` does) and then counts
the local ops and collectives that op becomes on rank 0:

  * flops: the local ops' FLOPs by `torch.utils.flop_counter`'s formulas
    (GEMMs, attention) and, for pointwise, reduction and scan ops, what
    XLA's cost analysis gives the same function (`pointwise_flops`;
    transcendentals, data movement and collectives count 0), so per
    device: a sharded op at its local shape, replicated work and the ops
    the port runs on a rank's own block (attention, the embedding lookup,
    MoE experts) as each device runs them;
  * bytes: each local op's input + output bytes, views and metadata
    queries excluded: the unfused eager traffic the port moves (XLA's
    "bytes accessed" is of a fused module);
  * collectives: each `_c10d_functional` / `c10d` collective mapped to
    the five HLO kinds, its local output bytes times `_WIRE_FACTOR` (a
    functional collective's `wait_tensor` is not counted again, as the
    HLO parser skips `-done`);
  * bytes_per_device: the peak of rank 0's live local storage, the
    program's inputs included (the counterpart of XLA's
    `memory_analysis()`).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core import hw

# bytes-on-wire multiplier per collective, ring algorithm, large-N limit:
#   all-gather: each device sends its shard N-1 times -> (N-1)/N ~ 1x output
#   all-reduce: reduce-scatter + all-gather -> 2x
#   reduce-scatter: 1x input shard traffic ~ 1x
#   all-to-all: (N-1)/N ~ 1x
#   collective-permute: 1x
_WIRE_FACTOR = {
    "all-gather": 1.0,
    "all-reduce": 2.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "c128": 16, "s4": 1, "u4": 1,
}

# torch collective op name -> (HLO kind, where its output is): "out" the
# functional op's result, "arg" its first argument (c10d's in-place ops).
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", "out"),
    "all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "all_reduce": ("all-reduce", "out"),
    "all_reduce_coalesced": ("all-reduce", "out"),
    "reduce_scatter_tensor": ("reduce-scatter", "out"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "out"),
    "all_to_all_single": ("all-to-all", "out"),
    "shard_dim_alltoall": ("all-to-all", "out"),
    "allgather_": ("all-gather", "arg"),
    "_allgather_base_": ("all-gather", "arg"),
    "allgather_into_tensor_coalesced_": ("all-gather", "arg"),
    "allreduce_": ("all-reduce", "arg"),
    "allreduce_coalesced_": ("all-reduce", "arg"),
    "reduce_scatter_": ("reduce-scatter", "arg"),
    "_reduce_scatter_base_": ("reduce-scatter", "arg"),
    "alltoall_": ("all-to-all", "arg"),
    "alltoall_base_": ("all-to-all", "arg"),
    "send": ("collective-permute", "arg"),
    "recv_": ("collective-permute", "arg"),
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "c10d", "_dtensor")


@dataclasses.dataclass
class CollectiveStats:
    counts: dict[str, int]
    bytes_by_kind: dict[str, float]   # wire bytes per device

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


@dataclasses.dataclass
class ProgramCost:
    """What one device does in a program: FLOPs, bytes moved, collective
    wire bytes and counts, and peak live bytes.  `gemm_flops` is the part
    of `flops` that GEMMs and attention do (`flop_registry`'s formulas),
    the elementwise ops' FLOPs aside."""
    flops: float
    bytes: float
    collective_bytes: float
    collective_counts: dict[str, int]
    bytes_per_device: int
    gemm_flops: float = 0.0


def tensors(tree, out: list | None = None) -> list[torch.Tensor]:
    """The tensors in a tree of lists, tuples and dicts."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            tensors(x, out)
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "placements") else t


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


_SHARDING_PROP_FILES = ("_sharding_prop.py", "_op_schema.py")


def _in_sharding_propagation() -> bool:
    """Whether the op being dispatched is DTensor's own shape propagation:
    it runs each new op once on global-shape fake tensors to learn its
    output's shape, work no device does."""
    f = sys._getframe(2)
    for _ in range(12):
        if f is None:
            return False
        if f.f_code.co_filename.endswith(_SHARDING_PROP_FILES):
            return True
        f = f.f_back
    return False


# FLOPs an element of an elementwise op's output costs, as XLA's
# HloCostAnalysis counts the same function: one for each arithmetic,
# compare, select or convert op XLA runs for it.  Transcendentals (exp,
# log, tanh, rsqrt, pow, erf ...) XLA counts in a field of their own, not
# in "flops", so they are absent here, and so are data movement (views,
# copies, gathers, concatenation, padding) and collectives.  A fused torch
# op counts what XLA's expansion of it does (silu = x * logistic(x), and
# XLA expands the logistic to 1 / (1 + exp(-x)); gelu is the tanh form).
_PER_ELEMENT = {
    **dict.fromkeys((
        "add", "add_", "sub", "sub_", "rsub", "mul", "mul_", "div", "div_",
        "neg", "abs", "reciprocal", "maximum", "minimum", "clamp",
        "clamp_", "clamp_min", "clamp_max", "where", "masked_fill",
        "masked_fill_", "eq", "ne", "gt", "ge", "lt", "le", "bitwise_and",
        "bitwise_or", "bitwise_not", "logical_and", "logical_or",
        "logical_not", "sign", "floor", "ceil", "round", "remainder",
        "fmod", "tril", "triu", "lerp"), 1),
    "sigmoid": 3, "sigmoid_backward": 3, "tanh_backward": 3,
    "silu": 4, "silu_backward": 9, "gelu": 8, "gelu_backward": 20,
    "softplus": 6, "softplus_backward": 7,
}
# reductions: one op for each input element folded into an output
_REDUCE = {"sum", "amax", "amin", "max", "min", "prod", "nansum"}


def _xla_cumsum(n: int) -> int:
    """XLA's count for a cumulative sum along a length-n row: a reduce
    window of n - 1 adds an output up to 16, else the rewrite into blocks
    of 16 (padded; the block sums scanned the same way)."""
    if n <= 16:
        return n * (n - 1)
    m = -(-n // 16)
    return 256 * m + (m * m - 1 if m <= 16 else _xla_cumsum(m))


def pointwise_flops(func, args, kwargs, out: torch.Tensor) -> float:
    """XLA's FLOPs for one pointwise, reduction or scan aten op (0 for any
    other op without a `flop_registry` formula)."""
    name = func._overloadpacket.__name__
    n = out.numel()
    if name in _PER_ELEMENT:
        return float(_PER_ELEMENT[name] * n)
    src = args[0] if args and isinstance(args[0], torch.Tensor) else None
    if name in ("_to_copy", "copy_"):
        # a convert when the dtype changes, a copy (no FLOPs) otherwise
        src = args[1] if name == "copy_" else src
        return float(n) if src is not None and src.dtype != out.dtype \
            else 0.0
    if src is None:
        return 0.0
    if name in _REDUCE:
        return float(src.numel() - n) if n <= src.numel() else 0.0
    if name == "mean":
        return float(src.numel())              # the adds and one divide
    if name == "pow":
        e = args[1] if len(args) > 1 else kwargs.get("exponent")
        if isinstance(e, (int, float)) and float(e).is_integer() and e:
            return float((abs(int(e)) - 1 + (e < 0)) * n)
        return 0.0                             # a transcendental power
    if name in ("cumsum", "cumsum_"):
        dim = args[1] if len(args) > 1 else kwargs["dim"]
        length = src.shape[dim] if src.dim() else 1
        return float(_xla_cumsum(length) * (n // max(length, 1)))
    if name == "_softmax":                     # max, sub, sum, divide
        rows = n // src.shape[args[1]]
        return float(2 * n + 2 * (n - rows))
    if name == "_softmax_backward_data":       # y * (g - sum(g * y))
        rows = n // src.shape[args[2]]
        return float(3 * n + n - rows)
    if name == "logsumexp":
        rows = out.numel()
        return float(src.numel() + 2 * (src.numel() - rows) + 4 * rows)
    if name in ("index_add", "index_add_", "scatter_add", "scatter_add_"):
        return float(args[3].numel())          # one add an update
    if name in ("index_put", "index_put_") and (
            args[3] if len(args) > 3 else kwargs.get("accumulate", False)):
        return float(args[2].numel())
    return 0.0


class ProgramCounter(TorchDispatchMode):
    """Counts rank 0's local work (see the module docstring).  `inputs`
    (any tree of tensors or `DTensor`s) are live from the start."""

    def __init__(self, inputs: Any = ()):
        super().__init__()
        self.flops = 0.0
        self.gemm_flops = 0.0
        self.bytes = 0.0
        self.collectives = CollectiveStats({}, {})
        self.live = 0
        self.peak = 0
        self._held: dict[int, int] = {}
        self._track([_local(t) for t in tensors(inputs)])

    # ------------------------------------------------------------ memory
    def _release(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    def _track(self, ts) -> None:
        for t in ts:
            if t.device.type == "meta":
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._held:
                continue
            n = st.nbytes()
            self._held[key] = n
            self.live += n
            weakref.finalize(st, self._release, key)
        self.peak = max(self.peak, self.live)

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(getattr(t, "__name__", "") == "DTensor" for t in types):
            # let DTensor desugar into local ops and collectives, which
            # come back through this mode
            return NotImplemented
        out = func(*args, **kwargs)
        outs = tensors(out)
        if _in_sharding_propagation() or (
                outs and all(t.device.type == "meta" for t in outs)):
            # DTensor's own propagation, or shapes built on the meta
            # device (a cache tree's specs): work no device does
            return out
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns in _COLLECTIVE_NS and name in _COLLECTIVES:
            kind, where = _COLLECTIVES[name]
            nbytes = _nbytes(tensors(out if where == "out" else args[0]))
            stats = self.collectives
            stats.counts[kind] = stats.counts.get(kind, 0) + 1
            stats.bytes_by_kind[kind] = (stats.bytes_by_kind.get(kind, 0.0)
                                         + nbytes * _WIRE_FACTOR[kind])
        elif ns not in _COLLECTIVE_NS:
            self._count(func, out, outs, args, kwargs)
        self._track(outs)
        return out

    def _count(self, func, out, outs, args, kwargs) -> None:
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            flops = formula(*args, **kwargs, out_val=out)
            self.flops += flops
            self.gemm_flops += flops
        elif outs:
            self.flops += pointwise_flops(func, args, kwargs, outs[0])
        if not outs or func.is_view:
            return          # a metadata query (prim.device) or a view
        self.bytes += _nbytes(tensors((args, kwargs))) + _nbytes(outs)

    def cost(self) -> ProgramCost:
        return ProgramCost(
            flops=float(self.flops), bytes=float(self.bytes),
            collective_bytes=float(self.collectives.total_bytes),
            collective_counts=dict(self.collectives.counts),
            bytes_per_device=int(self.peak),
            gemm_flops=float(self.gemm_flops))


def measure(fn, *args, **kwargs) -> tuple[Any, ProgramCost]:
    """(fn(*args, **kwargs), its `ProgramCost` on rank 0)."""
    counter = ProgramCounter((args, kwargs))
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.cost()


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device quantities of the traced program
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    # roofline terms, seconds
    compute_s: float
    memory_s: float
    collective_s: float
    # bookkeeping
    model_flops: float            # 6*N*D (or 6*N_active*D) for the step
    peak_flops: float
    bytes_per_device: int
    collective_counts: dict[str, int]

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """useful-model-FLOPs MFU at the roofline-limited step time."""
        if self.step_s == 0:
            return 0.0
        return (self.model_flops / self.chips / self.step_s) / self.peak_flops

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (HLO_FLOPs*chips): remat/redundancy waste detector."""
        total_hlo = self.hlo_flops * self.chips
        return self.model_flops / total_hlo if total_hlo else 0.0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        d["step_s"] = self.step_s
        d["roofline_fraction"] = self.roofline_fraction
        d["useful_ratio"] = self.useful_ratio
        return d

    def row(self) -> str:
        return (f"{self.arch:<24}{self.shape:<13}{self.mesh:<10}"
                f"compute={self.compute_s * 1e3:9.2f}ms "
                f"memory={self.memory_s * 1e3:9.2f}ms "
                f"coll={self.collective_s * 1e3:9.2f}ms "
                f"dom={self.dominant:<10} useful={self.useful_ratio:5.2f} "
                f"frac={self.roofline_fraction:5.3f}")


def analyze(cost: ProgramCost, *, arch: str, shape: str, mesh: str,
            chips: int, model_flops: float, dtype_bytes: int = 2,
            ici_links: int | None = None,
            chip: hw.ChipSpec | str | None = None) -> RooflineReport:
    """Build a RooflineReport from a measured `ProgramCost`.

    `chip` defaults to the current `mm_config` chip (`gpu_h100` unless a
    scope says otherwise); `ici_links` to the chip's own link count
    (`ChipSpec.ici_links`); pass it only to model a deliberately reduced
    topology.
    """
    if chip is None:
        from repro_torch.core import config as mmcfg
        chip = mmcfg.current().chip_spec
    chip = hw.get_chip(chip)
    if ici_links is None:
        ici_links = chip.ici_links
    peak = hw.peak_flops(chip, dtype_bytes)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        hlo_flops=cost.flops, hlo_bytes=cost.bytes,
        collective_bytes=cost.collective_bytes,
        compute_s=cost.flops / peak,
        memory_s=cost.bytes / chip.hbm_bw,
        collective_s=cost.collective_bytes / (chip.ici_bw_per_link
                                              * ici_links),
        model_flops=model_flops,
        peak_flops=peak,
        bytes_per_device=cost.bytes_per_device,
        collective_counts=cost.collective_counts,
    )


def save_report(report: RooflineReport, path: str) -> None:
    with open(path, "w") as f:
        json.dump(report.to_json(), f, indent=2, default=float)
