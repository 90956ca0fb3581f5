"""Thread-local span tree — the structured-tracing half of repro_torch.obs.

`trace_scope()` is layered exactly like `mm_config()` / `fault_scope()`:
a thread-local stack of trace layers, pushed by a contextmanager and
popped on exit, so nested scopes compose (spans always land in the
*innermost* trace) and a fresh thread starts disarmed.  Hot paths emit
spans through `span()` / `event()` / `annotate()`; all three follow the
`validate.scrub` discipline — with no scope armed they return a shared
null object and touch nothing, so tracing disarmed costs one integer
check per call site and shows no extra counters anywhere.

Span kinds emitted by the instrumented stack:

  dispatch   one guarded matmul dispatch (kernels/ops): site, dims,
             backend, epilogue; annotated along the way with the tune
             cache key, the ladder rung that delivered, the planner's
             modeled_us and (clock armed) the measured_us
  rung       one degradation-ladder attempt (guard/fallback): level,
             index, and the typed GuardError when the level failed
  plan       one planner resolution (core/planner, sparse/planner):
             mode, dims, candidate count, chosen schedule/blocks,
             modeled_us
  tune       one tuned-cache lookup (tune/runtime): cache key, hit/miss,
             the cached schedule (split-K hits are the GEMV ledger)
  validate   a pre-dispatch plan rejection (guard/validate)
  retry      a transient re-execution (guard/fallback.retry_call)
  tick       one scheduler step (children admit / prefill / decode):
             emitted once the serving scheduler is ported

The tree itself is plain data (`Span`); exporters live in
`repro_torch.obs.export` and are reachable through `Trace.export_chrome` /
`Trace.render` / `Trace.digest`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Iterator

_TLS = threading.local()
_ARM_LOCK = threading.Lock()
# Process-wide count of open trace scopes: the disarmed fast path is one
# falsy check on this int, before any thread-local attribute lookup.
_ARMED = 0


@dataclasses.dataclass
class Span:
    """One node of the trace tree.

    `modeled_us` / `measured_us` are the attribution pair: the cost
    model's prediction and the armed clock's observation for the same
    region (either may be absent).  Everything else rides in `attrs`.
    `t0_us` / `t1_us` are wall timestamps, recorded only by the wall
    clock (the sim clock keeps traces host-independent).
    """

    kind: str
    name: str
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    children: list["Span"] = dataclasses.field(default_factory=list)
    modeled_us: float | None = None
    measured_us: float | None = None
    t0_us: float | None = None
    t1_us: float | None = None

    def set(self, **attrs: Any) -> "Span":
        """Merge attributes; modeled_us / measured_us land on the typed
        fields so exporters and the drift meter find them uniformly."""
        for key in ("modeled_us", "measured_us"):
            if key in attrs:
                val = attrs.pop(key)
                if val is not None:
                    setattr(self, key, float(val))
        self.attrs.update(attrs)
        return self

    def walk(self) -> Iterator["Span"]:
        """This span and every descendant, depth-first."""
        yield self
        for child in self.children:
            yield from child.walk()

    @property
    def drift_log(self) -> float | None:
        """log(measured / modeled) when both sides exist and are
        positive — the per-span attribution residual."""
        import math

        if not self.modeled_us or not self.measured_us:
            return None
        if self.modeled_us <= 0 or self.measured_us <= 0:
            return None
        return math.log(self.measured_us / self.modeled_us)


class _NullSpan:
    """The disarmed sentinel: every mutation is a no-op."""

    __slots__ = ()

    def set(self, **attrs: Any) -> "_NullSpan":
        del attrs
        return self


NULL_SPAN = _NullSpan()
_NULL_SPAN_CTX = contextlib.nullcontext(NULL_SPAN)


class Trace:
    """One trace scope's collected span forest plus its armed clock."""

    def __init__(self, clock: Any = None):
        self.clock = clock
        self.roots: list[Span] = []

    def spans(self) -> Iterator[Span]:
        for root in self.roots:
            yield from root.walk()

    def digest(self) -> dict[str, int]:
        """Span-kind counts (plus ``total``) — the provenance fragment."""
        from repro_torch.obs import export

        return export.digest(self)

    def render(self) -> str:
        """Deterministic text tree (the test-facing exporter)."""
        from repro_torch.obs import export

        return export.render_text(self)

    def export_chrome(self, path: str) -> str:
        """Write the Chrome-trace/Perfetto JSON document; returns path."""
        from repro_torch.obs import export

        return export.export_chrome(self, path)


@dataclasses.dataclass
class _Layer:
    trace: Trace
    open: list[Span] = dataclasses.field(default_factory=list)


def _layers() -> list[_Layer]:
    stack = getattr(_TLS, "layers", None)
    if stack is None:
        stack = _TLS.layers = []
    return stack


def tracing() -> bool:
    """Is a trace scope armed on *this* thread?  The hot-path check."""
    return bool(_ARMED) and bool(getattr(_TLS, "layers", None))


def current_trace() -> Trace | None:
    """The innermost armed trace, or None."""
    if not _ARMED:
        return None
    layers = getattr(_TLS, "layers", None)
    return layers[-1].trace if layers else None


def current_span() -> Span | None:
    """The innermost *open* span of the armed trace, or None."""
    if not _ARMED:
        return None
    layers = getattr(_TLS, "layers", None)
    if not layers or not layers[-1].open:
        return None
    return layers[-1].open[-1]


def open_span(kind: str) -> Span | None:
    """The innermost open span of `kind` in the armed trace, or None.

    This is how nested dispatch wrappers *join* one logical dispatch
    instead of stacking spans: `skewmm.matmul` opens the dispatch span,
    and the `kernels.ops` wrapper it delegates to finds it open and
    decorates it rather than opening a second one.
    """
    if not _ARMED:
        return None
    layers = getattr(_TLS, "layers", None)
    if not layers or not layers[-1].open:
        return None
    for sp in reversed(layers[-1].open):
        if sp.kind == kind:
            return sp
    return None


@contextlib.contextmanager
def trace_scope(clock: Any = None) -> Iterator[Trace]:
    """Arm structured tracing for the dynamic extent of the block.

    Layered like `mm_config()`: scopes nest (spans land in the innermost
    trace), the stack is thread-local, and exit always restores the
    enclosing state.  `clock` is an attribution clock (`SimClock` /
    `WallClock` from `repro_torch.obs.clock`, or None for structure-only
    traces); dispatch sites consult it through `measured()`.

        with trace_scope(clock=SimClock()) as tr:
            out = skew_matmul(a, b)
        tr.export_chrome("trace.json")
    """
    global _ARMED
    layer = _Layer(trace=Trace(clock=clock))
    layers = _layers()
    layers.append(layer)
    with _ARM_LOCK:
        _ARMED += 1
    try:
        yield layer.trace
    finally:
        with _ARM_LOCK:
            _ARMED -= 1
        layers.pop()


def span(kind: str, name: str = "", **attrs: Any):
    """Open a span for the extent of the block (no-op when disarmed: the
    shared null context, cheaper to enter than a generator's).

    The yielded object supports ``.set(**attrs)`` either way, so call
    sites never branch on armed-ness themselves.
    """
    if not _ARMED:
        return _NULL_SPAN_CTX
    return _span(kind, name, **attrs)


@contextlib.contextmanager
def _span(kind: str, name: str, **attrs: Any) -> Iterator[Span | _NullSpan]:
    layers = getattr(_TLS, "layers", None)
    if not layers:
        yield NULL_SPAN
        return
    layer = layers[-1]
    sp = Span(kind=kind, name=name)
    sp.set(**attrs)
    parent = layer.open[-1] if layer.open else None
    (parent.children if parent is not None else layer.trace.roots).append(sp)
    layer.open.append(sp)
    clock = layer.trace.clock
    if clock is not None and getattr(clock, "wall", False):
        sp.t0_us = clock.now_us()
    try:
        yield sp
    finally:
        if clock is not None and getattr(clock, "wall", False):
            sp.t1_us = clock.now_us()
        layer.open.pop()


def event(kind: str, name: str = "", **attrs: Any) -> Span | _NullSpan:
    """Emit a leaf span with no extent (no-op when disarmed)."""
    if not _ARMED:
        return NULL_SPAN
    layers = getattr(_TLS, "layers", None)
    if not layers:
        return NULL_SPAN
    layer = layers[-1]
    sp = Span(kind=kind, name=name)
    sp.set(**attrs)
    parent = layer.open[-1] if layer.open else None
    (parent.children if parent is not None else layer.trace.roots).append(sp)
    return sp


def annotate(kind: str | None = None, **attrs: Any) -> bool:
    """Set attributes on the nearest enclosing open span (of `kind`,
    when given).  Returns whether a span was found; no-op disarmed.

    This is how inner layers decorate the outer dispatch span — the
    tune lookup stamps its cache key, the planner its modeled_us, the
    ladder the rung that delivered — without threading span handles
    through every signature.
    """
    if not _ARMED:
        return False
    layers = getattr(_TLS, "layers", None)
    if not layers or not layers[-1].open:
        return False
    for sp in reversed(layers[-1].open):
        if kind is None or sp.kind == kind:
            sp.set(**attrs)
            return True
    return False
