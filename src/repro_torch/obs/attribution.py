"""Dispatch spans + modeled-vs-measured drift attribution.

`dispatch()` is the one helper kernel wrappers use: it opens a
"dispatch" span around a guarded matmul, and on exit folds the span's
attribution pair into the metrics registry — per-shape-class drift
histograms (`drift/<class>` observes log(measured/modeled)) plus the
obs counters the `obs` bench suite gates integer-exact.  `measured()`
routes the actual kernel thunk through the armed trace's clock so the
span picks up `measured_us` (the wall clock on the card stamps it when
the trace scope closes).

`drift_report()` turns the per-class histograms into the same
fit-quality shape the calibration gate uses: a class is *accepted* when
its worst |log(measured/modeled)| stays within `calibrate.MAX_LOG_SPREAD`
— the identical threshold that decides whether a measured correction
fit may be absorbed into a ChipSpec.  A sim-clock run must report every
class accepted with drift exactly 0.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Iterator

from repro_torch.obs import spans as _spans
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.spans import NULL_SPAN, Span, annotate, tracing  # noqa: F401
# annotate/tracing re-exported so dispatch sites import one module.


def shape_class_token(m: int, k: int, n: int, batch: int = 1) -> str:
    """The tune shape-class token for a dispatch — lazy import so obs
    stays importable without the tune package."""
    from repro_torch.tune.shapeclass import ShapeClass

    return ShapeClass.of(m, k, n, batch).token


def record_drift(cls_token: str, modeled_us: float, measured_us: float) -> None:
    """Fold one attribution pair into the per-class drift histogram."""
    if modeled_us <= 0 or measured_us <= 0:
        return
    REGISTRY.histogram(f"drift/{cls_token}").observe(
        math.log(measured_us / modeled_us)
    )


# The disarmed dispatch context: shared, stateless, and cheaper to enter
# than a generator-based context manager (every eager matmul enters one).
_NULL_DISPATCH = contextlib.nullcontext(NULL_SPAN)


def dispatch(site: str, **attrs: Any):
    """Span a guarded matmul dispatch; disarmed this is pure no-op
    (no span, no counters — the scrub discipline).

    Nested wrappers *join*: when a dispatch span is already open (the
    `skewmm.matmul` entry point delegating to a `kernels.ops` wrapper),
    the inner call decorates the enclosing span with any attributes it
    doesn't carry yet instead of opening a second one — one logical
    dispatch is one span, one counter tick, one drift sample.
    """
    if not _spans.tracing():
        return _NULL_DISPATCH
    return _dispatch_span(site, **attrs)


@contextlib.contextmanager
def _dispatch_span(site: str, **attrs: Any) -> Iterator[Span | Any]:
    enclosing = _spans.open_span("dispatch")
    if enclosing is not None:
        enclosing.set(
            **{k: v for k, v in attrs.items() if k not in enclosing.attrs}
        )
        yield enclosing
        return
    with _spans.span("dispatch", site, **attrs) as sp:
        yield sp
    REGISTRY.inc("obs_dispatches")
    fold_drift(sp)


def fold_drift(sp: Span) -> None:
    """Stamp a dispatch span's shape class and fold its attribution pair
    into the class's drift histogram, once both sides exist (at the
    span's close, or when the wall clock resolves a deferred pair)."""
    if sp.modeled_us is None or sp.measured_us is None:
        return
    m = sp.attrs.get("m")
    k = sp.attrs.get("k")
    n = sp.attrs.get("n")
    if m is not None and k is not None and n is not None:
        cls = shape_class_token(m, k, n, int(sp.attrs.get("batch", 1)))
        sp.set(shape_class=cls)
        record_drift(cls, sp.modeled_us, sp.measured_us)


def measured(sp: Span | Any, fn: Callable[[], Any]) -> Any:
    """Run `fn` through the armed trace's clock, stamping the span's
    `measured_us`.  With no trace/clock armed (or a null span) this is
    just `fn()`."""
    if sp is NULL_SPAN:
        return fn()
    trace = _spans.current_trace()
    clock = trace.clock if trace is not None else None
    if clock is None:
        return fn()
    out, us = clock.measure(fn, modeled_us=sp.modeled_us, span=sp)
    if us is not None:
        sp.set(measured_us=us)
    return out


def drift_report(registry=REGISTRY) -> dict[str, Any]:
    """Per-shape-class drift summary in calibration fit-quality terms.

    Returns ``{"classes": {cls: {count, geomean_ratio, max_abs_log,
    accepted}}, "max_abs_log", "accepted", "classes_total",
    "classes_accepted"}``.  `accepted` uses `calibrate.MAX_LOG_SPREAD`,
    the same bound `fit_corrections` enforces before a measured
    correction may be absorbed — so a drifting shape class is judged the
    same way a bad calibration fit is.
    """
    from repro_torch.tune.calibrate import MAX_LOG_SPREAD

    classes: dict[str, dict[str, Any]] = {}
    worst = 0.0
    for name, hist in sorted(registry.histograms().items()):
        if not name.startswith("drift/"):
            continue
        logs = hist.values()
        if not logs:
            continue
        cls = name[len("drift/") :]
        max_abs = max(abs(v) for v in logs)
        worst = max(worst, max_abs)
        classes[cls] = {
            "count": len(logs),
            "geomean_ratio": math.exp(sum(logs) / len(logs)),
            "max_abs_log": max_abs,
            "accepted": max_abs <= MAX_LOG_SPREAD,
        }
    return {
        "classes": classes,
        "max_abs_log": worst,
        "accepted": worst <= MAX_LOG_SPREAD,
        "classes_total": len(classes),
        "classes_accepted": sum(1 for c in classes.values() if c["accepted"]),
    }
