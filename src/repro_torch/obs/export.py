"""Trace exporters: digest, deterministic text tree, Chrome trace JSON.

`digest()` is the provenance fragment (span-kind counts, gated
integer-exact by the `obs` bench suite).  `render_text()` is the
test-facing exporter — stable ordering, no timestamps unless the wall
clock stamped them.  `to_chrome()` emits the Chrome-tracing / Perfetto
"traceEvents" document with complete ("ph": "X") events: real
timestamps when the wall clock ran, otherwise a synthetic sequential
layout (each span as wide as its measured_us, children packed in
order) so sim-clock traces open identically on every host.
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    from repro_torch.obs.spans import Span, Trace

CHROME_SCHEMA_VERSION = 1


def digest(trace: "Trace") -> dict[str, int]:
    """Span-kind counts plus ``total``, sorted — deterministic."""
    counts: dict[str, int] = {}
    total = 0
    for sp in trace.spans():
        counts[sp.kind] = counts.get(sp.kind, 0) + 1
        total += 1
    out = dict(sorted(counts.items()))
    out["total"] = total
    return out


def _fmt_us(us: float | None) -> str:
    if us is None:
        return ""
    if us == int(us):
        return f"{int(us)}us"
    return f"{us:.3f}us"


def render_text(trace: "Trace") -> str:
    """Indented text tree; attrs sorted by key, one span per line."""
    lines: list[str] = []

    def emit(sp: "Span", depth: int) -> None:
        head = f"{sp.kind}:{sp.name}" if sp.name else sp.kind
        parts = [head]
        if sp.modeled_us is not None:
            parts.append(f"modeled={_fmt_us(sp.modeled_us)}")
        if sp.measured_us is not None:
            parts.append(f"measured={_fmt_us(sp.measured_us)}")
        for key in sorted(sp.attrs):
            parts.append(f"{key}={sp.attrs[key]}")
        lines.append("  " * depth + " ".join(parts))
        for child in sp.children:
            emit(child, depth + 1)

    for root in trace.roots:
        emit(root, 0)
    return "\n".join(lines)


def _synthetic_dur(sp: "Span") -> float:
    """Layout width: own measurement, else children's packed total,
    floored at 1us so zero-width spans stay visible."""
    child_total = sum(_synthetic_dur(c) for c in sp.children)
    own = sp.measured_us if sp.measured_us is not None else sp.modeled_us
    if own is None:
        own = 0.0
    return max(round(own, 3), child_total, 1.0)


def to_chrome(trace: "Trace") -> dict[str, Any]:
    """Build the Chrome-tracing JSON document (complete events)."""
    events: list[dict[str, Any]] = []

    def args_of(sp: "Span") -> dict[str, Any]:
        args = {k: sp.attrs[k] for k in sorted(sp.attrs)}
        if sp.modeled_us is not None:
            args["modeled_us"] = sp.modeled_us
        if sp.measured_us is not None:
            args["measured_us"] = sp.measured_us
        return args

    def emit(sp: "Span", ts: float) -> float:
        """Emit span at ts; returns its duration.  Real timestamps win
        when the wall clock stamped them."""
        if sp.t0_us is not None and sp.t1_us is not None:
            ts, dur = sp.t0_us, max(sp.t1_us - sp.t0_us, 0.0)
        else:
            dur = _synthetic_dur(sp)
        events.append(
            {
                "name": f"{sp.kind}:{sp.name}" if sp.name else sp.kind,
                "cat": sp.kind,
                "ph": "X",
                "ts": round(ts, 3),
                "dur": round(dur, 3),
                "pid": 0,
                "tid": 0,
                "args": args_of(sp),
            }
        )
        child_ts = ts
        for child in sp.children:
            child_ts += emit(child, child_ts)
        return dur

    ts = 0.0
    for root in trace.roots:
        ts += emit(root, ts)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        # the JAX package's document schema: the two read each other's
        "otherData": {"schema": "repro.obs", "version": CHROME_SCHEMA_VERSION},
    }


def export_chrome(trace: "Trace", path: str) -> str:
    doc = to_chrome(trace)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return path


def validate_chrome(doc: dict[str, Any]) -> None:
    """Schema-validate a Chrome-trace document; raises ValueError.

    This is the trace-smoke contract (`launch.trace --check`): the document must be loadable
    by chrome://tracing / Perfetto — a traceEvents list of complete
    events with numeric ts/dur and string name/cat.
    """
    if not isinstance(doc, dict):
        raise ValueError("chrome trace: document must be an object")
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("chrome trace: traceEvents must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"chrome trace: event {i} is not an object")
        for key in ("name", "cat", "ph", "ts", "dur", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"chrome trace: event {i} missing {key!r}")
        if ev["ph"] != "X":
            raise ValueError(f"chrome trace: event {i} ph={ev['ph']!r}, want 'X'")
        for key in ("ts", "dur"):
            if not isinstance(ev[key], (int, float)) or ev[key] < 0:
                raise ValueError(f"chrome trace: event {i} {key} not a number >= 0")
        for key in ("name", "cat"):
            if not isinstance(ev[key], str) or not ev[key]:
                raise ValueError(f"chrome trace: event {i} {key} not a string")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"chrome trace: event {i} args not an object")
