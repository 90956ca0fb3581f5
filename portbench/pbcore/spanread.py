"""Read the program's own profiler ranges out of a traced window.

While `torch.profiler` records, the port's scheduler opens host ranges
named `repro_torch.<kind>` (`tick`, `admit`, `prefill`, `decode` and the
phases `forward`, `sample`, `scatter`, `slab` inside them) on the
profiler's clock, the clock of the device events.  A program that opens
none gives no ranges here, and the readers built on these return None.
"""

from __future__ import annotations

PREFIX = "repro_torch."


def ranges(trace, kind: str) -> list[tuple[int, int, str]]:
    """The window's host ranges `repro_torch.<kind>`, in order ([] with no
    trace)."""
    if trace is None:
        return []
    name = PREFIX + kind
    return [r for r in trace.ranges(name) if r[2] == name]


def mean_ms(trace, kind: str) -> float | None:
    """Mean host ms of the window's `repro_torch.<kind>` ranges."""
    rs = ranges(trace, kind)
    if not rs:
        return None
    return sum(t - s for s, t, _ in rs) / len(rs) / 1e6


def idle_share(trace, kind: str) -> float | None:
    """Share, in %, of the `repro_torch.<kind>` ranges' time in which no
    device operation ran (the union of the trace's device intervals);
    None where the trace holds no device event or no such range."""
    rs = ranges(trace, kind)
    if not rs or not trace.device:
        return None
    busy: list[list[int]] = []
    for s, t, _ in trace.device:              # sorted by start
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], t)
        else:
            busy.append([s, t])
    total = idle = 0
    i = 0
    for s, t, _ in sorted(rs):
        total += t - s
        covered = 0
        while i < len(busy) and busy[i][1] <= s:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < t:
            covered += min(t, busy[j][1]) - max(s, busy[j][0])
            j += 1
        idle += t - s - covered
    return 100.0 * idle / total if total > 0 else None
