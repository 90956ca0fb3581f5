"""Reduce a `torch.profiler` trace to what the per-layer metrics read.

The harness wraps its measured window in a `record_function` range named
`WINDOW`, each `Scheduler.step()` (or trainer call) in a range named
`tick.<kind>`, and its own bookkeeping in `harness.bookkeeping`.  Device
events (kernels, copies, sets) and host events come from the profiler's
Kineto results on one clock.  Each tick ends in a transfer of its result
to the host, so every device event that starts inside a tick's host range
belongs to that tick.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW = "portbench.window"
HARNESS_PREFIXES = ("tick.", "harness.", "portbench.")


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _end_ns(ev) -> int:
    f = getattr(ev, "end_ns", None)
    if f is not None:
        return int(f())
    return _ns(ev, "start") + _ns(ev, "duration")


class DeviceTrace:
    """Device intervals and host ranges of one traced window."""

    def __init__(self, device: list, host: list, window: tuple[int, int]):
        # device: (start_ns, end_ns, name), clipped to the window, sorted
        # host: (start_ns, end_ns, name) of the window's thread, sorted
        self.t0, self.t1 = window
        self.device = device
        self.host = host

    @classmethod
    def from_profiler(cls, prof) -> "DeviceTrace":
        from torch.autograd import DeviceType
        events = prof.profiler.kineto_results.events()
        win = [e for e in events if e.name() == WINDOW
               and e.device_type() == DeviceType.CPU]
        if not win:
            raise RuntimeError(f"no {WINDOW!r} range in the trace")
        w = win[0]
        t0, t1 = _ns(w, "start"), _end_ns(w)
        thread = w.start_thread_id()
        device, host = [], []
        for e in events:
            name = e.name()
            if e.device_type() == DeviceType.CPU:
                if e.start_thread_id() == thread:
                    host.append((_ns(e, "start"), _end_ns(e), name))
                continue
            if e.is_user_annotation() or name.startswith(HARNESS_PREFIXES):
                continue
            s, t = _ns(e, "start"), _end_ns(e)
            if t <= t0 or s >= t1:
                continue
            device.append((max(s, t0), min(t, t1), name))
        device.sort()
        host.sort(key=lambda r: (r[0], -r[1]))
        return cls(device, host, (t0, t1))

    # ------------------------------------------------------------ window
    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _union(self) -> list[tuple[int, int]]:
        out: list[list[int]] = []
        for s, t, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [(s, t) for s, t in out]

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran."""
        return sum(t - s for s, t in self._union()) / 1e9

    # ------------------------------------------------------------- ticks
    def ranges(self, prefix: str) -> list[tuple[int, int, str]]:
        """Host ranges whose name starts with `prefix`, in order."""
        return [r for r in self.host if r[2].startswith(prefix)
                and r[0] >= self.t0 and r[1] <= self.t1]

    def device_s_in(self, ranges, patterns) -> list[float]:
        """For each (start, end, _) host range: seconds of device events
        that start inside it and whose name holds one of `patterns`."""
        starts = [d[0] for d in self.device]
        out = []
        for s, t, _ in ranges:
            lo, hi = bisect.bisect_left(starts, s), bisect.bisect_right(
                starts, t)
            out.append(sum(e - b for b, e, n in self.device[lo:hi]
                           if any(p in n for p in patterns)) / 1e9)
        return out

    # --------------------------------------------------------- breakdown
    def top_ops(self, n: int = 10) -> list[list]:
        """The `n` device operations that took most time: [name, s]."""
        tot: dict[str, int] = defaultdict(int)
        for s, t, name in self.device:
            tot[name] += t - s
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """Idle device time by what the host was doing: each gap between
        device operations is named by the harness range around the gap's
        midpoint and the innermost host event there ("<range>:<event>"),
        and gaps of one name are summed; the `n` largest, [name, s]."""
        union = self._union()
        gaps, prev = [], self.t0
        for s, t in union:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        tot: dict[str, int] = defaultdict(int)
        stack: list[tuple[int, int, str]] = []
        i = 0
        for a, b in gaps:                     # gaps are sorted by time
            q = (a + b) // 2
            while i < len(self.host) and self.host[i][0] <= q:
                ev = self.host[i]
                while stack and stack[-1][1] <= ev[0]:
                    stack.pop()
                stack.append(ev)
                i += 1
            while stack and stack[-1][1] < q:
                stack.pop()
            outer = next((e[2] for e in stack
                          if e[2].startswith(("tick.", "harness."))), "-")
            inner = stack[-1][2] if stack else "-"
            tot[f"{outer}:{inner}"] += b - a
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]
