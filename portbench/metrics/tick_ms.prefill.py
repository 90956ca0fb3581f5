"""tick_ms.prefill: host ms of the window's ticks that admit (their
prefill groups and the decode step after them) over their count.  Layer:
the serve tick (`Scheduler.step()` whole).  Moves ttft_p90_ms."""


def read(ctx):
    ts = [t["t1"] - t["t0"] for t in ctx["ticks"] if t["kind"] == "prefill"]
    return 1e3 * sum(ts) / len(ts) if ts else None
