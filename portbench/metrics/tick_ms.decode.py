"""tick_ms.decode: host ms of the window's decode-only ticks (no
admission) over their count; each tick ends in the transfer of its tokens
to the host.  Layer: the serve tick, the scheduler and the model step
together (`Scheduler.step()` whole).  Moves serve_tok_s."""


def read(ctx):
    ts = [t["t1"] - t["t0"] for t in ctx["ticks"] if t["kind"] == "decode"]
    return 1e3 * sum(ts) / len(ts) if ts else None
