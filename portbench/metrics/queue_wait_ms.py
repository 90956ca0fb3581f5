"""queue_wait_ms: mean wall ms from `Scheduler.submit` to the start of the
request's prefill group over the window's prefill groups, from the port's
`guard.health` counters `serve_queue_wait_us` / `serve_queue_waits`
(counted while the profiler records).  Layer: scheduler admission.
Moves ttft_p90_ms."""


def read(ctx):
    h = ctx["health"]
    n = h.get("serve_queue_waits", 0)
    if not n:
        return None
    return h.get("serve_queue_wait_us", 0) / n / 1e3
