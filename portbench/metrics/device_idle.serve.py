"""device_idle.serve: share of the traced serving window in which no
operation ran on the device (union of the profiler's device intervals),
in %.  Layer: device.  Moves serve_tok_s."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None         # no device event traced: nothing to read
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
