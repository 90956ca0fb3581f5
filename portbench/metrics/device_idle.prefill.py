"""device_idle.prefill: share of the window's `repro_torch.prefill` ranges'
time in which no operation ran on the device (union of the profiler's
device intervals), in %.  Layer: model step (prompt).  Moves
ttft_p90_ms."""

from pbcore import spanread


def read(ctx):
    return spanread.idle_share(ctx["trace"], "prefill")
