"""device_idle.decode: share of the window's `repro_torch.decode` ranges'
time in which no operation ran on the device (union of the profiler's
device intervals), in %.  Layer: model step (decode).  Moves
serve_tok_s."""

from pbcore import spanread


def read(ctx):
    return spanread.idle_share(ctx["trace"], "decode")
