"""gemm_roofline.prefill: as gemm_roofline.decode over the window's ticks
that admit (their prefill groups and the decode step after them), in %.
Layer: kernels.  Moves ttft_p90_ms."""

from pbcore.gemm_share import share


def read(ctx):
    return share(ctx, "prefill")
