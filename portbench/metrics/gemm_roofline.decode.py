"""gemm_roofline.decode: over the window's decode-only ticks, the least
time of their linear-layer GEMMs (the `work` module: real rows only,
weights of the experts hit read once) over the device time of the kernels
that `kernels/gemm*.txt` classes as GEMMs in those ticks, in %.  Layer:
kernels.  Moves serve_tok_s."""

from pbcore.gemm_share import share


def read(ctx):
    return share(ctx, "decode")
