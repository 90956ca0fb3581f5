"""attn_roofline.decode: over the window's decode-only ticks, the least
time of their decode attention (the `work` module's
`decode_attn_least_s`: the keys each row really has cached, bf16 K and V
read once) over the device time of the kernels that `kernels/attn*.txt`
classes as attention in those ticks, in %.  Layer: attention.  Moves
serve_tok_s."""

from pbcore.gemm_share import roofline_share


def read(ctx):
    work = ctx["work"]
    if not hasattr(work, "decode_attn_least_s"):
        return None
    return roofline_share(ctx, "decode", "attn", lambda t: (
        work.decode_attn_least_s(ctx["cfg"], t["decode_rows"],
                                 t["decode_keys"])))
