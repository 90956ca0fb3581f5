"""group_ms.prefill: mean host ms of the window's `repro_torch.prefill`
ranges, one a prefill group (its forward, the transfer of its first
tokens, the scatter into the slab).  Layer: model step (prompt).  Moves
ttft_p90_ms."""

from pbcore import spanread


def read(ctx):
    return spanread.mean_ms(ctx["trace"], "prefill")
