"""serve_mfu: the forward MODEL_FLOPS (2 N T, `work` module, frozen) of
every prompt token prefilled and every token decoded in the window, over
the window's seconds times the card's bf16 peak, in %.  Layer: the model
step.  Moves serve_tok_s."""


def read(ctx):
    work = ctx["work"]
    tokens = sum(sum(t["admitted"]) + t["decode_rows"] for t in ctx["ticks"])
    if not tokens:
        return None
    flops = work.model_flops(ctx["cfg"], tokens, "forward")
    return 100.0 * flops / (ctx["window_s"] * work.PEAK_BF16)
