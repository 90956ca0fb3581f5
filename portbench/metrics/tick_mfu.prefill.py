"""tick_mfu.prefill: over the window's ticks that admit, the forward
MODEL_FLOPS (2 N T, `work` module, frozen) of the prompt tokens they
prefill and the rows they decode, over those ticks' host seconds times
the card's bf16 peak, in %: the whole step's share of the peak beside
gemm_roofline.prefill.  Layer: the model step.  Moves ttft_p90_ms."""


def read(ctx):
    ticks = [t for t in ctx["ticks"] if t["kind"] == "prefill"]
    seconds = sum(t["t1"] - t["t0"] for t in ticks)
    if not ticks or seconds <= 0:
        return None
    work = ctx["work"]
    tokens = sum(sum(t["admitted"]) + t["decode_rows"] for t in ticks)
    flops = work.model_flops(ctx["cfg"], tokens, "forward")
    return 100.0 * flops / (seconds * work.PEAK_BF16)
