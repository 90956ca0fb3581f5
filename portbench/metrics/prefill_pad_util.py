"""prefill_pad_util: real prompt tokens of the window's prefill groups
over the slots their (batch bucket x prompt bucket) shapes compute, from
the port's `guard.health` counters `serve_prefill_tokens` /
`serve_prefill_slots`, in %.  Layer: scheduler buckets.  Moves
ttft_p90_ms."""


def read(ctx):
    h = ctx["health"]
    slots = h.get("serve_prefill_slots", 0)
    if not slots:
        return None
    return 100.0 * h.get("serve_prefill_tokens", 0) / slots
