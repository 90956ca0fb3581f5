"""moe_slot_util: expert capacity slots filled over slots run in the
window, from the port's `guard.health` counters `moe_slots_filled` /
`moe_slots_total` (the scheduler arms their tracking for MoE models; a
decode graph replay adds its capture's counts), in %.  Layer: MoE.
Moves serve_tok_s."""


def read(ctx):
    h = ctx["health"]
    total = h.get("moe_slots_total", 0)
    if not total:
        return None
    return 100.0 * h.get("moe_slots_filled", 0) / total
