"""kv_slot_util: cached keys the live rows attend to in the window's
decode steps over the slab's rows x `max_len` in those steps (what
attention over the slab reads), from the port's `guard.health` counters
`serve_decode_keys` / `serve_kv_slots`, in %.  Layer: KV cache.  Moves
serve_tok_s."""


def read(ctx):
    h = ctx["health"]
    slots = h.get("serve_kv_slots", 0)
    if not slots:
        return None
    return 100.0 * h.get("serve_decode_keys", 0) / slots
