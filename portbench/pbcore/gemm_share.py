"""A kernel family's roofline share over one kind of serving tick, read
by the `gemm_roofline.*` and `attn_roofline.*` metrics."""


def tick_least_s(work, cfg, tick) -> float:
    """Least time of a tick's GEMMs: one call a prefill group (the
    admitted requests grouped by the scheduler's prompt bucket: the next
    power of two), then the decode step over its live rows."""
    groups = {}
    for n in tick["admitted"]:
        groups.setdefault(1 << (n - 1).bit_length(), []).append(n)
    least = sum(work.call_gemm_least_s(cfg, sum(g), len(g))
                for g in groups.values())
    return least + work.call_gemm_least_s(cfg, tick["decode_rows"],
                                          tick["decode_rows"])


def share(ctx, kind: str):
    return roofline_share(ctx, kind, "gemm", lambda t: tick_least_s(
        ctx["work"], ctx["cfg"], t))


def roofline_share(ctx, kind: str, family: str, least_of):
    """Over the window's ticks of `kind`: the sum of `least_of(tick)` over
    the device time of the kernels of the families whose name starts with
    `family` in those ticks, in %; None where the run holds nothing to
    read."""
    trace = ctx["trace"]
    if trace is None:
        return None
    ranges = trace.ranges(f"tick.{kind}")
    ticks = [t for t in ctx["ticks"] if t["kind"] == kind]
    if not ticks or len(ranges) != len(ticks):
        return None
    pats = [p for fam, ps in ctx["families"].items()
            if fam.startswith(family) for p in ps]
    device_s = sum(trace.device_s_in(ranges, pats))
    if device_s <= 0:
        return None
    return 100.0 * sum(least_of(t) for t in ticks) / device_s
