"""Device idle ms a batch in the traced window's gaps that begin while the
main thread is inside the port's spans ``quantize``, ``featurize`` or
``encode_audio``: the idle time the port's own host work leaves. The rest
of the window's idle time is the harness's (the wait in the copy back)."""

SPANS = ("quantize", "featurize", "encode_audio")


def read(ctx):
    t = ctx.trace
    spans = [t.spans[n] for n in SPANS if n in t.spans]
    batches = t.span_count("bench.batch")
    if not spans or not batches or t.window is None:
        return None
    lo, hi = t.window
    idle, prev = 0.0, lo
    for start, end in t.busy_intervals() + [[hi, hi]]:
        if start > prev and any(iv.contains(t.main_tid, prev) for iv in spans):
            idle += start - prev
        prev = max(prev, end)
    return idle / 1e3 / batches
