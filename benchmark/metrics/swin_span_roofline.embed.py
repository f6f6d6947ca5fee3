"""The Swin layers' least time on one H100, ``max(ops / 989 TFLOP/s,
bytes / 3.35 TB/s)`` of the algorithm's count (``counts/htsat_forward.py``),
as a share of their device ms a batch under the port's spans
``htsat.patch_embed`` and ``htsat.layer*`` in the traced window of the real
loop."""


def read(ctx):
    t = ctx.trace
    names = [n for n in t.spans if n == "htsat.patch_embed" or n.startswith("htsat.layer")]
    batches = t.span_count("bench.batch")
    bound = ctx.counters.get("swin_bound_ms")
    if not names or not batches or bound is None:
        return None
    ms = sum(t.device_ms(n) or 0.0 for n in names) / batches
    return 100.0 * bound / ms if ms > 0 else None
