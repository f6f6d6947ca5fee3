"""Device ms a batch of the kernels launched inside the port's spans
``quantize``, ``featurize`` and ``htsat.frontend`` (K1, bn0, the AMP cast,
the bicubic stretch) in the traced window of the real loop."""

SPANS = ("quantize", "featurize", "htsat.frontend")


def read(ctx):
    t = ctx.trace
    names = [n for n in SPANS if n in t.spans]
    batches = t.span_count("bench.batch")
    if not names or not batches:
        return None
    return sum(t.device_ms(n) or 0.0 for n in names) / batches
