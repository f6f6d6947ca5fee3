"""Device ms a batch of the kernels launched inside the port's spans
``htsat.merge*``: PatchMerging's gather, LayerNorm and f32 reduction."""


def read(ctx):
    t = ctx.trace
    names = [n for n in t.spans if n.startswith("htsat.merge")]
    batches = t.span_count("bench.batch")
    if not names or not batches:
        return None
    return sum(t.device_ms(n) or 0.0 for n in names) / batches
