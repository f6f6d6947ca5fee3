"""Device ms a batch of the kernels launched in the span around the
benchmark's encode closure (featurize, the tapped forward) in the traced
job."""


def read(ctx):
    ms = ctx.trace.device_ms("bench.encode")
    n = ctx.trace.span_count("bench.encode")
    return None if ms is None or not n else ms / n
