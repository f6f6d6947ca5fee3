"""Device ms a batch of the kernels launched inside the port's span
``pca.encode`` (``run_pca``'s call of the encode closure: featurize and the
tapped forward) in the traced job."""


def read(ctx):
    t = ctx.trace
    n = t.span_count("pca.encode")
    if not n:
        return None
    return (t.device_ms("pca.encode") or 0.0) / n
