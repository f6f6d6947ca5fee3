"""Device ms a batch of the kernels launched inside the port's span
``pca.update`` (``AttentionPCA.update``: every head's moments) in the
traced job."""


def read(ctx):
    t = ctx.trace
    n = t.span_count("pca.update")
    if not n:
        return None
    return (t.device_ms("pca.update") or 0.0) / n
