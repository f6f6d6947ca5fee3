"""Device ms a job of the kernels launched inside the port's span
``pca.finalize`` (``AttentionPCA.finalize``: the float64 randomized
eigensolve of every head) in the traced job."""


def read(ctx):
    t = ctx.trace
    n = t.span_count("pca.finalize")
    if not n:
        return None
    return (t.device_ms("pca.finalize") or 0.0) / n
