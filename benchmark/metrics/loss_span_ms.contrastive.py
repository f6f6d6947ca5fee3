"""Device ms a step of the kernels launched inside the port's span
``train.loss``: the CLIP loss's similarities and cross-entropies."""


def read(ctx):
    ms = ctx.trace.device_ms("train.loss")
    return None if ms is None else ms / ctx.counters["trace_steps"]
