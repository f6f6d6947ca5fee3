"""Device ms a step of the kernels launched inside the port's span
``train.update``: the zero-fill, the gradient norm, AdamW's step, the logit
scales' clamp and bn0's merge."""


def read(ctx):
    ms = ctx.trace.device_ms("train.update")
    return None if ms is None else ms / ctx.counters["trace_steps"]
