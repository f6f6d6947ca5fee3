"""Device ms a step of the kernels launched inside the port's span
``encode_text``: RoBERTa's training forward (its dropout drawn) and the text
projection."""


def read(ctx):
    ms = ctx.trace.device_ms("encode_text")
    return None if ms is None else ms / ctx.counters["trace_steps"]
