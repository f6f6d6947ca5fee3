"""Device ms a step of the kernels launched inside the port's span
``encode_audio``: HTSAT's training forward (K1 and bn0, SpecAugment, the
Swin layers, the head) and the audio projection."""


def read(ctx):
    ms = ctx.trace.device_ms("encode_audio")
    return None if ms is None else ms / ctx.counters["trace_steps"]
