"""Device ms a step of the kernels launched inside the port's span
``train.forward`` (``make_zero_shot_step``'s loss: the forward from the
cached image, the similarities and the loss)."""


def read(ctx):
    t = ctx.trace
    if "train.forward" not in t.spans:
        return None
    return (t.device_ms("train.forward") or 0.0) / ctx.counters["trace_steps"]
