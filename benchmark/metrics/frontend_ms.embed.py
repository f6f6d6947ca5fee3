"""Device ms a batch of the kernels launched in the frontend span of the
split-point pass (K1, bn0, the bicubic stretch: ``encode_audio(
stop_at_image=True)`` after quantize and featurize)."""


def read(ctx):
    if ctx.split is None:
        return None
    ms = ctx.split.device_ms("bench.frontend")
    return None if ms is None else ms / ctx.counters["split_batches"]
