"""Device ms a batch of the kernels launched in the spans of Swin layers
0-3 of the split-point pass (layer 0 with the patch embedding, each layer
with its patch merging)."""


def read(ctx):
    if ctx.split is None:
        return None
    parts = [ctx.split.device_ms(f"bench.layer{i}") for i in range(ctx.counters["layers"])]
    if any(p is None for p in parts):
        return None
    return sum(parts) / ctx.counters["split_batches"]
