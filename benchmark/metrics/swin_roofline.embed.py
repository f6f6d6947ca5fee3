"""The Swin layers' least time on one H100, ``max(ops / 989 TFLOP/s,
bytes / 3.35 TB/s)`` of the algorithm's count (``counts/htsat_forward.py``),
as a share of their device ms a batch in the split-point pass."""


def read(ctx):
    if ctx.split is None:
        return None
    parts = [ctx.split.device_ms(f"bench.layer{i}") for i in range(ctx.counters["layers"])]
    if any(p is None for p in parts):
        return None
    return 100.0 * ctx.counters["swin_bound_ms"] / (sum(parts) / ctx.counters["split_batches"])
