"""The text side's least time on one H100, ``max(ops / 989 TFLOP/s, bytes /
3.35 TB/s)`` of the algorithm's count (``counts/roberta_forward.py``), as a
share of its device ms a step under the port's span ``encode_text``."""


def read(ctx):
    ms = ctx.trace.device_ms("encode_text")
    bound = ctx.counters.get("text_bound_ms")
    if ms is None or bound is None:
        return None
    return 100.0 * bound / (ms / ctx.counters["trace_steps"])
