"""Ms a batch that the garbage collector's passes took in the untraced
stretch of a traced run (``gc.callbacks``)."""


def read(ctx):
    return ctx.counters.get("gc_ms_per_batch")
