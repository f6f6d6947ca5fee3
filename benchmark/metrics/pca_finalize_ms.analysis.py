"""Host ms from the last batch drawn off the benchmark's iterator to
``run_pca``'s return (the finalize, and the last update's wait), mean over
the jobs of the untraced stretch."""


def read(ctx):
    return ctx.counters.get("finalize_ms")
