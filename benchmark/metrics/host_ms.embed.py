"""Host ms a batch from the call into the port (quantize, featurize,
encode) to its return, before the harness waits for the device: the
untraced stretch of a traced run."""


def read(ctx):
    return ctx.counters.get("host_ms")
