"""Device ms a batch of the kernels launched inside the port's spans
``htsat.patch_embed`` and ``htsat.layer0`` .. ``htsat.layer3`` (each layer's
blocks and its PatchMerging) in the traced window of the real loop."""


def read(ctx):
    t = ctx.trace
    names = [n for n in t.spans if n == "htsat.patch_embed" or n.startswith("htsat.layer")]
    batches = t.span_count("bench.batch")
    if not names or not batches:
        return None
    return sum(t.device_ms(n) or 0.0 for n in names) / batches
