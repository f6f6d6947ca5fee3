"""Device kernels, memcpys and memsets a batch launched inside the port's
spans ``quantize``, ``featurize`` or ``encode_audio`` in the traced window
of the real loop."""

SPANS = ("quantize", "featurize", "encode_audio")


def read(ctx):
    t = ctx.trace
    spans = [t.spans[n] for n in SPANS if n in t.spans]
    batches = t.span_count("bench.batch")
    if not spans or not batches:
        return None
    n = sum(1 for _, _, _, tid, ts in t.kernels
            if ts is not None and any(iv.contains(tid, ts) for iv in spans))
    return n / batches
