"""Device ms a step of the kernels launched inside the port's spans
``kernel.linear_tf32x3`` (the text tower's golden dense products on the
3xTF32 GEMM and the splits of their weights) or
``kernel.linear_tf32x3.backward`` (their gradients: the products for dx and
dW, the split of dW's operand, the sum of its splits and db); None where the
trace has neither span, as a program whose text tower runs ``F.linear``
leaves."""

SPANS = ("kernel.linear_tf32x3", "kernel.linear_tf32x3.backward")


def read(ctx):
    t = ctx.trace
    spans = [t.spans[n] for n in SPANS if n in t.spans]
    if not spans:
        return None
    us = sum(e - s for _, s, e, tid, ts in t.kernels
             if ts is not None and any(iv.contains(tid, ts) for iv in spans))
    return us / 1e3 / ctx.counters["trace_steps"] if us > 0 else None
