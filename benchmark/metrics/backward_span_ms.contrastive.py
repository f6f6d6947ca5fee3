"""Device ms a step of the kernels launched inside the port's spans
``train.backward`` or ``recompute.*``, or under the autograd engine's
``evaluate_function`` ops (the backward's device thread): the backward
through both towers and the loss, each kernel counted once."""

BACKWARD = "autograd::engine::evaluate_function"


def read(ctx):
    t = ctx.trace
    if "train.backward" not in t.spans:
        return None
    spans = [iv for n, iv in t.spans.items()
             if n == "train.backward" or n.startswith("recompute.") or n == BACKWARD]
    us = sum(e - s for _, s, e, tid, ts in t.kernels
             if ts is not None and any(iv.contains(tid, ts) for iv in spans))
    return us / 1e3 / ctx.counters["trace_steps"] if us > 0 else None
