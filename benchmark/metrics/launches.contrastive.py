"""Device kernels, memcpys and memsets a step launched inside the port's
spans ``train.*`` (forward, loss, backward, update) or ``recompute.*``, or
under the autograd engine's ``evaluate_function`` ops (the backward's other
threads): the whole step's launches."""

BACKWARD = "autograd::engine::evaluate_function"


def read(ctx):
    t = ctx.trace
    if "train.forward" not in t.spans or "train.update" not in t.spans:
        return None
    spans = [iv for n, iv in t.spans.items()
             if n.startswith(("train.", "recompute.")) or n == BACKWARD]
    n = sum(1 for _, _, _, tid, ts in t.kernels
            if ts is not None and any(iv.contains(tid, ts) for iv in spans))
    return n / ctx.counters["trace_steps"]
