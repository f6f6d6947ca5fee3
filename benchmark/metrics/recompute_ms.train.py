"""Device ms a step of the kernels launched inside the port's spans
``recompute.*``: ``ops/cuda/autograd.py::Recompute``'s backward, the K2-K5
plain versions re-run under autograd and their ``autograd.grad``, on the
autograd engine's device thread."""


def read(ctx):
    t = ctx.trace
    names = [n for n in t.spans if n.startswith("recompute.")]
    if not names:
        return None
    return sum(t.device_ms(n) or 0.0 for n in names) / ctx.counters["trace_steps"]
