"""Device ms a step of the kernels launched under the autograd engine's
``evaluate_function`` ops (the backward to λ, ``ops/cuda/autograd.py``'s
recompute included)."""


def read(ctx):
    ms = ctx.trace.device_ms("autograd::engine::evaluate_function")
    return None if ms is None else ms / ctx.counters["trace_steps"]
