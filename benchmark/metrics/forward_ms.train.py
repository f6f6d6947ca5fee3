"""Device ms a step of the kernels launched by the step's forward: inside
the step's span on the calling thread, outside the autograd engine's
``evaluate_function`` ops and the optimizer's spans."""


def read(ctx):
    ms = ctx.trace.device_ms("bench.step", ("autograd::engine::evaluate_function",
                                             "Optimizer."))
    return None if ms is None else ms / ctx.counters["trace_steps"]
