"""The share of the traced window in which no kernel ran on the device,
in %: 1 - the union of kernel intervals over the window."""


def read(ctx):
    w, busy = ctx.trace.window_s(), ctx.trace.busy_s()
    if not w or not busy:
        return None
    return 100.0 * (1.0 - busy / w)
