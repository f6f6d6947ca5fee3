"""The step's operations (``counts/contrastive_step.py``) over the untraced
stretch of a traced run, over its seconds times one H100's dense bf16
peak, 989 TFLOP/s, in %."""


def read(ctx):
    return ctx.counters.get("mfu")
