"""LR schedules, from ``audio_residual_tpu/training/scheduler.py``: the
reference's ``cosine_lr`` (`training/scheduler.py:4-23`), linear warmup then
cosine decay to zero over the total steps."""

from __future__ import annotations

import math

__all__ = ["cosine_lr"]


def cosine_lr(base_lr: float, warmup: int, total_steps: int):
    """``f(step) -> lr``, ``step`` the count of updates made before this one
    (0 for the first, as optax's ``scale_by_schedule`` counts)."""

    def schedule(step) -> float:
        step = float(step)
        if step < warmup:
            return base_lr * (step + 1) / max(warmup, 1)
        e = (step - warmup) / max(total_steps - warmup, 1)
        return 0.5 * (1 + math.cos(math.pi * e)) * base_lr

    return schedule
