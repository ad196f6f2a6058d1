"""The Myle learning-rate schedule (counterpart of
``seamless_communication_tpu/train/lr.py``; fairseq2's MyleLR): a linear
warm-up to the base rate, then an inverse-square-root decay."""

from __future__ import annotations

import math


def myle_lr(base_lr: float, warmup_steps: int = 100):
    """The rate of update ``step`` (counted from 0, as optax counts):
    ``base_lr * s / warmup_steps`` below the warm-up, else ``base_lr *
    sqrt(warmup_steps / s)``, with s = max(step, 1), so updates 0 and 1 use
    the same rate."""
    def schedule(step: int) -> float:
        step = max(step, 1)
        if step < warmup_steps:
            return base_lr * step / warmup_steps
        return base_lr * math.sqrt(warmup_steps / step)
    return schedule
