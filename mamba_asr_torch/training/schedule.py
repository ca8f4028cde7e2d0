"""Noam learning-rate schedule (port of mamba_asr_tpu/training/schedule.py).

lr(step) = lr_initial * sqrt(warmup) * min(step^-0.5, step * warmup^-1.5),
peaking at lr_initial at step == warmup, with step = max(count *
steps_per_update, 1): the count is clamped at 1, so the first two
updates both use lr(1). `steps_per_update=2` reproduces the reference
S2S recipe, which steps its scheduler twice per update.
"""

from __future__ import annotations

from typing import Callable


def noam_schedule(lr_initial: float, warmup_steps: int,
                  steps_per_update: int = 1) -> Callable[[int], float]:
    """count (updates already taken) -> learning rate."""
    norm = warmup_steps**0.5

    def schedule(count: int) -> float:
        step = float(max(count * steps_per_update, 1))
        return lr_initial * norm * min(step**-0.5, step * warmup_steps**-1.5)

    return schedule
