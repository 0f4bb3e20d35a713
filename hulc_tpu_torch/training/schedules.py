"""KL-beta annealing and learning-rate schedules (port of
hulc_tpu/training/schedules.py).

``KLSchedule`` gives the KL beta of an epoch (constant, linear or sigmoid
annealing). ``make_lr_schedule`` returns step -> learning rate, in plain
Python with optax's formulas: constant, cosine with linear warmup
(``optax.warmup_cosine_decay_schedule``) and linear with warmup (two
``optax.linear_schedule`` joined at the warmup boundary). A float
``num_warmup_steps`` below 1 is a fraction of the training steps.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

Schedule = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class KLSchedule:
    """kind: "constant" | "linear" | "sigmoid"."""

    kind: str = "constant"
    start_epoch: int = 10
    end_epoch: int = 50
    max_kl_beta: float = 0.01

    def __call__(self, epoch: int, base_beta: float) -> float:
        if self.kind == "constant":
            return base_beta
        if epoch < self.start_epoch:
            return 0.0
        if epoch > self.end_epoch:
            return self.max_kl_beta
        if self.kind == "linear":
            frac = (epoch - self.start_epoch) / max(1, self.end_epoch - self.start_epoch)
            return self.max_kl_beta * frac
        if self.kind == "sigmoid":
            scale = self.end_epoch - self.start_epoch
            shift = (self.end_epoch + self.start_epoch) / 2
            return self.max_kl_beta / (1.0 + math.exp(-(epoch - shift) / (scale / 12)))
        raise ValueError(f"unknown KL schedule {self.kind!r}")


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule."""

    def schedule(count: int) -> float:
        if transition_steps <= 0:
            return init_value
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""

    def schedule(count: int) -> float:
        if decay_steps <= 0:
            return init_value
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def join_schedules(schedules, boundaries) -> Schedule:
    """optax.join_schedules: past each boundary, the next schedule counts
    from that boundary."""

    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, nxt in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = nxt(count - boundary)
        return out

    return schedule


def make_lr_schedule(
    kind: str, lr: float, num_training_steps: int = -1, num_warmup_steps: float = 0.0
) -> Schedule:
    """kind: "constant" | "cosine_with_warmup" | "linear_with_warmup"."""
    if kind == "constant":
        return lambda count: lr
    if isinstance(num_warmup_steps, float) and num_warmup_steps < 1:
        warmup = int(num_warmup_steps * num_training_steps)
    else:
        warmup = int(num_warmup_steps)
    if kind == "cosine_with_warmup":
        warmup_steps = max(1, warmup)
        return join_schedules(
            [linear_schedule(0.0, lr, warmup_steps),
             cosine_decay_schedule(lr, max(2, num_training_steps) - warmup_steps)],
            [warmup_steps],
        )
    if kind == "linear_with_warmup":
        return join_schedules(
            [linear_schedule(0.0, lr, max(1, warmup)),
             linear_schedule(lr, 0.0, max(1, num_training_steps - warmup))],
            [max(1, warmup)],
        )
    raise ValueError(f"unknown lr schedule {kind!r}")
