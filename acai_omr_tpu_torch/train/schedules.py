"""LR and curriculum schedules (the twin of the JAX package's
``train/schedules.py``): pure ``step -> value`` functions on host floats.

LinearLR(start_factor=5e-3) warm-up chained into cosine annealing, stepped
per optimizer step in stage 2; the linear decay of stage 3's learning rate;
the scheduled-sampling curriculum anneals the teacher-forcing probability
linearly and the Gumbel temperature exponentially.
"""

from __future__ import annotations

import math


def cosine_anneal_with_warmup(base_lr: float, warmup_steps: int,
                              total_steps: int, final_lr: float,
                              start_factor: float = 5e-3):
    """Factor interpolates start_factor -> 1 over ``warmup_steps``, then
    cosine from base_lr to final_lr over the remaining steps."""
    anneal_steps = max(total_steps - warmup_steps, 1)

    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            frac = min(max(step / max(warmup_steps, 1), 0.0), 1.0)
            return base_lr * (start_factor + (1.0 - start_factor) * frac)
        t = min(max((step - warmup_steps) / anneal_steps, 0.0), 1.0)
        return final_lr + (base_lr - final_lr) * 0.5 * (1.0 + math.cos(math.pi * t))

    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int):
    """``optax.linear_schedule``: linear from init_value to end_value over
    ``transition_steps`` steps, then held (constant when that is <= 0)."""
    if transition_steps <= 0:
        return lambda step: init_value

    def schedule(step) -> float:
        frac = 1.0 - min(max(float(step), 0.0), transition_steps) \
            / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def linear_anneal(init_value: float, min_value: float, step: int,
                  anneal_steps: int) -> float:
    progress = step / max(anneal_steps, 1)
    return max(init_value - (init_value - min_value) * progress, min_value)


def exp_anneal(init_value: float, min_value: float, step: int,
               anneal_steps: int) -> float:
    progress = step / max(anneal_steps, 1)
    return max(init_value * (min_value / init_value) ** progress, min_value)


class TFSchedule:
    """Scheduled-sampling curriculum: tf_prob 1->0 linear, tau 5->0.1 exp,
    hard sampling after ``soft_steps``."""

    def __init__(self, init_tf_prob=1.0, min_tf_prob=0.0, init_tau=5.0,
                 min_tau=0.1, soft_steps=0, anneal_steps=1):
        self.init_tf_prob = init_tf_prob
        self.min_tf_prob = min_tf_prob
        self.init_tau = init_tau
        self.min_tau = min_tau
        self.soft_steps = soft_steps
        self.anneal_steps = anneal_steps

    def at(self, step: int):
        tf_prob = linear_anneal(self.init_tf_prob, self.min_tf_prob, step,
                                self.anneal_steps)
        tau = exp_anneal(self.init_tau, self.min_tau, step, self.anneal_steps)
        return tf_prob, tau, step >= self.soft_steps
