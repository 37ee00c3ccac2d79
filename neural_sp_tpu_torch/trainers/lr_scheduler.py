"""Step learning-rate schedules (counterpart of
``neural_sp_tpu/trainers/lr_scheduler.py``): a schedule maps the optimizer's
step count (an int) to a learning rate. The epoch controller is not ported
yet (ROADMAP)."""
from __future__ import annotations


def noam_schedule(d_model: int, warmup_n_steps: int, factor: float = 1.0,
                  peak_lr: float | None = None):
    """lr = factor * d^-0.5 * min(step^-0.5, step * warmup^-1.5), the step
    clamped to at least 1, with an optional peak clamp."""

    def sched(step: int) -> float:
        step = float(max(step, 1))
        lr = factor * d_model ** -0.5 * min(step ** -0.5,
                                            step * warmup_n_steps ** -1.5)
        return min(lr, peak_lr) if peak_lr is not None else lr

    return sched


def warmup_schedule(base_lr: float, warmup_start_lr: float,
                    warmup_n_steps: int):
    """Linear warmup from ``warmup_start_lr`` to ``base_lr``, then constant."""

    def sched(step: int) -> float:
        if warmup_n_steps <= 0:
            return base_lr
        frac = min(step / warmup_n_steps, 1.0)
        return warmup_start_lr + (base_lr - warmup_start_lr) * frac

    return sched
