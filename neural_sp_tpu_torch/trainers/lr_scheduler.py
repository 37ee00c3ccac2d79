"""Learning-rate control (counterpart of
``neural_sp_tpu/trainers/lr_scheduler.py``), in two layers: step schedules
(a schedule maps the optimizer's step count, an int, to a learning rate)
and ``EpochController``, the per-epoch decay, patience, early stop and
top-k checkpoint bookkeeping that the train CLI consults. The controller's
state is a plain dict, saved in every checkpoint."""
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


class EpochController:
    """Per-epoch decay, patience, early stop and top-k epochs, as the JAX
    package's: ``step_epoch(dev_value)`` advances one epoch."""

    def __init__(
        self,
        base_lr: float,
        decay_type: str = "always",       # always | metric | warmup | no
        decay_rate: float = 0.9,
        decay_patient_n_epochs: int = 0,
        decay_start_epoch: int = 0,
        early_stop_patient_n_epochs: int = -1,
        lower_better: bool = True,
        metric: str = "loss",
    ):
        self.base_lr = base_lr
        self.lr = base_lr
        self.decay_type = decay_type
        self.decay_rate = decay_rate
        self.decay_patient_n_epochs = decay_patient_n_epochs
        self.decay_start_epoch = decay_start_epoch
        self.early_stop_patient_n_epochs = early_stop_patient_n_epochs
        self.lower_better = lower_better
        self.metric = metric
        self.epoch = 0
        self.best_value = float("inf") if lower_better else -float("inf")
        self.n_patience = 0
        self.n_early_stop = 0
        self.topk: list[tuple[float, int]] = []   # (value, epoch), best first

    def _improved(self, value: float) -> bool:
        return value < self.best_value if self.lower_better \
            else value > self.best_value

    def step_epoch(self, value: float | None = None) -> dict:
        """Advance an epoch with the dev metric; returns {"lr": the new lr,
        "early_stop": bool, "is_best": bool}."""
        self.epoch += 1
        is_best = False
        if value is not None:
            if self._improved(value):
                self.best_value = value
                is_best = True
                self.n_patience = 0
                self.n_early_stop = 0
            else:
                self.n_patience += 1
                self.n_early_stop += 1
            self.topk.append((value, self.epoch))
            self.topk.sort(key=lambda t: t[0] if self.lower_better else -t[0])
        if self.epoch >= self.decay_start_epoch:
            if self.decay_type == "always":
                self.lr *= self.decay_rate
            elif self.decay_type == "metric" and value is not None and \
                    self.n_patience > self.decay_patient_n_epochs:
                self.lr *= self.decay_rate
                self.n_patience = 0
        early_stop = (self.early_stop_patient_n_epochs > 0 and
                      self.n_early_stop >= self.early_stop_patient_n_epochs)
        return {"lr": self.lr, "early_stop": early_stop, "is_best": is_best}

    def convert_to_sgd(self, lr: float) -> dict:
        """Switch to plain SGD at a fixed lr; decay stops from here on.
        Returns the optimizer settings to rebuild with."""
        self.lr = lr
        self.decay_type = "no"
        return {"optimizer": "sgd", "lr": lr}

    def topk_epochs(self, k: int) -> list[int]:
        return [e for _, e in self.topk[:k]]

    def state_dict(self) -> dict:
        return dict(self.__dict__)

    def load_state_dict(self, state: dict):
        self.__dict__.update(state)
        self.topk = [tuple(t) for t in self.topk]
