"""Optimizer (counterpart of ``neural_sp_tpu/trainers/optimizer.py``): the
JAX package's optax chain written out, so the order of every operation is
explicit:

    efficient_multi_steps(k)( clip_by_global_norm(max_norm), adam(lr),
                              add_decayed_weights(-weight_decay) )

* accumulation: a running MEAN of the k microbatch gradients
  (acc = g at n = 0, else acc + (g - acc) / (n + 1)); the inner update
  runs only at n == k - 1 and only emitted steps advance the step count;
* clipping applies to the accumulated mean: scaled by max_norm / |g|
  (divided, then multiplied, as optax) only when |g| >= max_norm;
* Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8 outside the square
  root of the bias-corrected second moment); the learning rate of the
  update is ``schedule(count)`` at the count BEFORE it increments (optax's
  ``scale_by_schedule``), so with ``noam_schedule``'s clamp to step 1 the
  first two updates share ``lr(1)``;
* weight decay, as the JAX chain has it (ROADMAP C1): ``-weight_decay *
  param`` added to Adam's update, not scaled by the learning rate, inside
  the accumulator, so it is scaled by the step's ``lr_scale`` with the
  rest. Upstream neural_sp applies coupled L2 before the optimizer
  instead; the port mirrors the JAX package.

``SGD`` is ``optax.sgd(lr)`` in the same chain as Adam (the accumulator,
the clip, the update ``-lr(count) * g``, then the weight decay, unscaled
by the lr, C1). The JAX train CLI's switch at ``convert_to_sgd_epoch``
builds it with neither accumulation (every microstep emits), weight
decay nor schedule; its state is then empty, as optax's. With a schedule
the state holds the count, with accumulation the accumulator and the
cycle's position.

``Momentum`` is ``optax.sgd(lr, momentum=MOMENTUM, nesterov=)`` in the
same chain as Adam (the accumulator, the clip, then the update, then the
weight decay, unscaled by the lr, C1): the trace t <- g + MOMENTUM t and
the update -lr(count) t, or with nesterov -lr(count) (g + MOMENTUM t) of
the new trace, as optax's ``trace``.

``init(params)`` makes the state (moments, the accumulator, the counts),
which then lives in the object; ``update(grads)`` returns the parameter
updates (to be scaled by the step's ``lr_scale`` and added) when it emits,
and None otherwise. ``state_dict(names)`` / ``load_state_dict(state,
names)`` carry that state by parameter name, for checkpoints. The other
optimizers raise (ROADMAP).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

Schedule = Callable[[int], float]
B1, B2, EPS = 0.9, 0.999, 1e-8      # optax.adam's defaults
MOMENTUM = 0.9                      # the JAX package's sgd momentum


class Adam:
    def __init__(self, lr: Union[float, Schedule] = 1e-3,
                 clip_grad_norm: float = 5.0, accum_grad_n_steps: int = 1,
                 weight_decay: float = 0.0):
        self.schedule = lr if callable(lr) else (lambda step: lr)
        self.clip_grad_norm = clip_grad_norm
        self.weight_decay = weight_decay
        self.k = max(accum_grad_n_steps, 1)
        self.mu = self.nu = self.acc = None
        self.name = "adam"
        self.count = 0        # emitted (real) optimizer steps
        self.mini_step = 0    # position in the accumulation cycle

    def init(self, params: Sequence[torch.Tensor]) -> None:
        self.params = list(params)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.mini_step = 0

    def _accumulate(self, grads: Sequence[torch.Tensor]) -> bool:
        """Fold ``grads`` into the running mean; True at the cycle's last
        microstep (the step emits)."""
        n = self.mini_step
        for a, g in zip(self.acc, grads):
            if n == 0:
                a.copy_(g)
            else:
                a.add_((g - a) * (1.0 / (n + 1)))
        self.mini_step = (n + 1) % self.k
        return n == self.k - 1

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]
               ) -> Optional[list[torch.Tensor]]:
        if not self._accumulate(grads):
            return None
        g = clip_by_global_norm(self.acc, self.clip_grad_norm)
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1.0 - B1 ** self.count
        c2 = 1.0 - B2 ** self.count
        updates = []
        for mu, nu, x, p in zip(self.mu, self.nu, g, self.params):
            mu.mul_(B1).add_((1.0 - B1) * x)
            nu.mul_(B2).add_((1.0 - B2) * x * x)
            u = -lr * ((mu / c1) / (torch.sqrt(nu / c2) + EPS))
            if self.weight_decay > 0:
                u = u + (-self.weight_decay) * p
            updates.append(u)
        return updates

    def state_dict(self, names: Sequence[str]) -> dict:
        """The state by parameter name (``names`` in the order of the
        parameters given to ``init``); tensors are the live ones."""
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": dict(zip(names, self.mu)),
                "nu": dict(zip(names, self.nu)),
                "acc": dict(zip(names, self.acc))}

    @torch.no_grad()
    def load_state_dict(self, state: dict, names: Sequence[str]) -> None:
        """Copy ``state`` (as ``state_dict`` gives it) into the state that
        ``init`` made; every name must be there, with its shape. The state
        of ``SGD`` raises: a run resumed past ``convert_to_sgd_epoch``
        builds the conf's optimizer, as the JAX CLI does, and cannot
        restore it (ROADMAP C10)."""
        if state.get("optimizer") == "sgd":
            raise ValueError(
                "the checkpoint holds the SGD state of a run past its "
                "convert_to_sgd_epoch; the conf's optimizer (Adam) cannot "
                "restore it, as in the JAX train CLI (see ROADMAP C10)")
        if state.get("optimizer", self.name) != self.name:
            raise ValueError(f"not the state of {self.name}: "
                             f"{state['optimizer']}")
        self._load(state, names, self._moments())
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])

    def _moments(self) -> tuple:
        return (("mu", self.mu), ("nu", self.nu), ("acc", self.acc))

    @staticmethod
    def _load(state: dict, names: Sequence[str], moments) -> None:
        for key, mine in moments:
            missing = set(names) - set(state[key])
            if missing:
                raise KeyError(f"optimizer state {key} lacks {sorted(missing)}")
            for name, t in zip(names, mine):
                t.copy_(state[key][name])


class Momentum(Adam):
    """``optax.sgd(lr, momentum=MOMENTUM, nesterov=nesterov)`` in Adam's
    chain (accumulation, clip, update, weight decay); its state is the
    trace instead of the two moments."""

    def __init__(self, lr: Union[float, Schedule] = 1e-3,
                 nesterov: bool = False, clip_grad_norm: float = 5.0,
                 accum_grad_n_steps: int = 1, weight_decay: float = 0.0):
        super().__init__(lr, clip_grad_norm, accum_grad_n_steps,
                         weight_decay)
        self.nesterov = nesterov
        self.name = "nesterov" if nesterov else "momentum"

    def init(self, params: Sequence[torch.Tensor]) -> None:
        super().init(params)
        self.trace, self.mu, self.nu = self.mu, None, None

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]
               ) -> Optional[list[torch.Tensor]]:
        if not self._accumulate(grads):
            return None
        g = clip_by_global_norm(self.acc, self.clip_grad_norm)
        lr = self.schedule(self.count)
        self.count += 1
        updates = []
        for t, x, p in zip(self.trace, g, self.params):
            t.mul_(MOMENTUM).add_(x)
            u = x + MOMENTUM * t if self.nesterov else t.clone()
            u = -lr * u
            if self.weight_decay > 0:
                u = u + (-self.weight_decay) * p
            updates.append(u)
        return updates

    def state_dict(self, names: Sequence[str]) -> dict:
        return {"optimizer": self.name, "count": self.count,
                "mini_step": self.mini_step,
                "trace": dict(zip(names, self.trace)),
                "acc": dict(zip(names, self.acc))}

    def _moments(self) -> tuple:
        return (("trace", self.trace), ("acc", self.acc))


class SGD(Adam):
    """``optax.sgd(lr)`` in Adam's chain (accumulation, clip, update,
    weight decay); no moments. Without a schedule or accumulation its
    state is empty, as optax's."""

    def __init__(self, lr: Union[float, Schedule] = 1e-3,
                 clip_grad_norm: float = 5.0, accum_grad_n_steps: int = 1,
                 weight_decay: float = 0.0):
        super().__init__(lr, clip_grad_norm, accum_grad_n_steps,
                         weight_decay)
        self.name = "sgd"
        self.scheduled = callable(lr)

    def init(self, params: Sequence[torch.Tensor]) -> None:
        self.params = list(params)
        # the running mean only when it has more than one microstep
        self.acc = [torch.zeros_like(p) for p in self.params] \
            if self.k > 1 else []
        self.count = 0
        self.mini_step = 0

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]
               ) -> Optional[list[torch.Tensor]]:
        if self.k > 1:
            if not self._accumulate(grads):
                return None
            grads = self.acc
        g = clip_by_global_norm(grads, self.clip_grad_norm)
        lr = self.schedule(self.count)
        self.count += 1
        updates = [(-lr) * x for x in g]
        if self.weight_decay > 0:
            updates = [u + (-self.weight_decay) * p
                       for u, p in zip(updates, self.params)]
        return updates

    def state_dict(self, names: Sequence[str]) -> dict:
        state = {"optimizer": "sgd"}
        if self.scheduled:
            state["count"] = self.count
        if self.k > 1:
            state.update(count=self.count, mini_step=self.mini_step,
                         acc=dict(zip(names, self.acc)))
        return state

    @torch.no_grad()
    def load_state_dict(self, state: dict, names: Sequence[str]) -> None:
        if state.get("optimizer") != "sgd":
            raise ValueError("not the state of SGD")
        if self.k > 1:
            self._load(state, names, (("acc", self.acc),))
        self.count = int(state.get("count", 0))
        self.mini_step = int(state.get("mini_step", 0))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax.global_norm)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> list[torch.Tensor]:
    """optax.clip_by_global_norm (none at ``max_norm`` 0): scaled by
    max_norm / |g| (divided, then multiplied, as optax) only when |g| >=
    max_norm."""
    if max_norm <= 0:
        return list(grads)
    g_norm = global_norm(grads)
    clipped = g_norm >= max_norm
    return [torch.where(clipped, x / g_norm * max_norm, x) for x in grads]


def build_optimizer(optimizer: str = "adam",
                    lr: float = 1e-3, weight_decay: float = 0.0,
                    clip_grad_norm: float = 5.0, schedule=None,
                    accum_grad_n_steps: int = 1) -> Union[Adam, SGD]:
    """'adam' and 'noam' (adam + a schedule, e.g. ``noam_schedule``),
    'momentum' and 'nesterov' (optax's sgd with ``MOMENTUM``) and 'sgd',
    each with a schedule, accumulation and weight decay when asked for, as
    the JAX package's ``build_optimizer``; the others raise."""
    if optimizer in ("momentum", "nesterov"):
        return Momentum(schedule if schedule is not None else lr,
                        optimizer == "nesterov", clip_grad_norm,
                        accum_grad_n_steps, weight_decay)
    if optimizer == "sgd":
        return SGD(schedule if schedule is not None else lr, clip_grad_norm,
                   accum_grad_n_steps, weight_decay)
    if optimizer not in ("adam", "noam", "noam_adam"):
        raise NotImplementedError(
            f"optimizer {optimizer!r} is not ported yet (adam, noam, "
            f"momentum, nesterov and sgd only), see ROADMAP")
    return Adam(schedule if schedule is not None else lr, clip_grad_norm,
                accum_grad_n_steps, weight_decay)
