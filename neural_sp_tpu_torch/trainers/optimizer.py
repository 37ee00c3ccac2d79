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


class Adam:
    def __init__(self, lr: Union[float, Schedule] = 1e-3,
                 clip_grad_norm: float = 5.0, accum_grad_n_steps: int = 1,
                 weight_decay: float = 0.0):
        self.schedule = lr if callable(lr) else (lambda step: lr)
        self.clip_grad_norm = clip_grad_norm
        self.weight_decay = weight_decay
        self.k = max(accum_grad_n_steps, 1)
        self.mu = self.nu = self.acc = None
        self.count = 0        # emitted (real) optimizer steps
        self.mini_step = 0    # position in the accumulation cycle

    def init(self, params: Sequence[torch.Tensor]) -> None:
        self.params = list(params)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.mini_step = 0

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]
               ) -> Optional[list[torch.Tensor]]:
        n = self.mini_step
        for a, g in zip(self.acc, grads):
            if n == 0:
                a.copy_(g)
            else:
                a.add_((g - a) * (1.0 / (n + 1)))
        self.mini_step = (n + 1) % self.k
        if n != self.k - 1:
            return None
        g = self.acc
        if self.clip_grad_norm > 0:
            g_norm = global_norm(g)
            clipped = g_norm >= self.clip_grad_norm
            g = [torch.where(clipped, x / g_norm * self.clip_grad_norm, x)
                 for x in g]
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
        ``init`` made; every name must be there, with its shape."""
        for key, mine in (("mu", self.mu), ("nu", self.nu),
                          ("acc", self.acc)):
            missing = set(names) - set(state[key])
            if missing:
                raise KeyError(f"optimizer state {key} lacks {sorted(missing)}")
            for name, t in zip(names, mine):
                t.copy_(state[key][name])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax.global_norm)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def build_optimizer(optimizer: str = "adam",
                    lr: float = 1e-3, weight_decay: float = 0.0,
                    clip_grad_norm: float = 5.0, schedule=None,
                    accum_grad_n_steps: int = 1) -> Adam:
    """'adam' and 'noam' (adam + a schedule, e.g. ``noam_schedule``), with
    weight decay when ``weight_decay`` > 0, as the JAX factory builds
    them."""
    if optimizer not in ("adam", "noam", "noam_adam"):
        raise NotImplementedError(
            f"optimizer {optimizer!r} is not ported yet (adam and noam "
            f"only), see ROADMAP")
    return Adam(schedule if schedule is not None else lr, clip_grad_norm,
                accum_grad_n_steps, weight_decay)
