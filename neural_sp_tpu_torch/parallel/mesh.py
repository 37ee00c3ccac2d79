"""The training step (counterpart of ``neural_sp_tpu/parallel/mesh.py::
make_train_step``), single device. Data parallelism over a mesh is not
ported yet (ROADMAP)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..trainers.optimizer import Adam, global_norm


class TrainStep:
    """``step(xs, xlens, ys, ylens, lr_scale=1.0, gen=None) -> metrics``:
    one microbatch forward and backward, then the optimizer (which holds
    its state and decides whether this microstep emits an update); an
    emitted update is scaled by ``lr_scale`` and added to the parameters.
    The model runs in the mode it is in: ``train()`` draws SpecAugment and
    dropout from ``gen`` (the JAX step's ``deterministic=False``).

    metrics: the scalar observations of the loss ("loss", "loss_ctc",
    "loss_att", "acc_att", "ppl_att"), "grad_norm" (the global norm of this
    microbatch's gradients, before accumulation and clipping), as 0-dim
    tensors on the model's device (no host sync), and "emitted" (bool)."""

    def __init__(self, model: nn.Module, opt: Adam):
        self.model = model
        self.opt = opt
        self.params = [p for p in model.parameters() if p.requires_grad]
        opt.init(self.params)

    def __call__(self, xs, xlens, ys, ylens, lr_scale: float = 1.0,
                 gen: Optional[torch.Generator] = None) -> dict:
        for p in self.params:
            p.grad = None
        loss, obs = self.model(xs, xlens, ys, ylens, gen)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        metrics = {k: v.detach().float() for k, v in obs.items()
                   if torch.is_tensor(v) and v.ndim == 0}
        metrics["grad_norm"] = global_norm(grads)
        updates = self.opt.update(grads)
        metrics["emitted"] = updates is not None
        if updates is not None:
            with torch.no_grad():
                for p, u in zip(self.params, updates):
                    p.add_(u * lr_scale)
        return metrics


def make_train_step(model: nn.Module, opt: Adam, mesh=None) -> TrainStep:
    if mesh is not None:
        raise NotImplementedError(
            "a data-parallel mesh is not ported yet, see ROADMAP")
    return TrainStep(model, opt)
