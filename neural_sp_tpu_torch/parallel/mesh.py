"""The training step (counterpart of ``neural_sp_tpu/parallel/mesh.py::
make_train_step``), single device, and the random-state-passing step
(``make_rsp_train_step``). Data parallelism over a mesh is not ported yet
(ROADMAP).

``compute_dtype`` is the JAX step's mixed-precision policy: with
``torch.bfloat16`` each microstep runs the model through
``torch.func.functional_call`` with every floating parameter cast to bf16
and the features cast to bf16, as JAX's ``cast_floating`` inside its loss.
The casts are differentiable, so the gradients land in the float32 master
parameters' ``.grad``; the Adam moments, ``grad_norm`` and the returned
loss stay float32. The losses, the softmaxes and the LayerNorm statistics
are computed in float32 by the modules themselves (``F.layer_norm`` keeps
its statistics in float32 for a bf16 input; the K1 / K1b kernels and K3 /
K3b keep their softmaxes and state in float32). Not every activation is
bf16, as in JAX: an LSTM layer without a carry computes in float32 (flax's
float32 zero carry), and the layers after it promote their bf16 weights
to float32 (``models/modules/promote.py``), as flax's ``promote_dtype``.

``torch.autocast`` is not used: its per-op lists are not the JAX policy.
It keeps some outputs in float32 (so bf16 would not flow through the
model) and casts the weights again at every op that takes them.

A microstep is the same bits in every run, as the JAX step is for a given
key: the port's kernels sum in fixed orders, and the step selects cuDNN's
deterministic algorithms (``deterministic_cudnn``), since its default
weight-gradient convolutions for the front end's Conv2d add in an order
that changes between runs.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Union

import torch
from torch import nn
from torch.func import functional_call

from ..trainers.optimizer import Adam, SGD, global_norm


def compute_loss(model: nn.Module, compute_dtype: Optional[torch.dtype],
                 xs, xlens, ys, ylens,
                 gen: Optional[torch.Generator] = None, **sub_labels):
    """(loss, obs) of ``model`` on one microbatch under the precision
    policy: the model as it is when ``compute_dtype`` is None, else its
    floating parameters and ``xs`` cast to ``compute_dtype`` (the casts
    differentiable, the loss returned in float32). ``sub_labels``: the
    hierarchical sub-tasks' ``ys_sub1`` / ``ylens_sub1`` / ``ys_sub2`` /
    ``ylens_sub2`` and the ``trigger_points`` (None entries dropped)."""
    sub_labels = {k: v for k, v in sub_labels.items() if v is not None}
    if compute_dtype is None:
        return model(xs, xlens, ys, ylens, gen, **sub_labels)
    loss, obs = functional_call(
        model, cast_params(model, compute_dtype),
        (xs.to(compute_dtype), xlens, ys, ylens, gen), sub_labels)
    return loss.float(), obs


def cast_params(model: nn.Module, dtype: torch.dtype) -> dict:
    """JAX's ``cast_floating`` of the parameters: each floating one in
    ``dtype`` (a differentiable cast), by name, for ``functional_call``."""
    return {name: p.to(dtype) if p.is_floating_point() else p
            for name, p in model.named_parameters()}


def compute_loss_with_carry(model: nn.Module,
                            compute_dtype: Optional[torch.dtype], carry,
                            xs, xlens, ys, ylens,
                            gen: Optional[torch.Generator] = None):
    """(loss, obs, new_carry) of ``model.forward_with_carry`` from the RNN
    encoder's ``carry`` (None: zeros) under the precision policy of
    ``compute_loss``; under ``compute_dtype`` the carry is cast too, and a
    None carry becomes zeros of that type, as JAX's random-state-passing
    step casts its carry (always an array there)."""
    if compute_dtype is None:
        return model.forward_with_carry(xs, xlens, ys, ylens, carry, gen)
    carry = cast_floating(carry, compute_dtype) if carry is not None else \
        model.encoder.zero_carry(xs.shape[0], compute_dtype, xs.device)
    params = cast_params(model, compute_dtype)
    loss, obs, new = functional_call(
        _WithCarry(model), {"model." + k: v for k, v in params.items()},
        (xs.to(compute_dtype), xlens, ys, ylens, carry, gen))
    return loss.float(), obs, new


class _WithCarry(nn.Module):
    """``model.forward_with_carry`` as a module's forward, so that
    ``functional_call`` can run it over cast parameters."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args):
        return self.model.forward_with_carry(*args)


def cast_floating(tree, dtype: torch.dtype):
    """Every floating tensor of a nested tuple / list in ``dtype``."""
    if torch.is_tensor(tree):
        return tree.to(dtype) if tree.is_floating_point() else tree
    return type(tree)(cast_floating(t, dtype) for t in tree)


@contextmanager
def deterministic_cudnn():
    """``torch.backends.cudnn.deterministic`` inside, as it was after."""
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.deterministic = before


class TrainStep:
    """``step(xs, xlens, ys, ylens, lr_scale=1.0, gen=None, **sub_labels)
    -> metrics``: one microbatch forward and backward (with the sub-tasks'
    labels, as JAX's ``make_train_step``), then the optimizer (which holds
    its state and decides whether this microstep emits an update); an
    emitted update is scaled by ``lr_scale`` and added to the parameters.
    The model runs in the mode it is in: ``train()`` draws SpecAugment and
    dropout from ``gen`` (the JAX step's ``deterministic=False``), and in
    ``compute_dtype`` (see ``compute_loss``).

    metrics: the scalar observations of the loss ("loss", "loss_ctc",
    "loss_att", "acc_att", "ppl_att"), "grad_norm" (the global norm of this
    microbatch's gradients, before accumulation and clipping), as float32
    0-dim tensors on the model's device (no host sync), and "emitted"
    (bool).

    A run switches optimizers (the JAX CLI's ``convert_to_sgd_epoch``) by
    building a new step over the same model with the new optimizer, whose
    ``init`` makes its state afresh."""

    def __init__(self, model: nn.Module, opt: Union[Adam, SGD],
                 compute_dtype: Optional[torch.dtype] = None):
        self.model = model
        self.opt = opt
        self.compute_dtype = compute_dtype
        self.params = [p for p in model.parameters() if p.requires_grad]
        opt.init(self.params)

    def __call__(self, xs, xlens, ys, ylens, lr_scale: float = 1.0,
                 gen: Optional[torch.Generator] = None,
                 **sub_labels) -> dict:
        return self.update(lambda: compute_loss(
            self.model, self.compute_dtype, xs, xlens, ys, ylens, gen,
            **sub_labels), lr_scale)[0]

    def update(self, loss_fn, lr_scale: float) -> tuple:
        """One microstep of ``loss_fn() -> (loss, obs, *rest)``: its
        backward, then the optimizer. Returns (metrics, rest)."""
        for p in self.params:
            p.grad = None
        with deterministic_cudnn():
            loss, obs, *rest = loss_fn()
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
        return metrics, rest


def rsp_draw(gen: Optional[torch.Generator], rsp_prob: float) -> bool:
    """Random state passing's draw of one step: True (pass the carry on)
    with probability ``rsp_prob``, from the step's generator."""
    return bool(torch.rand((), generator=gen) < rsp_prob)


class RSPTrainStep(TrainStep):
    """JAX's ``make_rsp_train_step``: ``step(carry, xs, xlens, ys, ylens,
    lr_scale=1.0, gen=None) -> (metrics, new_carry)``. The RNN encoder
    starts from the previous batch's carry where ``rsp_draw`` says so, else
    from zeros (carry None: zeros); the loss is
    ``Speech2Text.forward_with_carry``'s; the new carry is detached (no
    gradient crosses batches).

    Under ``compute_dtype`` (bf16) the parameters, ``xs`` and the carry are
    cast (``compute_loss_with_carry``), as JAX's step casts them: JAX's
    carry is always an array (zeros where the draw says so), so every layer
    starts from a bf16 carry and the RNN encoder computes in bf16 (see
    ``modules/recurrent.py``); the new carry is bf16."""

    def __init__(self, model: nn.Module, opt: Union[Adam, SGD],
                 rsp_prob: float,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(model, opt, compute_dtype)
        self.rsp_prob = rsp_prob

    def __call__(self, carry, xs, xlens, ys, ylens, lr_scale: float = 1.0,
                 gen: Optional[torch.Generator] = None):
        carry_in = carry if rsp_draw(gen, self.rsp_prob) else None
        metrics, (new_carry,) = self.update(
            lambda: compute_loss_with_carry(
                self.model, self.compute_dtype, carry_in, xs, xlens, ys,
                ylens, gen), lr_scale)
        return metrics, _detach(new_carry)


def _detach(carry):
    """A carry (nested tuples and lists of tensors) without gradient."""
    if torch.is_tensor(carry):
        return carry.detach()
    return type(carry)(_detach(c) for c in carry)


def make_rsp_train_step(model: nn.Module, opt: Union[Adam, SGD],
                        rsp_prob: float,
                        compute_dtype: Optional[torch.dtype] = None
                        ) -> RSPTrainStep:
    """The counterpart of JAX ``make_rsp_train_step(model, tx, rsp_prob,
    compute_dtype=...)``."""
    return RSPTrainStep(model, opt, rsp_prob, compute_dtype)


def make_train_step(model: nn.Module, opt: Union[Adam, SGD], mesh=None,
                    compute_dtype: Optional[torch.dtype] = None) -> TrainStep:
    """The counterpart of JAX ``make_train_step(model, tx, mesh,
    compute_dtype=...)``: ``compute_dtype`` None trains in float32, a dtype
    (``torch.bfloat16``) computes in it over float32 master weights."""
    if mesh is not None:
        raise NotImplementedError(
            "a data-parallel mesh is not ported yet, see ROADMAP")
    return TrainStep(model, opt, compute_dtype)
