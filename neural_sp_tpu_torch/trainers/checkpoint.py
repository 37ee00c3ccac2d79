"""Checkpoints of the port (counterpart of
``neural_sp_tpu/trainers/checkpoint.py``, which writes orbax directories
that the card's machine cannot read).

``<save_dir>/ckpt.epoch-N`` is one ``torch.save`` file of a dict:

* ``model``: the model's ``state_dict``;
* ``optimizer``: the Adam state (``Adam.state_dict``: count, mini_step,
  and the mu, nu and accumulator tensors by parameter name), when given;
* ``controller``: the ``EpochController``'s ``state_dict``, when given.

The names follow the JAX package's, so ``latest_epoch`` and a
``--recog_model .../ckpt.epoch-N`` path work as there. Saving keeps the
top-k epochs and deletes the rest; ``average_checkpoints`` averages the
models of several epochs in float64 and casts to float32, as the JAX
package's does. ``utils/convert_params.py::convert_checkpoint`` turns a
JAX checkpoint into this format.
"""
from __future__ import annotations

import os
import re

import torch

_CKPT = re.compile(r"ckpt\.epoch-(\d+)$")


def ckpt_path(save_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(save_dir), f"ckpt.epoch-{epoch}")


def _to_cpu(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def save_checkpoint(save_dir: str, epoch: int, model_state: dict,
                    optimizer_state: dict | None = None,
                    controller_state: dict | None = None,
                    keep_epochs: list[int] | None = None) -> str:
    """Write ``ckpt.epoch-{epoch}`` (through a temporary file, so a cut run
    leaves no half-written checkpoint) and, with ``keep_epochs``, delete
    every other epoch's checkpoint not in it."""
    payload = {"model": _to_cpu(model_state)}
    if optimizer_state is not None:
        payload["optimizer"] = _to_cpu(optimizer_state)
    if controller_state is not None:
        payload["controller"] = dict(controller_state)
    path = ckpt_path(save_dir, epoch)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    if keep_epochs is not None:
        for d in os.listdir(save_dir):
            m = _CKPT.match(d)
            if m and int(m.group(1)) not in keep_epochs and \
                    int(m.group(1)) != epoch:
                os.remove(os.path.join(save_dir, d))
    return path


def load_checkpoint(path: str) -> dict:
    """The payload of a checkpoint, tensors on the CPU, mapped from the
    file: a tensor is read when it is used (evaluation reads the model and
    never the optimizer state)."""
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def latest_epoch(save_dir: str) -> int | None:
    if not os.path.isdir(save_dir):
        return None
    epochs = [int(m.group(1)) for d in os.listdir(save_dir)
              if (m := _CKPT.match(d))]
    return max(epochs) if epochs else None


def average_checkpoints(save_dir: str, epochs: list[int]) -> dict:
    """The uniform average of the epochs' model state_dicts, summed in
    float64 and cast to float32."""
    if not epochs:
        raise ValueError("no epochs to average")
    acc = None
    for e in epochs:
        sd = load_checkpoint(ckpt_path(save_dir, e))["model"]
        if acc is None:
            acc = {k: v.double() for k, v in sd.items()}
        else:
            for k, v in sd.items():
                acc[k] += v.double()
    return {k: (v / len(epochs)).float() for k, v in acc.items()}
