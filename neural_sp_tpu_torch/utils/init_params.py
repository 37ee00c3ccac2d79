"""Seeded initialisation of the port's weights from a ``torch.Generator``.

It follows flax's default initialisers in scale, not in values: weights
are normal with std ``1/sqrt(fan_in)`` (lecun normal, untruncated), biases
zero (also a free one that belongs to no Linear, such as an RNNLM's
``output_bias``), norm scales one, embeddings normal with std
``1/sqrt(emb_dim)``; MoChA's energy vector ``v`` [H, A] has flax's
``lecun_normal`` fan-in H, its offset ``r`` the module's ``init_r``. The numbers are drawn on the CPU in a fixed order, so
one seed gives the same model on any device.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def _fan_in(module: nn.Module, name: str, p: torch.Tensor) -> int:
    if isinstance(module, nn.Linear):
        return p.shape[1]
    if isinstance(module, (nn.Conv1d, nn.Conv2d)):
        return p[0].numel()             # (in / groups) x kernel taps
    if name in ("w_ih", "w_hh"):        # LSTMCell: [in, 4H]
        return p.shape[0]
    if name.startswith(("weight_ih", "weight_hh")):   # nn.LSTM: [4H, in]
        return p.shape[1]
    if name == "v":                     # MoChA energy [H, A]: lecun_normal
        return p.shape[0]
    raise ValueError(f"no fan-in rule for {type(module).__name__}.{name}")


@torch.no_grad()
def init_params(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter of ``model`` in place; returns ``model``."""
    gen = torch.Generator().manual_seed(seed)
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if isinstance(module, nn.LayerNorm):
                val = torch.ones(p.shape) if name == "weight" else \
                    torch.zeros(p.shape)
            elif isinstance(module, nn.Embedding):
                val = torch.randn(p.shape, generator=gen) / \
                    math.sqrt(p.shape[1])
            elif name == "r" and hasattr(module, "init_r"):
                val = torch.full(p.shape, float(module.init_r))
            elif name == "bias" or name.endswith("_bias") or \
                    name.startswith("bias_"):
                val = torch.zeros(p.shape)
            else:
                val = torch.randn(p.shape, generator=gen) / \
                    math.sqrt(_fan_in(module, name, p))
            p.copy_(val)
    return model
