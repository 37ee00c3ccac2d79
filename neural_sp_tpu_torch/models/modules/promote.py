"""Layers that compute in the promoted type of their input and parameters,
as flax's ``Dense``, ``Conv`` and ``LayerNorm`` do (``promote_dtype``).

Under a bf16 ``compute_dtype`` every floating parameter is bf16, but not
every activation: an LSTM's output is float32 (flax's ``nn.RNN`` starts
from a float32 carry, see ``recurrent.py``), and so is everything computed
from it. flax then casts the bf16 weight up and computes in float32 over
the bf16-rounded values; PyTorch's ``F.linear`` / ``F.conv1d`` /
``F.layer_norm`` refuse two types. These subclasses cast both sides to the
promoted type first, and are ``nn.Linear`` / ``nn.Conv1d`` /
``nn.LayerNorm`` themselves where the types agree.
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


def promoted(x: torch.Tensor, *params):
    """``params`` (None kept) in the promoted type of x and the first of
    them, and x in it too: (x, *params)."""
    dt = torch.promote_types(x.dtype, params[0].dtype)
    return (x.to(dt), *(None if p is None else p.to(dt) for p in params))


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return F.linear(x, self.weight, self.bias)
        return F.linear(*promoted(x, self.weight, self.bias))


class Conv1d(nn.Conv1d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return self._conv_forward(*promoted(x, self.weight, self.bias))


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight is None or x.dtype == self.weight.dtype:
            return super().forward(x)
        x, w, b = promoted(x, self.weight, self.bias)
        return F.layer_norm(x, self.normalized_shape, w, b, self.eps)
