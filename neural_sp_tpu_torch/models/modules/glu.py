"""GLU block (counterpart of ``neural_sp_tpu/models/modules/glu.py``):
``LinearGLUBlock``, the RNNLM's head. The JAX module's ``ConvGLUBlock``
belongs to the gated-conv encoder and LM, which are not ported."""
from __future__ import annotations

import torch
from torch import nn


class LinearGLUBlock(nn.Module):
    """One Linear to 2 * size, then a * sigmoid(b) of its two halves."""

    def __init__(self, in_dim: int, size: int):
        super().__init__()
        self.fc = nn.Linear(in_dim, 2 * size)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        a, b = self.fc(xs).chunk(2, dim=-1)
        return a * torch.sigmoid(b)
