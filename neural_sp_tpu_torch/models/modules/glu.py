"""GLU blocks (counterpart of ``neural_sp_tpu/models/modules/glu.py``):
``LinearGLUBlock``, the FC-GLU (the RNNLM's head, the gated-conv
encoder's last layer), and ``ConvGLUBlock``, the gated-conv encoder's
block and the body of the GCNN LM's causal one."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from ...ops.dropout import Dropout
from .promote import Conv1d, Linear


class LinearGLUBlock(nn.Module):
    """One Linear to 2 * size, then a * sigmoid(b) of its two halves."""

    def __init__(self, in_dim: int, size: int):
        super().__init__()
        self.fc = Linear(in_dim, 2 * size)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        a, b = self.fc(xs).chunk(2, dim=-1)
        return a * torch.sigmoid(b)


class ConvGLUBlock(nn.Module):
    """A Conv1d over time to twice the width, a * sigmoid(b) of its halves,
    with an optional bottleneck Linear on either side, dropout, and the
    residual scaled by sqrt(0.5) where the widths match: the JAX block
    with ``causal=False`` (padding ((k - 1) // 2, k // 2)), the gated-conv
    encoder's. The LM's causal block with its cache,
    ``models/lm/gated_convlm.py::CausalConvGLU``, extends it."""

    def __init__(self, kernel_size: int, in_ch: int, out_ch: int,
                 bottleneck_dim: int = 0, dropout: float = 0.0):
        super().__init__()
        width = bottleneck_dim or out_ch
        if bottleneck_dim > 0:
            self.bn_in = Linear(in_ch, bottleneck_dim)
            self.bn_out = Linear(bottleneck_dim, out_ch)
        self.conv = Conv1d(bottleneck_dim or in_ch, 2 * width,
                           kernel_size)
        self.drop = Dropout(dropout)

    def forward(self, xs: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """xs [B, T, in_ch] -> [B, T, out_ch]."""
        k = self.conv.kernel_size[0]
        h = self.bn_in(xs) if hasattr(self, "bn_in") else xs
        h = self.conv(F.pad(h.transpose(1, 2), ((k - 1) // 2, k // 2)))
        return self.gate(h.transpose(1, 2), xs, gen)

    def gate(self, h: torch.Tensor, xs: torch.Tensor,
             gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """The block after its convolution: the GLU of h [B, T, 2 width],
        the bottleneck's way back, dropout, the residual with xs."""
        a, b = h.chunk(2, -1)
        h = a * torch.sigmoid(b)
        if hasattr(self, "bn_out"):
            h = self.bn_out(h)
        h = self.drop(h, gen)
        if xs.shape[-1] == h.shape[-1]:
            h = (h + xs) * math.sqrt(0.5)
        return h
