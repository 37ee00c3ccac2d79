"""Absolute positional encoding (counterpart of
``neural_sp_tpu/models/modules/positional_embedding.py::PositionalEncoding``).

The input is scaled by sqrt(d_model); with ``pe_type`` "add" (or
"1dconv3L_add") the sinusoid of positions ``offset .. offset + T - 1`` is
added, sin in the even and cos in the odd channels; then dropout. Every
other ``pe_type`` ("none", and the recipes' "1dconv3L", which the JAX
module reads as no positions at all: ROADMAP C21) only scales.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...ops.dropout import Dropout

ADDS_POSITIONS = ("add", "1dconv3L_add")


def sinusoid(t: int, d_model: int, offset: int = 0, device=None,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[t, d_model] table of positions offset .. offset + t - 1, computed
    in float32 as the JAX module: sin in the even channels, cos in the
    odd."""
    pos = (torch.arange(t, dtype=torch.float32, device=device)
           + float(offset))[:, None]
    inv = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=device)
                    * -(math.log(10000.0) / d_model))
    tab = torch.empty(t, d_model, dtype=torch.float32, device=device)
    tab[:, 0::2] = torch.sin(pos * inv)
    tab[:, 1::2] = torch.cos(pos * inv)
    return tab.to(dtype)


class PositionalEncoding(nn.Module):
    def __init__(self, d_model: int, pe_type: str = "add",
                 dropout: float = 0.0):
        super().__init__()
        self.d_model, self.pe_type = d_model, pe_type
        self.drop = Dropout(dropout)

    def forward(self, xs: torch.Tensor, offset: int = 0,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """xs [B, T, d_model]; ``offset`` the position of its first
        frame (a decode step's index)."""
        xs = xs * math.sqrt(self.d_model)
        if self.pe_type in ADDS_POSITIONS:
            xs = xs + sinusoid(xs.shape[1], self.d_model, offset, xs.device,
                               xs.dtype)
        return self.drop(xs, gen)
