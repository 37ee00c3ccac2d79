"""Position-wise feed-forward network (counterpart of
``neural_sp_tpu/models/modules/feed_forward.py``): w1 -> activation ->
dropout -> w2, with swish (the conformer's FFN) or relu (the transformer
blocks' ``transformer_ffn_activation``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from ...ops.dropout import Dropout
from .promote import Linear

_ACTIVATIONS = {"swish": F.silu, "silu": F.silu, "relu": F.relu}


class FFN(nn.Module):
    def __init__(self, d_model: int, d_ff: int, activation: str = "swish",
                 bottleneck_dim: int = 0, dropout: float = 0.0):
        super().__init__()
        if activation not in _ACTIVATIONS or bottleneck_dim > 0:
            raise NotImplementedError(
                f"FFN activation {activation!r} / bottleneck is not ported "
                f"yet (swish and relu are), see ROADMAP")
        self.act = _ACTIVATIONS[activation]
        self.w1 = Linear(d_model, d_ff)
        self.w2 = Linear(d_ff, d_model)
        self.drop = Dropout(dropout)

    def forward(self, xs: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.w2(self.drop(self.act(self.w1(xs)), gen))
