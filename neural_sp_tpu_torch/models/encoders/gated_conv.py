"""Gated convolutional (GLU) encoder (counterpart of
``neural_sp_tpu/models/encoders/gated_conv.py``): a stack of non-causal
``ConvGLUBlock``s with residuals, a Linear ``resize{i}`` before a block
whose width differs from its input's, then a final FC-GLU; no time
subsampling. Plain PyTorch (cuDNN's convolutions), as the JAX package
computes it in plain JAX. The layers come from ``layers``,
'_'-separated 'channels:kernel' (JAX's builder reads ``gated_conv_layers``
and not the recipes' ``conv_channels`` / ``conv_kernel_sizes``: ROADMAP
C42).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..modules.glu import ConvGLUBlock, LinearGLUBlock


class GatedConvEncoder(nn.Module):
    def __init__(self, input_dim: int, layers: str = "100:3_100:3_100:3",
                 dropout: float = 0.0, last_proj_dim: int = 0,
                 bottleneck_dim: int = 0):
        super().__init__()
        specs = [tuple(int(x) for x in tok.split(":"))
                 for tok in layers.split("_")]
        in_ch = input_dim
        self.n_layers = len(specs)
        for i, (ch, k) in enumerate(specs):
            if in_ch != ch:
                setattr(self, f"resize{i}", nn.Linear(in_ch, ch))
                in_ch = ch
            setattr(self, f"glu{i}", ConvGLUBlock(k, ch, ch, bottleneck_dim,
                                                  dropout))
        self.fc_glu = LinearGLUBlock(in_ch, specs[-1][0])
        self.output_dim = last_proj_dim or specs[-1][0]
        if last_proj_dim > 0:
            self.bridge = nn.Linear(specs[-1][0], last_proj_dim)
        self.subsampling_factor = 1

    def forward(self, xs: torch.Tensor, xlens: torch.Tensor,
                task: str = "all", gen: Optional[torch.Generator] = None):
        """xs [B, T, input_dim], xlens [B] -> {"ys": {"xs": [B, T,
        output_dim], "xlens": xlens}}."""
        h = xs
        for i in range(self.n_layers):
            if hasattr(self, f"resize{i}"):
                h = getattr(self, f"resize{i}")(h)
            h = getattr(self, f"glu{i}")(h, gen)
        h = self.fc_glu(h)
        if hasattr(self, "bridge"):
            h = self.bridge(h)
        return {"ys": {"xs": h, "xlens": xlens}}
