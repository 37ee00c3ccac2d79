"""Conformer convolution module (counterpart of
``neural_sp_tpu/models/modules/conformer_convolution.py``), offline form:
pointwise -> GLU -> batch-edge zeroing -> depthwise -> LayerNorm -> swish
-> pointwise."""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

LN_EPS = 1e-6   # flax nn.LayerNorm's default (torch's is 1e-5)


class ConformerConvBlock(nn.Module):
    def __init__(self, d_model: int, kernel_size: int = 15,
                 normalization: str = "layer_norm"):
        super().__init__()
        if normalization != "layer_norm":
            raise NotImplementedError(
                "batch_norm / group_norm conformer convolution is not "
                "ported yet, see ROADMAP")
        self.kernel_size = kernel_size
        self.pointwise1 = nn.Linear(d_model, 2 * d_model)
        self.depthwise = nn.Conv1d(d_model, d_model, kernel_size,
                                   groups=d_model)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.pointwise2 = nn.Linear(d_model, d_model)

    def forward(self, xs: torch.Tensor, edge: torch.Tensor) -> torch.Tensor:
        """xs [B, T, D]; edge [T] bool, position < max(xlens). Frames from
        the batch edge on are zeroed before the depthwise conv, so a
        bucket-padded batch computes the same valid frames as a packed one
        (per-utterance pad frames are NOT zeroed, as in the JAX module)."""
        a, b = self.pointwise1(xs).chunk(2, dim=-1)
        h = torch.where(edge[None, :, None], a * torch.sigmoid(b), 0.0)
        k = self.kernel_size
        left = (k - 1) // 2
        h = F.pad(h.transpose(1, 2), (left, k - 1 - left))
        h = self.depthwise(h).transpose(1, 2)
        return self.pointwise2(F.silu(self.norm(h)))
