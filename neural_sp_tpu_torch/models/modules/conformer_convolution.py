"""Conformer convolution module (counterpart of
``neural_sp_tpu/models/modules/conformer_convolution.py``): pointwise ->
GLU -> batch-edge zeroing -> depthwise (symmetric, or causal: k - 1 frames
of left padding) -> LayerNorm -> swish -> pointwise.

Streaming: the causal depthwise conv takes its k - 1 frames of left
context from ``conv_cache`` (the tail of the previous block's GLU output)
and returns the new tail, cut after the block's first ``cur_len`` frames
so that lookahead frames never enter it."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

LN_EPS = 1e-6   # flax nn.LayerNorm's default (torch's is 1e-5)


class ConformerConvBlock(nn.Module):
    def __init__(self, d_model: int, kernel_size: int = 15,
                 normalization: str = "layer_norm", causal: bool = False):
        super().__init__()
        if normalization != "layer_norm":
            raise NotImplementedError(
                "batch_norm / group_norm conformer convolution is not "
                "ported yet, see ROADMAP")
        self.kernel_size, self.causal = kernel_size, causal
        self.pointwise1 = nn.Linear(d_model, 2 * d_model)
        self.depthwise = nn.Conv1d(d_model, d_model, kernel_size,
                                   groups=d_model)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.pointwise2 = nn.Linear(d_model, d_model)

    def forward(self, xs: torch.Tensor, edge: Optional[torch.Tensor],
                conv_cache: Optional[torch.Tensor] = None,
                cur_len: Optional[int] = None):
        """xs [B, T, D]; edge [T] bool, position < max(xlens), or None (a
        streaming block). Frames from the batch edge on are zeroed before
        the depthwise conv, so a bucket-padded batch computes the same
        valid frames as a packed one (per-utterance pad frames are NOT
        zeroed, as in the JAX module). Returns [B, T, D]; with
        ``conv_cache`` [B, k - 1, D] (causal only), (out, new cache)."""
        a, b = self.pointwise1(xs).chunk(2, dim=-1)
        h = a * torch.sigmoid(b)
        if edge is not None:
            h = torch.where(edge[None, :, None], h, 0.0)
        k = self.kernel_size
        left = k - 1 if self.causal else (k - 1) // 2
        new_cache = None
        if conv_cache is not None:
            if not self.causal:
                raise ValueError("a conv cache needs the causal conv")
            h = torch.cat([conv_cache, h], 1)
            m = conv_cache.shape[1]
            new_cache = h[:, :m + (xs.shape[1] if cur_len is None
                                   else cur_len)][:, -left:]
            h = F.pad(h.transpose(1, 2), (0, k - 1 - left))
        else:
            h = F.pad(h.transpose(1, 2), (left, k - 1 - left))
        h = self.depthwise(h).transpose(1, 2)
        out = self.pointwise2(F.silu(self.norm(h)))
        return out if conv_cache is None else (out, new_cache)
