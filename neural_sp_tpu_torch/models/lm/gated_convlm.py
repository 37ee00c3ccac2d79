"""Gated convolutional LM, GCNN (counterpart of
``neural_sp_tpu/models/lm/gated_convlm.py``): a stack of causal ConvGLU
blocks with residuals, plain PyTorch (cuDNN's convolutions), as the JAX
package computes it in plain JAX.

A block: an optional bottleneck Dense, a Conv1d of kernel k over the input
padded with k - 1 frames on the left (or, stepping, over the cached k - 1
previous post-bottleneck inputs), a GLU, the bottleneck's way back, dropout
and the residual scaled by sqrt(0.5) (when the widths match, as they do
after the ``resizes`` Dense that precedes a change of width). The
incremental state is each block's cache [B, k - 1, bottleneck or
channels] (None for k = 1).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from ... import PAD
from ...ops.criterion import compute_accuracy, cross_entropy_lsm
from ...ops.dropout import Dropout
from ..utils import model_device


class CausalConvGLU(nn.Module):
    def __init__(self, channels: int, kernel_size: int,
                 bottleneck_dim: int = 0, dropout: float = 0.0):
        super().__init__()
        self.channels, self.kernel_size = channels, kernel_size
        self.bottleneck_dim = bottleneck_dim
        width = bottleneck_dim or channels
        if bottleneck_dim > 0:
            self.bn_in = nn.Linear(channels, bottleneck_dim)
            self.bn_out = nn.Linear(bottleneck_dim, channels)
        self.conv = nn.Conv1d(width, 2 * width, kernel_size)
        self.drop = Dropout(dropout)

    def forward(self, xs: torch.Tensor, cache: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None):
        """xs [B, T, channels]; cache [B, k - 1, width] of previous inputs,
        or None (left zero padding). Returns (out, new cache)."""
        k = self.kernel_size
        h = self.bn_in(xs) if self.bottleneck_dim > 0 else xs
        h_in = torch.cat([cache, h], 1) if cache is not None else h
        new_cache = h_in[:, -(k - 1):] if k > 1 else None
        c = h_in.transpose(1, 2)
        if cache is None:
            c = F.pad(c, (k - 1, 0))
        c = self.conv(c).transpose(1, 2)[:, -xs.shape[1]:]
        a, b = c.chunk(2, -1)
        h = a * torch.sigmoid(b)
        if self.bottleneck_dim > 0:
            h = self.bn_out(h)
        h = self.drop(h, gen)
        if xs.shape[-1] == h.shape[-1]:
            h = (h + xs) * math.sqrt(0.5)
        return h, new_cache


def parse_layers(layers: str) -> list[tuple[int, int, int]]:
    """'channels:kernel[:bottleneck]' tokens joined by '_' -> [(channels,
    kernel, bottleneck or 0)]."""
    out = []
    for tok in layers.split("_"):
        parts = tok.split(":")
        out.append((int(parts[0]), int(parts[1]),
                    int(parts[2]) if len(parts) > 2 else 0))
    return out


class GatedConvLM(nn.Module):
    """Built on ``device``: the CUDA card when it is None (raising without
    one), the CPU only when asked (``device="cpu"``). Its output is a Dense
    of its own: a conf's ``tie_embedding`` is not read, as in the JAX
    module."""

    def __init__(self, vocab: int, emb_dim: int = 280,
                 layers: str = "850:6_850:6_850:6", dropout: float = 0.0,
                 dropout_emb: float = 0.0, lsm_prob: float = 0.0,
                 device=None):
        super().__init__()
        device = model_device(device, "GatedConvLM")
        self.vocab, self.lsm_prob = vocab, lsm_prob
        self.specs = parse_layers(layers)
        self.embed = nn.Embedding(vocab, emb_dim)
        blocks, resizes = [], []
        in_ch = emb_dim
        for ch, k, bn in self.specs:
            resizes.append(nn.Linear(in_ch, ch) if in_ch != ch else None)
            blocks.append(CausalConvGLU(ch, k, bn, dropout))
            in_ch = ch
        self.blocks = nn.ModuleList(blocks)
        self.resizes = nn.ModuleList(resizes)
        self.output = nn.Linear(in_ch, vocab)
        self.drop_emb = Dropout(dropout_emb)
        self.to(device)

    def decode(self, ys: torch.Tensor, caches: Optional[list] = None,
               gen: Optional[torch.Generator] = None):
        """ys [B, T] -> (hidden [B, T, last channels], new caches)."""
        h = self.drop_emb(self.embed(ys), gen)
        new_caches = []
        for lth, blk in enumerate(self.blocks):
            if self.resizes[lth] is not None:
                h = self.resizes[lth](h)
            h, nc = blk(h, None if caches is None else caches[lth], gen)
            new_caches.append(nc)
        return h, new_caches

    def forward(self, ys_in: torch.Tensor, ys_out: torch.Tensor,
                state=None, gen: Optional[torch.Generator] = None):
        """A BPTT window's loss (PAD ignored); no state crosses windows.
        Returns (loss, None, {"loss", "ppl", "acc"})."""
        h, _ = self.decode(ys_in, None, gen)
        logits = self.output(h)
        loss, nll = cross_entropy_lsm(logits, ys_out, self.lsm_prob,
                                      ignore_index=PAD,
                                      normalize_length=True)
        acc = compute_accuracy(logits, ys_out, PAD)
        return loss, None, {"loss": loss, "ppl": torch.exp(nll), "acc": acc}

    def init_state(self, bs: int) -> list:
        """Per-block zero caches [bs, k - 1, bottleneck or channels]."""
        w = self.embed.weight
        return [w.new_zeros(bs, k - 1, bn or ch) for ch, k, bn in self.specs]

    def predict(self, y: torch.Tensor, state: Optional[list] = None):
        """One step: y [B] -> (log-probs [B, V] float32, new caches, hidden
        [B, channels])."""
        caches = state if state is not None else self.init_state(y.shape[0])
        h, new_caches = self.decode(y[:, None], caches)
        lp = torch.log_softmax(self.output(h[:, 0]).float(), -1)
        return lp, new_caches, h[:, 0]
