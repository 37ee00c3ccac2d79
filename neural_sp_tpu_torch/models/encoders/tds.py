"""Time-depth separable (TDS) convolutional encoder (counterpart of
``neural_sp_tpu/models/encoders/tds.py``): subsample blocks (time stride
2) interleaved with TDS blocks (a 2-D conv over time, then a pointwise
two-layer FC, each with its residual and a LayerNorm over channels x
frequency), plain PyTorch (cuDNN's convolutions), as the JAX package
computes it in plain JAX.

The stream is [B, T, F, C], the JAX module's layout (F the input's
features, C the channels), so the FCs see the same (F, C) flattening; each
conv runs over [B, C, T, F] with a (k, 1) kernel and flax's SAME padding.
A stage starts with a subsample block wherever the channel count changes,
so the total subsampling is 2 per change. The per-layer channels come
from ``channels`` and the kernels from ``kernel_sizes``, zipped: the
shorter list sets the depth (ROADMAP C41, as JAX's builder reads them;
``output_dim`` and ``subsampling_factor`` read all of ``channels``, as
JAX's, even where the zip left a count out).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from ...ops.dropout import Dropout
from ..modules.conformer_convolution import LN_EPS
from .subsampling import new_lens


def same_pad(t: int, k: int, stride: int) -> tuple[int, int]:
    """flax's SAME padding (low, high) of a length-t axis for a width-k
    kernel at ``stride``: ceil(t / stride) outputs."""
    total = max((-(-t // stride) - 1) * stride + k - t, 0)
    return total // 2, total - total // 2


class FreqChannelNorm(nn.LayerNorm):
    """flax ``LayerNorm(reduction_axes=(-2, -1))`` over [.., F, C]: the
    statistics over F and C together, the scale and bias per channel (a
    LayerNorm's parameters over C)."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=LN_EPS)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(xs, dim=(-2, -1), unbiased=False,
                                   keepdim=True)
        return (xs - mean) * torch.rsqrt(var + self.eps) * self.weight + \
            self.bias


class TimeConv(nn.Conv2d):
    """Conv2d of a (k, 1) kernel over [B, T, F, C_in] -> [B, T', F, C],
    flax's SAME padding, stride (stride, 1)."""

    def __init__(self, in_ch: int, channels: int, kernel_t: int,
                 stride: int = 1):
        super().__init__(in_ch, channels, (kernel_t, 1), (stride, 1))

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        h = xs.permute(0, 3, 1, 2)                      # [B, C, T, F]
        lo, hi = same_pad(h.shape[2], self.kernel_size[0], self.stride[0])
        return super().forward(F.pad(h, (0, 0, lo, hi))).permute(0, 2, 3, 1)


class TDSBlock(nn.Module):
    def __init__(self, channels: int, kernel_t: int, freq: int,
                 dropout: float = 0.0):
        super().__init__()
        self.conv = TimeConv(channels, channels, kernel_t)
        self.norm1 = FreqChannelNorm(channels)
        self.fc1 = nn.Linear(freq * channels, freq * channels)
        self.fc2 = nn.Linear(freq * channels, freq * channels)
        self.norm2 = FreqChannelNorm(channels)
        self.drop = Dropout(dropout)

    def forward(self, xs: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """xs [B, T, F, C]."""
        b, t, f, c = xs.shape
        xs = self.norm1(xs + self.drop(torch.relu(self.conv(xs)), gen))
        hf = xs.reshape(b, t, f * c)
        h = self.drop(torch.relu(self.fc1(hf)), gen)
        h = self.drop(self.fc2(h), gen)
        return self.norm2((hf + h).reshape(b, t, f, c))


class SubsampleBlock(nn.Module):
    def __init__(self, in_ch: int, channels: int, kernel_t: int,
                 dropout: float = 0.0):
        super().__init__()
        self.conv = TimeConv(in_ch, channels, kernel_t, stride=2)
        self.norm = FreqChannelNorm(channels)
        self.drop = Dropout(dropout)

    def forward(self, xs: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.norm(self.drop(torch.relu(self.conv(xs)), gen))


class TDSEncoder(nn.Module):
    """``channels`` / ``kernel_sizes``: '_'-separated per-layer values, e.g.
    "10_10_14_14_18_18" / "21_21_21_21_21_21"; layer i is ``tds{i}``,
    preceded by ``subsample{i}`` where its channel count changes."""

    def __init__(self, input_dim: int, channels: str = "10_10_14_14_18_18",
                 kernel_sizes: str = "21_21_21_21_21_21",
                 dropout: float = 0.0, last_proj_dim: int = 0):
        super().__init__()
        chs = [int(c) for c in channels.split("_")]
        kts = [int(k) for k in kernel_sizes.split("_")]
        self.layers = []                  # (subsample or None, tds) names
        prev, in_ch = None, 1
        for i, (c, kt) in enumerate(zip(chs, kts)):
            sub = None
            if c != prev:
                sub = f"subsample{i}"
                setattr(self, sub, SubsampleBlock(in_ch, c, kt, dropout))
                prev = in_ch = c
            setattr(self, f"tds{i}", TDSBlock(c, kt, input_dim, dropout))
            self.layers.append((sub, f"tds{i}"))
        # JAX's subsampling factor (2 per change of the channel count) and
        # output_dim (the last count) read all the channel counts, zipped
        # away or not (C41): a zip that cuts one gives the stream another
        self.subsampling_factor = 2 ** sum(
            c != p for c, p in zip(chs, [None] + chs[:-1]))
        self.output_dim = last_proj_dim or chs[-1] * input_dim
        if last_proj_dim > 0:
            self.bridge = nn.Linear(prev * input_dim, last_proj_dim)

    def forward(self, xs: torch.Tensor, xlens: torch.Tensor,
                task: str = "all", gen: Optional[torch.Generator] = None):
        """xs [B, T, input_dim], xlens [B] -> {"ys": {"xs": [B, T', C_last
        input_dim], "xlens": [B]}}, T' and the lengths halved (rounded up)
        per subsample block."""
        h = xs[..., None]                               # [B, T, F, 1]
        for sub, tds in self.layers:
            if sub is not None:
                h = getattr(self, sub)(h, gen)
                xlens = new_lens(xlens, 2)
            h = getattr(self, tds)(h, gen)
        h = h.reshape(*h.shape[:2], -1)
        if hasattr(self, "bridge"):
            h = self.bridge(h)
        return {"ys": {"xs": h, "xlens": xlens}}
