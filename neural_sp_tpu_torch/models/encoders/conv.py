"""Convolutional frontend encoder (counterpart of
``neural_sp_tpu/models/encoders/conv.py``), 2-D blocks.

The JAX module keeps activations as [B, T, F, C]; here they run as NCHW
[B, C, T, F] through ``torch.nn.Conv2d`` and are permuted back to
[B, T, F, C] before the flatten to ``f * C + c`` that feeds the bridge, so
the bridge weights convert unchanged (transposed only).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field

import torch
from torch import nn
import torch.nn.functional as F

POOL_FILL = -1e9   # the JAX module's ceil max-pool tail value


@dataclass
class CNNConfig:
    channels: list = field(default_factory=list)        # [int]
    kernel_sizes: list = field(default_factory=list)    # [(kt, kf)]
    strides: list = field(default_factory=list)         # [(st, sf)]
    poolings: list = field(default_factory=list)        # [(pt, pf)]


def parse_cnn_config(channels: str, kernel_sizes: str, strides: str,
                     poolings: str) -> CNNConfig:
    """Parse reference-style strings, e.g. channels "32_32", kernel_sizes
    "(3,3)_(3,3)", poolings "(2,2)_(2,2)" (copied from the JAX module)."""
    def parse_pairs(s):
        return [tuple(ast.literal_eval(p)) if "(" in p else (int(p), int(p))
                for p in s.split("_")] if s else []

    cfg = CNNConfig()
    cfg.channels = [int(c) for c in channels.split("_")] if channels else []
    cfg.kernel_sizes = parse_pairs(kernel_sizes)
    cfg.strides = parse_pairs(strides)
    cfg.poolings = parse_pairs(poolings)
    n = len(cfg.channels)
    cfg.kernel_sizes = (cfg.kernel_sizes or [(3, 3)] * n)[:n]
    cfg.strides = (cfg.strides or [(1, 1)] * n)[:n]
    cfg.poolings = (cfg.poolings or [(1, 1)] * n)[:n]
    return cfg


def _ceil_div_lens(xlens: torch.Tensor, factor: int) -> torch.Tensor:
    return (xlens + factor - 1) // factor


def _edge_fill(h: torch.Tensor, t_valid: torch.Tensor, fill: float,
               t_dim: int) -> torch.Tensor:
    """Overwrite positions >= t_valid (the BATCH edge) along ``t_dim`` with
    ``fill``, so a bucket-padded batch computes the same valid frames as a
    packed one (the JAX module's ``_edge_fill``)."""
    idx = torch.arange(h.shape[t_dim], device=h.device) < t_valid
    shape = [1] * h.ndim
    shape[t_dim] = -1
    return torch.where(idx.view(shape), h, fill)


def _pool(xs: torch.Tensor, pt: int, pf: int) -> torch.Tensor:
    """Max-pool NCHW [B, C, T, F] with ceil semantics: the tail pads with
    -1e9 explicitly, then a VALID pool."""
    pad_t, pad_f = (-xs.shape[2]) % pt, (-xs.shape[3]) % pf
    if pad_t or pad_f:
        xs = F.pad(xs, (0, pad_f, 0, pad_t), value=POOL_FILL)
    return F.max_pool2d(xs, (pt, pf), stride=(pt, pf))


class Conv2dBlock(nn.Module):
    """conv3x3 -> relu -> conv3x3 -> relu -> maxpool (no normalisation)."""

    def __init__(self, in_channels: int, channels: int, kernel=(3, 3),
                 stride=(1, 1), pooling=(1, 1), normalization: str = ""):
        super().__init__()
        if normalization:
            raise NotImplementedError(
                "frontend conv normalization is not ported yet, see ROADMAP")
        if tuple(stride) != (1, 1):
            raise NotImplementedError(
                "strided frontend convs are not ported yet, see ROADMAP")
        self.kernel, self.pooling = tuple(kernel), tuple(pooling)
        self.conv1 = nn.Conv2d(in_channels, channels, self.kernel)
        self.conv2 = nn.Conv2d(channels, channels, self.kernel)

    def _same(self, xs):
        """flax padding='SAME' at stride 1: (k-1)//2 before, the rest after."""
        kt, kf = self.kernel
        return F.pad(xs, ((kf - 1) // 2, kf - 1 - (kf - 1) // 2,
                          (kt - 1) // 2, kt - 1 - (kt - 1) // 2))

    def forward(self, xs: torch.Tensor, t_valid: torch.Tensor) -> torch.Tensor:
        for conv in (self.conv1, self.conv2):
            xs = _edge_fill(xs, t_valid, 0.0, 2)   # conv sees the packed edge
            xs = F.relu(conv(self._same(xs)))
        if max(self.pooling) > 1:
            # straddling pool windows ignore beyond-edge positions like the
            # packed batch's -1e9 ceil-pad tail
            xs = _edge_fill(xs, t_valid, POOL_FILL, 2)
            xs = _pool(xs, *self.pooling)
        return xs


class ConvEncoder(nn.Module):
    """CNN frontend with its bridge to ``bottleneck_dim`` (0: no bridge,
    the flattened ``f * C`` features go out as they are, as the JAX
    module's); returns (xs [B, T', output_dim], xlens)."""

    def __init__(self, input_dim: int, bottleneck_dim: int,
                 channels: str = "32_32", kernel_sizes: str = "(3,3)_(3,3)",
                 strides: str = "(1,1)_(1,1)",
                 poolings: str = "(2,2)_(2,2)", normalization: str = ""):
        super().__init__()
        self.cfg = parse_cnn_config(channels, kernel_sizes, strides, poolings)
        blocks, in_ch, freq = [], 1, input_dim
        for ch, k, st, pl in zip(self.cfg.channels, self.cfg.kernel_sizes,
                                 self.cfg.strides, self.cfg.poolings):
            blocks.append(Conv2dBlock(in_ch, ch, k, st, pl, normalization))
            in_ch = ch
            freq = -(-freq // pl[1]) if pl[1] > 1 else freq
        self.blocks = nn.ModuleList(blocks)
        self.output_dim = bottleneck_dim or freq * in_ch
        self.bridge = nn.Linear(freq * in_ch, bottleneck_dim) \
            if bottleneck_dim > 0 else None

    def forward(self, xs: torch.Tensor, xlens: torch.Tensor):
        """xs [B, T, input_dim], xlens [B] int."""
        t_valid = xlens.max()
        h = xs[:, None]                                   # [B, 1, T, F]
        for block, (st, _), (pt, _) in zip(self.blocks, self.cfg.strides,
                                           self.cfg.poolings):
            h = block(h, t_valid)
            xlens = _ceil_div_lens(xlens, st * max(pt, 1))
            t_valid = _ceil_div_lens(t_valid, st * max(pt, 1))
        b, c, t, f = h.shape
        h = h.permute(0, 2, 3, 1).reshape(b, t, f * c)   # JAX's f * C + c
        # keep the pool's -1e9 edge fill out of the blocks downstream
        h = _edge_fill(h, t_valid, 0.0, 1)
        return (h if self.bridge is None else self.bridge(h)), xlens

    @property
    def subsampling_factor(self) -> int:
        f = 1
        for (st, _), (pt, _) in zip(self.cfg.strides, self.cfg.poolings):
            f *= st * max(pt, 1)
        return f
