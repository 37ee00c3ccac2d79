"""Interlayer time subsampling (counterpart of
``neural_sp_tpu/models/encoders/subsampling.py``): drop and max_pool, each
updating lengths with ceil semantics."""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


def new_lens(xlens: torch.Tensor, factor: int) -> torch.Tensor:
    return (xlens + factor - 1) // factor


class DropSubsampler(nn.Module):
    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor

    def forward(self, xs, xlens):
        if self.factor == 1:
            return xs, xlens
        return xs[:, ::self.factor], new_lens(xlens, self.factor)


class MaxPoolSubsampler(nn.Module):
    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor

    def forward(self, xs, xlens):
        if self.factor == 1:
            return xs, xlens
        pad = (-xs.shape[1]) % self.factor
        if pad:   # ZERO tail, as the JAX module's _pad_to_multiple
            xs = F.pad(xs, (0, 0, 0, pad))
        b, t, d = xs.shape
        xs = xs.view(b, t // self.factor, self.factor, d).amax(2)
        return xs, new_lens(xlens, self.factor)


def build_subsampler(stype: str, factor: int) -> nn.Module:
    if stype == "drop":
        return DropSubsampler(factor)
    if stype == "max_pool":
        return MaxPoolSubsampler(factor)
    raise NotImplementedError(
        f"subsampling type {stype!r} is not ported yet, see ROADMAP")
