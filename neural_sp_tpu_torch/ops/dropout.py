"""Counter-hash dropout (counterpart of ``neural_sp_tpu/ops/dropout.py``).

``fast_uniform`` is the JAX package's murmur-style hash of a lane counter
mixed with two 32-bit key words, bit for bit: the uint32 arithmetic is
carried in int64 and masked back to 32 bits after every product, so given
the same key words both packages draw the same mask. The key words of a
site come from the step's ``torch.Generator`` (``key_words``); the JAX
package derives them from its flax rng path instead, so the two draw
different masks for the same step (ROADMAP C4).

``Dropout`` drops only in ``train()`` mode, and takes the generator as an
argument of ``forward``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

_MASK32 = 0xFFFFFFFF


def key_words(gen: Optional[torch.Generator]) -> tuple[int, int]:
    """Two uint32 key words (as the JAX key's ``kd[0]``, ``kd[-1]``)."""
    w = torch.randint(0, 1 << 32, (2,), generator=gen, dtype=torch.int64)
    return int(w[0]), int(w[1])


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for x, m < 2^32, in int64 without overflow: the
    high half of m contributes only its product's low 16 bits."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def fast_uniform(key: tuple[int, int], shape, device=None) -> torch.Tensor:
    """[0, 1) float32 uniforms of ``shape`` from the counter hash."""
    k0, k1 = key
    n = 1
    for s in shape:
        n *= int(s)
    x = torch.arange(n, dtype=torch.int64, device=device)
    x = (_mul32(x, 0x9E3779B9) + k0) & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D ^ k1)
    x = x ^ (x >> 15)
    # 24-bit mantissa -> exact float in [0, 1)
    return ((x >> 8).to(torch.float32) * (1.0 / 16777216.0)).reshape(shape)


def keep_mask(gen: Optional[torch.Generator], rate: float, shape,
              device=None) -> torch.Tensor:
    """float32 mask: 1 / (1 - rate) where kept, 0 where dropped."""
    keep = 1.0 - rate
    u = fast_uniform(key_words(gen), shape, device)
    return (u < keep).to(torch.float32) / keep


class Dropout(nn.Module):
    """``Dropout(rate)(x, gen)``: identity in ``eval()`` or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        u = fast_uniform(key_words(gen), x.shape, x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))
