"""SpecAugment (counterpart of ``neural_sp_tpu/ops/specaugment.py``), in
two parts: ``draw_masks`` draws the mask positions from a
``torch.Generator`` with the JAX function's distributions, and
``apply_masks`` applies given positions deterministically (masked bins take
the utterance's mean over its valid frames). A test feeds ``apply_masks``
the JAX package's own draws. The adaptive variants raise.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SpecAugDraws(NamedTuple):
    f_width: torch.Tensor   # [B, n_freq_masks] int64
    f_start: torch.Tensor
    t_width: torch.Tensor   # [B, n_time_masks] int64
    t_start: torch.Tensor


def draw_masks(gen: Optional[torch.Generator], xlens: torch.Tensor,
               dim: int, freq_mask_width: int = 27, n_freq_masks: int = 2,
               time_mask_width: int = 100, n_time_masks: int = 2,
               p: float = 1.0) -> SpecAugDraws:
    """Mask widths and starts as the JAX ``spec_augment`` draws them:
    ``f_width ~ U{0..F}``, ``f_start = floor(u * max(dim - f_width, 1))``,
    ``t_width = floor(u * (min(T, max(floor(p * xlen), 1)) + 1))``,
    ``t_start = floor(u * max(xlen - t_width, 1))``. Drawn on the CPU."""
    xlens = xlens.detach().to("cpu", torch.int64)
    bs = xlens.shape[0]
    if n_freq_masks > 0 and freq_mask_width > 0:
        f_width = torch.randint(0, freq_mask_width + 1, (bs, n_freq_masks),
                                generator=gen)
        f_start = (torch.rand((bs, n_freq_masks), generator=gen)
                   * (dim - f_width).clamp(min=1)).to(torch.int64)
    else:
        f_width = f_start = torch.zeros((bs, 0), dtype=torch.int64)
    if n_time_masks > 0 and time_mask_width > 0:
        max_w = (p * xlens.to(torch.float32)).to(torch.int64).clamp(min=1)
        max_w = max_w.clamp(max=time_mask_width)[:, None]
        t_width = (torch.rand((bs, n_time_masks), generator=gen)
                   * (max_w + 1)).to(torch.int64)
        t_start = (torch.rand((bs, n_time_masks), generator=gen)
                   * (xlens[:, None] - t_width).clamp(min=1)).to(torch.int64)
    else:
        t_width = t_start = torch.zeros((bs, 0), dtype=torch.int64)
    return SpecAugDraws(f_width, f_start, t_width, t_start)


def apply_masks(xs: torch.Tensor, xlens: torch.Tensor,
                draws: SpecAugDraws) -> torch.Tensor:
    """xs [B, T, D] -> masked copy. Bin (b, t, d) takes utterance b's mean
    when d lies in a frequency mask or t in a time mask."""
    bs, tmax, dim = xs.shape
    dev = xs.device
    xlens = xlens.to(dev)
    valid = (torch.arange(tmax, device=dev)[None] < xlens[:, None]).to(
        xs.dtype)
    fill = ((xs * valid[:, :, None]).sum(dim=(1, 2))
            / (valid.sum(1) * dim).clamp(min=1.0))[:, None, None]
    fw, fs, tw, ts = (d.to(dev)[:, :, None] for d in draws)
    d_idx = torch.arange(dim, device=dev)[None, None]
    t_idx = torch.arange(tmax, device=dev)[None, None]
    fmask = ((d_idx >= fs) & (d_idx < fs + fw)).any(1)          # [B, D]
    tmask = ((t_idx >= ts) & (t_idx < ts + tw)).any(1)          # [B, T]
    mask = fmask[:, None, :] | tmask[:, :, None]
    return torch.where(mask, fill.to(xs.dtype), xs)
