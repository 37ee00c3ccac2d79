"""Padding / attention mask utilities (counterpart of
``neural_sp_tpu/ops/masks.py``). Boolean masks, True = attend / valid."""
from __future__ import annotations

import torch


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] int lengths -> [B, max_len] bool mask, True for valid frames."""
    idx = torch.arange(max_len, device=lengths.device)
    return idx[None, :] < lengths[:, None]


def make_san_mask(pad_mask: torch.Tensor) -> torch.Tensor:
    """Self-attention mask [B, T] -> [B, T, T]: (b, q, k) is True iff key k
    is valid. KEYS ONLY, as the JAX module: pad queries still attend the
    valid keys, and no softmax row is all masked."""
    t = pad_mask.shape[1]
    return pad_mask[:, None, :].expand(pad_mask.shape[0], t, t)


def apply_mask_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked-out logits become ``finfo(dtype).min / 2`` (not -inf), so an
    all-masked row softmaxes to uniform weights instead of NaN."""
    return logits.masked_fill(~mask, torch.finfo(logits.dtype).min / 2)


def causal_mask(n: int, device=None) -> torch.Tensor:
    """[n, n] lower-triangular mask: query i attends keys <= i."""
    i = torch.arange(n, device=device)
    return i[None] <= i[:, None]
