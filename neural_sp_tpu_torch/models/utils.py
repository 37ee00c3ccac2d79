"""Sequence helpers (counterpart of ``neural_sp_tpu/models/utils.py``),
and the device rule of the port's ``build_*`` functions."""
from __future__ import annotations

import torch

from .. import EOS, PAD


def append_sos_eos(ys: torch.Tensor, ylens: torch.Tensor):
    """ys [B, U] PAD-padded -> (ys_in [B, U+1], ys_out [B, U+1], ylens+1):
    ys_in = [eos, y1..yU, pad...] (eos doubles as sos), ys_out = [y1..yU,
    eos, pad...]. Forward direction only (the backward decoder is not
    ported)."""
    bs, u = ys.shape
    ylens = ylens.to(ys.device)
    pos = torch.arange(u + 1, device=ys.device)[None]
    ys_in = torch.cat([torch.full((bs, 1), EOS, dtype=ys.dtype,
                                  device=ys.device), ys], 1)
    ys_in = torch.where(pos <= ylens[:, None], ys_in,
                        torch.full_like(ys_in, PAD))
    ys_out = torch.cat([ys, torch.full((bs, 1), PAD, dtype=ys.dtype,
                                       device=ys.device)], 1)
    ys_out = torch.where(pos == ylens[:, None], torch.full_like(ys_out, EOS),
                         ys_out)
    ys_out = torch.where(pos > ylens[:, None], torch.full_like(ys_out, PAD),
                         ys_out)
    return ys_in, ys_out, ylens + 1


def model_device(device, who: str) -> torch.device:
    """Where ``build_*`` puts a model: ``device``, or the CUDA card when it is
    None. Without a card the default raises: nothing falls back to the
    CPU, which a caller gets only by asking (``device="cpu"``)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device; pass device=\"cpu\" to build the "
            f"model on the CPU")
    return device
