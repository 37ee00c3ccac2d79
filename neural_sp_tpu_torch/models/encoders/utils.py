"""Chunkwise reshaping of the latency-controlled encoders' ``reshape``
streaming mode (counterpart of ``neural_sp_tpu/models/encoders/utils.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def chunkwise(xs: torch.Tensor, n_left: int, n_current: int,
              n_right: int) -> torch.Tensor:
    """[B, T, D] -> [B * n_chunks, N_l + N_c + N_r, D]: chunk c covers
    frames [c N_c - N_l, (c + 1) N_c + N_r), zeros past either edge."""
    bs, t, d = xs.shape
    n_chunks = -(-t // n_current)
    xs_pad = F.pad(xs, (0, 0, n_left, n_chunks * n_current - t + n_right))
    win = n_left + n_current + n_right
    out = xs_pad.unfold(1, win, n_current)       # [B, n_chunks, D, win]
    return out.transpose(2, 3).reshape(bs * n_chunks, win, d)


def chunkwise_merge(ys: torch.Tensor, bs: int, n_left: int, n_current: int,
                    n_right: int, t_out: int) -> torch.Tensor:
    """The inverse of ``chunkwise`` over each chunk's current frames, cut
    to ``t_out`` frames: [B, t_out, D]."""
    win, d = ys.shape[1], ys.shape[2]
    n_chunks = ys.shape[0] // bs
    cur = ys.reshape(bs, n_chunks, win, d)[:, :, n_left:n_left + n_current]
    return cur.reshape(bs, n_chunks * n_current, d)[:, :t_out]
