"""Relative-position multi-head self-attention (counterpart of
``neural_sp_tpu/models/modules/relative_multihead_attention.py``), offline
encoder form: ``pe_type='relative'`` (``xl_like=False``), positions
projected through ``w_value`` (bias included) and no u/v biases.

The distance embedding is the XL sinusoid of ``-(|q - k| + 1)`` in the
concatenated [sin | cos] layout. With ``clamp_len > 0`` distances clamp at
``clamp_len`` and the table has ``R = clamp_len + 1`` rows; unclamped, it
has ``R = T`` rows. Either way the score is

    e[b,h,i,j] = (q_i . k_j + q_i . r_{min(|i-j|, R-1)}) / sqrt(dk)

which is what both branches of the JAX module (one-hot for long inputs,
skew for short ones) compute. The per-query table ``p = q r^T`` is a plain
matmul; the rest runs in kernel K1 (``ops.kernels.rel_attention``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...ops.kernels import rel_attention


def rel_distance_table(n_rows: int, d_model: int) -> np.ndarray:
    """[n_rows, d_model] embeddings of absolute distances 0..n_rows-1: the
    XL sinusoid of -(distance + 1), [sin | cos] (the rows of the JAX
    module's ``_signed_rel_table`` for distances >= 0)."""
    pos = -(np.arange(n_rows, dtype=np.float32) + 1.0)
    inv = np.exp(np.arange(0, d_model, 2, np.float32)
                 * -(np.log(10000.0) / d_model))
    ang = pos[:, None] * inv
    return np.concatenate([np.sin(ang), np.cos(ang)],
                          axis=-1).astype(np.float32)


class RelativeMultiheadAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, clamp_len: int = -1,
                 xl_like: bool = False):
        super().__init__()
        if xl_like:
            raise NotImplementedError(
                "pe_type 'relative_xl' (w_pos + u/v biases) is not ported "
                "yet, see ROADMAP")
        self.d_model, self.n_heads, self.clamp_len = d_model, n_heads, clamp_len
        self.w_query = nn.Linear(d_model, d_model)
        self.w_key = nn.Linear(d_model, d_model)
        self.w_value = nn.Linear(d_model, d_model)
        self.w_out = nn.Linear(d_model, d_model)

    def forward(self, query: torch.Tensor, klens: torch.Tensor,
                cache=None) -> torch.Tensor:
        """query [B, T, d_model]; klens [B] valid keys per utterance (the
        keys-only pad mask of ``make_san_mask``). Returns [B, T, d_model]."""
        if cache is not None:
            raise NotImplementedError(
                "streaming attention with a KV cache is not ported yet, see "
                "ROADMAP")
        bs, t, _ = query.shape
        h, dk = self.n_heads, self.d_model // self.n_heads

        def heads(x):   # [B, T, d] -> [B, H, T, dk]
            return x.view(bs, t, h, dk).transpose(1, 2)

        q = heads(self.w_query(query))
        k = heads(self.w_key(query)).contiguous()
        v = heads(self.w_value(query)).contiguous()
        n_rel = self.clamp_len + 1 if self.clamp_len > 0 else t
        rel = torch.from_numpy(rel_distance_table(n_rel, self.d_model)).to(
            query.device, query.dtype)
        r = self.w_value(rel).view(n_rel, h, dk)    # positions share w_value
        scale = 1.0 / math.sqrt(dk)
        p = torch.einsum("bhqd,rhd->bhqr", q, r) * scale
        o = rel_attention((q * scale).contiguous(), k, v, p.contiguous(),
                          klens.to(device=query.device, dtype=torch.int32))
        return self.w_out(o.transpose(1, 2).reshape(bs, t, self.d_model))
