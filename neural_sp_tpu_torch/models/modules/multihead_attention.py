"""Multi-head scaled-dot attention with the JAX module's cache protocol
(counterpart of ``neural_sp_tpu/models/modules/multihead_attention.py``).

Caches are {"k", "v"} of [B, T, H, d_k], the projected keys and values
(the keys and values are one tensor at every caller):
  * ``cache=None``, ``key`` given        -> full attention over ``key``;
  * ``cache`` given, ``key=None``        -> the cached keys and values
    (the decoder's source attention at decode);
  * ``cache`` given, ``key`` given       -> the new keys and values
    appended to the cache's (incremental self-attention).

A mask [B, Tk] or [B | 1, Tq, Tk] (True = attend) sets the masked energies
to ``finfo.min / 2``; the softmax runs in float32. Plain PyTorch (matmul and
softmax), as the JAX package computes it in plain JAX. The additive
energies (``atype="add"``) and HeadDrop (``dropout_head > 0``) are not
ported: no builder of the port's decoders or encoders sets them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...ops.dropout import Dropout
from ...ops.masks import apply_mask_logits


class MultiheadAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, dropout: float = 0.0,
                 dropout_head: float = 0.0, atype: str = "scaled_dot"):
        super().__init__()
        if atype != "scaled_dot":
            raise NotImplementedError(
                f"MultiheadAttention atype {atype!r} is not ported yet, see "
                f"ROADMAP")
        if dropout_head > 0:
            raise NotImplementedError(
                "HeadDrop (dropout_head > 0) is not ported yet, see ROADMAP")
        self.d_model, self.n_heads = d_model, n_heads
        self.dk = d_model // n_heads
        self.w_query = nn.Linear(d_model, d_model)
        self.w_key = nn.Linear(d_model, d_model)
        self.w_value = nn.Linear(d_model, d_model)
        self.w_out = nn.Linear(d_model, d_model)
        self.drop = Dropout(dropout)

    def project_kv(self, key: torch.Tensor) -> dict:
        """{"k", "v"} [B, T, H, d_k] of ``key`` (keys and values are the
        same tensor at every caller)."""
        bs, tk = key.shape[:2]
        return {"k": self.w_key(key).view(bs, tk, self.n_heads, self.dk),
                "v": self.w_value(key).view(bs, tk, self.n_heads, self.dk)}

    def weights(self, q: torch.Tensor, k: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The attention weights [B, H, Tq, Tk] of the projected queries q
        [B, Tq, H, d_k] over the projected keys k [B, Tk, H, d_k]."""
        e = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.dk)
        if mask is not None:
            mask = mask[:, None, None, :] if mask.ndim == 2 else mask[:, None]
            e = apply_mask_logits(e, mask)
        return torch.softmax(e.float(), -1).to(q.dtype)

    def forward(self, query: torch.Tensor,
                key: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                cache: Optional[dict] = None,
                gen: Optional[torch.Generator] = None):
        """Returns (out [B, Tq, d_model], the new cache {"k", "v"})."""
        bs, tq, _ = query.shape
        q = self.w_query(query).view(bs, tq, self.n_heads, self.dk)
        if key is not None:
            kv = self.project_kv(key)
            k, v = kv["k"], kv["v"]
            if cache is not None:
                k = torch.cat([cache["k"], k], 1)
                v = torch.cat([cache["v"], v], 1)
        else:
            k, v = cache["k"], cache["v"]
        aws = self.weights(q, k, mask)
        ctx = torch.einsum("bhqk,bkhd->bqhd", self.drop(aws, gen), v)
        out = self.w_out(ctx.reshape(bs, tq, self.d_model))
        return out, {"k": k, "v": v}
