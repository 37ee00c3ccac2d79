"""Relative-position multi-head self-attention (counterpart of
``neural_sp_tpu/models/modules/relative_multihead_attention.py``). The
encoders' form, ``pe_type='relative'`` (``xl_like=False``): positions
projected through ``w_value`` (bias included) and no u/v biases. The
Transformer-XL's form (``xl_like=True``, JAX :84-95): a separate ``w_pos``
without bias and the global biases ``u_bias`` / ``v_bias`` [H, dk], the
content query q + u and the position table p = (q + v) w_pos(rel).

The distance embedding is the XL sinusoid of ``-(|q - k| + 1)`` in the
concatenated [sin | cos] layout. With ``clamp_len > 0`` distances clamp at
``clamp_len`` and the table has ``R = clamp_len + 1`` rows; unclamped, it
has ``R = T`` rows. Either way the score is

    e[b,h,i,j] = (q_i . k_j + q_i . r_{min(|i-j|, R-1)}) / sqrt(dk)

which is what both branches of the JAX module (one-hot for long inputs,
skew for short ones) compute. The per-query table ``p = q r^T`` is a plain
matmul; the rest runs in kernel K1 (``ops.kernels.rel_attention``).

The streaming encoders' masks reach K1 as its ``window`` (n_l, n_c, n_r):
``CAUSAL`` for the unidirectional encoder, the chunk window of the
``mask`` mode. ``stream`` is a streaming block's attention against the
cached keys and values of the previous blocks (the JAX module with a
``cache``): query i of the block sits at key position i + n_l, the
distance |i + n_l - j| indexes the table (R = Tk unclamped), and the
cache's empty slots (keys below ``key_start``) are masked.

``attend`` is the Transformer-XL's call: queries from a segment h against
keys and values from [memory; h] (Tq <= Tk), under ``masks.CAUSAL`` (query
i at key position i + Tk - Tq), with ``dropout_att`` on the attention
probabilities (K1 / K1b's ``dropout``, its key words drawn from the step's
``torch.Generator`` in ``train()`` mode). The encoders' ``forward`` drops
them the same way (the conformers' ``dropout_att``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...ops.dropout import key_words
from ...ops.kernels import rel_attention
from ...ops.masks import CAUSAL
from .promote import Linear


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
                 xl_like: bool = False, dropout: float = 0.0):
        super().__init__()
        self.d_model, self.n_heads, self.clamp_len = d_model, n_heads, clamp_len
        self.xl_like, self.dropout = xl_like, dropout
        self.w_query = Linear(d_model, d_model)
        self.w_key = Linear(d_model, d_model)
        self.w_value = Linear(d_model, d_model)
        self.w_out = Linear(d_model, d_model)
        if xl_like:
            dk = d_model // n_heads
            self.u_bias = nn.Parameter(torch.zeros(n_heads, dk))
            self.v_bias = nn.Parameter(torch.zeros(n_heads, dk))
            self.w_pos = Linear(d_model, d_model, bias=False)
        # the distance table's longest form so far on the device (not a
        # parameter or a buffer: no state_dict entry), sliced per call
        self._rel = None

    def _distance_table(self, n_rel: int, like: torch.Tensor
                        ) -> torch.Tensor:
        """``rel_distance_table(n_rel)`` on ``like``'s device and in its
        type. Its rows do not depend on n_rel, so the longest table yet is
        kept and sliced: a one-token step then neither builds it in numpy
        nor copies it from the host, per layer and step."""
        t = self._rel
        if t is None or t.shape[0] < n_rel or t.device != like.device or \
                t.dtype != like.dtype:
            n = max(n_rel, 0 if t is None else t.shape[0])
            # a normal tensor even when made under inference mode (a
            # session's step), so a later training step can save it
            with torch.inference_mode(False):
                t = self._rel = torch.from_numpy(
                    rel_distance_table(n, self.d_model)).to(like.device,
                                                            like.dtype)
        return t[:n_rel]

    def forward(self, query: torch.Tensor, klens: torch.Tensor,
                window=None, gen=None) -> torch.Tensor:
        """query [B, T, d_model]; klens [B] valid keys per utterance (the
        keys-only pad mask of ``make_san_mask``); ``window`` (n_l, n_c,
        n_r) or None; in ``train()`` the probabilities dropped at
        ``dropout``, the key words from ``gen``. Returns [B, T, d_model]."""
        bs, t, _ = query.shape
        q, kv = self._project(query)
        o = self._attend(q, kv["k"], kv["v"], klens, window, 0,
                         self._drop(gen))
        return self.w_out(o.transpose(1, 2).reshape(bs, t, self.d_model))

    def stream(self, query: torch.Tensor, cache: dict, key_start: int):
        """A streaming block: query [B, Tq, d_model] against the cache
        {"k", "v"} [B, n_l, H, dk] and the block's own keys, the cache's
        slots below ``key_start`` masked. Returns (out [B, Tq, d_model],
        {"k", "v"} [B, n_l + Tq, H, dk])."""
        bs, tq, _ = query.shape
        q, kv = self._project(query)
        k = torch.cat([cache["k"], kv["k"]], 1)
        v = torch.cat([cache["v"], kv["v"]], 1)
        klens = torch.full((bs,), k.shape[1], dtype=torch.int32,
                           device=query.device)
        o = self._attend(q, k, v, klens, None, key_start)
        out = self.w_out(o.transpose(1, 2).reshape(bs, tq, self.d_model))
        return out, {"k": k, "v": v}

    def attend(self, query: torch.Tensor, key: torch.Tensor,
               gen=None) -> torch.Tensor:
        """Queries from ``query`` [B, Tq, d_model] against keys and values
        projected from ``key`` [B, Tk, d_model] (Tq <= Tk; every key valid:
        no padding), under ``masks.CAUSAL``, the attention probabilities
        dropped at ``dropout`` in ``train()`` mode. Returns [B, Tq,
        d_model]."""
        bs, tq, _ = query.shape
        h, dk = self.n_heads, self.d_model // self.n_heads
        q = self.w_query(query).view(bs, tq, h, dk).transpose(1, 2)
        tk = key.shape[1]
        k = self.w_key(key).view(bs, tk, h, dk)
        v = self.w_value(key).view(bs, tk, h, dk)
        klens = torch.full((bs,), tk, dtype=torch.int32, device=query.device)
        o = self._attend(q, k, v, klens, CAUSAL, 0, self._drop(gen))
        return self.w_out(o.transpose(1, 2).reshape(bs, tq, self.d_model))

    def _drop(self, gen):
        """K1's ``dropout`` argument: (rate, key words from ``gen``) in
        ``train()`` at a rate above 0, else None."""
        return (self.dropout, key_words(gen)) \
            if self.training and self.dropout > 0 else None

    def _project(self, query):
        """(q [B, H, T, dk], {"k", "v"} [B, T, H, dk])."""
        bs, t, _ = query.shape
        h, dk = self.n_heads, self.d_model // self.n_heads
        q = self.w_query(query).view(bs, t, h, dk).transpose(1, 2)
        return q, {"k": self.w_key(query).view(bs, t, h, dk),
                   "v": self.w_value(query).view(bs, t, h, dk)}

    def _attend(self, q, k, v, klens, window, key_start, dropout=None):
        """K1 over q [B, H, Tq, dk] and k, v [B, Tk, H, dk]: [B, H, Tq,
        dk]. The table has clamp_len + 1 rows when clamped, else Tk (at
        most Tk rows either way: a row past the longest distance is never
        read, as the JAX module's unclamped branch)."""
        tk = k.shape[1]
        h, dk = self.n_heads, self.d_model // self.n_heads
        n_rel = self.clamp_len + 1 if self.clamp_len > 0 else tk
        if self.xl_like:
            n_rel = min(n_rel, tk)
        rel = self._distance_table(n_rel, q)
        scale = 1.0 / math.sqrt(dk)
        if self.xl_like:
            # content query q + u; positions through w_pos, queried by q + v
            r = self.w_pos(rel).view(n_rel, h, dk)
            p = torch.einsum("bhqd,rhd->bhqr", q + self.v_bias[:, None],
                             r) * scale
            q = q + self.u_bias[:, None]
        else:
            r = self.w_value(rel).view(n_rel, h, dk)  # positions share w_value
            p = torch.einsum("bhqd,rhd->bhqr", q, r) * scale
        args = ((q * scale).contiguous(), k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(), p.contiguous(),
                klens.to(device=q.device, dtype=torch.int32))
        if window is None and key_start == 0 and dropout is None:
            # the offline call takes the five tensors alone, as do the
            # plain versions that chip_smoke.py and tools/train_diagnosis.py
            # patch in here (autograd functions: no keyword arguments)
            return rel_attention(*args)
        return rel_attention(*args, window=window, key_start=key_start,
                             dropout=dropout)
