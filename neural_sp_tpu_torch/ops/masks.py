"""Padding / attention mask utilities (counterpart of
``neural_sp_tpu/ops/masks.py``). Boolean masks, True = attend / valid.

Kernel K1 takes the causal and chunkwise masks as a window of three
integers ``(n_l, n_c, n_r)`` (``CAUSAL`` is ``causal_mask``'s): its plain
version and the transformer blocks build the mask from it with
``window_mask``, which is ``make_chunkwise_san_mask`` (and ``causal_mask``)
generalised to a block of queries against cached keys."""
from __future__ import annotations

import torch


# query i attends keys j <= i (``causal_mask``), as a window (n_l, n_c, n_r)
CAUSAL = (-1, 1, 0)


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


def causal_mask(qlen: int, klen: int | None = None, offset: int = 0,
                device=None) -> torch.Tensor:
    """[qlen, klen] lower-triangular mask: query i attends keys <= i +
    ``offset`` (a query block that starts mid-sequence)."""
    klen = qlen if klen is None else klen
    q = torch.arange(qlen, device=device)[:, None]
    k = torch.arange(klen, device=device)[None, :]
    return k <= q + offset


def make_chunkwise_san_mask(pad_mask: torch.Tensor, chunk_size_left: int,
                            chunk_size_current: int,
                            chunk_size_right: int) -> torch.Tensor:
    """The streaming ``mask`` mode's self-attention mask [B, T, T]: frame t
    of chunk c = t // N_c attends frames [c N_c - N_l, (c + 1) N_c + N_r)
    that the pad mask [B, T] leaves valid; N_l < 0 is unlimited left
    context."""
    tmax = pad_mask.shape[1]
    t = torch.arange(tmax, device=pad_mask.device)
    chunk = t // max(chunk_size_current, 1)
    hi = (chunk + 1) * chunk_size_current + chunk_size_right
    m = t[None, :] < hi[:, None]
    if chunk_size_left >= 0:
        lo = chunk * chunk_size_current - chunk_size_left
        m = m & (t[None, :] >= lo[:, None])
    return m[None] & make_san_mask(pad_mask)


def window_mask(klens: torch.Tensor, tq: int, tk: int, window=None,
                key_start: int = 0, device=None) -> torch.Tensor:
    """[B, Tq, Tk] bool: key j < klens[b] is valid for query i, which sits
    at key position a = i + Tk - Tq, iff j >= ``key_start`` and, with a
    ``window`` (n_l, n_c, n_r), j < (a // n_c + 1) n_c + n_r and, when n_l
    >= 0, j >= (a // n_c) n_c - n_l: ``make_chunkwise_san_mask`` (with
    ``CAUSAL``, ``make_san_mask & causal_mask``) for Tq = Tk and no
    ``key_start``."""
    i = torch.arange(tq, device=device) + (tk - tq)
    j = torch.arange(tk, device=device)
    ok = (j >= key_start)[None, :].expand(tq, tk)
    if window is not None:
        n_l, n_c, n_r = window
        c = i // n_c
        ok = ok & (j[None, :] < ((c + 1) * n_c + n_r)[:, None])
        if n_l >= 0:
            ok = ok & (j[None, :] >= (c * n_c - n_l)[:, None])
    pad = j[None, :] < klens.to(device=device)[:, None]
    return ok[None] & pad[:, None, :]
