"""Decoder-only Transformer LM (counterpart of
``neural_sp_tpu/models/lm/transformerlm.py``): pre-norm blocks of causal
self-attention (``modules/multihead_attention.py``, plain PyTorch, as the
JAX package computes it in plain JAX) and a ReLU FFN, with the sinusoidal
``add`` positions.

Incremental prediction keeps per-layer caches {"k", "v"} [B, T, H, d_k]
of the projected keys and values; a step's position is the caches'
length.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from ... import PAD
from ...ops.criterion import compute_accuracy, cross_entropy_lsm
from ...ops.dropout import Dropout
from ...ops.masks import causal_mask
from ..modules.conformer_convolution import LN_EPS
from ..modules.feed_forward import FFN
from ..modules.multihead_attention import MultiheadAttention
from ..modules.positional_embedding import PositionalEncoding
from ..utils import model_device


class TransformerLMBlock(nn.Module):
    def __init__(self, d_model: int, d_ff: int, n_heads: int,
                 dropout: float = 0.0, dropout_att: float = 0.0):
        super().__init__()
        self.norm_self = nn.LayerNorm(d_model, eps=LN_EPS)
        self.self_attn = MultiheadAttention(d_model, n_heads, dropout_att)
        self.norm_ff = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ff = FFN(d_model, d_ff, "relu", 0, dropout)
        self.drop = Dropout(dropout)

    def forward(self, ys: torch.Tensor, mask: Optional[torch.Tensor] = None,
                cache: Optional[dict] = None,
                gen: Optional[torch.Generator] = None):
        """Returns (ys, this layer's keys and values {"k", "v"})."""
        h = self.norm_self(ys)
        h, kv = self.self_attn(h, h, mask, cache, gen)
        ys = ys + self.drop(h, gen)
        ys = ys + self.drop(self.ff(self.norm_ff(ys), gen), gen)
        return ys, kv


class TransformerLM(nn.Module):
    """Built on ``device``: the CUDA card when it is None (raising without
    one), the CPU only when asked (``device="cpu"``)."""

    def __init__(self, vocab: int, d_model: int = 512, d_ff: int = 2048,
                 n_heads: int = 8, n_layers: int = 6, pe_type: str = "add",
                 dropout: float = 0.1, dropout_att: float = 0.0,
                 dropout_emb: float = 0.0, lsm_prob: float = 0.0,
                 tie_embedding: bool = False, device=None):
        super().__init__()
        device = model_device(device, "TransformerLM")
        self.vocab, self.d_model, self.n_heads = vocab, d_model, n_heads
        self.n_layers, self.lsm_prob = n_layers, lsm_prob
        self.tie_embedding = tie_embedding
        self.embed = nn.Embedding(vocab, d_model)
        self.pos_enc = PositionalEncoding(d_model, pe_type, dropout_emb)
        self.blocks = nn.ModuleList([
            TransformerLMBlock(d_model, d_ff, n_heads, dropout, dropout_att)
            for _ in range(n_layers)])
        self.norm_out = nn.LayerNorm(d_model, eps=LN_EPS)
        if not tie_embedding:
            self.output = nn.Linear(d_model, vocab)
        self.to(device)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        h = self.norm_out(h)
        if self.tie_embedding:
            return F.linear(h, self.embed.weight)
        return self.output(h)

    def decode(self, ys: torch.Tensor, caches: Optional[list] = None,
               offset: int = 0, gen: Optional[torch.Generator] = None):
        """ys [B, T]; caches per-layer {"k", "v"} or None. Returns (hidden
        [B, T, d_model], new caches)."""
        t = ys.shape[1]
        h = self.pos_enc(self.embed(ys), offset, gen)
        klen = t + (caches[0]["k"].shape[1] if caches is not None else 0)
        mask = causal_mask(t, klen, klen - t, ys.device)[None]
        new_caches = []
        for lth, blk in enumerate(self.blocks):
            h, kv = blk(h, mask, None if caches is None else caches[lth], gen)
            new_caches.append(kv)
        return h, new_caches

    def forward(self, ys_in: torch.Tensor, ys_out: torch.Tensor,
                state=None, gen: Optional[torch.Generator] = None):
        """A BPTT window's loss (PAD ignored); no state crosses windows.
        Returns (loss, None, {"loss", "ppl", "acc"})."""
        h, _ = self.decode(ys_in, None, 0, gen)
        logits = self._logits(h)
        loss, nll = cross_entropy_lsm(logits, ys_out, self.lsm_prob,
                                      ignore_index=PAD,
                                      normalize_length=True)
        acc = compute_accuracy(logits, ys_out, PAD)
        return loss, None, {"loss": loss, "ppl": torch.exp(nll), "acc": acc}

    def init_state(self, bs: int) -> list:
        """Per-layer empty caches {"k", "v"} [bs, 0, H, d_k]."""
        dk = self.d_model // self.n_heads
        w = self.embed.weight
        return [{"k": w.new_zeros(bs, 0, self.n_heads, dk),
                 "v": w.new_zeros(bs, 0, self.n_heads, dk)}
                for _ in range(self.n_layers)]

    def predict(self, y: torch.Tensor, state: Optional[list] = None):
        """One step: y [B] -> (log-probs [B, V] float32, new caches, hidden
        [B, d_model]); the step's position is the caches' length."""
        offset = state[0]["k"].shape[1] if state is not None else 0
        h, new_caches = self.decode(y[:, None], state, offset)
        lp = torch.log_softmax(self._logits(h[:, 0]).float(), -1)
        return lp, new_caches, h[:, 0]
