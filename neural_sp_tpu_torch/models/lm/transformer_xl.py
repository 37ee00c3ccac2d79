"""Transformer-XL LM (counterpart of
``neural_sp_tpu/models/lm/transformer_xl.py``): relative positions with the
global u / v biases, and a segment-level memory.

Each of the n_layers + 1 memories holds the last ``mem_len`` inputs of its
layer (the last one the top layer's output), detached, as the JAX module's
``stop_gradient``. A block's queries come from its segment h; its keys and
values from ``LayerNorm([memory; h])`` (one norm over both, so the memory's
keys match), through K1 / K1b with the causal window over Tk = M + Tq
keys (``RelativeMultiheadAttention.attend``), the attention probabilities
dropped at ``dropout_att`` in ``train()`` mode. Incremental prediction is
the same path with one-token segments; the state is the list of memories
[B, M, d_model], M growing to ``mem_len``. Under a bf16 compute_dtype the
XL computes in float32 over its bf16-rounded weights, its memories too,
as JAX's (its embedding scale promotes: ROADMAP C50), through K1 / K1b's
float32 entries.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from ... import PAD
from ...ops.criterion import compute_accuracy, cross_entropy_lsm
from ...ops.dropout import Dropout
from ..modules.conformer_convolution import LN_EPS
from ..modules.feed_forward import FFN
from ..modules.relative_multihead_attention import RelativeMultiheadAttention
from ..utils import model_device
from ..modules.promote import LayerNorm, Linear, promoted


class XLBlock(nn.Module):
    def __init__(self, d_model: int, d_ff: int, n_heads: int,
                 dropout: float = 0.0, dropout_att: float = 0.0,
                 clamp_len: int = -1):
        super().__init__()
        self.norm_self = LayerNorm(d_model, eps=LN_EPS)
        self.self_attn = RelativeMultiheadAttention(
            d_model, n_heads, clamp_len, xl_like=True, dropout=dropout_att)
        self.norm_ff = LayerNorm(d_model, eps=LN_EPS)
        self.ff = FFN(d_model, d_ff, "relu", 0, dropout)
        self.drop = Dropout(dropout)

    def forward(self, h: torch.Tensor, mem: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """h [B, T, d_model]; mem [B, M, d_model] (M may be 0)."""
        cat = torch.cat([mem, h], 1) if mem is not None and mem.shape[1] \
            else h
        key = self.norm_self(cat)
        x = key[:, -h.shape[1]:]
        h = h + self.drop(self.self_attn.attend(x, key, gen), gen)
        return h + self.drop(self.ff(self.norm_ff(h), gen), gen)


class TransformerXL(nn.Module):
    """Built on ``device``: the CUDA card when it is None (raising without
    one), the CPU only when asked (``device="cpu"``)."""

    def __init__(self, vocab: int, d_model: int = 512, d_ff: int = 2048,
                 n_heads: int = 8, n_layers: int = 6, mem_len: int = 128,
                 clamp_len: int = -1, dropout: float = 0.1,
                 dropout_att: float = 0.0, dropout_emb: float = 0.0,
                 lsm_prob: float = 0.0, tie_embedding: bool = False,
                 device=None):
        super().__init__()
        device = model_device(device, "TransformerXL")
        self.vocab, self.d_model, self.n_layers = vocab, d_model, n_layers
        self.mem_len, self.lsm_prob = mem_len, lsm_prob
        self.tie_embedding = tie_embedding
        self.embed = nn.Embedding(vocab, d_model)
        self.blocks = nn.ModuleList([
            XLBlock(d_model, d_ff, n_heads, dropout, dropout_att, clamp_len)
            for _ in range(n_layers)])
        self.norm_out = LayerNorm(d_model, eps=LN_EPS)
        if not tie_embedding:
            self.output = Linear(d_model, vocab)
        self.drop_emb = Dropout(dropout_emb)
        self.to(device)

    def init_state(self, bs: int) -> list:
        """n_layers + 1 empty memories [bs, 0, d_model], in the type the
        blocks compute in (``decode``'s: a bf16 embedding promotes to
        float32)."""
        w = self.embed.weight
        return [torch.zeros(bs, 0, self.d_model, device=w.device,
                            dtype=torch.promote_types(w.dtype, torch.float32))
                for _ in range(self.n_layers + 1)]

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        h = self.norm_out(h)
        if self.tie_embedding:
            return F.linear(*promoted(h, self.embed.weight))
        return self.output(h)

    def decode(self, ys: torch.Tensor, mems: Optional[list] = None,
               gen: Optional[torch.Generator] = None):
        """ys [B, T] -> (hidden [B, T, d_model], new memories)."""
        # JAX scales by a float32 array, which promotes a bf16 embedding:
        # under bf16 compute the XL runs in float32 over the bf16-rounded
        # weights, its memories too (JAX's init_mems(bs, h.dtype))
        h = self.embed(ys)
        h = self.drop_emb(h.to(torch.promote_types(h.dtype, torch.float32))
                          * math.sqrt(self.d_model), gen)
        if mems is None:
            mems = self.init_state(ys.shape[0])
        new_mems = []
        for lth, blk in enumerate(self.blocks):
            new_mems.append(
                torch.cat([mems[lth], h], 1)[:, -self.mem_len:].detach())
            h = blk(h, mems[lth], gen)
        new_mems.append(torch.cat([mems[-1], h], 1)[:, -self.mem_len:].detach())
        return h, new_mems

    def forward(self, ys_in: torch.Tensor, ys_out: torch.Tensor,
                state: Optional[list] = None,
                gen: Optional[torch.Generator] = None):
        """A BPTT window's loss (PAD ignored) with the memories ``state``.
        Returns (loss, new memories, {"loss", "ppl", "acc"})."""
        h, new_mems = self.decode(ys_in, state, gen)
        logits = self._logits(h)
        loss, nll = cross_entropy_lsm(logits, ys_out, self.lsm_prob,
                                      ignore_index=PAD,
                                      normalize_length=True)
        acc = compute_accuracy(logits, ys_out, PAD)
        return loss, new_mems, {"loss": loss, "ppl": torch.exp(nll),
                                "acc": acc}

    def predict(self, y: torch.Tensor, state: Optional[list] = None):
        """One step: y [B] -> (log-probs [B, V] float32, new memories,
        hidden [B, d_model])."""
        h, new_mems = self.decode(y[:, None], state)
        lp = torch.log_softmax(self._logits(h[:, 0]).float(), -1)
        return lp, new_mems, h[:, 0]
