"""LSTM language model (counterpart of ``neural_sp_tpu/models/lm/rnnlm.py``):
projections, residual connections, a GLU head, tied embeddings, an
adaptive softmax; explicit recurrent state I/O for BPTT windows, shallow
fusion and rescoring.

The state is a list of per-layer (c, h) tensors [B, n_units]; None means
zeros. The products stay plain ``torch`` matmuls (no kernel of the JAX
package's is on this path: its LSTM is plain JAX too).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from ... import PAD
from ...ops.criterion import compute_accuracy, cross_entropy_lsm
from ...ops.dropout import Dropout
from ..modules.glu import LinearGLUBlock
from ..modules.recurrent import RNNLayer
from ..utils import model_device
from ..modules.promote import Linear, promoted


class RNNLM(nn.Module):
    """Built on ``device``: the CUDA card when it is None (raising without
    one), the CPU only when asked (``device="cpu"``)."""

    def __init__(self, vocab: int, n_units: int = 1024, n_projs: int = 0,
                 n_layers: int = 2, emb_dim: int = 1024,
                 residual: bool = False, use_glu: bool = False,
                 adaptive_softmax: bool = False,
                 adaptive_softmax_cutoffs: tuple = (2000, 10000),
                 tie_embedding: bool = False, dropout: float = 0.0,
                 dropout_emb: float = 0.0, lsm_prob: float = 0.0,
                 n_units_null_context: int = 0, device=None):
        super().__init__()
        device = model_device(device, "RNNLM")
        self.vocab, self.n_units, self.n_projs = vocab, n_units, n_projs
        self.n_layers, self.emb_dim = n_layers, emb_dim
        self.residual, self.use_glu = residual, use_glu
        self.adaptive_softmax = adaptive_softmax
        self.tie_embedding = tie_embedding
        self.lsm_prob = lsm_prob
        # a null context vector concatenated to the embedding, so the LM
        # matches a fusion decoder's input layout
        self.n_units_null_context = n_units_null_context
        odim = n_projs if n_projs > 0 else n_units
        self.embed = nn.Embedding(vocab, emb_dim)
        in_dims = [emb_dim + n_units_null_context] + [odim] * (n_layers - 1)
        self.rnns = nn.ModuleList([RNNLayer(d, n_units) for d in in_dims])
        if n_projs > 0:
            self.projs = nn.ModuleList([Linear(n_units, n_projs)
                                        for _ in range(n_layers)])
        if use_glu:
            self.glu = LinearGLUBlock(odim, odim)
        if adaptive_softmax:
            self.asm = AdaptiveSoftmax(vocab, odim, adaptive_softmax_cutoffs)
        elif tie_embedding:
            # the tied output reads the embedding matrix itself, through a
            # bridge projection when the widths differ, with a free bias
            self.output_proj = Linear(odim, emb_dim) \
                if odim != emb_dim else None
            self.output_bias = nn.Parameter(torch.zeros(vocab))
        else:
            self.output = Linear(odim, vocab)
        self.drop = Dropout(dropout)
        self.drop_emb = Dropout(dropout_emb)
        self.to(device)

    def decode(self, ys: torch.Tensor, state: Optional[list] = None,
               gen: Optional[torch.Generator] = None):
        """ys [B, T] -> (hidden [B, T, D], new state)."""
        h = self.drop_emb(self.embed(ys), gen)
        if self.n_units_null_context > 0:
            h = torch.cat([h, h.new_zeros(h.shape[:-1] +
                                          (self.n_units_null_context,))], -1)
        new_state = []
        for lth in range(self.n_layers):
            residual = h
            h, carry = self.rnns[lth](
                h, carry=None if state is None else state[lth])
            h = self.drop(h, gen)
            if self.n_projs > 0:
                h = torch.tanh(self.projs[lth](h))
            # never on the first layer, even at emb_dim == n_units
            if self.residual and residual.shape[-1] == h.shape[-1] and \
                    lth > 0:
                h = h + residual
            new_state.append(carry)
        if self.use_glu:
            h = self.glu(h)
        return h, new_state

    def logits_from_hidden(self, h: torch.Tensor) -> torch.Tensor:
        """Logits (log-probs with the adaptive softmax) [..., vocab]."""
        if self.adaptive_softmax:
            return self.asm.log_probs(h)
        if self.tie_embedding:
            if self.output_proj is not None:
                h = self.output_proj(h)
            return F.linear(*promoted(h, self.embed.weight,
                                      self.output_bias))
        return self.output(h)

    def forward(self, ys_in: torch.Tensor, ys_out: torch.Tensor,
                state: Optional[list] = None,
                gen: Optional[torch.Generator] = None):
        """BPTT window loss. ys_in / ys_out [B, T], PAD ignored. Returns
        (loss, new state, {"loss", "ppl", "acc"})."""
        h, new_state = self.decode(ys_in, state, gen)
        if self.adaptive_softmax:
            loss = self.asm.loss(h, ys_out, ignore_index=PAD)
            acc = compute_accuracy(self.asm.log_probs(h), ys_out, PAD)
            return loss, new_state, {"loss": loss, "ppl": torch.exp(loss),
                                     "acc": acc}
        logits = self.logits_from_hidden(h)
        loss, nll = cross_entropy_lsm(logits, ys_out, self.lsm_prob,
                                      ignore_index=PAD,
                                      normalize_length=True)
        acc = compute_accuracy(logits, ys_out, PAD)
        return loss, new_state, {"loss": loss, "ppl": torch.exp(nll),
                                 "acc": acc}

    def init_state(self, bs: int) -> None:
        """The empty state: None, the zero state of every layer."""
        return None

    def predict(self, y: torch.Tensor, state: Optional[list] = None):
        """One step for fusion and rescoring: y [B] -> (log-probs [B, V]
        float32, new state, hidden [B, D])."""
        h, new_state = self.decode(y[:, None], state)
        h = h[:, 0]
        if self.adaptive_softmax:
            return self.asm.log_probs(h), new_state, h
        lp = torch.log_softmax(self.logits_from_hidden(h).float(), -1)
        return lp, new_state, h


class AdaptiveSoftmax(nn.Module):
    """Cluster-factorised softmax: the head scores the frequent tokens and
    one slot per tail cluster; tail i projects through a bottleneck of
    d_in / div_value^(i+1) (at least 8). Log-probs are computed for every
    position of every cluster, as the JAX module does."""

    def __init__(self, vocab: int, d_in: int, cutoffs: tuple = (2000, 10000),
                 div_value: int = 4):
        super().__init__()
        self._cuts = tuple(c for c in cutoffs if c < vocab) + (vocab,)
        n_tails = len(self._cuts) - 1
        self.head = Linear(d_in, self._cuts[0] + n_tails)
        self.tails = nn.ModuleList()
        for i in range(n_tails):
            d_tail = max(d_in // (div_value ** (i + 1)), 8)
            self.tails.append(nn.ModuleList([
                Linear(d_in, d_tail),
                Linear(d_tail, self._cuts[i + 1] - self._cuts[i])]))

    def log_probs(self, h: torch.Tensor) -> torch.Tensor:
        """h [..., d_in] -> full-vocabulary log-probs [..., vocab]."""
        head_lp = torch.log_softmax(self.head(h).float(), -1)
        c0 = self._cuts[0]
        parts = [head_lp[..., :c0]]
        for i, (proj, out) in enumerate(self.tails):
            tail_lp = torch.log_softmax(out(proj(h)).float(), -1)
            parts.append(head_lp[..., c0 + i:c0 + i + 1] + tail_lp)
        return torch.cat(parts, -1)

    def loss(self, h: torch.Tensor, ys: torch.Tensor,
             ignore_index: int = PAD) -> torch.Tensor:
        """Mean negative log-likelihood over the tokens that are not
        ``ignore_index``."""
        lp = self.log_probs(h)
        mask = ys != ignore_index
        tok = torch.gather(lp, -1, ys.clamp(min=0)[..., None].long())[..., 0]
        n = mask.sum().clamp(min=1)
        return -torch.where(mask, tok, torch.zeros_like(tok)).sum() / n
