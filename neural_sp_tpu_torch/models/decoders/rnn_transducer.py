"""RNN-Transducer decoder (counterpart of
``neural_sp_tpu/models/decoders/rnn_transducer.py``): a prediction network
(embedding, LSTM layers on cuDNN through ``RNNLayer``, optional ``tanh``
projections) and the additive joint ``output(tanh(w_enc(h_enc) +
w_pred(h_pred)))``, broadcast over [B, T, U+1].

The prediction network reads the previous label with EOS as the start
symbol; the loss reads PAD as 0, as the JAX module's. The [B, T, U+1, V]
joint logits are materialised, as JAX's; the lattice loss is
``ops/rnnt.py::rnnt_loss_from_logits`` (kernel K5 on the card). In
``train()`` mode dropout runs after the embedding (``dropout_emb``) and
after each LSTM layer (``dropout``), from the ``gen`` argument; the GRU
prediction network is not ported (ROADMAP). Under a bf16 compute_dtype
the prediction network's LSTM computes in float32 from its bf16
embedding (``RNNLayer.compute_type``) and the joint promotes its weights
to float32, as JAX's (ROADMAP C50); K5 takes float32 log-probabilities.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ... import BLANK, EOS, PAD
from ...ops.dropout import Dropout
from ...ops.rnnt import rnnt_loss_from_logits
from ..modules.recurrent import RNNLayer
from ..modules.promote import Linear


class RNNTransducer(nn.Module):
    def __init__(self, vocab: int, enc_n_units: int, n_units: int = 512,
                 n_projs: int = 0, n_layers: int = 1, emb_dim: int = 512,
                 joint_dim: int = 512, rnn_type: str = "lstm",
                 dropout: float = 0.0, dropout_emb: float = 0.0,
                 backward: bool = False):
        super().__init__()
        if rnn_type != "lstm":
            raise NotImplementedError(
                f"a {rnn_type!r} prediction network is not ported yet (only "
                f"the LSTM), see ROADMAP")
        if backward:
            raise NotImplementedError(
                "a backward transducer is not ported yet, see ROADMAP")
        self.vocab = vocab
        self.embed = nn.Embedding(vocab, emb_dim)
        rnns, projs = [], []
        in_dim = emb_dim
        for _ in range(n_layers):
            rnns.append(RNNLayer(in_dim, n_units, "lstm", False))
            if n_projs > 0:
                projs.append(Linear(n_units, n_projs))
            in_dim = n_projs if n_projs > 0 else n_units
        self.pred_rnns = nn.ModuleList(rnns)
        self.pred_projs = nn.ModuleList(projs)
        self.w_enc = Linear(enc_n_units, joint_dim)
        self.w_pred = Linear(in_dim, joint_dim, bias=False)
        self.output = Linear(joint_dim, vocab)
        self.drop = Dropout(dropout)
        self.drop_emb = Dropout(dropout_emb)

    def pred_net(self, ys_in: torch.Tensor, carry=None,
                 gen: Optional[torch.Generator] = None):
        """ys_in [B, U'] token ids -> ([B, U', d_pred], new carry: per layer
        (c, h) [B, n_units]; None = zeros)."""
        h = self.drop_emb(self.embed(ys_in), gen)
        new_carry = []
        for lth, rnn in enumerate(self.pred_rnns):
            h, c = rnn(h, None, carry[lth] if carry is not None else None)
            h = self.drop(h, gen)
            if len(self.pred_projs):
                h = torch.tanh(self.pred_projs[lth](h))
            new_carry.append(c)
        return h, new_carry

    def joint(self, eouts: torch.Tensor, pred_out: torch.Tensor
              ) -> torch.Tensor:
        """eouts [B, T, De], pred_out [B, U', Dp] -> logits [B, T, U', V]."""
        he = self.w_enc(eouts)[:, :, None, :]
        hp = self.w_pred(pred_out)[:, None, :, :]
        return self.output(torch.tanh(he + hp))

    def joint_step(self, eout_t: torch.Tensor, pred_t: torch.Tensor
                   ) -> torch.Tensor:
        """eout_t [N, De], pred_t [N, Dp] -> logits [N, V]."""
        return self.output(torch.tanh(self.w_enc(eout_t)
                                      + self.w_pred(pred_t)))

    def forward(self, eouts: torch.Tensor, elens: torch.Tensor,
                ys: torch.Tensor, ylens: torch.Tensor,
                gen: Optional[torch.Generator] = None, trigger_points=None):
        """The transducer loss (the lattice nll summed over the batch over
        B); ys [B, U] PAD-padded. Returns (loss, {"loss_transducer"})."""
        bs = ys.shape[0]
        ys = torch.where(ys == PAD, torch.zeros_like(ys), ys).long()
        ys_in = torch.cat([torch.full((bs, 1), EOS, dtype=ys.dtype,
                                      device=ys.device), ys], 1)
        pred_out, _ = self.pred_net(ys_in, None, gen)
        logits = self.joint(eouts, pred_out)
        loss = rnnt_loss_from_logits(logits, ys, elens, ylens, blank=BLANK)
        return loss, {"loss_transducer": loss}
