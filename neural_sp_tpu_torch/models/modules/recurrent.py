"""Recurrent building blocks (counterpart of
``neural_sp_tpu/models/modules/recurrent.py``): the flax
``OptimizedLSTMCell`` parameter layout and one unidirectional LSTM layer
with explicit state I/O.

The cell is written out (no ``nn.LSTM`` / cuDNN, whose gate layout and
fused biases differ): gates (i, f, g, o), no forget-gate offset,
``c' = sigmoid(f) c + sigmoid(i) tanh(g)``, ``h' = sigmoid(o) tanh(c')``,
carry in flax's order (c, h). The bidirectional, zoneout and GRU forms of
the JAX ``RNNLayer`` are not on the port's path and raise.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell`` parameters in one block per side, gate
    order (i, f, g, o): ``w_ih`` [in, 4H] (the input denses have no bias),
    ``w_hh`` [H, 4H] and ``bias`` [4H] (the hidden denses')."""

    def __init__(self, in_dim: int, n_units: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(in_dim, 4 * n_units))
        self.w_hh = nn.Parameter(torch.empty(n_units, 4 * n_units))
        self.bias = nn.Parameter(torch.empty(4 * n_units))

    def step(self, xg: torch.Tensor, c: torch.Tensor, h: torch.Tensor):
        """One step from the input half of the gates xg = x @ w_ih [B, 4H]
        and the carry (c, h) -> the new (c, h)."""
        gates = torch.addmm(self.bias, h, self.w_hh) + xg
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)


class RNNLayer(nn.Module):
    """One unidirectional LSTM layer: ``forward(xs [B, T, in], carry=None)
    -> (ys [B, T, H], (c, h))``, a None carry meaning zeros, as the JAX
    layer's flax ``nn.RNN``. The input half of the gates is one product
    over all T steps."""

    def __init__(self, in_dim: int, n_units: int, rnn_type: str = "lstm",
                 bidirectional: bool = False, zoneout_h: float = 0.0,
                 zoneout_c: float = 0.0):
        super().__init__()
        if rnn_type != "lstm" or bidirectional or zoneout_h or zoneout_c:
            raise NotImplementedError(
                "RNNLayer: only the unidirectional LSTM without zoneout is "
                "ported yet, see ROADMAP")
        self.n_units = n_units
        self.fwd = LSTMCell(in_dim, n_units)

    def forward(self, xs: torch.Tensor,
                carry: Optional[tuple[torch.Tensor, torch.Tensor]] = None):
        bs, t, _ = xs.shape
        if carry is None:
            c = h = xs.new_zeros(bs, self.n_units)
        else:
            c, h = carry
        xg = xs @ self.fwd.w_ih                            # [B, T, 4H]
        ys = []
        for i in range(t):
            c, h = self.fwd.step(xg[:, i], c, h)
            ys.append(h)
        return torch.stack(ys, 1), (c, h)
