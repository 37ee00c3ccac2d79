"""Recurrent building blocks (counterpart of
``neural_sp_tpu/models/modules/recurrent.py``): the flax
``OptimizedLSTMCell`` parameter layout (the LAS decoder's cell) and one
uni- or bidirectional LSTM layer with explicit state I/O.

The layer runs PyTorch's LSTM (``torch.lstm``, cuDNN on the card) over
parameters it holds in cuDNN's layout, gates (i, f, g, o) as flax's: an
``nn.LSTM``'s ``weight_ih_l0`` [4H, in], ``weight_hh_l0`` [4H, H] and
``bias_hh_l0`` [4H] (the hidden denses' bias), ``_reverse`` for the
reverse direction; its input-side bias is a zero buffer, since flax's
input denses have none. ``nn.LSTM`` flattens them into one cuDNN buffer
when the layer moves to the card, so no call copies a weight. On a CUDA
tensor the layer runs cuDNN or raises: it never falls back to the
written-out loop, which ``RNNLayer.forward_ref`` keeps as the plain
version the tests hold the layer to. cuDNN computes in TF32 where
``torch.backends.cudnn.allow_tf32`` is on (PyTorch's default); the ASR
CLIs turn it off. The GRU and zoneout forms of the JAX ``RNNLayer`` are
not ported and raise.

Types (``compute_type``), as flax's ``OptimizedLSTMCell`` promotes them:
the recurrence runs in the promoted type of the input, the weights and the
carry, where a missing carry is float32 at least (flax's zero carry has
the cell's float32 ``param_dtype``). So under a bf16 ``compute_dtype`` a
layer without a carry computes in float32 over the bf16-rounded weights
and returns float32 outputs and carries, and a layer given a bf16 carry
(random state passing casts it) computes in bf16. One rounding of JAX's is
left out: where the input is bf16 and the recurrence float32, flax rounds
the input product x W_ih to bf16 before adding it, while cuDNN takes no
precomputed input gates (only through an identity input weight, 4H wide,
which would cost more than the product itself) and forms it in float32
from the bf16 values. ``forward_ref`` rounds it as flax does.

Lengths: the JAX layer's flax ``nn.RNN`` takes ``seq_lengths``; its final
carries are the states at each row's last valid frame, and its reverse
direction runs over each row's reversed valid prefix. Here the rows run
as a packed sequence when lengths are given: the valid frames and the
final carries are flax's; the outputs past a row's length are zero (flax
emits other values there, which nothing downstream of an RNN encoder reads
unless a ``max_pool`` subsampler straddles a row's edge, and that raises
in ``models/encoders/rnn.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn.utils.rnn import (PackedSequence, pack_padded_sequence,
                                pad_packed_sequence)


def input_gates(xs: torch.Tensor, w_ih: torch.Tensor,
                dt: torch.dtype) -> torch.Tensor:
    """xs W_ih^T in the input's and the weight's promoted type, as flax's
    input dense computes it (bf16 for a bf16 input), then in ``dt``: the
    written-out loops' input gates."""
    pt = torch.promote_types(xs.dtype, w_ih.dtype)
    return (xs.to(pt) @ w_ih.t().to(pt)).to(dt)


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell`` parameters in one block per side, gate
    order (i, f, g, o): ``w_ih`` [in, 4H] (the input denses have no bias),
    ``w_hh`` [H, 4H] and ``bias`` [4H] (the hidden denses')."""

    def __init__(self, in_dim: int, n_units: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(in_dim, 4 * n_units))
        self.w_hh = nn.Parameter(torch.empty(n_units, 4 * n_units))
        self.bias = nn.Parameter(torch.empty(4 * n_units))


class RNNLayer(nn.Module):
    """One uni- or bidirectional LSTM layer: ``forward(xs [B, T, in],
    xlens=None, carry=None) -> (ys, carry)``. ``xlens`` are the rows'
    lengths on the host (int64, as ``pack_padded_sequence`` takes them),
    None for full rows; a None
    carry means zeros, as the JAX layer's flax ``nn.RNN``. ys is [B, T, H],
    or for a bidirectional layer the two directions summed ([B, T, H],
    ``merge="sum"``) or concatenated ([B, T, 2H], "concat"); the carry is
    (c, h), for a bidirectional layer ((c, h) forward, (c, h) reverse)."""

    def __init__(self, in_dim: int, n_units: int, rnn_type: str = "lstm",
                 bidirectional: bool = False, merge: str = "sum",
                 zoneout_h: float = 0.0, zoneout_c: float = 0.0):
        super().__init__()
        if rnn_type != "lstm" or zoneout_h or zoneout_c:
            raise NotImplementedError(
                "RNNLayer: only the LSTM without zoneout is ported yet, see "
                "ROADMAP")
        if merge not in ("sum", "concat"):
            raise ValueError(f"merge {merge!r}: 'sum' or 'concat'")
        self.n_units = n_units
        self.bidirectional = bidirectional
        self.merge = merge
        self.lstm = nn.LSTM(in_dim, n_units, batch_first=True,
                            bidirectional=bidirectional)
        for sfx in ("", "_reverse")[:2 if bidirectional else 1]:
            name = "bias_ih_l0" + sfx
            delattr(self.lstm, name)
            self.lstm.register_buffer(name, torch.zeros(4 * n_units),
                                      persistent=False)
            # assigning it again points the LSTM's list of flat weights,
            # which it flattens on a move to the card, at the buffer
            setattr(self.lstm, name, self.lstm.get_buffer(name))

    def _merge(self, ys_f, ys_b):
        if self.merge == "sum":
            return ys_f + ys_b
        return torch.cat([ys_f, ys_b], -1)

    def compute_type(self, xs: torch.Tensor, carry=None) -> torch.dtype:
        """The type the recurrence runs in: the input's, the weights' and
        the carry's promoted (a missing carry float32 at least)."""
        if carry is None:
            dt = torch.promote_types(xs.dtype, torch.float32)
        else:
            while not torch.is_tensor(carry):
                carry = carry[0]
            dt = torch.promote_types(xs.dtype, carry.dtype)
        return torch.promote_types(dt, self.lstm.weight_hh_l0.dtype)

    def weights(self, dt: torch.dtype) -> list:
        """[w_ih, w_hh, b_ih, b_hh] per direction, torch.lstm's order, in
        ``dt`` (the layer's own tensors where they are of that type)."""
        return [w.to(dt) for ws in self.lstm.all_weights for w in ws]

    def forward(self, xs: torch.Tensor,
                xlens: Optional[torch.Tensor] = None, carry=None):
        bs, t, _ = xs.shape
        if xs.is_cuda and not (torch.backends.cudnn.is_available() and
                               torch.backends.cudnn.enabled):
            raise RuntimeError("RNNLayer: cuDNN is not available on the card")
        dt = self.compute_type(xs, carry)
        xs = xs.to(dt)
        n_dir = 2 if self.bidirectional else 1
        carries = [carry] if n_dir == 1 else carry
        if carry is None:
            h0 = c0 = xs.new_zeros(n_dir, bs, self.n_units)
        else:
            c0 = torch.stack([c for c, _ in carries]).to(dt)
            h0 = torch.stack([h for _, h in carries]).to(dt)
        weights = self.weights(dt)
        # cuDNN keeps what its backward needs only in training mode
        train = torch.is_grad_enabled()
        if xlens is None:
            ys, h_n, c_n = torch.lstm(xs, (h0, c0), weights, True, 1, 0.0,
                                      train, self.bidirectional, True)
        else:
            packed = pack_padded_sequence(xs, xlens, batch_first=True,
                                          enforce_sorted=False)
            order = packed.sorted_indices
            data, h_n, c_n = torch.lstm(
                packed.data, packed.batch_sizes,
                (h0.index_select(1, order), c0.index_select(1, order)),
                weights, True, 1, 0.0, train, self.bidirectional)
        if xlens is not None:
            ys, _ = pad_packed_sequence(
                PackedSequence(data, packed.batch_sizes, order,
                               packed.unsorted_indices),
                batch_first=True, total_length=t)
            back = packed.unsorted_indices
            h_n, c_n = h_n.index_select(1, back), c_n.index_select(1, back)
        new = [(c_n[i], h_n[i]) for i in range(n_dir)]
        if not self.bidirectional:
            return ys, new[0]
        return self._merge(ys[..., :self.n_units], ys[..., self.n_units:]), \
            tuple(new)

    def forward_ref(self, xs: torch.Tensor,
                    xlens: Optional[torch.Tensor] = None, carry=None):
        """The written-out cell loop, the layer's plain version: the same
        outputs (zero past a row's length when ``xlens`` is given) and
        carries as ``forward``."""
        bs, t, _ = xs.shape
        dt = self.compute_type(xs, carry)
        lens = torch.full((bs,), t) if xlens is None else xlens
        valid = (torch.arange(t)[None] < lens[:, None]).to(xs.device)
        carries = carry if self.bidirectional else [carry]
        outs, new = [], []
        for d, (w_ih, w_hh, _, bias) in enumerate(self.lstm.all_weights):
            if carry is None:
                c = h = xs.new_zeros(bs, self.n_units, dtype=dt)
            else:
                c, h = (x.to(dt) for x in carries[d])
            xg = input_gates(xs, w_ih, dt)                 # [B, T, 4H]
            w_hh, bias = w_hh.to(dt), bias.to(dt)
            ys = [None] * t
            for i in (range(t) if d == 0 else reversed(range(t))):
                g_i, g_f, g_g, g_o = (torch.addmm(bias, h, w_hh.t()) +
                                      xg[:, i]).chunk(4, dim=-1)
                c_i = torch.sigmoid(g_f) * c + \
                    torch.sigmoid(g_i) * torch.tanh(g_g)
                h_i = torch.sigmoid(g_o) * torch.tanh(c_i)
                keep = valid[:, i, None]
                c, h = torch.where(keep, c_i, c), torch.where(keep, h_i, h)
                ys[i] = torch.where(keep, h_i, 0.0)
            outs.append(torch.stack(ys, 1))
            new.append((c, h))
        if not self.bidirectional:
            return outs[0], new[0]
        return self._merge(*outs), tuple(new)
