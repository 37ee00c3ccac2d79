"""RNN encoder (counterpart of ``neural_sp_tpu/models/encoders/rnn.py``),
the offline branch: the optional conv front end, then per layer a (B)LSTM
(``modules/recurrent.py::RNNLayer``), dropout, an optional ``tanh``
projection and an interlayer subsampler; a ``bridge`` projection after
the last layer.

The layers run as packed sequences over the rows' lengths, which are
taken to the host once per forward and carried there through the front
end and the subsamplers. Outputs past a row's length are zero (the JAX
module's differ there, and nothing reads them): so an interlayer
``max_pool``, whose last window of a row can straddle its edge, raises, as
do the sub1 / sub2 taps with their task-specific layers, ``dropout_in``
(in ``build.py``), the GRU and the latency-controlled branch (ROADMAP).

In ``train()`` mode dropout (rate ``dropout``) runs after every layer, as
the JAX module's; the step's generator is the ``gen`` argument of
``forward``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...ops.dropout import Dropout
from ..modules.recurrent import RNNLayer
from .conv import ConvEncoder
from .subsampling import build_subsampler, new_lens


class RNNEncoder(nn.Module):
    def __init__(self, input_dim: int, rnn_type: str = "blstm",
                 n_units: int = 512, n_projs: int = 0,
                 last_proj_dim: int = 0, n_layers: int = 5,
                 dropout: float = 0.0, subsample: tuple = (),
                 subsample_type: str = "drop", conv_channels: str = "",
                 conv_kernel_sizes: str = "", conv_strides: str = "",
                 conv_poolings: str = "", conv_normalization: str = "",
                 conv_bottleneck_dim: int = 0,
                 bidir_sum_fwd_bwd: bool = False):
        super().__init__()
        if rnn_type not in ("lstm", "blstm"):
            raise NotImplementedError(
                f"RNN encoder {rnn_type!r} is not ported yet (only lstm and "
                f"blstm), see ROADMAP")
        # one factor a layer; a conf that lists fewer (the swbd confs: 5
        # for 6 layers) leaves the last layers unsubsampled (ROADMAP C19)
        self.subsample = (list(subsample) + [1] * n_layers)[:n_layers]
        if subsample_type != "drop" and max(self.subsample) > 1:
            raise NotImplementedError(
                f"interlayer {subsample_type!r} subsampling in an RNN "
                f"encoder is not ported yet (only drop), see ROADMAP")
        bidirectional = rnn_type == "blstm"
        self.conv = ConvEncoder(
            input_dim, conv_bottleneck_dim, conv_channels, conv_kernel_sizes,
            conv_strides, conv_poolings, conv_normalization) \
            if conv_channels else None
        in_dim = self.conv.output_dim if self.conv is not None else input_dim
        rnn_dim = 2 * n_units if bidirectional and not bidir_sum_fwd_bwd \
            else n_units
        layers, projs = [], []
        for _ in range(n_layers):
            layers.append(RNNLayer(
                in_dim, n_units, "lstm", bidirectional,
                merge="sum" if bidir_sum_fwd_bwd else "concat"))
            if n_projs > 0:
                projs.append(nn.Linear(rnn_dim, n_projs))
            in_dim = n_projs if n_projs > 0 else rnn_dim
        self.rnns = nn.ModuleList(layers)
        self.projs = nn.ModuleList(projs)
        self.subsamplers = nn.ModuleList(
            build_subsampler(subsample_type, f) if f > 1 else nn.Identity()
            for f in self.subsample)
        self.bridge = nn.Linear(in_dim, last_proj_dim) \
            if last_proj_dim > 0 else None
        self.output_dim = last_proj_dim if last_proj_dim > 0 else in_dim
        self.drop = Dropout(dropout)

    def forward(self, xs: torch.Tensor, xlens: torch.Tensor,
                task: str = "all", gen: Optional[torch.Generator] = None):
        """xs [B, T, input_dim], xlens [B] int. Returns {"ys": {"xs": [B,
        T', output_dim], "xlens": [B]}}, the lengths on xlens's device."""
        if task not in ("all", "ys"):
            raise NotImplementedError(
                f"encoder task {task!r} (sub1/sub2 taps) is not ported yet, "
                f"see ROADMAP")
        if xs.dtype in (torch.bfloat16, torch.float16):
            raise NotImplementedError(
                "the RNN encoder computes in float32 (or float64) only "
                "(bf16 compute is not ported for it), see ROADMAP")
        # the packed layers take the lengths on the host: one copy a forward
        lens = xlens.to("cpu", torch.int64)
        h = xs
        if self.conv is not None:
            h, xlens = self.conv(h, xlens)
            lens = new_lens(lens, self.conv.subsampling_factor)
        for rnn, proj, factor, sub in zip(
                self.rnns, list(self.projs) or [None] * len(self.rnns),
                self.subsample, self.subsamplers):
            h, _ = rnn(h, lens)
            h = self.drop(h, gen)
            if proj is not None:
                h = torch.tanh(proj(h))
            if factor > 1:
                h, xlens = sub(h, xlens)
                lens = new_lens(lens, factor)
        if self.bridge is not None:
            h = self.bridge(h)
        return {"ys": {"xs": h, "xlens": xlens}}
