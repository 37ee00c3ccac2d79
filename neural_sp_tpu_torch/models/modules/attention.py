"""Location-aware attention of the LAS decoder (counterpart of
``AttentionMechanism(atype='location')`` in
``neural_sp_tpu/models/modules/attention.py``).

    e  = v . tanh(key_cache + w_query(query) + w_conv(conv(aw_prev)))
    aw = softmax_f32(e masked);  ctx = aw values

``conv`` is a width-K, SAME-padded, bias-free cross-correlation of the
previous weights into C channels (flax ``nn.Conv``). The keys arrive
projected (``RNNDecoder.key_proj``), so this module has no ``w_key``. Its
math runs inside kernel K2 together with the LSTM cell: ``LASStep`` calls
``ops.kernels.las_step`` with ``kernel_weights()``.
"""
from __future__ import annotations

from torch import nn


class AttentionMechanism(nn.Module):
    def __init__(self, kdim: int, qdim: int, adim: int,
                 atype: str = "location", conv_out_channels: int = 10,
                 conv_kernel_size: int = 201, sharpening_factor: float = 1.0,
                 sigmoid_smoothing: bool = False):
        super().__init__()
        if atype != "location" or sharpening_factor != 1.0 or \
                sigmoid_smoothing:
            raise NotImplementedError(
                f"attention {atype!r} (sharpening {sharpening_factor}, "
                f"sigmoid {sigmoid_smoothing}) is not ported yet (only "
                f"plain location attention), see ROADMAP")
        self.w_query = nn.Linear(qdim, adim, bias=False)
        self.v = nn.Linear(adim, 1, bias=False)
        self.conv = nn.Conv1d(1, conv_out_channels, conv_kernel_size,
                              bias=False)
        self.w_conv = nn.Linear(conv_out_channels, adim, bias=False)

    def kernel_weights(self):
        """(w_q [A, qdim], conv_w [C, K], w_f [A, C], v [A]): the layout
        ``ops.kernels.las_step`` takes."""
        c, _, k = self.conv.weight.shape
        return (self.w_query.weight, self.conv.weight.view(c, k),
                self.w_conv.weight, self.v.weight.view(-1))
