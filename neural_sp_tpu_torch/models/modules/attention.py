"""The LAS decoder's attention (counterpart of ``AttentionMechanism`` in
``neural_sp_tpu/models/modules/attention.py``): location-aware or additive.

    location:  e = v . tanh(key_cache + w_query(query) + w_conv(conv(aw_prev)))
    additive:  e = v . tanh(key_cache + w_query(query))
    aw = softmax_f32(e masked);  ctx = aw values

``conv`` is a width-K, SAME-padded, bias-free cross-correlation of the
previous weights into C channels (flax ``nn.Conv``). The keys arrive
projected (``RNNDecoder.key_proj``), so this module has no ``w_key``. Its
math runs inside kernel K2 together with the LSTM cell: ``LASStep`` calls
``ops.kernels.las_step`` with ``kernel_weights()``, whose conv weights are
None for the additive energy.

``atype`` "add" is the additive energy; "triggered" is the same energy,
and the decoder masks the frames past each step's trigger point (JAX's
``trigger_points``: frames ``t <= trigger``), as the JAX decoder maps
"triggered" to "add". The recipes' name ``triggered_attention`` is read
as "triggered" by ``build_decoder`` (ROADMAP C44). Sharpening, sigmoid
smoothing and the dot-product types raise: no recipe sets them.
"""
from __future__ import annotations

from torch import nn

from .promote import Conv1d, Linear

# the energies this module computes, and the type each is built as
ATYPES = {"location": "location", "add": "add", "triggered": "add"}


class AttentionMechanism(nn.Module):
    def __init__(self, kdim: int, qdim: int, adim: int,
                 atype: str = "location", conv_out_channels: int = 10,
                 conv_kernel_size: int = 201, sharpening_factor: float = 1.0,
                 sigmoid_smoothing: bool = False):
        super().__init__()
        if atype not in ATYPES or sharpening_factor != 1.0 or \
                sigmoid_smoothing:
            raise NotImplementedError(
                f"attention {atype!r} (sharpening {sharpening_factor}, "
                f"sigmoid {sigmoid_smoothing}) is not ported yet (only "
                f"plain location, additive and triggered attention), see "
                f"ROADMAP")
        self.atype = ATYPES[atype]
        self.w_query = Linear(qdim, adim, bias=False)
        self.v = Linear(adim, 1, bias=False)
        if self.atype == "location":
            self.conv = Conv1d(1, conv_out_channels, conv_kernel_size,
                               bias=False)
            self.w_conv = Linear(conv_out_channels, adim, bias=False)

    def kernel_weights(self):
        """(w_q [A, qdim], conv_w [C, K], w_f [A, C], v [A]): the layout
        ``ops.kernels.las_step`` takes; conv_w and w_f are None for the
        additive energy."""
        if self.atype != "location":
            return self.w_query.weight, None, None, self.v.weight.view(-1)
        c, _, k = self.conv.weight.shape
        return (self.w_query.weight, self.conv.weight.view(c, k),
                self.w_conv.weight, self.v.weight.view(-1))
