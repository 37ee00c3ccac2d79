"""Transformer / conformer encoder (counterpart of
``neural_sp_tpu/models/encoders/transformer.py``), offline path only:
conv frontend -> ``PositionalEncoding`` (input scale sqrt(d_model); the
sinusoid added for ``pe_type`` "add") -> pre-norm blocks with interlayer
subsampling -> final LayerNorm. No streaming, no sub1/sub2 taps, no layer
scan or rematerialisation (those change how the JAX program compiles, not
what it computes).

The blocks: the conformer's (macaron FFN / rel-PE MHA through kernel K1 /
conv / FFN / final norm) with ``pe_type`` "relative", and the
transformer's (scaled-dot MHA / FFN, the FFN's residual at factor 1, no
final norm) with ``pe_type`` "add" or "none". Self-attention masks keys
only (``make_san_mask``): pad queries attend the valid keys.

In ``train()`` mode dropout (rate ``dropout``) runs at the JAX module's
sites: after the positional encoding, inside each FFN, and on each
residual branch of a block. The generator of the step is the ``gen``
argument of ``forward``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...ops.dropout import Dropout
from ...ops.masks import make_pad_mask
from ..modules.conformer_convolution import ConformerConvBlock, LN_EPS
from ..modules.feed_forward import FFN
from ..modules.multihead_attention import MultiheadAttention
from ..modules.positional_embedding import ADDS_POSITIONS, PositionalEncoding
from ..modules.relative_multihead_attention import RelativeMultiheadAttention
from .conv import ConvEncoder
from .subsampling import build_subsampler


class EncoderBlock(nn.Module):
    """Pre-norm block: the conformer's (macaron FFN / rel-PE MHA / conv /
    FFN / final norm) or the transformer's (MHA / FFN)."""

    def __init__(self, d_model: int, d_ff: int, n_heads: int,
                 btype: str = "conformer", pe_type: str = "relative",
                 clamp_len: int = -1, ffn_activation: str = "swish",
                 ffn_bottleneck_dim: int = 0, conv_kernel_size: int = 15,
                 conv_normalization: str = "layer_norm", dropout: float = 0.0):
        super().__init__()
        if not (btype == "conformer" and pe_type == "relative" or
                btype == "transformer" and
                pe_type in ADDS_POSITIONS + ("none",)):
            raise NotImplementedError(
                f"encoder block {btype!r} with pe_type {pe_type!r} is not "
                f"ported yet (only conformer + relative and transformer + "
                f"add / none), see ROADMAP")
        self.conformer = btype == "conformer"
        self.drop = Dropout(dropout)
        if not self.conformer:
            self.norm_mha = nn.LayerNorm(d_model, eps=LN_EPS)
            self.mha = MultiheadAttention(d_model, n_heads)
            self.norm_ff = nn.LayerNorm(d_model, eps=LN_EPS)
            self.ff = FFN(d_model, d_ff, ffn_activation, ffn_bottleneck_dim,
                          dropout)
            return
        self.norm_ff_macaron = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ff_macaron = FFN(d_model, d_ff, ffn_activation,
                              ffn_bottleneck_dim, dropout)
        self.norm_mha = nn.LayerNorm(d_model, eps=LN_EPS)
        self.mha = RelativeMultiheadAttention(d_model, n_heads, clamp_len)
        self.norm_conv = nn.LayerNorm(d_model, eps=LN_EPS)
        self.conv = ConformerConvBlock(d_model, conv_kernel_size,
                                       conv_normalization)
        self.norm_ff = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ff = FFN(d_model, d_ff, ffn_activation, ffn_bottleneck_dim,
                      dropout)
        self.norm_final = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, xs: torch.Tensor, klens: torch.Tensor,
                edge: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """xs [B, T, d]; klens [B] valid frames (keys-only mask); edge [T]
        bool batch edge for the conv module."""
        if not self.conformer:
            h = self.norm_mha(xs)
            h, _ = self.mha(h, h, mask=make_pad_mask(klens, xs.shape[1]),
                            gen=gen)
            xs = xs + self.drop(h, gen)
            return xs + self.drop(self.ff(self.norm_ff(xs), gen), gen)
        xs = xs + 0.5 * self.drop(
            self.ff_macaron(self.norm_ff_macaron(xs), gen), gen)
        xs = xs + self.drop(self.mha(self.norm_mha(xs), klens), gen)
        xs = xs + self.drop(self.conv(self.norm_conv(xs), edge), gen)
        xs = xs + 0.5 * self.drop(self.ff(self.norm_ff(xs), gen), gen)
        return self.norm_final(xs)


class XformerEncoder(nn.Module):
    def __init__(self, input_dim: int, btype: str = "conformer",
                 d_model: int = 256, d_ff: int = 2048, n_heads: int = 4,
                 n_layers: int = 12, pe_type: str = "relative",
                 clamp_len: int = -1, ffn_activation: str = "swish",
                 ffn_bottleneck_dim: int = 0, last_proj_dim: int = 0,
                 subsample: tuple = (), subsample_type: str = "drop",
                 conv_kernel_size: int = 15,
                 conv_normalization: str = "layer_norm",
                 conv_channels: str = "", conv_kernel_sizes: str = "",
                 conv_strides: str = "", conv_poolings: str = "",
                 conv_frontend_normalization: str = "", dropout: float = 0.0):
        super().__init__()
        if not conv_channels:
            raise NotImplementedError(
                "an encoder without the conv frontend is not ported yet, "
                "see ROADMAP")
        if last_proj_dim > 0:
            raise NotImplementedError(
                "enc_last_proj_dim is not ported yet, see ROADMAP")
        self.d_model = d_model
        self.conv = ConvEncoder(
            input_dim, d_model, conv_channels, conv_kernel_sizes,
            conv_strides, conv_poolings, conv_frontend_normalization)
        self.blocks = nn.ModuleList(
            EncoderBlock(d_model, d_ff, n_heads, btype, pe_type, clamp_len,
                         ffn_activation, ffn_bottleneck_dim,
                         conv_kernel_size, conv_normalization, dropout)
            for _ in range(n_layers))
        self.subsample = list(subsample) or [1] * n_layers
        self.subsamplers = nn.ModuleList(
            build_subsampler(subsample_type, f) if f > 1 else nn.Identity()
            for f in self.subsample)
        self.norm_out = nn.LayerNorm(d_model, eps=LN_EPS)
        self.pos_enc = PositionalEncoding(
            d_model, "add" if pe_type in ADDS_POSITIONS else "none", dropout)

    @property
    def output_dim(self) -> int:
        return self.d_model

    def forward(self, xs: torch.Tensor, xlens: torch.Tensor,
                task: str = "all", gen: Optional[torch.Generator] = None):
        """xs [B, T, input_dim], xlens [B] int. Returns
        {"ys": {"xs": [B, T', d_model], "xlens": [B]}}."""
        if task not in ("all", "ys"):
            raise NotImplementedError(
                f"encoder task {task!r} (sub1/sub2 taps) is not ported yet, "
                f"see ROADMAP")
        h, xlens = self.conv(xs, xlens)
        h = self.pos_enc(h, 0, gen)
        edge = make_pad_mask(xlens, h.shape[1]).any(dim=0)
        for block, factor, sub in zip(self.blocks, self.subsample,
                                      self.subsamplers):
            h = block(h, xlens, edge, gen)
            if factor > 1:
                h, xlens = sub(h, xlens)
                edge = make_pad_mask(xlens, h.shape[1]).any(dim=0)
        return {"ys": {"xs": self.norm_out(h), "xlens": xlens}}
