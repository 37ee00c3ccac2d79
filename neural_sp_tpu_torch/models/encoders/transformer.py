"""Transformer / conformer encoder (counterpart of
``neural_sp_tpu/models/encoders/transformer.py``): conv frontend ->
``PositionalEncoding`` (input scale sqrt(d_model); the sinusoid added for
``pe_type`` "add") -> pre-norm blocks with interlayer subsampling -> final
LayerNorm. No layer scan or rematerialisation (those change how the JAX
program compiles, not what it computes).

``dropout_in`` drops input features before the front end. The
hierarchical taps (``n_layers_sub1`` / ``n_layers_sub2`` > 0), as JAX's:
after block n - 1, before that layer's interlayer subsampler, the stream
goes through an optional task-specific block ``block_sub{n}_tsl`` (not
causal, as JAX builds it) and the tap's ``norm_out_sub{n}``, merged back
from its chunks in the reshape mode; it is returned as "ys_sub1" /
"ys_sub2" with the lengths of that point, and ``task="ys_sub1"`` returns
there.

The unidirectional and latency-controlled (streaming) encoders, as JAX's:
  * ``unidirectional``: a causal mask (after each interlayer subsampling
    too) and the causal conformer convolution;
  * ``chunk_size_current > 0`` with ``streaming_type`` "mask": the
    chunkwise mask (sizes in input frames, divided by the conv factor) and
    the causal convolution; no interlayer subsampling;
  * "reshape": the utterance cut into overlapping chunks that run as a
    batch with no mask (zero padding attended, as in JAX), merged back to
    ``ceil(T / f)`` frames;
  * bidirectional chunking (``chunk_size_current > 0``, not
    unidirectional) runs the conv frontend per chunk, so its outputs do
    not depend on the next chunk; xlens become ceil(xlens / f).
A conformer block's mask reaches kernel K1 as its window; a transformer
block's as a [B, T, T] mask. ``streaming_step`` runs one block of input
frames against per-layer key / value caches (and the conformer
convolution's), as JAX's: the block's queries attend the cache and the
block, and the outputs agree with the offline ``mask`` mode's wherever
the two see the same inputs (no lookahead; see ``stream_geometry``).

The blocks: the conformer's (macaron FFN / rel-PE MHA through kernel K1 /
conv / FFN / final norm) and the transformer's (MHA / FFN, the FFN's
residual at factor 1, no final norm). With ``pe_type`` "relative" or
"relative_xl" (either block, as JAX's ``_make_mha``) the MHA is
``RelativeMultiheadAttention`` on K1 / K1b ("relative_xl" its
Transformer-XL form, with ``w_pos`` and the u / v biases), clamped at
``clamp_len`` or unclamped (R = T); a transformer block with "add" or
"none" takes the scaled-dot ``MultiheadAttention`` (matmuls and a float32
softmax). Self-attention masks keys only (``make_san_mask``): pad queries
attend the valid keys.

In ``train()`` mode dropout (rate ``dropout``) runs at the JAX module's
sites: after the positional encoding, inside each FFN, and on each
residual branch of a block; ``dropout_att`` drops each block's attention
probabilities (a conformer's inside kernel K1, its mask hashed from key
words of the step's generator; a transformer's in
``MultiheadAttention``), in every streaming mode (the reshape mode's
chunks are rows of the batch); and LayerDrop (``dropout_layer``, layer l
of L at ``dropout_layer (l + 1) / L``) keeps or drops each residual
branch of a block as a whole, JAX's ``drop_path``: a kept branch's sum
``old + (new - old) / (1 - p)``, one decision per branch from the step's
generator. The task-specific blocks of the taps take neither, as JAX
builds them. The generator of the step is the ``gen`` argument of
``forward``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...ops.dropout import Dropout, bernoulli_mask
from ...ops.masks import CAUSAL, make_pad_mask, window_mask
from ..modules.conformer_convolution import ConformerConvBlock, LN_EPS
from ..modules.feed_forward import FFN
from ..modules.multihead_attention import MultiheadAttention
from ..modules.positional_embedding import ADDS_POSITIONS, PositionalEncoding
from ..modules.relative_multihead_attention import RelativeMultiheadAttention
from .conv import ConvEncoder
from .subsampling import build_subsampler
from .utils import chunkwise, chunkwise_merge

# the pe_types whose blocks attend with relative positions (K1 / K1b)
RELATIVE = ("relative", "relative_xl")


class EncoderBlock(nn.Module):
    """Pre-norm block: the conformer's (macaron FFN / rel-PE MHA / conv /
    FFN / final norm) or the transformer's (MHA / FFN)."""

    def __init__(self, d_model: int, d_ff: int, n_heads: int,
                 btype: str = "conformer", pe_type: str = "relative",
                 clamp_len: int = -1, ffn_activation: str = "swish",
                 ffn_bottleneck_dim: int = 0, conv_kernel_size: int = 15,
                 conv_normalization: str = "layer_norm", dropout: float = 0.0,
                 causal: bool = False, dropout_att: float = 0.0,
                 dropout_layer: float = 0.0):
        super().__init__()
        self.relative = pe_type in RELATIVE
        if not (btype == "conformer" and self.relative or
                btype == "transformer" and
                pe_type in ADDS_POSITIONS + ("none",) + RELATIVE):
            raise NotImplementedError(
                f"encoder block {btype!r} with pe_type {pe_type!r} is not "
                f"ported yet (only conformer + relative / relative_xl and "
                f"transformer + add / none / relative / relative_xl), see "
                f"ROADMAP")
        self.conformer = btype == "conformer"
        self.drop = Dropout(dropout)
        self.dropout_layer = dropout_layer
        if not self.conformer:
            self.norm_mha = nn.LayerNorm(d_model, eps=LN_EPS)
            self.mha = RelativeMultiheadAttention(
                d_model, n_heads, clamp_len, pe_type == "relative_xl",
                dropout_att) if self.relative else \
                MultiheadAttention(d_model, n_heads, dropout_att)
            self.norm_ff = nn.LayerNorm(d_model, eps=LN_EPS)
            self.ff = FFN(d_model, d_ff, ffn_activation, ffn_bottleneck_dim,
                          dropout)
            return
        self.norm_ff_macaron = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ff_macaron = FFN(d_model, d_ff, ffn_activation,
                              ffn_bottleneck_dim, dropout)
        self.norm_mha = nn.LayerNorm(d_model, eps=LN_EPS)
        self.mha = RelativeMultiheadAttention(d_model, n_heads, clamp_len,
                                              pe_type == "relative_xl",
                                              dropout_att)
        self.norm_conv = nn.LayerNorm(d_model, eps=LN_EPS)
        self.conv = ConformerConvBlock(d_model, conv_kernel_size,
                                       conv_normalization, causal)
        self.norm_ff = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ff = FFN(d_model, d_ff, ffn_activation, ffn_bottleneck_dim,
                      dropout)
        self.norm_final = nn.LayerNorm(d_model, eps=LN_EPS)

    def drop_path(self, new: torch.Tensor, old: torch.Tensor,
                  gen: Optional[torch.Generator]) -> torch.Tensor:
        """LayerDrop of one residual branch (JAX's ``drop_path``): in
        ``train()`` at ``dropout_layer`` p > 0, one draw from ``gen`` keeps
        the branch, scaled (old + (new - old) / (1 - p)), or drops it
        (old)."""
        p = self.dropout_layer
        if not self.training or p == 0.0:
            return new
        keep = bernoulli_mask(gen, 1.0 - p, (), new.device)
        return torch.where(keep, old + (new - old) * (1.0 / (1.0 - p)), old)

    def forward(self, xs: torch.Tensor, klens: torch.Tensor,
                edge: Optional[torch.Tensor],
                gen: Optional[torch.Generator] = None,
                window=None) -> torch.Tensor:
        """xs [B, T, d]; klens [B] valid frames (keys-only mask); edge [T]
        bool batch edge for the conv module (None: none); ``window`` the
        keys' window (n_l, n_c, n_r) or None."""
        dp = self.drop_path
        if not self.conformer:
            h = self.norm_mha(xs)
            if self.relative:
                h = self.mha(h, klens, window, gen)
            else:
                t = xs.shape[1]
                mask = make_pad_mask(klens, t) if window is None else \
                    window_mask(klens, t, t, window, 0, xs.device)
                h, _ = self.mha(h, h, mask=mask, gen=gen)
            xs = dp(xs + self.drop(h, gen), xs, gen)
            return dp(xs + self.drop(self.ff(self.norm_ff(xs), gen), gen),
                      xs, gen)
        xs = dp(xs + 0.5 * self.drop(
            self.ff_macaron(self.norm_ff_macaron(xs), gen), gen), xs, gen)
        xs = dp(xs + self.drop(self.mha(self.norm_mha(xs), klens, window,
                                        gen), gen), xs, gen)
        xs = dp(xs + self.drop(self.conv(self.norm_conv(xs), edge), gen),
                xs, gen)
        xs = dp(xs + 0.5 * self.drop(self.ff(self.norm_ff(xs), gen), gen),
                xs, gen)
        return self.norm_final(xs)

    def stream(self, xs: torch.Tensor, cache: dict, key_start: int,
               cur_len: int):
        """A streaming block xs [B, Tq, d] against the layer's cache ("k",
        "v" [B, n_l, H, dk]; "conv" [B, k - 1, d] for a conformer), the
        cache's slots below ``key_start`` masked. Returns (xs, {"k", "v"}
        over the cache and the block, the new conv cache or None)."""
        if not self.conformer:
            h = self.norm_mha(xs)
            if self.relative:
                h, kv = self.mha.stream(h, cache, key_start)
            else:
                bs, tq, _ = xs.shape
                tk = cache["k"].shape[1] + tq
                mask = (torch.arange(tk, device=xs.device) >= key_start)[
                    None, None].expand(bs, tq, tk)
                h, kv = self.mha(h, h, mask=mask, cache=cache)
            xs = xs + h
            return xs + self.ff(self.norm_ff(xs)), kv, None
        xs = xs + 0.5 * self.ff_macaron(self.norm_ff_macaron(xs))
        h, kv = self.mha.stream(self.norm_mha(xs), cache, key_start)
        xs = xs + h
        h, conv = self.conv(self.norm_conv(xs), None, cache["conv"], cur_len)
        xs = xs + h
        xs = xs + 0.5 * self.ff(self.norm_ff(xs))
        return self.norm_final(xs), kv, conv


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
                 conv_frontend_normalization: str = "", dropout: float = 0.0,
                 unidirectional: bool = False, chunk_size_left: int = -1,
                 chunk_size_current: int = -1, chunk_size_right: int = 0,
                 streaming_type: str = "mask", n_layers_sub1: int = 0,
                 n_layers_sub2: int = 0, task_specific_layer: bool = False,
                 dropout_in: float = 0.0, dropout_att: float = 0.0,
                 dropout_layer: float = 0.0):
        super().__init__()
        if not conv_channels:
            raise NotImplementedError(
                "an encoder without the conv frontend is not ported yet, "
                "see ROADMAP")
        if last_proj_dim > 0:
            raise NotImplementedError(
                "enc_last_proj_dim is not ported yet, see ROADMAP")
        if streaming_type not in ("mask", "reshape"):
            raise ValueError(f"streaming_type {streaming_type!r}")
        self.d_model, self.n_heads = d_model, n_heads
        self.conformer = btype == "conformer"
        self.conv_kernel_size = conv_kernel_size
        self.unidirectional = unidirectional
        self.chunk_size_left = chunk_size_left
        self.chunk_size_current = chunk_size_current
        self.chunk_size_right = chunk_size_right
        self.streaming_type = streaming_type
        self.conv = ConvEncoder(
            input_dim, d_model, conv_channels, conv_kernel_sizes,
            conv_strides, conv_poolings, conv_frontend_normalization)
        # the conformer conv is causal for `mask`-mode chunking too, so a
        # chunk never sees the next through it (JAX's causal flag)
        causal = unidirectional or (chunk_size_current > 0
                                    and streaming_type == "mask")
        # deeper layers dropped more by LayerDrop (JAX's formula)
        self.blocks = nn.ModuleList(
            EncoderBlock(d_model, d_ff, n_heads, btype, pe_type, clamp_len,
                         ffn_activation, ffn_bottleneck_dim,
                         conv_kernel_size, conv_normalization, dropout,
                         causal, dropout_att,
                         dropout_layer * (lth + 1) / max(n_layers, 1))
            for lth in range(n_layers))
        self.subsample = list(subsample) or [1] * n_layers
        self.subsamplers = nn.ModuleList(
            build_subsampler(subsample_type, f) if f > 1 else nn.Identity()
            for f in self.subsample)
        self.norm_out = nn.LayerNorm(d_model, eps=LN_EPS)
        # the taps: (the layer they follow, their name)
        self.taps = [(n - 1, sub) for sub, n in (("sub1", n_layers_sub1),
                                                 ("sub2", n_layers_sub2))
                     if n > 0]
        for _, sub in self.taps:
            if task_specific_layer:
                setattr(self, f"block_{sub}_tsl", EncoderBlock(
                    d_model, d_ff, n_heads, btype, pe_type, clamp_len,
                    ffn_activation, conv_kernel_size=conv_kernel_size,
                    dropout=dropout))
            setattr(self, f"norm_out_{sub}",
                    nn.LayerNorm(d_model, eps=LN_EPS))
        self.drop_in = Dropout(dropout_in)
        self.pos_enc = PositionalEncoding(
            d_model, "add" if pe_type in ADDS_POSITIONS else "none", dropout)

    @property
    def output_dim(self) -> int:
        return self.d_model

    @property
    def conv_factor(self) -> int:
        return self.conv.subsampling_factor

    @property
    def subsampling_factor(self) -> int:
        f = self.conv_factor
        for s in self.subsample:
            f *= s
        return f

    def _chunks(self) -> tuple[int, int, int]:
        """(n_l, n_c, n_r) in encoder frames: n_l -1 for an unlimited left
        context (a negative chunk_size_left), 0 for none."""
        f = self.conv_factor
        n_l = self.chunk_size_left // f if self.chunk_size_left > 0 else \
            (-1 if self.chunk_size_left < 0 else 0)
        return n_l, max(self.chunk_size_current // f, 1), \
            self.chunk_size_right // f

    def forward(self, xs: torch.Tensor, xlens: torch.Tensor,
                task: str = "all", gen: Optional[torch.Generator] = None):
        """xs [B, T, input_dim], xlens [B] int. Returns
        {"ys": {"xs": [B, T', d_model], "xlens": [B]}} and each tap's
        "ys_sub1" / "ys_sub2"; with ``task`` "ys_sub1" or "ys_sub2" the
        taps up to that one only."""
        xs = self.drop_in(xs, gen)
        f = self.conv_factor
        bs, t_raw = xs.shape[:2]
        streaming = self.chunk_size_current > 0
        reshape = streaming and self.streaming_type == "reshape"
        n_l, n_c, n_r = self._chunks()
        if streaming and not self.unidirectional:
            # chunk BEFORE the CNN: its outputs do not depend on the next
            # chunk (JAX's lc_bidir)
            nl_in = max(self.chunk_size_left, 0) if reshape else 0
            nr_in = max(self.chunk_size_right, 0) if reshape else 0
            h = chunkwise(xs, nl_in, self.chunk_size_current, nr_in)
            h, _ = self.conv(h, torch.full((h.shape[0],), h.shape[1],
                                           dtype=xlens.dtype,
                                           device=xlens.device))
            xlens = (xlens + f - 1) // f
            if not reshape:   # mask mode: back to [B, ceil(T / f), d]
                h = h.reshape(bs, -1, h.shape[-1])[:, :-(-t_raw // f)]
        else:
            h, xlens = self.conv(xs, xlens)
        h = self.pos_enc(h, 0, gen)
        window = None
        if reshape:
            # each chunk a row of its own, every frame a key
            klens = torch.full((h.shape[0],), h.shape[1], dtype=xlens.dtype,
                               device=xlens.device)
            edge = None
        else:
            klens = xlens
            edge = make_pad_mask(xlens, h.shape[1]).any(dim=0)
            if streaming:
                window = (n_l, n_c, n_r)
            elif self.unidirectional:
                window = CAUSAL
        eouts = {}
        for lth, (block, factor, sub) in enumerate(zip(
                self.blocks, self.subsample, self.subsamplers)):
            h = block(h, klens, edge, gen, window)
            for name in (s for at, s in self.taps if at == lth):
                h_sub = h
                if hasattr(self, f"block_{name}_tsl"):
                    h_sub = getattr(self, f"block_{name}_tsl")(
                        h_sub, klens, edge, gen, window)
                h_sub = getattr(self, f"norm_out_{name}")(h_sub)
                if reshape:
                    h_sub = chunkwise_merge(h_sub, bs, max(n_l, 0), n_c, n_r,
                                            -(-t_raw // f))
                eouts[f"ys_{name}"] = {"xs": h_sub, "xlens": xlens}
                if task == f"ys_{name}":
                    return eouts
            if factor > 1:
                if streaming:   # JAX asserts here, past the layer (C28)
                    raise ValueError("interlayer subsampling with a "
                                     "streaming (chunked) encoder")
                h, xlens = sub(h, xlens)
                klens = xlens
                edge = make_pad_mask(xlens, h.shape[1]).any(dim=0)
        h = self.norm_out(h)
        if reshape:
            h = chunkwise_merge(h, bs, max(n_l, 0), n_c, n_r,
                                -(-t_raw // f))
        eouts["ys"] = {"xs": h, "xlens": xlens}
        return eouts

    # ---- streaming inference (per-layer caches) ----------------------- #
    def stream_geometry(self) -> tuple[int, int, int, int, int]:
        """(conv factor f, cnn_ctx_in, n_l, n_c, n_r): the last three in
        encoder frames, cnn_ctx_in (0: the CNN sees the current block
        only, as JAX's) in input frames. Raises without chunks, as JAX's
        assertion (the unidirectional recipe confs set none)."""
        f = self.conv_factor
        n_c_in = self.chunk_size_current
        n_r_in = max(self.chunk_size_right, 0)
        n_l_in = self.chunk_size_left if self.chunk_size_left > 0 else 0
        if n_c_in <= 0:
            raise ValueError("streaming requires chunk_size_current > 0")
        if n_c_in % f or n_l_in % f or n_r_in % f:
            raise ValueError("streaming chunk sizes must be multiples of "
                             "the conv factor")
        return f, 0, n_l_in // f, n_c_in // f, n_r_in // f

    def block_input_frames(self) -> tuple[int, int]:
        """(input frames per block, new frames consumed per block)."""
        f, cnn_ctx_in, _, n_c, n_r = self.stream_geometry()
        return cnn_ctx_in + (n_c + n_r) * f, n_c * f

    def init_stream_cache(self, bs: int, dtype=torch.float32, device=None):
        """Zero caches: per layer "k", "v" [B, n_l, H, dk] (and "conv"
        [B, k - 1, d] for a conformer); "len" the valid cached frames and
        "offset" the frames encoded so far (ints)."""
        _, _, n_l, _, _ = self.stream_geometry()
        device = device or self.norm_out.weight.device
        dk = self.d_model // self.n_heads
        layers = []
        for _ in self.blocks:
            layer = {x: torch.zeros((bs, n_l, self.n_heads, dk), dtype=dtype,
                                    device=device) for x in ("k", "v")}
            if self.conformer:
                layer["conv"] = torch.zeros(
                    (bs, self.conv_kernel_size - 1, self.d_model),
                    dtype=dtype, device=device)
            layers.append(layer)
        return {"layers": layers, "len": 0, "offset": 0}

    def streaming_step(self, xs_block: torch.Tensor, cache: dict):
        """One block: xs_block [B, cnn_ctx_in + (n_c + n_r) f, input_dim]
        (zero-padded at the utterance's edges) -> (eouts [B, n_c, d],
        new cache). The block's queries attend the cached n_l frames (the
        empty slots masked) and the whole block; the right-context frames
        are attended, never cached."""
        f, cnn_ctx_in, n_l, n_c, n_r = self.stream_geometry()
        bs = xs_block.shape[0]
        blk = n_c + n_r
        full = torch.full((bs,), xs_block.shape[1], dtype=torch.long,
                          device=xs_block.device)
        h, _ = self.conv(xs_block, full)
        h = self.pos_enc(h[:, cnn_ctx_in // f: cnn_ctx_in // f + blk],
                         cache["offset"])
        key_start = n_l - cache["len"]
        layers = []
        for block, lc in zip(self.blocks, cache["layers"]):
            h, kv, conv = block.stream(h, lc, key_start, n_c)
            new = {x: kv[x][:, :n_l + n_c][:, n_c:] for x in ("k", "v")}
            if conv is not None:
                new["conv"] = conv
            layers.append(new)
        h = self.norm_out(h)
        return h[:, :n_c], {"layers": layers,
                            "len": min(cache["len"] + n_c, n_l),
                            "offset": cache["offset"] + n_c}
