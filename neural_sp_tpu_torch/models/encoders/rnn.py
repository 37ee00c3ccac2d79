"""RNN encoder (counterpart of ``neural_sp_tpu/models/encoders/rnn.py``):
the optional conv front end, then per layer a (B)LSTM
(``modules/recurrent.py::RNNLayer``) or a latency-controlled BLSTM
(``LCBLSTMLayer``), dropout, an optional ``tanh`` projection and an
interlayer subsampler; a ``bridge`` projection after the last layer.

The (B)LSTM layers run as packed sequences over the rows' lengths, which
are taken to the host once per forward and carried there through the
front end and the subsamplers. Their outputs past a row's length are zero
(the JAX module's differ there, and nothing reads them): so an interlayer
``max_pool``, whose last window of a row can straddle its edge, raises, as
does the GRU (ROADMAP).

``dropout_in`` drops input features before the front end. The
hierarchical taps (``n_layers_sub1`` / ``n_layers_sub2`` > 0), as JAX's:
after layer n - 1 (its dropout and projection), before its subsampler, an
optional task-specific (B)LSTM ``rnn_sub{n}_tsl`` (packed over the rows'
lengths, unprojected: ``output_dim_sub1`` / ``_sub2``) and an optional
``bridge_sub{n}``, returned as "ys_sub1" / "ys_sub2"; ``task="ys_sub1"``
returns there. The latency-controlled encoder taps the same way.

The latency-controlled BLSTM (``chunk_size_current > 0`` with a
bidirectional type) runs its forward direction over the whole padded
length and its backward direction over ``chunkwise`` windows of N_c + N_r
frames, as the JAX layer: a window of a row's last chunk reads the frames
past the row's length, so those frames are computed as JAX computes them
(padded, not packed; as with C5), and the layer's outputs past a row's
length are JAX's, not zero. The chunk shrinks with each interlayer
subsample, as JAX's.

Streaming (``stream_geometry``, ``block_input_frames``, ``streaming_step``)
is JAX's: one block of ``cnn_ctx_in + (N_c + N_r) f`` input frames, the
carry of every layer's forward direction returned frozen at the N_c
boundary; a unidirectional encoder streams in blocks of 40 frames.

In ``train()`` mode dropout (rate ``dropout``) runs after every layer, as
the JAX module's; the step's generator is the ``gen`` argument of
``forward``.

Random state passing (``forward_with_carry``, JAX's ``carry`` argument of
the encoder's call): each layer starts from a carry (per layer (c, h), or
((c, h) forward, (c, h) backward) for a BLSTM layer; None: zeros) and
returns its state at each row's last frame, which the training step
passes to the next batch.

Under a bf16 compute_dtype the types are JAX's (ROADMAP C50): the conv
front end computes in bf16, each layer in the type ``RNNLayer.
compute_type`` gives (float32 without a carry, bf16 from a bf16 carry),
and the projections and bridges promote their bf16 weights to their
input's type (``modules/promote.py``). So the encoder's outputs and
carries are float32 from no carry and bf16 from random state passing's
bf16 carry (an LC-BLSTM's outputs float32: its backward direction runs
carry-less; C48).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...ops.dropout import Dropout
from ..modules.promote import Linear
from ..modules.recurrent import RNNLayer, input_gates
from .conv import ConvEncoder, parse_cnn_config
from .subsampling import build_subsampler, new_lens
from .utils import chunkwise, chunkwise_merge


class LCBLSTMLayer(RNNLayer):
    """Latency-controlled BLSTM layer (the JAX ``LCBLSTMLayer``): the
    forward direction over the whole sequence, the backward direction over
    windows of the current chunk and its right context, run from each
    window's end. ``forward(xs [B, T, in], xlens=None, carry=None,
    single_chunk=False) -> (ys, carry_f)``; the parameters and their names
    are ``RNNLayer``'s bidirectional ones.

    Both directions run on cuDNN (``torch.lstm``), unpacked:
    * forward: the outputs at every frame, past a row's length too, are
      those of one scan over the padded length (flax ``nn.RNN``'s with
      ``seq_lengths``); the returned carry is each row's state at its
      length (the final one for a length of 0 or of T and more, as flax's
      gather clips it), so with lengths the scan runs in segments that end
      at the rows' distinct lengths and carries the state across them;
    * backward: one call over all B x n_chunks windows
      ``chunkwise(xs, 0, N_c, N_r)``, each reversed, from zero states,
      without lengths (the zero tail of the last chunk included, as JAX's),
      merged back to each chunk's current frames; with ``single_chunk`` the
      whole input is one window (a streaming block).
    On the card each direction's weights lie in a cuDNN buffer of their
    own, so neither call copies them.
    """

    def __init__(self, in_dim: int, n_units: int, n_current: int,
                 n_right: int, merge: str = "sum"):
        super().__init__(in_dim, n_units, "lstm", bidirectional=True,
                         merge=merge)
        self.n_current = n_current
        self.n_right = n_right

    def _apply(self, fn, recurse=True):
        """``nn.LSTM`` flattens both directions into one cuDNN buffer on a
        move to the card; this layer runs each direction in a call of its
        own, and cuDNN takes a direction's weights without copying them
        only where they begin a buffer. So each direction gets a buffer of
        its own after every move."""
        out = super()._apply(fn, recurse)
        flat = self.lstm._flat_weights
        if all(w.is_cuda and w.dtype == flat[0].dtype for w in flat) and \
                torch.backends.cudnn.is_acceptable(flat[0]) and \
                torch._use_cudnn_rnn_flatten_weight():
            from torch.backends.cudnn import rnn
            with torch.cuda.device_of(flat[0]), torch.no_grad():
                for d in (0, 4):
                    torch._cudnn_rnn_flatten_weight(
                        flat[d:d + 4], 4, self.lstm.input_size,
                        rnn.get_cudnn_mode("LSTM"), self.n_units, 0, 1,
                        True, False)
        return out

    def _lstm(self, xs, h0, c0, weights):
        """One direction over xs [B, T, in] from (h0, c0) [1, B, H]:
        (ys [B, T, H], h_n, c_n); cuDNN keeps what its backward needs only
        when grad is on."""
        return torch.lstm(xs, (h0, c0), weights, True, 1, 0.0,
                          torch.is_grad_enabled(), False, True)

    def _forward_direction(self, xs, xlens, carry, weights):
        bs, t, _ = xs.shape
        if carry is None:
            h = c = xs.new_zeros(1, bs, self.n_units)
        else:
            c, h = carry[0][None].to(xs.dtype), carry[1][None].to(xs.dtype)
        ends = [t] if xlens is None else [
            t if n <= 0 or n >= t else n for n in xlens.tolist()]
        outs, start = [], 0
        c_out = h_out = None
        for end in sorted(set(ends) | {t}):
            ys, h, c = self._lstm(xs[:, start:end], h, c, weights)
            outs.append(ys)
            rows = torch.tensor([e == end for e in ends],
                                device=xs.device)[:, None]
            c_out = c[0] if c_out is None else torch.where(rows, c[0], c_out)
            h_out = h[0] if h_out is None else torch.where(rows, h[0], h_out)
            start = end
        return torch.cat(outs, 1) if len(outs) > 1 else outs[0], \
            (c_out, h_out)

    def forward(self, xs: torch.Tensor,
                xlens: Optional[torch.Tensor] = None, carry=None,
                single_chunk: bool = False):
        if xs.is_cuda and not (torch.backends.cudnn.is_available() and
                               torch.backends.cudnn.enabled):
            raise RuntimeError("LCBLSTMLayer: cuDNN is not available on "
                               "the card")
        bs, t, _ = xs.shape
        # the forward direction's type (``RNNLayer.compute_type``); the
        # backward one starts from zeros, as the carry-less flax scan
        dt = self.compute_type(xs, carry)
        xs_b = xs.to(self.compute_type(xs))
        xs = xs.to(dt)
        weights = self.weights(dt)
        ys_f, carry_f = self._forward_direction(xs, xlens, carry,
                                                weights[:4])
        n_c, n_r = self.n_current, self.n_right
        windows = xs_b if single_chunk else chunkwise(xs_b, 0, n_c, n_r)
        zeros = windows.new_zeros(1, windows.shape[0], self.n_units)
        ys_b, _, _ = self._lstm(windows.flip(1), zeros, zeros,
                                self.weights(xs_b.dtype)[4:])
        ys_b = ys_b.flip(1)
        if not single_chunk:
            ys_b = chunkwise_merge(ys_b, bs, 0, n_c, n_r, t)
        return self._merge(ys_f, ys_b), carry_f

    def forward_ref(self, xs: torch.Tensor,
                    xlens: Optional[torch.Tensor] = None, carry=None,
                    single_chunk: bool = False):
        """The written-out cell loops, the layer's plain version: the
        forward direction over every frame (its carry taken at each row's
        length), the backward one over each window from its end."""
        bs, t, _ = xs.shape
        (w_f, u_f, _, b_f), (w_b, u_b, _, b_b) = self.lstm.all_weights
        ends = torch.full((bs,), t) if xlens is None else torch.where(
            (xlens <= 0) | (xlens >= t), torch.full_like(xlens, t), xlens)

        def cell(x_t, c, h, w_hh, bias):
            g_i, g_f, g_g, g_o = (torch.addmm(bias, h, w_hh.t())
                                  + x_t).chunk(4, dim=-1)
            c = torch.sigmoid(g_f) * c + torch.sigmoid(g_i) * torch.tanh(g_g)
            return c, torch.sigmoid(g_o) * torch.tanh(c)

        dt = self.compute_type(xs, carry)
        if carry is None:
            c = h = xs.new_zeros(bs, self.n_units, dtype=dt)
        else:
            c, h = (x.to(dt) for x in carry)
        xg = input_gates(xs, w_f, dt)
        u_f, b_f = u_f.to(dt), b_f.to(dt)
        ys_f, c_out, h_out = [], c, h
        for i in range(t):
            c, h = cell(xg[:, i], c, h, u_f, b_f)
            ys_f.append(h)
            at = (ends == i + 1).to(xs.device)[:, None]
            c_out, h_out = torch.where(at, c, c_out), torch.where(at, h, h_out)
        windows = xs if single_chunk else chunkwise(
            xs, 0, self.n_current, self.n_right)
        dt = self.compute_type(xs)
        xg = input_gates(windows, w_b, dt)
        u_b, b_b = u_b.to(dt), b_b.to(dt)
        c = h = xs.new_zeros(windows.shape[0], self.n_units, dtype=dt)
        ys_b = [None] * windows.shape[1]
        for i in reversed(range(windows.shape[1])):
            c, h = cell(xg[:, i], c, h, u_b, b_b)
            ys_b[i] = h
        ys_b = torch.stack(ys_b, 1)
        if not single_chunk:
            ys_b = chunkwise_merge(ys_b, bs, 0, self.n_current,
                                   self.n_right, t)
        return self._merge(torch.stack(ys_f, 1), ys_b), (c_out, h_out)


class RNNEncoder(nn.Module):
    def __init__(self, input_dim: int, rnn_type: str = "blstm",
                 n_units: int = 512, n_projs: int = 0,
                 last_proj_dim: int = 0, n_layers: int = 5,
                 dropout: float = 0.0, subsample: tuple = (),
                 subsample_type: str = "drop", conv_channels: str = "",
                 conv_kernel_sizes: str = "", conv_strides: str = "",
                 conv_poolings: str = "", conv_normalization: str = "",
                 conv_bottleneck_dim: int = 0,
                 chunk_size_current: int = -1, chunk_size_right: int = 0,
                 bidir_sum_fwd_bwd: bool = False, n_layers_sub1: int = 0,
                 n_layers_sub2: int = 0, task_specific_layer: bool = False,
                 dropout_in: float = 0.0):
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
        # latency-controlled: chunks in RNN-input (post-conv) frames
        self.lc = bidirectional and chunk_size_current > 0
        self.chunk_size_current = chunk_size_current
        self.chunk_size_right = chunk_size_right
        self.conv_cfg = (conv_channels, conv_kernel_sizes, conv_strides,
                         conv_poolings)
        self.conv = ConvEncoder(
            input_dim, conv_bottleneck_dim, conv_channels, conv_kernel_sizes,
            conv_strides, conv_poolings, conv_normalization) \
            if conv_channels else None
        in_dim = self.conv.output_dim if self.conv is not None else input_dim
        rnn_dim = 2 * n_units if bidirectional and not bidir_sum_fwd_bwd \
            else n_units
        merge = "sum" if bidir_sum_fwd_bwd else "concat"
        # the taps: (the layer they follow, their name)
        self.taps = [(n - 1, sub) for sub, n in (("sub1", n_layers_sub1),
                                                 ("sub2", n_layers_sub2))
                     if n > 0]
        layers, projs = [], []
        n_cur, n_right = chunk_size_current, chunk_size_right
        for lth, factor in enumerate(self.subsample):
            layers.append(
                LCBLSTMLayer(in_dim, n_units, n_cur, n_right, merge)
                if self.lc else
                RNNLayer(in_dim, n_units, "lstm", bidirectional, merge=merge))
            if n_projs > 0:
                projs.append(Linear(rnn_dim, n_projs))
            in_dim = n_projs if n_projs > 0 else rnn_dim
            for name in (s for at, s in self.taps if at == lth):
                # the task-specific layer emits unprojected units (JAX's
                # _output_dim_sub)
                dim_sub = in_dim
                if task_specific_layer:
                    setattr(self, f"rnn_{name}_tsl", RNNLayer(
                        in_dim, n_units, "lstm", bidirectional, merge=merge))
                    dim_sub = rnn_dim
                if last_proj_dim > 0:
                    setattr(self, f"bridge_{name}",
                            Linear(dim_sub, last_proj_dim))
                    dim_sub = last_proj_dim
                setattr(self, f"output_dim_{name}", dim_sub)
            if factor > 1 and self.lc:
                n_cur = max(n_cur // factor, 1)
                n_right = max(n_right // factor, 1)
        self.rnns = nn.ModuleList(layers)
        self.projs = nn.ModuleList(projs)
        self.subsamplers = nn.ModuleList(
            build_subsampler(subsample_type, f) if f > 1 else nn.Identity()
            for f in self.subsample)
        self.bridge = Linear(in_dim, last_proj_dim) \
            if last_proj_dim > 0 else None
        self.output_dim = last_proj_dim if last_proj_dim > 0 else in_dim
        self.drop_in = Dropout(dropout_in)
        self.drop = Dropout(dropout)

    @property
    def conv_factor(self) -> int:
        return self.conv.subsampling_factor if self.conv is not None else 1

    @property
    def subsampling_factor(self) -> int:
        f = self.conv_factor
        for s in self.subsample:
            f *= s
        return f

    def _layers(self):
        return zip(self.rnns, list(self.projs) or [None] * len(self.rnns),
                   self.subsample, self.subsamplers)

    def forward(self, xs: torch.Tensor, xlens: torch.Tensor,
                task: str = "all", gen: Optional[torch.Generator] = None):
        """xs [B, T, input_dim], xlens [B] int. Returns {"ys": {"xs": [B,
        T', output_dim], "xlens": [B]}} and each tap's "ys_sub1" /
        "ys_sub2" (``task`` "ys_sub1" or "ys_sub2": the taps up to that one
        only), the lengths on xlens's device."""
        return self._run(xs, xlens, task, gen)[0]

    def forward_with_carry(self, xs: torch.Tensor, xlens: torch.Tensor,
                           carry=None, gen: Optional[torch.Generator] = None):
        """``forward`` from each layer's carry (None: zeros), with the
        layers' carries at each row's last frame: (eouts, new_carry), a
        list with one carry per layer (JAX's ``encode(..., carry=)``)."""
        return self._run(xs, xlens, "all", gen, carry, True)

    def _run(self, xs, xlens, task, gen, carry=None, with_carry=False):
        # the packed layers take the lengths on the host: one copy a forward
        lens = xlens.to("cpu", torch.int64)
        h = self.drop_in(xs, gen)
        if self.conv is not None:
            h, xlens = self.conv(h, xlens)
            lens = new_lens(lens, self.conv.subsampling_factor)
        eouts, new_carry = {}, []
        for lth, (rnn, proj, factor, sub) in enumerate(self._layers()):
            # the LC layer's outputs do not depend on the lengths, only its
            # carry does, which the offline forward does not return
            h, c = rnn(h, None if self.lc and not with_carry else lens,
                       None if carry is None else carry[lth])
            new_carry.append(c)
            h = self.drop(h, gen)
            if proj is not None:
                h = torch.tanh(proj(h))
            for name in (s for at, s in self.taps if at == lth):
                h_sub = h
                if hasattr(self, f"rnn_{name}_tsl"):
                    h_sub, _ = getattr(self, f"rnn_{name}_tsl")(h_sub, lens)
                if hasattr(self, f"bridge_{name}"):
                    h_sub = getattr(self, f"bridge_{name}")(h_sub)
                eouts[f"ys_{name}"] = {"xs": h_sub, "xlens": xlens}
                if task == f"ys_{name}":
                    return eouts, new_carry
            if factor > 1:
                h, xlens = sub(h, xlens)
                lens = new_lens(lens, factor)
        if self.bridge is not None:
            h = self.bridge(h)
        eouts["ys"] = {"xs": h, "xlens": xlens}
        return eouts, new_carry

    def zero_carry(self, bs: int, dtype: torch.dtype, device) -> list:
        """Zeros [bs, n_units] of ``dtype`` in ``forward_with_carry``'s
        carry structure (random state passing's carry where its draw resets
        it, which JAX's step casts to the compute type)."""
        def state():
            z = torch.zeros(bs, self.rnns[0].n_units, dtype=dtype,
                            device=device)
            return (z, z)
        return [state() if self.lc or not rnn.bidirectional else
                (state(), state()) for rnn in self.rnns]

    # ---- streaming inference (JAX's; the carry is explicit) ------------ #
    def stream_geometry(self) -> tuple[int, int, int, int]:
        """(conv factor f, cnn_ctx_in input frames, n_c, n_r): n_c / n_r in
        RNN-input (post-conv) frames; a unidirectional encoder's block is
        40 frames with no lookahead (the reference's recog_block_sync_size
        default). cnn_ctx_in is the conv front end's left context, rounded
        up to a multiple of f."""
        f = self.conv_factor
        n_c, n_r = (self.chunk_size_current, self.chunk_size_right) \
            if self.lc else (40, 0)
        cnn_ctx_in = 0
        if self.conv is not None:
            cfg = parse_cnn_config(*self.conv_cfg)
            left, fac = 0, 1
            for (kt, _), (st, _), (pt, _) in zip(
                    cfg.kernel_sizes, cfg.strides, cfg.poolings):
                left += 2 * ((kt - 1) // 2) * fac
                fac *= st * max(pt, 1)
            cnn_ctx_in = -(-left // f) * f
        return f, cnn_ctx_in, n_c, n_r

    def block_input_frames(self) -> tuple[int, int]:
        """(input frames per block, new frames consumed per block)."""
        f, cnn_ctx_in, n_c, n_r = self.stream_geometry()
        return cnn_ctx_in + (n_c + n_r) * f, n_c * f

    def streaming_step(self, xs_block: torch.Tensor, carry=None):
        """One block: xs_block [B, cnn_ctx_in + (n_c + n_r) f, input_dim]
        -> (eouts [B, n_c', d], new carry: per layer the forward
        direction's state at the N_c boundary, (c, h), or for a
        bidirectional non-LC layer ((c, h), (c, h))). n_c' is n_c after the
        interlayer subsampling; carry None starts a segment (zeros)."""
        f, cnn_ctx_in, n_c, n_r = self.stream_geometry()
        bs = xs_block.shape[0]
        if self.conv is not None:
            full = torch.full((bs,), xs_block.shape[1], dtype=torch.long,
                              device=xs_block.device)
            h, _ = self.conv(xs_block, full)
            h = h[:, cnn_ctx_in // f: cnn_ctx_in // f + n_c + n_r]
        else:
            h = xs_block[:, cnn_ctx_in:]
        # the N_c boundary as every row's length: the layers compute the
        # whole window (the lookahead included) and return their carry
        # frozen there, so the next block continues from the true state
        boundary = torch.full((bs,), n_c, dtype=torch.long)
        new_carry = []
        n_c_l = n_c
        for lth, (rnn, proj, factor, sub) in enumerate(self._layers()):
            layer_carry = carry[lth] if carry is not None else None
            if self.lc:
                h, c = rnn(h, boundary, layer_carry, single_chunk=True)
            else:
                h, c = rnn(h, boundary, layer_carry)
            new_carry.append(c)
            if proj is not None:
                h = torch.tanh(proj(h))
            if factor > 1:
                h, boundary = sub(h, boundary)
                n_c_l = max(n_c_l // factor, 1)
        if self.bridge is not None:
            h = self.bridge(h)
        return h[:, :n_c_l], new_carry
