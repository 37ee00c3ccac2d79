"""LAS (attention-based) RNN decoder (counterpart of
``neural_sp_tpu/models/decoders/las.py``), decode step and teacher-forced
training loss.

One step: embed -> LSTM layer 0 on [emb, ctx_prev] -> dropout -> location
attention with the dropped output as the query -> readout
tanh(w_gen([h, ctx])) -> dropout -> vocab projection. At decode everything
from the gate pre-activations to the new context is kernel K2
(``ops.kernels.las_step``). A decode loop (``greedy_scan`` and the beam
searches of ``decoding.py``) steps through a ``DecodeLoop``, which builds
K2's ``LasStepWorkspace`` once: the carry lives there, and a beam's reorder
is K2's ``parent`` argument, so a step copies no carry and allocates nothing
for K2. In
training (``RNNDecoder.forward``) the U+1 teacher-forced steps are kernel
K3 with its backward K3b (``ops.kernels.las_scan``); the embedding half of
the gates and the readout over all steps are plain matmuls, as the JAX
module hoists them too. Scheduled sampling, zoneout, projections, deeper
stacks, LM fusion and the other attention types raise.

Carry: ``(((c, h),), aw_prev [B, T], ctx_prev [B, enc_n_units])`` — the
JAX carry without its logits and LM slots.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ... import EOS, PAD
from ...ops.criterion import compute_accuracy, cross_entropy_lsm
from ...ops.dropout import Dropout, keep_mask
from ...ops.kernels import las_step
from ...ops.kernels.las_step import LasStepWorkspace
from ...ops.kernels.las_scan import LASScan
from ..modules.attention import AttentionMechanism
from ..utils import append_sos_eos


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell`` parameters in one block per side, gate
    order (i, f, g, o): ``w_ih`` [in, 4H] (the input denses have no bias),
    ``w_hh`` [H, 4H] and ``bias`` [4H] (the hidden denses')."""

    def __init__(self, in_dim: int, n_units: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(in_dim, 4 * n_units))
        self.w_hh = nn.Parameter(torch.empty(n_units, 4 * n_units))
        self.bias = nn.Parameter(torch.empty(4 * n_units))


class LASStep(nn.Module):
    """One decode step: embed -> LSTM -> attend -> readout."""

    def __init__(self, vocab: int, emb_dim: int, n_units: int, n_projs: int,
                 n_layers: int, enc_n_units: int, attn_type: str = "location",
                 attn_dim: int = 512, attn_n_heads: int = 1,
                 attn_conv_n_channels: int = 10,
                 attn_conv_kernel_size: int = 201,
                 attn_sharpening_factor: float = 1.0,
                 attn_sigmoid_smoothing: bool = False,
                 bottleneck_dim: int = 1024, zoneout: float = 0.0,
                 lm_fusion: str = "", dropout: float = 0.0,
                 dropout_emb: float = 0.0):
        super().__init__()
        if n_layers != 1 or n_projs > 0 or zoneout > 0 or lm_fusion or \
                attn_n_heads != 1:
            raise NotImplementedError(
                "LAS decoder with n_layers != 1, projections, zoneout, LM "
                "fusion or multi-head attention is not ported yet, see "
                "ROADMAP")
        self.emb_dim = emb_dim
        self.embed = nn.Embedding(vocab, emb_dim)
        self.cells = nn.ModuleList([LSTMCell(emb_dim + enc_n_units, n_units)])
        self.attn = AttentionMechanism(
            kdim=enc_n_units, qdim=n_units, adim=attn_dim, atype=attn_type,
            conv_out_channels=attn_conv_n_channels,
            conv_kernel_size=attn_conv_kernel_size,
            sharpening_factor=attn_sharpening_factor,
            sigmoid_smoothing=attn_sigmoid_smoothing)
        self.w_gen = nn.Linear(n_units + enc_n_units, bottleneck_dim)
        self.output = nn.Linear(bottleneck_dim, vocab)
        self.drop = Dropout(dropout)
        self.drop_emb = Dropout(dropout_emb)

    def workspace(self, key_cache, values, klens) -> LasStepWorkspace:
        """K2's workspace for a decode loop over these keys, values and
        lengths (int32): built once, before the loop's first step."""
        cell = self.cells[0]
        return LasStepWorkspace(
            cell.w_ih[self.emb_dim:], cell.w_hh, cell.bias,
            *self.attn.kernel_weights(), key_cache, values, klens)

    def forward(self, carry, y_t, key_cache, values, klens, ws=None,
                parent=None):
        """carry as the module docstring; y_t [B] token ids; key_cache
        [B, T, attn_dim]; values [B, T, enc_n_units]; klens [B] int32;
        parent [B] int or None: row b continues row parent[b] of the carry
        (a beam's reorder, done inside K2). With ``ws`` (``workspace()``
        of the same keys, values and lengths; inference only) the carry
        lives in the workspace, ``carry`` is not read, and the step
        allocates nothing for K2. Returns (new_carry, logits [B, vocab],
        aw [B, T])."""
        cell = self.cells[0]
        if ws is None:
            ((c, h),), aw_prev, ctx_prev = carry
            eg = self.embed(y_t) @ cell.w_ih[:self.emb_dim]
            if parent is not None:
                parent = parent.to(torch.int32)
            h, c, aw, ctx = las_step(
                eg, ctx_prev, h, c, aw_prev, cell.w_ih[self.emb_dim:],
                cell.w_hh, cell.bias, *self.attn.kernel_weights(), key_cache,
                values, klens, parent=parent)
        else:
            torch.mm(self.embed(y_t), cell.w_ih[:self.emb_dim], out=ws.eg)
            if parent is not None:
                ws.parent.copy_(parent)
            h, c, aw, ctx = ws.step(use_parent=parent is not None)
        # readout order [dout, ctx] (JAX LASStep._generate)
        logits = self.output(torch.tanh(self.w_gen(torch.cat([h, ctx], -1))))
        return (((c, h),), aw, ctx), logits, aw


class DecodeLoop:
    """The decode steps of one loop over fixed keys, values and lengths,
    through K2's workspace: the carry lives there (zero at the start), and
    a beam search names each row's ``parent`` row of it. ``DecodeLoop.steps``
    counts the steps taken by all loops."""

    steps = 0

    def __init__(self, step: LASStep, key_cache, values, klens):
        self._step = step
        self._fixed = (key_cache, values.contiguous(), klens)
        self.ws = step.workspace(*self._fixed)

    def step(self, y_t, parent=None):
        """Tokens y_t [B] (and a beam's parent rows [B]) -> (logits
        [B, vocab], aw [B, T]); aw is the workspace's own tensor,
        overwritten by the step after the next."""
        DecodeLoop.steps += 1
        return self._step(None, y_t, *self._fixed, self.ws, parent)[1:]


class RNNDecoder(nn.Module):
    def __init__(self, vocab: int, enc_n_units: int, n_units: int = 1024,
                 n_projs: int = 0, n_layers: int = 1, emb_dim: int = 512,
                 bottleneck_dim: int = 1024, attn_type: str = "location",
                 attn_dim: int = 512, attn_n_heads: int = 1,
                 attn_conv_n_channels: int = 10,
                 attn_conv_kernel_size: int = 201,
                 attn_sharpening_factor: float = 1.0,
                 attn_sigmoid_smoothing: bool = False, zoneout: float = 0.0,
                 backward: bool = False, lm_fusion: str = "",
                 dropout: float = 0.0, dropout_emb: float = 0.0,
                 lsm_prob: float = 0.0):
        super().__init__()
        if backward:
            raise NotImplementedError(
                "the backward decoder is not ported yet, see ROADMAP")
        self.vocab, self.enc_n_units, self.n_units = vocab, enc_n_units, n_units
        self.attn_type = attn_type
        self.lsm_prob = lsm_prob
        self.step = LASStep(
            vocab, emb_dim, n_units, n_projs, n_layers, enc_n_units,
            attn_type, attn_dim, attn_n_heads, attn_conv_n_channels,
            attn_conv_kernel_size, attn_sharpening_factor,
            attn_sigmoid_smoothing, bottleneck_dim, zoneout, lm_fusion,
            dropout, dropout_emb)
        # attention keys projected once per utterance (with bias, as the
        # reference's location-attention w_key)
        self.key_proj = nn.Linear(enc_n_units, attn_dim)

    def forward(self, eouts: torch.Tensor, elens: torch.Tensor,
                ys: torch.Tensor, ylens: torch.Tensor,
                gen: Optional[torch.Generator] = None):
        """Teacher-forced label-smoothed cross entropy (JAX
        ``RNNDecoder.__call__`` with the hoisted embedding gates and
        readout). eouts [B, T, D]; elens [B]; ys [B, U] PAD-padded; ylens
        [B]. Returns (loss, {"loss_att", "acc_att", "ppl_att"})."""
        bs = eouts.shape[0]
        dev = eouts.device
        ys_in, ys_out, _ = append_sos_eos(ys.to(dev), ylens.to(dev))
        step, cell = self.step, self.step.cells[0]
        emb = step.drop_emb(step.embed(ys_in), gen)
        eg = emb @ cell.w_ih[:step.emb_dim]                # [B, U+1, 4H]
        shape = (bs, ys_in.shape[1], self.n_units)
        # in the activations' type (bf16 under a bf16 compute_dtype)
        if self.training and step.drop.rate > 0:
            keep = keep_mask(gen, step.drop.rate, shape, dev, eg.dtype)
        else:
            keep = torch.ones(shape, dtype=eg.dtype, device=dev)
        h, ctx, _ = LASScan.apply(
            eg, cell.w_ih[step.emb_dim:], cell.w_hh, cell.bias,
            *step.attn.kernel_weights(), self.precompute_keys(eouts),
            eouts.contiguous(), elens.to(device=dev, dtype=torch.int32),
            keep)
        # readout order [dout, ctx] (JAX LASStep._generate), dout = h keep
        logits = step.output(step.drop(
            torch.tanh(step.w_gen(torch.cat([h * keep, ctx], -1))), gen))
        loss, nll = cross_entropy_lsm(logits, ys_out, self.lsm_prob,
                                      ignore_index=PAD)
        acc = compute_accuracy(logits, ys_out, ignore_index=PAD)
        return loss, {"loss_att": loss, "acc_att": acc,
                      "ppl_att": torch.exp(nll)}

    def precompute_keys(self, eouts: torch.Tensor) -> torch.Tensor:
        return self.key_proj(eouts)

    def init_carry(self, bs: int, tmax: int, device,
                   dtype: torch.dtype = torch.float32):
        def z(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)
        return (((z(bs, self.n_units), z(bs, self.n_units)),),
                z(bs, tmax), z(bs, self.enc_n_units))

    def decode_loop(self, key_cache, eouts, klens) -> DecodeLoop:
        """What a decode loop steps through: built once, before its first
        step. klens [B] int32."""
        return DecodeLoop(self.step, key_cache, eouts, klens)

    def decode_step(self, carry, y_t, key_cache, eouts, klens, ws=None,
                    parent=None):
        """Single decode step. klens [B] int32: valid frames of each row
        (the JAX ``mask`` is ``make_pad_mask(klens, T)``); ``ws`` and
        ``parent`` as ``LASStep.forward``. Returns (carry, logits
        [B, vocab], aw [B, T])."""
        return self.step(carry, y_t, key_cache, eouts, klens, ws, parent)

    @torch.inference_mode()
    def greedy_scan(self, eouts, elens, max_len: int):
        """Greedy decode fed by its own argmax, ``max_len`` steps at most.
        Returns (tokens [B, max_len] with PAD after eos, lens [B]), as the
        JAX scan; the loop stops once every row has emitted eos, since the
        JAX scan only appends PAD after that."""
        bs = eouts.shape[0]
        key_cache = self.precompute_keys(eouts)
        klens = elens.to(device=eouts.device, dtype=torch.int32)
        loop = self.decode_loop(key_cache, eouts, klens)
        y = torch.full((bs,), EOS, dtype=torch.long, device=eouts.device)
        done = torch.zeros(bs, dtype=torch.bool, device=eouts.device)
        toks = torch.full((bs, max_len), PAD, dtype=torch.long,
                          device=eouts.device)
        for i in range(max_len):
            logits, _ = loop.step(y)
            y = logits.argmax(-1).masked_fill(done, PAD)
            done = done | (y == EOS)
            toks[:, i] = y
            y = y.masked_fill(done, EOS)
            if bool(done.all()):
                break
        ended = torch.cat([toks == EOS, torch.ones_like(toks[:, :1],
                                                        dtype=torch.bool)], 1)
        return toks, ended.int().argmax(1)
