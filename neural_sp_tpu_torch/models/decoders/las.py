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
module hoists them too.

Scheduled sampling (``ss_prob > 0`` in ``train()``): as in JAX, step u
feeds ``argmax`` of step u-1's logits (after the readout's dropout; zero
logits, so token 0, at step 0) in place of the label where a Bernoulli
draw per row and step says so. The fed token is an index, which carries
no gradient, so the loss's gradient is the teacher-forced gradient on the
stream of fed tokens. Training takes two passes: pass 1 (``fed_tokens``,
no autograd) steps kernel K2 with each step's dropout scale and the
readout inside the loop only to choose the tokens; pass 2 is the
teacher-forced path above (K3 / K3b, the hoisted readout) over the mixed
stream. Both passes use the same masks (``SamplingMasks``, drawn once per
microstep). Zoneout, projections, deeper stacks, LM fusion and the other
attention types raise.

MoChA (``attn_type="mocha"``, ``models/modules/mocha.py``) has no kernel:
the JAX package computes it in plain JAX. Its keys are projected once per
utterance (``key_proj_mono``, ``key_proj_chunk``, ``mono_conv``,
``key_proj_value``, as JAX names them). In training the U+1 teacher-forced
steps are a loop of PyTorch ops under autograd: the LSTM cell on the
hoisted embedding gates, the step's dropout, MoChA in parallel mode with
the energies' noise (in ``eval()``, for the dev loss, hard mode, as JAX's
deterministic loss); the readout over all steps is hoisted as above, and
the expected alignments [B, U+1, H_ma, T] feed the quantity loss and the
``ctc_sync`` latency loss. A decode loop (``MochaDecodeLoop``) steps the
cell and MoChA in hard mode and keeps the carry itself; a beam's reorder
is an ``index_select`` of it by ``parent``. K2, K3 and K3b fuse location
attention and never run for MoChA.

Carry: ``(((c, h),), aw_prev [B, T], ctx_prev [B, enc_n_units])`` — the
JAX carry without its logits and LM slots; for MoChA aw_prev is alpha
[B, H_ma, T], one-hot at frame 0 at the start.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ... import EOS, PAD
from ...ops.criterion import compute_accuracy, cross_entropy_lsm
from ...ops.dropout import Dropout, bernoulli_mask, keep_mask
from ...ops.kernels import las_step
from ...ops.kernels.las_step import LasStepWorkspace
from ...ops.kernels.las_scan import LASScan
from ...ops.masks import make_pad_mask
from ..modules.attention import AttentionMechanism
from ..modules.mocha import MoChA, mocha_noise
from ..modules.recurrent import LSTMCell
from ..utils import append_sos_eos


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
                 dropout_emb: float = 0.0, ss_prob: float = 0.0,
                 mocha: Optional[dict] = None):
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
        self.mocha = attn_type == "mocha"
        if self.mocha:
            # MoChA's keyword arguments (``RNNDecoder``'s mocha_* options);
            # the keys come projected by the decoder
            self.attn = MoChA(kdim=enc_n_units, qdim=n_units, adim=attn_dim,
                              external_keys=True, **(mocha or {}))
        else:
            self.attn = AttentionMechanism(
                kdim=enc_n_units, qdim=n_units, adim=attn_dim,
                atype=attn_type, conv_out_channels=attn_conv_n_channels,
                conv_kernel_size=attn_conv_kernel_size,
                sharpening_factor=attn_sharpening_factor,
                sigmoid_smoothing=attn_sigmoid_smoothing)
        self.w_gen = nn.Linear(n_units + enc_n_units, bottleneck_dim)
        self.output = nn.Linear(bottleneck_dim, vocab)
        self.drop = Dropout(dropout)
        self.drop_emb = Dropout(dropout_emb)
        self.ss_prob = ss_prob

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
        aw [B, T]). For MoChA (``mocha_step``) key_cache is the dict of
        ``RNNDecoder.precompute_keys``, values is not read, aw is alpha
        [B, H_ma, T], and there is no workspace."""
        if self.mocha:
            mask = make_pad_mask(klens, key_cache["mono"].shape[1])
            return self.mocha_step(carry, y_t, key_cache, mask, parent)
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

    def mocha_step(self, carry, y_t, key_cache: dict, mask: torch.Tensor,
                   parent=None):
        """One MoChA decode step (hard mode) on ``carry``: rows reordered
        by ``parent`` first (a beam's reorder), then the LSTM cell on
        [emb, ctx_prev], MoChA with h as the query, the readout. mask [B, T]
        bool, valid frames. Returns (new_carry, logits [B, vocab], alpha
        [B, H_ma, T])."""
        ((c, h),), alpha, ctx = carry
        if parent is not None:
            parent = parent.to(device=h.device, dtype=torch.long)
            c, h, alpha, ctx = (x.index_select(0, parent)
                                for x in (c, h, alpha, ctx))
        cell = self.cells[0]
        gates = torch.addmm(cell.bias, self.embed(y_t),
                            cell.w_ih[:self.emb_dim])
        gates = torch.addmm(torch.addmm(gates, ctx, cell.w_ih[self.emb_dim:]),
                            h, cell.w_hh)
        c, h = lstm_cell(gates, c)
        ctx, alpha, _ = self.attn(key_cache, h, alpha, "hard", mask)
        logits = self.output(torch.tanh(self.w_gen(torch.cat([h, ctx], -1))))
        return (((c, h),), alpha, ctx), logits, alpha


def lstm_cell(gates: torch.Tensor, c: torch.Tensor):
    """flax ``OptimizedLSTMCell``'s update from the gate pre-activations
    [B, 4H] in (i, f, g, o) order: returns (c, h)."""
    i, f, g, o = gates.chunk(4, -1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)


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


class MochaDecodeLoop:
    """``DecodeLoop``'s interface for MoChA: the loop keeps the carry (LSTM
    state, alpha, context; zero state, alpha one-hot at frame 0 at the
    start) and steps ``LASStep.mocha_step``; a beam's ``parent`` reorders
    the carry's rows. The steps count in ``DecodeLoop.steps``."""

    def __init__(self, step: LASStep, key_cache: dict, klens, carry):
        self._step = step
        self.key_cache = key_cache
        self.mask = make_pad_mask(klens, key_cache["mono"].shape[1])
        self.carry = carry

    def step(self, y_t, parent=None):
        """Tokens y_t [B] (and a beam's parent rows [B]) -> (logits
        [B, vocab], alpha [B, H_ma, T])."""
        DecodeLoop.steps += 1
        self.carry, logits, alpha = self._step.mocha_step(
            self.carry, y_t, self.key_cache, self.mask, parent)
        return logits, alpha


class SamplingMasks(NamedTuple):
    """What one scheduled-sampling microstep draws, once, for both passes:
    the embedding's dropout scale [B, U+1, E], the LSTM output's [B, U+1,
    H] and the readout's [B, U+1, bottleneck] (None at rate 0; in the
    activations' type), and the sampling mask [B, U+1] (bool: feed the
    previous step's argmax)."""
    emb: Optional[torch.Tensor]
    keep: Optional[torch.Tensor]
    out: Optional[torch.Tensor]
    sample: torch.Tensor


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
                 lsm_prob: float = 0.0, ss_prob: float = 0.0,
                 mocha_chunk_size: int = 1, mocha_n_heads_mono: int = 1,
                 mocha_n_heads_chunk: int = 1, mocha_init_r: float = -4.0,
                 mocha_noise_std: float = 1.0,
                 mocha_no_denominator: bool = False,
                 mocha_eps_wait: int = -1,
                 mocha_stableemit_weight: float = 0.0,
                 mocha_1dconv: bool = False, mocha_share_ca: bool = False,
                 quantity_loss_weight: float = 0.0, latency_metric: str = "",
                 latency_loss_weight: float = 0.0):
        super().__init__()
        if backward:
            raise NotImplementedError(
                "the backward decoder is not ported yet, see ROADMAP")
        if latency_metric in ("decot", "minlt"):
            raise NotImplementedError(
                f"MoChA's {latency_metric!r} latency metric reads word "
                f"alignment directories, which are not ported yet (A4 item "
                f"6), see ROADMAP")
        if latency_metric not in ("", "ctc_sync"):
            raise ValueError(f"latency_metric {latency_metric!r}")
        if attn_type == "mocha" and ss_prob > 0:
            raise NotImplementedError(
                "scheduled sampling with MoChA is not ported yet, see ROADMAP")
        self.vocab, self.enc_n_units, self.n_units = vocab, enc_n_units, n_units
        self.attn_type = attn_type
        self.lsm_prob = lsm_prob
        # MoChA's losses (JAX RNNDecoder.quantity_loss_weight, latency_*);
        # the train CLI gates them by epoch
        self.quantity_loss_weight = quantity_loss_weight
        self.latency_metric = latency_metric
        self.latency_loss_weight = latency_loss_weight
        mocha = dict(chunk_size=mocha_chunk_size,
                     n_heads_mono=mocha_n_heads_mono,
                     n_heads_chunk=mocha_n_heads_chunk, init_r=mocha_init_r,
                     noise_std=mocha_noise_std,
                     no_denominator=mocha_no_denominator,
                     eps_wait=mocha_eps_wait,
                     stableemit_weight=mocha_stableemit_weight,
                     share_ca=mocha_share_ca)
        self.step = LASStep(
            vocab, emb_dim, n_units, n_projs, n_layers, enc_n_units,
            attn_type, attn_dim, attn_n_heads, attn_conv_n_channels,
            attn_conv_kernel_size, attn_sharpening_factor,
            attn_sigmoid_smoothing, bottleneck_dim, zoneout, lm_fusion,
            dropout, dropout_emb, ss_prob, mocha)
        if attn_type == "mocha":
            # keys projected once per utterance, with biases (JAX
            # _key_cache): the monotonic keys (after relu of a SAME width-5
            # conv with mocha_1dconv), the chunk keys (one head set shared
            # over the monotonic heads with share_ca) and, multihead only,
            # the values; a single head reads the raw encoder outputs
            h_ma, h_ca = mocha_n_heads_mono, mocha_n_heads_chunk
            self.key_proj_mono = nn.Linear(enc_n_units, attn_dim * h_ma)
            if mocha_chunk_size != 1:
                h_ck = h_ca if mocha_share_ca else h_ma * h_ca
                self.key_proj_chunk = nn.Linear(enc_n_units, attn_dim * h_ck)
            if mocha_1dconv:
                self.mono_conv = nn.Conv1d(enc_n_units, enc_n_units, 5,
                                           padding=2)
            if h_ma * h_ca > 1:
                self.key_proj_value = nn.Linear(enc_n_units,
                                                attn_dim * h_ma * h_ca)
        else:
            # attention keys projected once per utterance (with bias, as
            # the reference's location-attention w_key)
            self.key_proj = nn.Linear(enc_n_units, attn_dim)

    def forward(self, eouts: torch.Tensor, elens: torch.Tensor,
                ys: torch.Tensor, ylens: torch.Tensor,
                gen: Optional[torch.Generator] = None,
                trigger_points: Optional[torch.Tensor] = None):
        """Label-smoothed cross entropy (JAX ``RNNDecoder.__call__`` with
        the hoisted embedding gates and readout), teacher-forced, or in
        ``train()`` with ``ss_prob > 0`` over the fed tokens of pass 1
        (see the module docstring). eouts [B, T, D]; elens [B]; ys [B, U]
        PAD-padded; ylens [B]. Returns (loss, {"loss_att", "acc_att",
        "ppl_att"}). For MoChA see ``forward_mocha``
        (``trigger_points``)."""
        bs = eouts.shape[0]
        dev = eouts.device
        ys_in, ys_out, _ = append_sos_eos(ys.to(dev), ylens.to(dev))
        if self.attn_type == "mocha":
            return self.forward_mocha(eouts, elens, ys_in, ys_out,
                                      ylens.to(dev), gen, trigger_points)
        step, cell = self.step, self.step.cells[0]
        kc = self.precompute_keys(eouts)
        values = eouts.contiguous()
        klens = elens.to(device=dev, dtype=torch.int32)
        shape = (bs, ys_in.shape[1], self.n_units)
        sampled = self.training and step.ss_prob > 0
        if sampled:
            masks = self.sampling_masks(gen, bs, ys_in.shape[1],
                                        step.embed.weight.dtype, dev)
            ys_in = self.fed_tokens(ys_in, kc, values, klens, masks)
            emb = _scaled(step.embed(ys_in), masks.emb)
        else:
            emb = step.drop_emb(step.embed(ys_in), gen)
        eg = emb @ cell.w_ih[:step.emb_dim]                # [B, U+1, 4H]
        # in the activations' type (bf16 under a bf16 compute_dtype)
        if sampled:
            keep = masks.keep
        elif self.training and step.drop.rate > 0:
            keep = keep_mask(gen, step.drop.rate, shape, dev, eg.dtype)
        else:
            keep = None
        if keep is None:
            keep = torch.ones(shape, dtype=eg.dtype, device=dev)
        h, ctx, _ = LASScan.apply(
            eg, cell.w_ih[step.emb_dim:], cell.w_hh, cell.bias,
            *step.attn.kernel_weights(), kc, values, klens, keep)
        # readout order [dout, ctx] (JAX LASStep._generate), dout = h keep
        out = torch.tanh(step.w_gen(torch.cat([h * keep, ctx], -1)))
        out = _scaled(out, masks.out) if sampled else step.drop(out, gen)
        logits = step.output(out)
        loss, nll = cross_entropy_lsm(logits, ys_out, self.lsm_prob,
                                      ignore_index=PAD)
        acc = compute_accuracy(logits, ys_out, ignore_index=PAD)
        return loss, {"loss_att": loss, "acc_att": acc,
                      "ppl_att": torch.exp(nll)}

    def forward_mocha(self, eouts, elens, ys_in, ys_out, ylens,
                      gen: Optional[torch.Generator] = None,
                      trigger_points: Optional[torch.Tensor] = None):
        """The MoChA decoder's loss, as JAX ``RNNDecoder.__call__``: the
        U+1 teacher-forced steps as a loop under autograd (the cell on the
        hoisted embedding gates, the LSTM output's dropout, MoChA with the
        query h: in ``train()`` in parallel mode with the energies' noise,
        in ``eval()`` in hard mode, as JAX's deterministic loss), then the
        hoisted readout and the cross entropy. In ``train()`` the dropout
        scales and the noise are drawn from ``gen`` once for all steps (the
        embedding's, the LSTM output's, the noise [B, U+1, H_ma, T], the
        readout's), and the expected alignments add the quantity loss
        (|sum of alpha's mass over the steps of the labels and eos - (U +
        1)|, its mean over B, ``loss_quantity``) and the ``ctc_sync``
        latency loss (|the expected boundary frame - trigger_points[b, u]|
        over the valid labels whose trigger is >= 0, ``loss_latency``; the
        trigger points [B, U] from ``CTC.trigger_points``). The returned
        loss carries them; obs["loss_att"] is the cross entropy alone."""
        if eouts.dtype == torch.bfloat16:
            raise NotImplementedError(
                "bf16 compute with MoChA is not ported yet, see ROADMAP")
        bs, tmax = eouts.shape[:2]
        dev, dt = eouts.device, eouts.dtype
        step, cell = self.step, self.step.cells[0]
        attn = step.attn
        u1 = ys_in.shape[1]
        kc = self.precompute_keys(eouts)
        mask = make_pad_mask(elens.to(dev), tmax)
        emb = step.drop_emb(step.embed(ys_in), gen)
        eg = torch.addmm(cell.bias, emb.reshape(bs * u1, -1),
                         cell.w_ih[:step.emb_dim]).view(bs, u1, -1)
        keep = keep_mask(gen, step.drop.rate, (bs, u1, self.n_units), dev,
                         dt) if self.training and step.drop.rate > 0 else None
        noise = mocha_noise(gen, (bs, u1, attn.n_heads_mono, tmax), dev, dt) \
            if self.training and attn.noise_std > 0 else None
        c = h = eouts.new_zeros(bs, self.n_units)
        ctx = eouts.new_zeros(bs, self.enc_n_units)
        alpha = attn.init_alpha(bs, tmax, dev, dt)
        w_ctx = cell.w_ih[step.emb_dim:]
        # the expected alignment in train(), the hard boundaries in eval()
        # (JAX: mode "hard" when deterministic, so the dev loss too)
        mode = "parallel" if self.training else "hard"
        queries, ctxs, alphas = [], [], []
        for u in range(u1):
            gates = torch.addmm(torch.addmm(eg[:, u], ctx, w_ctx), h,
                                cell.w_hh)
            c, h = lstm_cell(gates, c)
            q = h if keep is None else h * keep[:, u]
            ctx, alpha, _ = attn(kc, q, alpha, mode, mask,
                                 noise=None if noise is None else noise[:, u])
            queries.append(q)
            ctxs.append(ctx)
            alphas.append(alpha)
        # readout order [dout, ctx] (JAX LASStep._generate), dout = h keep
        out = torch.tanh(step.w_gen(torch.cat(
            [torch.stack(queries, 1), torch.stack(ctxs, 1)], -1)))
        logits = step.output(step.drop(out, gen))
        loss, nll = cross_entropy_lsm(logits, ys_out, self.lsm_prob,
                                      ignore_index=PAD)
        acc = compute_accuracy(logits, ys_out, ignore_index=PAD)
        obs = {"loss_att": loss, "acc_att": acc, "ppl_att": torch.exp(nll)}
        if not self.training:
            return loss, obs
        aws = torch.stack(alphas, 1).float()            # [B, U+1, H_ma, T]
        steps = torch.arange(u1, device=dev)[None]
        if self.quantity_loss_weight > 0:
            valid = (steps < ylens[:, None] + 1).float()
            mass = aws.sum((2, 3)) / aws.shape[2]        # [B, U+1]
            qty = ((mass * valid).sum(1) - (ylens + 1).float()).abs()
            obs["loss_quantity"] = qty.mean()
            loss = loss + self.quantity_loss_weight * obs["loss_quantity"]
        if self.latency_metric == "ctc_sync" and \
                self.latency_loss_weight > 0 and trigger_points is not None:
            frames = torch.arange(tmax, device=dev, dtype=aws.dtype)
            exp_bd = (aws * frames).sum(3).mean(2)       # [B, U+1]
            tp = trigger_points.to(dev).float()
            tp = torch.nn.functional.pad(
                tp, (0, max(u1 - tp.shape[1], 0)))[:, :u1]
            valid = ((steps < ylens[:, None]) & (tp >= 0)).float()
            lat = (exp_bd - tp).abs() * valid
            obs["loss_latency"] = lat.sum() / valid.sum().clamp(min=1.0)
            loss = loss + self.latency_loss_weight * obs["loss_latency"]
        return loss, obs

    def sampling_masks(self, gen: Optional[torch.Generator], bs: int,
                       u1: int, dtype: torch.dtype, device) -> SamplingMasks:
        """A scheduled-sampling microstep's masks, drawn from ``gen`` in
        this order: the embedding's, the LSTM output's and the readout's
        dropout scales (each only at a rate above 0), then the sampling
        mask, True with probability ``ss_prob``. The JAX module draws them
        per step from its flax rngs, so the two packages draw different
        masks for one microstep (ROADMAP C4)."""
        step = self.step

        def scale(rate, width):
            if rate == 0:
                return None
            return keep_mask(gen, rate, (bs, u1, width), device, dtype)

        return SamplingMasks(
            scale(step.drop_emb.rate, step.emb_dim),
            scale(step.drop.rate, self.n_units),
            scale(step.drop.rate, step.w_gen.out_features),
            bernoulli_mask(gen, step.ss_prob, (bs, u1), device))

    @torch.no_grad()
    def fed_tokens(self, ys_in, kc, values, klens,
                   masks: SamplingMasks) -> torch.Tensor:
        """Pass 1 of scheduled sampling: the tokens [B, U+1] the U+1 steps
        are fed. Step u feeds ``argmax`` of step u-1's logits where
        ``masks.sample[:, u]`` (token 0 at step 0: the argmax of the zero
        logits JAX's carry starts with) and ``ys_in[:, u]`` elsewhere. Each
        step runs K2 through its workspace (float32; the LSTM output's
        dropout scale as K2's ``keep``), then the readout with its dropout
        and the vocabulary projection in the activations' type, as pass 2
        computes them."""
        step, cell = self.step, self.step.cells[0]
        dt = step.embed.weight.dtype
        ws = LasStepWorkspace(
            cell.w_ih[step.emb_dim:].float(), cell.w_hh.float(),
            cell.bias.float(),
            *(w.float() for w in step.attn.kernel_weights()),
            kc.float().contiguous(), values.float().contiguous(), klens)
        w_emb = cell.w_ih[:step.emb_dim].float()
        keep = None if masks.keep is None else \
            masks.keep.transpose(0, 1).float().contiguous()   # [U+1, B, H]
        fed = torch.empty_like(ys_in)
        prev = torch.zeros_like(ys_in[:, 0])
        for u in range(ys_in.shape[1]):
            y = torch.where(masks.sample[:, u], prev, ys_in[:, u])
            fed[:, u] = y
            emb = _scaled(step.embed(y), _at(masks.emb, u))
            torch.mm(emb.float(), w_emb, out=ws.eg)
            h, _, _, ctx = ws.step(keep=None if keep is None else keep[u])
            dout = h.to(dt) if masks.keep is None else \
                h.to(dt) * masks.keep[:, u]
            out = torch.tanh(step.w_gen(torch.cat([dout, ctx.to(dt)], -1)))
            prev = step.output(_scaled(out, _at(masks.out, u))).argmax(-1)
        return fed

    def precompute_keys(self, eouts: torch.Tensor):
        """The attention keys of ``eouts`` [B, T, D]: [B, T, attn_dim], or
        for MoChA the dict "mono", "chunk" (chunk_size != 1) and "value"
        (``MoChA``'s key cache)."""
        if self.attn_type != "mocha":
            return self.key_proj(eouts)
        mono_in = eouts
        if hasattr(self, "mono_conv"):
            mono_in = torch.relu(self.mono_conv(
                eouts.transpose(1, 2))).transpose(1, 2)
        kc = {"mono": self.key_proj_mono(mono_in),
              "value": self.key_proj_value(eouts)
              if hasattr(self, "key_proj_value") else eouts}
        if hasattr(self, "key_proj_chunk"):
            kc["chunk"] = self.key_proj_chunk(eouts)
        return kc

    def init_carry(self, bs: int, tmax: int, device,
                   dtype: torch.dtype = torch.float32):
        def z(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)
        aw0 = self.step.attn.init_alpha(bs, tmax, device, dtype) \
            if self.attn_type == "mocha" else z(bs, tmax)
        return (((z(bs, self.n_units), z(bs, self.n_units)),),
                aw0, z(bs, self.enc_n_units))

    def decode_loop(self, key_cache, eouts, klens):
        """What a decode loop steps through: built once, before its first
        step. klens [B] int32. A ``DecodeLoop`` on K2, or for MoChA a
        ``MochaDecodeLoop``."""
        if self.attn_type == "mocha":
            return MochaDecodeLoop(self.step, key_cache, klens,
                                   self.init_carry(eouts.shape[0],
                                                   eouts.shape[1],
                                                   eouts.device, eouts.dtype))
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


def _scaled(x: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """x times a dropout scale (None: no dropout)."""
    return x if scale is None else x * scale


def _at(scale: Optional[torch.Tensor], u: int) -> Optional[torch.Tensor]:
    """Step u's slice [B, ...] of a [B, U+1, ...] scale (None stays
    None)."""
    return None if scale is None else scale[:, u]
