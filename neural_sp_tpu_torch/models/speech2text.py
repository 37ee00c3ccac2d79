"""Speech2Text (counterpart of ``neural_sp_tpu/models/speech2text.py``):
encoder + decoder (an attention decoder, LAS or transformer, or an RNN
transducer) + CTC head, assembled by ``build_speech2text`` from a
reference-style args namespace.

``forward`` is the training loss: SpecAugment (in ``train()`` mode), the
encoder, then ``ctc_weight * loss_ctc + fwd_weight * loss_dec``, the
decoder's loss being ``loss_att`` or ``loss_transducer``, with
``fwd_weight = max(1 - ctc_weight - sub1_weight - sub2_weight, 0)``; and
for each hierarchical sub-task whose encoder tap is there (JAX's MTL
sub-heads) ``ctc_weight_sub{n} * loss_ctc_sub{n} + (sub{n}_weight -
ctc_weight_sub{n}) * loss_att_sub{n}`` on the tap's outputs and the
``ys_sub{n}`` labels (``ys`` where none are given). As in JAX, a sub CTC
head reads neither ``ctc_fc_list`` nor ``ctc_lsm_prob`` (ROADMAP C38). The
step's randomness (SpecAugment, dropout) comes from the ``gen`` argument,
a ``torch.Generator``; in ``eval()`` mode the loss is deterministic, as the
JAX module's ``deterministic=True``. ``mbr_loss`` is minimum-Bayes-risk
training's loss (the JAX train CLI's ``_mbr_loss``) over an n-best.

Trigger points (per-label boundary frames [B, U], -1 for none) reach a LAS
decoder whose MoChA latency metric is ``ctc_sync``, ``decot`` or ``minlt``
or whose attention is triggered, as JAX's rule: given ones (from word or
CTC alignments on disk), else, except for ``minlt``, the forced alignment
of the labels to the CTC head's log-probabilities, computed in
``eval()`` too, with no gradient. ``forward_with_carry`` is JAX's random
state passing: the RNN encoder starts from the previous batch's carry.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ..ops.specaugment import apply_masks, draw_masks
from .decoders.ctc import CTC
from .decoders.las import RNNDecoder
from .decoders.rnn_transducer import RNNTransducer
from .decoders.transformer import TransformerDecoder
from .utils import model_device


class Speech2Text(nn.Module):
    def __init__(self, encoder: nn.Module,
                 dec_fwd: Optional[Union[RNNDecoder, TransformerDecoder,
                                         RNNTransducer]] = None,
                 ctc: Optional[CTC] = None, ctc_weight: float = 0.0,
                 specaug: Optional[dict] = None,
                 dec_fwd_sub1: Optional[nn.Module] = None,
                 ctc_sub1: Optional[CTC] = None,
                 dec_fwd_sub2: Optional[nn.Module] = None,
                 ctc_sub2: Optional[CTC] = None, sub1_weight: float = 0.0,
                 ctc_weight_sub1: float = 0.0, sub2_weight: float = 0.0,
                 ctc_weight_sub2: float = 0.0):
        super().__init__()
        self.encoder = encoder
        self.dec_fwd = dec_fwd
        self.ctc = ctc
        self.dec_fwd_sub1, self.ctc_sub1 = dec_fwd_sub1, ctc_sub1
        self.dec_fwd_sub2, self.ctc_sub2 = dec_fwd_sub2, ctc_sub2
        self.set_weights(ctc_weight=ctc_weight, sub1_weight=sub1_weight,
                         ctc_weight_sub1=ctc_weight_sub1,
                         sub2_weight=sub2_weight,
                         ctc_weight_sub2=ctc_weight_sub2)
        # draw_masks keywords; masks are drawn in train() mode only
        self.specaug = specaug or {}

    def set_weights(self, **weights) -> None:
        """Set the task weights named (``ctc_weight``, ``sub1_weight``,
        ``ctc_weight_sub1``, ``sub2_weight``, ``ctc_weight_sub2``): the
        train CLI's ``mtl_per_batch`` trains one task per batch this way,
        the same modules with the other tasks' weights zeroed."""
        for name, w in weights.items():
            if name not in WEIGHTS:
                raise ValueError(f"no task weight {name!r}")
            setattr(self, name, float(w))

    @property
    def fwd_weight(self) -> float:
        return max(1.0 - self.ctc_weight - self.sub1_weight
                   - self.sub2_weight, 0.0)

    def encode(self, xs: torch.Tensor, xlens: torch.Tensor,
               task: str = "all"):
        """Returns (eouts, None) like the JAX ``encode``: eouts =
        {"ys": {"xs": [B, T', d], "xlens": [B]}}."""
        return self.encoder(xs, xlens, task=task), None

    def _frontend(self, xs, xlens, gen):
        if self.training and (self.specaug.get("n_freq_masks", 0)
                              + self.specaug.get("n_time_masks", 0)) > 0:
            draws = draw_masks(gen, xlens, xs.shape[-1], **self.specaug)
            xs = apply_masks(xs, xlens, draws)
        return xs

    def forward(self, xs: torch.Tensor, xlens: torch.Tensor,
                ys: torch.Tensor, ylens: torch.Tensor,
                gen: Optional[torch.Generator] = None,
                ys_sub1: Optional[torch.Tensor] = None,
                ylens_sub1: Optional[torch.Tensor] = None,
                ys_sub2: Optional[torch.Tensor] = None,
                ylens_sub2: Optional[torch.Tensor] = None,
                trigger_points: Optional[torch.Tensor] = None):
        """xs [B, T, input_dim] features, xlens [B], ys [B, U] PAD-padded
        labels, ylens [B]; the sub-tasks' labels likewise; trigger_points
        [B, U] int (-1: none) or None (see the module docstring). Returns
        (loss, obs) with obs "loss", "loss_ctc", "loss_att", "acc_att",
        "ppl_att" (and a MoChA or MMA decoder's "loss_quantity" /
        "loss_latency" in ``train()``), or with a transducer "loss",
        "loss_ctc", "loss_transducer"; with sub-tasks "loss_ctc_sub1", "loss_att_sub1"
        and the same for sub2."""
        xs = self._frontend(xs, xlens, gen)
        return self.losses(self.encoder(xs, xlens, gen=gen), ys, ylens, gen,
                           ys_sub1, ylens_sub1, ys_sub2, ylens_sub2,
                           trigger_points)

    def losses(self, eouts_all: dict, ys: torch.Tensor, ylens: torch.Tensor,
               gen: Optional[torch.Generator] = None,
               ys_sub1: Optional[torch.Tensor] = None,
               ylens_sub1: Optional[torch.Tensor] = None,
               ys_sub2: Optional[torch.Tensor] = None,
               ylens_sub2: Optional[torch.Tensor] = None,
               trigger_points: Optional[torch.Tensor] = None):
        """``forward``'s loss and observations from the encoder's outputs
        (``encode``'s eouts)."""
        eouts = eouts_all["ys"]
        ex, el = eouts["xs"], eouts["xlens"]
        loss = torch.zeros((), dtype=torch.float32, device=ex.device)
        obs = {}
        if self.ctc is not None and self.ctc_weight > 0:
            loss_ctc, _ = self.ctc(ex, el, ys, ylens, gen)
            loss = loss + self.ctc_weight * loss_ctc
            obs["loss_ctc"] = loss_ctc
        if self.dec_fwd is not None and self.fwd_weight > 0:
            trig = self.decoder_triggers(ex, el, ys, ylens, trigger_points)
            loss_att, obs_att = self.dec_fwd(ex, el, ys, ylens, gen, trig)
            loss = loss + self.fwd_weight * loss_att
            obs.update(obs_att)
        for sub, ys_s, ylens_s in (("sub1", ys_sub1, ylens_sub1),
                                   ("sub2", ys_sub2, ylens_sub2)):
            if f"ys_{sub}" not in eouts_all:
                continue
            ex = eouts_all[f"ys_{sub}"]["xs"]
            el = eouts_all[f"ys_{sub}"]["xlens"]
            if ys_s is None:
                ys_s, ylens_s = ys, ylens
            w = getattr(self, f"{sub}_weight")
            wc = getattr(self, f"ctc_weight_{sub}")
            ctc, dec = getattr(self, f"ctc_{sub}"), getattr(self,
                                                         f"dec_fwd_{sub}")
            if ctc is not None and wc > 0:
                loss_s, _ = ctc(ex, el, ys_s, ylens_s, gen)
                loss = loss + wc * loss_s
                obs[f"loss_ctc_{sub}"] = loss_s
            if dec is not None and w - wc > 0:
                loss_s, _ = dec(ex, el, ys_s, ylens_s, gen)
                loss = loss + (w - wc) * loss_s
                obs[f"loss_att_{sub}"] = loss_s
        obs["loss"] = loss
        return loss, obs

    def mbr_loss(self, xs: torch.Tensor, xlens: torch.Tensor,
                 nbest_ys: torch.Tensor, nbest_ylens: torch.Tensor,
                 risks: torch.Tensor, ys: torch.Tensor, ylens: torch.Tensor,
                 ce_weight: float):
        """Minimum-Bayes-risk training's loss, as the JAX train CLI's
        ``_mbr_loss`` composes it: the encoder's outputs, the main
        decoder's ``forward_mbr`` over the n-best (nbest_ys [B, N, U],
        nbest_ylens [B, N], risks [B, N]), plus ``ce_weight`` times the
        model's own loss on the labels. Every part deterministic, as JAX's
        (``deterministic=True``): call it in ``eval()``; the encoder runs
        once for both. Returns (loss, {"loss", "loss_mbr", "loss_ce"})."""
        if self.training:
            raise ValueError("mbr_loss is deterministic: call it in eval()")
        eouts_all = self.encoder(xs, xlens)
        ex, el = eouts_all["ys"]["xs"], eouts_all["ys"]["xlens"]
        loss_mbr = self.dec_fwd.forward_mbr(ex, el, nbest_ys, nbest_ylens,
                                            risks)
        loss_ce, _ = self.losses(eouts_all, ys, ylens)
        loss = loss_mbr + ce_weight * loss_ce
        return loss, {"loss": loss, "loss_mbr": loss_mbr, "loss_ce": loss_ce}

    def decoder_triggers(self, ex, el, ys, ylens, trigger_points=None):
        """The trigger points the main decoder takes (JAX's ``needs_trig``
        rule): None unless the decoder reads them (MoChA's ``ctc_sync``,
        ``decot`` or ``minlt``, triggered attention); the given ones, or
        else (not for ``minlt``) the CTC head's forced alignment of the
        labels, which carries no gradient."""
        metric = getattr(self.dec_fwd, "latency_metric", "")
        if metric not in ("ctc_sync", "decot", "minlt") and \
                getattr(self.dec_fwd, "attn_type", "") != "triggered":
            return None
        if trigger_points is None and self.ctc is not None and \
                metric != "minlt":
            trigger_points = self.ctc.trigger_points(ex, el, ys, ylens)
        return trigger_points

    def forward_with_carry(self, xs: torch.Tensor, xlens: torch.Tensor,
                           ys: torch.Tensor, ylens: torch.Tensor, carry,
                           gen: Optional[torch.Generator] = None):
        """JAX's ``forward_with_carry``, random state passing: the frontend,
        the RNN encoder from ``carry`` (per layer, None: zeros), then
        ``ctc_weight * loss_ctc + fwd_weight * loss_dec`` (no trigger
        points, no sub-tasks, as JAX's). Returns (loss, obs, new_carry):
        the encoder's carry at each row's last frame."""
        xs = self._frontend(xs, xlens, gen)
        eouts, new_carry = self.encoder.forward_with_carry(xs, xlens, carry,
                                                           gen)
        ex, el = eouts["ys"]["xs"], eouts["ys"]["xlens"]
        loss = torch.zeros((), dtype=torch.float32, device=xs.device)
        obs = {}
        if self.ctc is not None and self.ctc_weight > 0:
            loss_ctc, _ = self.ctc(ex, el, ys, ylens, gen)
            loss = loss + self.ctc_weight * loss_ctc
            obs["loss_ctc"] = loss_ctc
        if self.dec_fwd is not None and self.fwd_weight > 0:
            loss_att, obs_att = self.dec_fwd(ex, el, ys, ylens, gen)
            loss = loss + self.fwd_weight * loss_att
            obs.update(obs_att)
        obs["loss"] = loss
        return loss, obs, new_carry


# the task weights ``Speech2Text.set_weights`` sets
WEIGHTS = ("ctc_weight", "sub1_weight", "ctc_weight_sub1", "sub2_weight",
           "ctc_weight_sub2")


# Training and model options of the JAX package the port does not have:
# each raises when set (non-zero / non-empty). The encoder's and the
# decoder's own options are read (or refused) by ``build_encoder`` and
# ``build_decoder``. (The recipes' rsp_prob_enc, random state passing, is
# the train CLI's: ROADMAP C16.)
_NOT_PORTED = ("bwd_weight", "sequence_summary_network", "input_noise_std",
               "adaptive_number_ratio", "adaptive_size_ratio",
               "distillation_weight", "teacher", "weight_noise_std")


def build_speech2text(args, device=None) -> Speech2Text:
    """Assemble a Speech2Text from a reference-style args namespace, on
    ``device``: the CUDA card when it is None, the CPU only when asked for
    (``device="cpu"``). Without a card the default raises: nothing falls
    back to the CPU. The flagship's training options are honoured:
    SpecAugment (freq_width, n_freq_masks, time_width, n_time_masks,
    time_width_upper), lsm_prob, dropout_in, dropout_enc, dropout_dec,
    dropout_emb, dropout_att, dropout_enc_layer, the CTC head's
    ctc_fc_list and ctc_lsm_prob, and the MTL
    sub-tasks (sub{n}_weight, ctc_weight_sub{n}, vocab_sub{n},
    dec_config_sub{n}, the encoder's taps); the others raise
    ``NotImplementedError``."""
    from .decoders.build import build_decoder, sub_args
    from .encoders.build import build_encoder

    device = model_device(device, "build_speech2text")
    g = lambda name, default=None: getattr(args, name, default)  # noqa: E731
    for name in _NOT_PORTED:
        if g(name, 0):
            raise NotImplementedError(
                f"{name} is not ported yet, see ROADMAP")
    enc = build_encoder(args)
    enc_n_units = enc.output_dim
    vocab = args.vocab
    ctc_weight = g("ctc_weight", 0.0)
    ctc = (CTC(vocab=vocab, enc_n_units=enc_n_units,
               fc_list=str(g("ctc_fc_list", "") or ""),
               lsm_prob=g("ctc_lsm_prob", 0.0),
               dropout=g("dropout_dec", 0.0))
           if ctc_weight > 0 else None)
    dec_fwd = build_decoder(args, vocab, enc_n_units) \
        if ctc_weight < 1.0 else None

    def sub_heads(sub):
        """JAX's sub_heads: a CTC over vocab_sub{n} at the tap's width when
        ctc_weight_sub{n} > 0 (no fc layers, no label smoothing: C38), a
        decoder built with dec_config_sub{n}'s overrides when
        sub{n}_weight - ctc_weight_sub{n} > 0."""
        w, wc = g(f"{sub}_weight", 0.0), g(f"ctc_weight_{sub}", 0.0)
        if w <= 0:
            return None, None
        vocab_sub = g(f"vocab_{sub}", vocab)
        n_units_sub = getattr(enc, f"output_dim_{sub}", enc_n_units)
        c = CTC(vocab=vocab_sub, enc_n_units=n_units_sub,
                dropout=g("dropout_dec", 0.0)) if wc > 0 else None
        d = build_decoder(sub_args(args, sub), vocab_sub, n_units_sub) \
            if w - wc > 0 else None
        return d, c

    dec_s1, ctc_s1 = sub_heads("sub1")
    dec_s2, ctc_s2 = sub_heads("sub2")
    specaug = dict(freq_mask_width=g("freq_width", 0),
                   n_freq_masks=g("n_freq_masks", 0),
                   time_mask_width=g("time_width", 0),
                   n_time_masks=g("n_time_masks", 0),
                   p=g("time_width_upper", 1.0))
    return Speech2Text(
        encoder=enc, dec_fwd=dec_fwd, ctc=ctc, ctc_weight=ctc_weight,
        specaug=specaug, dec_fwd_sub1=dec_s1, ctc_sub1=ctc_s1,
        dec_fwd_sub2=dec_s2, ctc_sub2=ctc_s2,
        sub1_weight=g("sub1_weight", 0.0),
        ctc_weight_sub1=g("ctc_weight_sub1", 0.0),
        sub2_weight=g("sub2_weight", 0.0),
        ctc_weight_sub2=g("ctc_weight_sub2", 0.0)).to(device)
