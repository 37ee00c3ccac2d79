"""Speech2Text (counterpart of ``neural_sp_tpu/models/speech2text.py``):
encoder + LAS decoder + CTC head, assembled by ``build_speech2text`` from a
reference-style args namespace.

``forward`` is the training loss: SpecAugment (in ``train()`` mode), the
encoder, then ``ctc_weight * loss_ctc + (1 - ctc_weight) * loss_att``. The
step's randomness (SpecAugment, dropout) comes from the ``gen`` argument,
a ``torch.Generator``; in ``eval()`` mode the loss is deterministic, as the
JAX module's ``deterministic=True``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.specaugment import apply_masks, draw_masks
from .decoders.ctc import CTC
from .decoders.las import RNNDecoder
from .utils import model_device


class Speech2Text(nn.Module):
    def __init__(self, encoder: nn.Module,
                 dec_fwd: Optional[RNNDecoder] = None,
                 ctc: Optional[CTC] = None, ctc_weight: float = 0.0,
                 specaug: Optional[dict] = None):
        super().__init__()
        self.encoder = encoder
        self.dec_fwd = dec_fwd
        self.ctc = ctc
        self.ctc_weight = ctc_weight
        # draw_masks keywords; masks are drawn in train() mode only
        self.specaug = specaug or {}

    @property
    def fwd_weight(self) -> float:
        return max(1.0 - self.ctc_weight, 0.0)

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
                gen: Optional[torch.Generator] = None):
        """xs [B, T, input_dim] features, xlens [B], ys [B, U] PAD-padded
        labels, ylens [B]. Returns (loss, obs) with obs "loss", "loss_ctc",
        "loss_att", "acc_att", "ppl_att" (and a MoChA decoder's
        "loss_quantity" / "loss_latency" in ``train()``)."""
        xs = self._frontend(xs, xlens, gen)
        eouts = self.encoder(xs, xlens, gen=gen)["ys"]
        ex, el = eouts["xs"], eouts["xlens"]
        loss = torch.zeros((), dtype=torch.float32, device=xs.device)
        obs = {}
        if self.ctc is not None and self.ctc_weight > 0:
            loss_ctc, _ = self.ctc(ex, el, ys, ylens, gen)
            loss = loss + self.ctc_weight * loss_ctc
            obs["loss_ctc"] = loss_ctc
        if self.dec_fwd is not None and self.fwd_weight > 0:
            trig = None
            if self.training and self.ctc is not None and \
                    getattr(self.dec_fwd, "latency_metric", "") == "ctc_sync":
                # MoChA's ctc_sync targets: the forced alignment of the
                # labels to the CTC head's deterministic log-probabilities,
                # no gradient (JAX computes them in eval mode too, where
                # nothing reads them)
                trig = self.ctc.trigger_points(ex, el, ys, ylens)
            loss_att, obs_att = self.dec_fwd(ex, el, ys, ylens, gen, trig)
            loss = loss + self.fwd_weight * loss_att
            obs.update(obs_att)
        obs["loss"] = loss
        return loss, obs


# Training and model options of the JAX package the port does not have:
# each raises when set (non-zero / non-empty). The encoder's and the
# decoder's own (dropout_in, dropout_att, dropout_enc_layer) raise in their
# builders. rsp_prob_enc is the recipes' name of random state passing,
# which the JAX package reads as rsp_prob only (ROADMAP C16).
_NOT_PORTED = ("bwd_weight", "sub1_weight", "sub2_weight",
               "sequence_summary_network", "input_noise_std",
               "adaptive_number_ratio", "adaptive_size_ratio",
               "distillation_weight", "teacher", "mbr_training",
               "weight_noise_std", "rsp_prob_enc")


def build_speech2text(args, device=None) -> Speech2Text:
    """Assemble a Speech2Text from a reference-style args namespace, on
    ``device``: the CUDA card when it is None, the CPU only when asked for
    (``device="cpu"``). Without a card the default raises: nothing falls
    back to the CPU. The flagship's training options are honoured:
    SpecAugment (freq_width, n_freq_masks, time_width, n_time_masks,
    time_width_upper), lsm_prob, dropout_enc, dropout_dec, dropout_emb,
    and the CTC head's ctc_fc_list and ctc_lsm_prob; the others raise
    ``NotImplementedError``."""
    from .decoders.build import build_decoder
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
    specaug = dict(freq_mask_width=g("freq_width", 0),
                   n_freq_masks=g("n_freq_masks", 0),
                   time_mask_width=g("time_width", 0),
                   n_time_masks=g("n_time_masks", 0),
                   p=g("time_width_upper", 1.0))
    return Speech2Text(encoder=enc, dec_fwd=dec_fwd, ctc=ctc,
                       ctc_weight=ctc_weight, specaug=specaug).to(device)
