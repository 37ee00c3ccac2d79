"""Speech2Text for inference (counterpart of
``neural_sp_tpu/models/speech2text.py``): encoder + LAS decoder + CTC
head, assembled by ``build_speech2text`` from a reference-style args
namespace. The port serves only: SpecAugment and input noise are
training-time and never run at ``deterministic=True``, so they are not
part of it; the training losses are a later slice (ROADMAP)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .decoders.ctc import CTC
from .decoders.las import RNNDecoder
from .encoders.transformer import XformerEncoder


class Speech2Text(nn.Module):
    def __init__(self, encoder: XformerEncoder,
                 dec_fwd: Optional[RNNDecoder] = None,
                 ctc: Optional[CTC] = None, ctc_weight: float = 0.0):
        super().__init__()
        self.encoder = encoder
        self.dec_fwd = dec_fwd
        self.ctc = ctc
        self.ctc_weight = ctc_weight

    def encode(self, xs: torch.Tensor, xlens: torch.Tensor,
               task: str = "all"):
        """Returns (eouts, None) like the JAX ``encode``: eouts =
        {"ys": {"xs": [B, T', d], "xlens": [B]}}."""
        return self.encoder(xs, xlens, task=task), None


_NOT_PORTED = ("bwd_weight", "sub1_weight", "sub2_weight",
               "sequence_summary_network", "input_noise_std")


def build_speech2text(args) -> Speech2Text:
    """Assemble a Speech2Text from a reference-style args namespace."""
    from .decoders.build import build_decoder
    from .encoders.build import build_encoder

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
               fc_list=g("ctc_fc_list", "") or "")
           if ctc_weight > 0 else None)
    dec_fwd = build_decoder(args, vocab, enc_n_units) \
        if ctc_weight < 1.0 else None
    return Speech2Text(encoder=enc, dec_fwd=dec_fwd, ctc=ctc,
                       ctc_weight=ctc_weight)
