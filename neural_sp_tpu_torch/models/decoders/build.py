"""build_decoder (counterpart of ``neural_sp_tpu/models/decoders/build.py``),
LAS LSTM branch."""
from __future__ import annotations

from .las import RNNDecoder


def _get(args, name, default=None):
    return getattr(args, name, default)


def build_decoder(args, vocab: int, enc_n_units: int,
                  backward: bool = False) -> RNNDecoder:
    dec_type = _get(args, "dec_type", "lstm")
    if _get(args, "dropout_att", 0.0):
        raise NotImplementedError(
            "dropout_att > 0 is not ported yet, see ROADMAP")
    if dec_type != "lstm":
        raise NotImplementedError(
            f"dec_type {dec_type!r} is not ported yet (only the LAS lstm "
            f"branch), see ROADMAP")
    return RNNDecoder(
        vocab=vocab, enc_n_units=enc_n_units,
        n_units=_get(args, "dec_n_units", 512),
        n_projs=_get(args, "dec_n_projs", 0),
        n_layers=_get(args, "dec_n_layers", 1),
        emb_dim=_get(args, "emb_dim", 512),
        bottleneck_dim=_get(args, "dec_bottleneck_dim",
                            _get(args, "dec_n_units", 512)),
        attn_type=_get(args, "attn_type", "location"),
        attn_dim=_get(args, "attn_dim", 512),
        attn_n_heads=_get(args, "attn_n_heads", 1),
        attn_conv_n_channels=_get(args, "attn_conv_n_channels", 10),
        attn_conv_kernel_size=_get(args, "attn_conv_width", 201),
        attn_sharpening_factor=_get(args, "attn_sharpening_factor", 1.0),
        attn_sigmoid_smoothing=_get(args, "attn_sigmoid", False),
        zoneout=_get(args, "zoneout", 0.0),
        lm_fusion=_get(args, "lm_fusion", "") or "",
        backward=backward,
        dropout=_get(args, "dropout_dec", 0.0),
        dropout_emb=_get(args, "dropout_emb", 0.0),
        lsm_prob=_get(args, "lsm_prob", 0.0),
        ss_prob=_get(args, "ss_prob", 0.0))
