"""build_decoder (counterpart of ``neural_sp_tpu/models/decoders/build.py``):
the LAS LSTM branch, with location, additive or triggered attention or
MoChA, the transformer branch, with or without MMA, and the LSTM
transducer. Each reads the keys JAX's ``build_decoder`` reads.
``sub_args`` gives a sub-task decoder's args.

The recipes name triggered attention ``triggered_attention`` (upstream's
name). JAX's ``build_decoder`` passes that name on unchanged and its
attention module raises on it; only ``triggered`` selects the additive
energy with the trigger window there. The port reads
``triggered_attention`` as ``triggered`` (ROADMAP C44, a departure)."""
from __future__ import annotations

from types import SimpleNamespace
from typing import Union

from .las import RNNDecoder
from .rnn_transducer import RNNTransducer
from .transformer import TransformerDecoder


def _get(args, name, default=None):
    return getattr(args, name, default)


def attn_type(args) -> str:
    """The LAS decoder's attention type, the recipes' ``triggered_attention``
    read as ``triggered`` (C44)."""
    atype = _get(args, "attn_type", "location")
    return "triggered" if atype == "triggered_attention" else atype


def _transformer(args, vocab: int, enc_n_units: int,
                 backward: bool) -> TransformerDecoder:
    # as JAX build.py: mocha_init_r and mocha_std are not read, so MMA's
    # offset and noise take MMAStep's defaults (-4.0, 1.0; ROADMAP C22),
    # and neither is dropout_head (C23); dropout_dec_layer is read there
    # into a field the block never uses; dropout_att reaches the self- and
    # source attention, but not MMA's layers (C43)
    return TransformerDecoder(
        vocab=vocab, enc_n_units=enc_n_units,
        d_model=_get(args, "transformer_dec_d_model",
                     _get(args, "transformer_d_model", 256)),
        d_ff=_get(args, "transformer_dec_d_ff",
                  _get(args, "transformer_d_ff", 2048)),
        n_heads=_get(args, "transformer_dec_n_heads",
                     _get(args, "transformer_n_heads", 4)),
        n_layers=_get(args, "dec_n_layers", 6),
        pe_type=_get(args, "transformer_dec_pe_type", "add"),
        dropout=_get(args, "dropout_dec", 0.1),
        dropout_att=_get(args, "dropout_att", 0.0),
        dropout_emb=_get(args, "dropout_emb", 0.0),
        lsm_prob=_get(args, "lsm_prob", 0.0),
        ffn_activation=_get(args, "transformer_ffn_activation", "relu"),
        mma_first_layer=_get(args, "mocha_first_layer", 0),
        mocha_chunk_size=_get(args, "mocha_chunk_size", 1),
        mocha_n_heads_mono=_get(args, "mocha_n_heads_mono", 1),
        mocha_n_heads_chunk=_get(args, "mocha_n_heads_chunk", 1),
        mocha_share_ca=_get(args, "share_chunkwise_attention", False),
        mocha_eps_wait=_get(args, "mocha_eps_wait", -1),
        quantity_loss_weight=_get(args, "mocha_quantity_loss_weight", 0.0),
        backward=backward)


def _transducer(args, vocab: int, enc_n_units: int,
                backward: bool) -> RNNTransducer:
    # as JAX build.py: the joint's width is transducer_joint_dim, else
    # dec_n_units; the recipes' dec_bottleneck_dim is not read
    return RNNTransducer(
        vocab=vocab, enc_n_units=enc_n_units,
        n_units=_get(args, "dec_n_units", 512),
        n_projs=_get(args, "dec_n_projs", 0),
        n_layers=_get(args, "dec_n_layers", 1),
        emb_dim=_get(args, "emb_dim", 512),
        joint_dim=_get(args, "transducer_joint_dim",
                       _get(args, "dec_n_units", 512)),
        rnn_type=_get(args, "dec_type").split("_")[0],
        dropout=_get(args, "dropout_dec", 0.0),
        dropout_emb=_get(args, "dropout_emb", 0.0),
        backward=backward)


def sub_args(args, sub: str):
    """The args a sub-task's decoder is built from: ``args`` with the
    ``dec_config_{sub}`` dict's keys over them (JAX's
    ``SimpleNamespace(**{**vars(args), **over})``), or ``args`` as they
    are without one."""
    over = _get(args, f"dec_config_{sub}", None)
    if not isinstance(over, dict):
        return args
    return SimpleNamespace(**{**vars(args), **over})


def build_decoder(args, vocab: int, enc_n_units: int, backward: bool = False
                  ) -> Union[RNNDecoder, TransformerDecoder, RNNTransducer]:
    dec_type = _get(args, "dec_type", "lstm")
    if dec_type in ("lstm_transducer", "gru_transducer"):
        return _transducer(args, vocab, enc_n_units, backward)
    if dec_type == "transformer":
        return _transformer(args, vocab, enc_n_units, backward)
    if dec_type != "lstm":
        raise NotImplementedError(
            f"dec_type {dec_type!r} is not ported yet (only the LAS lstm, "
            f"the transformer and the LSTM transducer branches), see "
            f"ROADMAP")
    return RNNDecoder(
        vocab=vocab, enc_n_units=enc_n_units,
        n_units=_get(args, "dec_n_units", 512),
        n_projs=_get(args, "dec_n_projs", 0),
        n_layers=_get(args, "dec_n_layers", 1),
        emb_dim=_get(args, "emb_dim", 512),
        bottleneck_dim=_get(args, "dec_bottleneck_dim",
                            _get(args, "dec_n_units", 512)),
        attn_type=attn_type(args),
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
        # the location attention's; MoChA reads none, as JAX's (C43)
        dropout_att=_get(args, "dropout_att", 0.0),
        lsm_prob=_get(args, "lsm_prob", 0.0),
        ss_prob=_get(args, "ss_prob", 0.0),
        # MoChA (attn_type "mocha"), as JAX build.py reads it
        mocha_chunk_size=_get(args, "mocha_chunk_size", 1),
        mocha_n_heads_mono=_get(args, "mocha_n_heads_mono", 1),
        mocha_n_heads_chunk=_get(args, "mocha_n_heads_chunk", 1),
        mocha_init_r=_get(args, "mocha_init_r", -4.0),
        mocha_noise_std=_get(args, "mocha_std", 1.0),
        mocha_no_denominator=_get(args, "mocha_no_denominator", False),
        mocha_eps_wait=_get(args, "mocha_eps_wait", -1),
        mocha_stableemit_weight=_get(args, "mocha_stableemit_weight", 0.0),
        mocha_1dconv=_get(args, "mocha_1dconv", False),
        mocha_share_ca=_get(args, "share_chunkwise_attention", False),
        quantity_loss_weight=_get(args, "mocha_quantity_loss_weight", 0.0),
        latency_metric=_get(args, "mocha_latency_metric", "") or "",
        latency_loss_weight=_get(args, "mocha_latency_loss_weight", 0.0),
        # the frames past a trigger point that triggered attention and
        # DeCoT attend to (JAX's trigger_lookahead)
        trigger_lookahead=_get(args, "mocha_decot_lookahead", 2))
