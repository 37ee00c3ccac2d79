"""build_encoder (counterpart of ``neural_sp_tpu/models/encoders/build.py``),
the RNN (lstm / blstm, with or without the conv front end), conformer and
transformer branches, with their unidirectional (``uni_`` types or
``unidirectional``) and latency-controlled (``lc_chunk_size_*``,
``lc_type``) forms, their sub1 / sub2 taps (``enc_n_layers_sub1`` /
``_sub2``, ``task_specific_layer``), ``dropout_in``, and for the
transformer / conformer ``dropout_att`` and LayerDrop
(``dropout_enc_layer``); the TDS and gated-conv encoders read the keys
JAX's builder reads (ROADMAP C41, C42). Takes any object with attribute
access and the reference's flag names."""
from __future__ import annotations

from typing import Union

from .gated_conv import GatedConvEncoder
from .rnn import RNNEncoder
from .tds import TDSEncoder
from .transformer import XformerEncoder


def _get(args, name, default=None):
    return getattr(args, name, default)


def _conv_norm(args) -> str:
    norm = _get(args, "conv_normalization", "")
    if not norm:
        if _get(args, "conv_batch_norm", False):
            norm = "batch_norm"
        elif _get(args, "conv_layer_norm", False):
            norm = "layer_norm"
    return norm


def _subsample_tuple(args) -> tuple:
    s = _get(args, "subsample", "")
    if not s:
        return ()
    if isinstance(s, (list, tuple)):
        return tuple(int(x) for x in s)
    return tuple(int(x) for x in str(s).split("_"))


def _chunk_current(args) -> int:
    """The LC-BLSTM's current chunk: ``lc_chunk_size_current`` (JAX's only
    key), else the recipes' ``lc_chunk_size_left``, which upstream reads as
    the current chunk and the JAX builder ignores, building those confs
    full-context (ROADMAP C13: not mirrored)."""
    return _get(args, "lc_chunk_size_current",
                _get(args, "chunk_size_current",
                     _get(args, "lc_chunk_size_left", -1)))


def _rnn_encoder(args, core: str, conv: bool) -> RNNEncoder:
    return RNNEncoder(
        input_dim=args.input_dim,
        rnn_type=core,
        n_units=_get(args, "enc_n_units", 512),
        n_projs=_get(args, "enc_n_projs", 0),
        last_proj_dim=_get(args, "enc_last_proj_dim", 0),
        n_layers=_get(args, "enc_n_layers", 5),
        dropout=_get(args, "dropout_enc", 0.0),
        subsample=_subsample_tuple(args),
        subsample_type=_get(args, "subsample_type", "drop"),
        conv_channels=_get(args, "conv_channels", "") if conv else "",
        conv_kernel_sizes=_get(args, "conv_kernel_sizes", ""),
        conv_strides=_get(args, "conv_strides", ""),
        conv_poolings=_get(args, "conv_poolings", ""),
        conv_normalization=_conv_norm(args),
        conv_bottleneck_dim=_get(args, "conv_bottleneck_dim", 0),
        chunk_size_current=_chunk_current(args),
        chunk_size_right=_get(args, "lc_chunk_size_right",
                              _get(args, "chunk_size_right", 0)),
        # JAX build.py: concat unless the conf sets the sum
        bidir_sum_fwd_bwd=_get(args, "bidirectional_sum_fwd_bwd",
                               _get(args, "bidir_sum_fwd_bwd", False)),
        **_taps(args),
    )


def _taps(args) -> dict:
    """The keys both encoders read for their taps and input dropout."""
    return dict(n_layers_sub1=_get(args, "enc_n_layers_sub1", 0),
                n_layers_sub2=_get(args, "enc_n_layers_sub2", 0),
                task_specific_layer=_get(args, "task_specific_layer", False),
                dropout_in=_get(args, "dropout_in", 0.0))


def build_encoder(args) -> Union[RNNEncoder, XformerEncoder, TDSEncoder,
                                 GatedConvEncoder]:
    enc_type = args.enc_type
    if enc_type == "tds":
        # JAX reads the kernels from tds_kernel_sizes, never from the
        # recipes' conv_kernel_sizes, zipped with conv_channels (C41)
        return TDSEncoder(
            input_dim=args.input_dim,
            channels=_get(args, "conv_channels", "10_10_14_14_18_18"),
            kernel_sizes=_get(args, "tds_kernel_sizes", "21_21_21_21_21_21"),
            dropout=_get(args, "dropout_enc", 0.0),
            last_proj_dim=_get(args, "enc_last_proj_dim", 0))
    if enc_type == "gated_conv":
        # JAX reads gated_conv_layers, never the recipes' conv_channels /
        # conv_kernel_sizes (C42)
        return GatedConvEncoder(
            input_dim=args.input_dim,
            layers=_get(args, "gated_conv_layers", "100:3_100:3_100:3"),
            dropout=_get(args, "dropout_enc", 0.0),
            last_proj_dim=_get(args, "enc_last_proj_dim", 0))
    conv = enc_type.startswith("conv_")
    core = enc_type[5:] if conv else enc_type
    uni = core.startswith("uni_") or _get(args, "unidirectional", False)
    if core in ("uni_conformer", "uni_transformer"):
        core = core[4:]
    xformer = core in ("conformer", "transformer")
    if not xformer and core not in ("blstm", "lstm", "bgru", "gru"):
        raise NotImplementedError(
            f"enc_type {enc_type!r} is not ported yet (only the conformer, "
            f"the transformer, the (B)LSTM, TDS and the gated conv), see "
            f"ROADMAP")
    if not xformer:
        return _rnn_encoder(args, core, conv)
    return XformerEncoder(
        input_dim=args.input_dim,
        btype=core,
        d_model=_get(args, "transformer_enc_d_model",
                     _get(args, "transformer_d_model", 256)),
        d_ff=_get(args, "transformer_enc_d_ff",
                  _get(args, "transformer_d_ff", 2048)),
        n_heads=_get(args, "transformer_enc_n_heads",
                     _get(args, "transformer_n_heads", 4)),
        n_layers=_get(args, "enc_n_layers", 12),
        pe_type=_get(args, "transformer_enc_pe_type", "add"),
        clamp_len=_get(args, "transformer_enc_clamp_len", -1),
        # conformer blocks always use swish FFNs (as JAX's build_encoder)
        ffn_activation="swish" if core == "conformer" else
        _get(args, "transformer_ffn_activation", "relu"),
        ffn_bottleneck_dim=_get(args, "transformer_ffn_bottleneck_dim", 0),
        last_proj_dim=_get(args, "enc_last_proj_dim", 0),
        subsample=_subsample_tuple(args),
        subsample_type=_get(args, "subsample_type", "drop"),
        conv_kernel_size=_get(args, "conformer_kernel_size", 15),
        conv_normalization=_get(args, "conformer_normalization",
                                "layer_norm"),
        conv_channels=_get(args, "conv_channels", "") if conv else "",
        conv_kernel_sizes=_get(args, "conv_kernel_sizes", ""),
        conv_strides=_get(args, "conv_strides", ""),
        conv_poolings=_get(args, "conv_poolings", ""),
        conv_frontend_normalization=_conv_norm(args),
        dropout=_get(args, "dropout_enc", 0.1),
        dropout_att=_get(args, "dropout_att", 0.0),
        dropout_layer=_get(args, "dropout_enc_layer", 0.0),
        unidirectional=uni,
        chunk_size_left=_get(args, "lc_chunk_size_left", -1),
        chunk_size_current=_get(args, "lc_chunk_size_current", -1),
        chunk_size_right=_get(args, "lc_chunk_size_right", 0),
        streaming_type=_get(args, "lc_type", "mask"),
        **_taps(args),
    )
