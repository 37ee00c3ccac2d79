"""build_encoder (counterpart of ``neural_sp_tpu/models/encoders/build.py``),
the RNN (lstm / blstm, with or without the conv front end), conformer and
transformer branches, with their unidirectional (``uni_`` types or
``unidirectional``) and latency-controlled (``lc_chunk_size_*``,
``lc_type``) forms, their sub1 / sub2 taps (``enc_n_layers_sub1`` /
``_sub2``, ``task_specific_layer``) and ``dropout_in``. Takes any object
with attribute access and the reference's flag names."""
from __future__ import annotations

from typing import Union

from .rnn import RNNEncoder
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


def build_encoder(args) -> Union[RNNEncoder, XformerEncoder]:
    enc_type = args.enc_type
    conv = enc_type.startswith("conv_")
    core = enc_type[5:] if conv else enc_type
    uni = core.startswith("uni_") or _get(args, "unidirectional", False)
    if core in ("uni_conformer", "uni_transformer"):
        core = core[4:]
    xformer = core in ("conformer", "transformer")
    if not xformer and core not in ("blstm", "lstm", "bgru", "gru"):
        raise NotImplementedError(
            f"enc_type {enc_type!r} is not ported yet (only the conformer, "
            f"the transformer and the (B)LSTM), see ROADMAP")
    # the RNN encoder reads no attention or layer dropout
    for name in ("dropout_att", "dropout_enc_layer") if xformer else ():
        if _get(args, name, 0.0):
            raise NotImplementedError(
                f"{name} > 0 is not ported yet, see ROADMAP")
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
        unidirectional=uni,
        chunk_size_left=_get(args, "lc_chunk_size_left", -1),
        chunk_size_current=_get(args, "lc_chunk_size_current", -1),
        chunk_size_right=_get(args, "lc_chunk_size_right", 0),
        streaming_type=_get(args, "lc_type", "mask"),
        **_taps(args),
    )
