"""build_lm (counterpart of ``neural_sp_tpu/models/lm/build.py``): dispatch
on ``lm_type`` as JAX's ``build_lm`` does: ``lstm`` / ``gru`` (both an LSTM,
as the JAX ``RNNLM``), ``transformer``, ``transformer_xl`` and
``gated_conv`` (its own layers) or the named GCNN presets
``gated_conv_{8,8B,9,13,14,14B}``."""
from __future__ import annotations

from .gated_convlm import GatedConvLM
from .rnnlm import RNNLM
from .transformer_xl import TransformerXL
from .transformerlm import TransformerLM

# the named GCNN stacks (the presets of JAX's build_lm, reference
# gated_convlm.py:49-128): 'channels:kernel[:bottleneck]' tokens
GCNN_PRESETS = {
    "8": "_".join(["900:4"] * 8),
    "8B": "_".join(["512:1"] + ["512:5:128"] * 3 + ["512:5:256"] * 3
                   + ["2048:1:1024"]),
    "9": "_".join(["807:4"] * 7),
    "13": "_".join(["1268:4"] * 13),
    "14": "_".join(["850:6"] * 3 + ["850:1"] + ["850:5"] * 4 + ["850:1"]
                   + ["850:4"] * 3 + ["1024:4", "2048:4"]),
    "14B": "_".join(["512:5"] + ["512:5:128"] * 3 + ["1024:5:512"] * 3
                    + ["2048:5:1024"] * 6 + ["4096:5:1024"]),
}


def _get(args, name, default=None):
    return getattr(args, name, default)


def build_lm(args, device=None):
    """An LM from a reference-style args namespace, on ``device``: the CUDA
    card when it is None (raising without one), the CPU only when asked
    (``device="cpu"``)."""
    lm_type = _get(args, "lm_type", "lstm")
    vocab = args.vocab
    if lm_type in ("lstm", "gru"):
        return RNNLM(
            vocab=vocab,
            n_units=_get(args, "n_units", 1024),
            n_projs=_get(args, "n_projs", 0),
            n_layers=_get(args, "n_layers", 2),
            emb_dim=_get(args, "emb_dim", 1024),
            residual=_get(args, "residual", False),
            use_glu=_get(args, "use_glu", False),
            tie_embedding=_get(args, "tie_embedding", False),
            dropout=_get(args, "dropout_hidden", 0.0),
            dropout_emb=_get(args, "dropout_in", 0.0),
            lsm_prob=_get(args, "lsm_prob", 0.0),
            n_units_null_context=_get(args, "n_units_null_context", 0) or 0,
            device=device)
    if lm_type == "transformer":
        return TransformerLM(
            vocab=vocab,
            d_model=_get(args, "transformer_d_model", 512),
            d_ff=_get(args, "transformer_d_ff", 2048),
            n_heads=_get(args, "transformer_n_heads", 8),
            n_layers=_get(args, "n_layers", 6),
            pe_type=_get(args, "transformer_pe_type", "add"),
            dropout=_get(args, "dropout_hidden", 0.1),
            dropout_att=_get(args, "dropout_att", 0.0),
            dropout_emb=_get(args, "dropout_in", 0.0),
            lsm_prob=_get(args, "lsm_prob", 0.0),
            tie_embedding=_get(args, "tie_embedding", False),
            device=device)
    if lm_type == "transformer_xl":
        return TransformerXL(
            vocab=vocab,
            d_model=_get(args, "transformer_d_model", 512),
            d_ff=_get(args, "transformer_d_ff", 2048),
            n_heads=_get(args, "transformer_n_heads", 8),
            n_layers=_get(args, "n_layers", 6),
            mem_len=_get(args, "mem_len", 128),
            clamp_len=_get(args, "clamp_len", -1),
            dropout=_get(args, "dropout_hidden", 0.1),
            dropout_att=_get(args, "dropout_att", 0.0),
            dropout_emb=_get(args, "dropout_in", 0.0),
            lsm_prob=_get(args, "lsm_prob", 0.0),
            tie_embedding=_get(args, "tie_embedding", False),
            device=device)
    if lm_type.startswith("gated_conv"):
        size = lm_type.replace("gated_conv", "").lstrip("_") or "custom"
        if size == "custom":
            n, k = _get(args, "n_units", 850), _get(args, "kernel_size", 4)
            bn = _get(args, "n_projs", 0)
            tok = f"{n}:{k}:{bn}" if bn else f"{n}:{k}"
            layers = _get(args, "gated_conv_layers",
                          "_".join([tok] * _get(args, "n_layers", 3)))
        else:
            layers = GCNN_PRESETS[size]
        return GatedConvLM(
            vocab=vocab,
            emb_dim=_get(args, "emb_dim", 280),
            layers=layers,
            dropout=_get(args, "dropout_hidden", 0.0),
            dropout_emb=_get(args, "dropout_in", 0.0),
            lsm_prob=_get(args, "lsm_prob", 0.0),
            device=device)
    raise ValueError(f"unknown lm_type: {lm_type}")
