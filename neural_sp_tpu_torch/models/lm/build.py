"""build_lm (counterpart of ``neural_sp_tpu/models/lm/build.py``): the
``lstm`` / ``gru`` branch. Both build an LSTM, as the JAX ``RNNLM`` does;
the other LM types raise."""
from __future__ import annotations

from .rnnlm import RNNLM


def _get(args, name, default=None):
    return getattr(args, name, default)


def build_lm(args, device=None) -> RNNLM:
    """An LM from a reference-style args namespace, on ``device``: the CUDA
    card when it is None (raising without one), the CPU only when asked
    (``device="cpu"``)."""
    lm_type = _get(args, "lm_type", "lstm")
    if lm_type not in ("lstm", "gru"):
        raise NotImplementedError(
            f"lm_type {lm_type!r} is not ported yet (only the RNNLM), see "
            f"ROADMAP")
    return RNNLM(
        vocab=args.vocab,
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
