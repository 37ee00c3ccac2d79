"""Config and flags (counterpart of ``neural_sp_tpu/bin/args.py``): a YAML
config, an optional overlay and ``--key value`` overrides, with the
reference's flag names, so a recipe conf drives the port as it drives the
JAX package. Unknown keys are kept. Training saves ``conf.yml`` beside its
checkpoints; evaluation reloads it and overlays the ``recog_*`` flags.

The JAX package's compile cache and preflight (TPU machinery) have no
counterpart here.
"""
from __future__ import annotations

import os
import re
from types import SimpleNamespace

import yaml

_EXP = re.compile(r"^-?\d+(\.\d+)?[eE][+-]?\d+$")


def load_config(path: str) -> dict:
    """YAML 1.1 reads dot-less exponents (``1e-6``, as the recipe confs
    write them) as strings: number-like strings become floats."""
    with open(path) as f:
        conf = yaml.safe_load(f) or {}
    return {k: float(v) if isinstance(v, str) and _EXP.match(v) else v
            for k, v in conf.items()}


def save_config(conf: dict, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(
            {k: v for k, v in conf.items() if not k.startswith("_")}, f,
            default_flow_style=False)


def _parse_value(v: str):
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def parse_cli(argv: list[str], defaults: dict | None = None) -> SimpleNamespace:
    """--config base.yml [--config2 overlay.yml] [--key value ...]; a bare
    flag is True, several values make a list."""
    conf = dict(defaults or {})
    pending: dict = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(f"expected --flag, got {tok}")
        key = tok[2:].replace("-", "_")
        vals = []
        i += 1
        while i < len(argv) and not argv[i].startswith("--"):
            vals.append(_parse_value(argv[i]))
            i += 1
        pending[key] = True if not vals else \
            vals[0] if len(vals) == 1 else vals
    for ckey in ("config", "config2"):
        if ckey in pending:
            conf.update(load_config(str(pending.pop(ckey))))
    conf.update(pending)
    return SimpleNamespace(**conf)


TRAIN_DEFAULTS = dict(
    # data
    unit="wp", batch_size=32, batch_size_type="seq", dynamic_batching=False,
    bucketing="shuffle", min_n_frames=40, max_n_frames=2000,
    sort_stop_epoch=100,
    # model
    enc_type="conv_blstm", dec_type="lstm", input_dim=80,
    ctc_weight=0.0, bwd_weight=0.0, sub1_weight=0.0, sub2_weight=0.0,
    lsm_prob=0.1, ss_prob=0.0,
    # optim
    optimizer="adam", lr=1e-3, weight_decay=1e-6, clip_grad_norm=5.0,
    accum_grad_n_steps=1, n_epochs=25, warmup_n_steps=0,
    lr_factor=5.0, transformer_d_model=256,
    lr_decay_type="always", lr_decay_rate=0.9, lr_decay_start_epoch=10,
    lr_decay_patient_n_epochs=0, early_stop_patient_n_epochs=-1,
    print_step=100, metric="edit_distance",
    # "bfloat16": bf16 compute over float32 masters
    train_dtype="float32",
    # checkpointing
    n_keep_best_checkpoints=5, seed=1, resume="",
)


def parse_args_train(argv: list[str]) -> SimpleNamespace:
    return parse_cli(argv, TRAIN_DEFAULTS)


EVAL_DEFAULTS = dict(
    recog_beam_width=10, recog_max_len_ratio=1.0, recog_min_len_ratio=0.0,
    recog_length_penalty=0.0, recog_length_norm=False,
    recog_coverage_penalty=0.0, recog_coverage_threshold=0.0,
    recog_eos_threshold=1.5, recog_ctc_weight=0.0, recog_lm_weight=0.0,
    recog_ilm_weight=0.0, recog_softmax_smoothing=1.0,
    recog_n_average=1, recog_batch_size=1,
    recog_phone_map="",
)


def parse_args_eval(argv: list[str]) -> SimpleNamespace:
    """The ``recog_*`` flags over the training ``conf.yml`` found beside
    ``--recog_model`` (its keys fill only what the flags leave unset)."""
    args = parse_cli(argv, EVAL_DEFAULTS)
    model_path = getattr(args, "recog_model", None)
    if model_path:
        conf_path = os.path.join(os.path.dirname(model_path), "conf.yml")
        if os.path.exists(conf_path):
            for k, v in load_config(conf_path).items():
                if not hasattr(args, k):
                    setattr(args, k, v)
    return args
