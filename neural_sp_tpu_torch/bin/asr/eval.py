"""ASR evaluation CLI (counterpart of ``neural_sp_tpu/bin/asr/eval.py``):
the model from ``--recog_model`` (a training directory or one of its
``ckpt.epoch-N``), optionally the average of its best epochs
(``--recog_n_average``), an RNNLM for shallow fusion (``--recog_lm``) and
for second-pass and backward rescoring (``--recog_lm_second``,
``--recog_lm_bwd``), then WER / CER and RTF for each ``--recog_sets`` TSV.

Usage:
  python -m neural_sp_tpu_torch.bin.asr.eval --recog_model exp/ \\
      --recog_sets test.tsv --recog_beam_width 10 --recog_ctc_weight 0.3

The model and the LMs run on the CUDA card; ``main(argv, device="cpu")``
runs them on the CPU. Ensembles, streaming, the oracle WER, the WER by
length, forward-backward attention and state carry-over raise
(ROADMAP).
"""
from __future__ import annotations

import csv
import logging
import os
import re
import sys
from types import SimpleNamespace

import torch

from ...datasets.asr.build import build_dataloader
from ...evaluators.asr import eval_unit
from ...models.decoders.decoding import DecodeConfig, Speech2TextSession
from ...models.speech2text import build_speech2text
from ...trainers.checkpoint import (
    average_checkpoints, ckpt_path, latest_epoch, load_checkpoint)
from ..args import load_config, parse_args_eval

logger = logging.getLogger(__name__)

_NOT_PORTED = ("recog_ensemble", "recog_streaming", "recog_block_sync",
               "recog_oracle", "recog_wer_by_length")


def _best_epochs(save_dir: str, n_avg: int) -> list[int]:
    """The ``n_avg`` epochs of lowest dev loss in ``history.csv`` among
    the checkpoints present (the last ``n_avg`` without a history)."""
    avail = [int(m.group(1)) for d in os.listdir(save_dir)
             if (m := re.match(r"ckpt\.epoch-(\d+)$", d))]
    hist = os.path.join(save_dir, "history.csv")
    if os.path.exists(hist):
        with open(hist) as f:
            ranked = sorted(
                (float(r["dev_loss_mean"]), int(r["epoch"]))
                for r in csv.DictReader(f)
                if r.get("dev_loss_mean") and int(r["epoch"]) in avail)
        if ranked:
            return sorted(e for _, e in ranked[:n_avg])
    return sorted(avail)[-n_avg:]


def load_model_for_eval(args, device=None):
    """(model in eval mode, its training args, its directory) from
    ``args.recog_model``, averaged over the best ``args.recog_n_average``
    epochs when that is > 1."""
    model_path = args.recog_model
    is_ckpt = os.path.basename(model_path).startswith("ckpt.")
    save_dir = model_path if os.path.isdir(model_path) and not is_ckpt \
        else os.path.dirname(model_path)
    targs = SimpleNamespace(**load_config(os.path.join(save_dir,
                                                       "conf.yml")))
    model = build_speech2text(targs, device=device)
    n_avg = getattr(args, "recog_n_average", 1)
    last = latest_epoch(save_dir)
    if n_avg > 1 and last is not None:
        epochs = _best_epochs(save_dir, n_avg)
        state = average_checkpoints(save_dir, epochs)
        logger.info("averaged %d checkpoints (metric top-k): %s",
                    len(epochs), epochs)
    else:
        path = model_path if is_ckpt else ckpt_path(save_dir, last)
        state = load_checkpoint(path)["model"]
    model.load_state_dict(state, strict=True)
    return model.eval(), targs, save_dir


def build_lm_session(lm_dir: str, weight: float, device=None):
    """An ``LMSession`` over the latest checkpoint of the LM trained in
    ``lm_dir`` (its ``conf.yml`` beside it); None without a directory or
    at weight 0."""
    if not lm_dir or weight == 0:
        return None
    from ...models.lm.build import build_lm
    from ...models.lm.session import LMSession
    conf = SimpleNamespace(**load_config(os.path.join(lm_dir, "conf.yml")))
    lm = build_lm(conf, device=device)
    state = load_checkpoint(ckpt_path(lm_dir, latest_epoch(lm_dir)))
    lm.load_state_dict(state["model"], strict=True)
    return LMSession(lm.eval())


def decode_config(args) -> DecodeConfig:
    """The ``recog_*`` flags as a DecodeConfig; an n-best of 10 when a
    second-pass or backward LM rescores it."""
    g = lambda name, default: getattr(args, name, default)  # noqa: E731
    return DecodeConfig(
        beam_width=args.recog_beam_width,
        max_len_ratio=args.recog_max_len_ratio,
        min_len_ratio=args.recog_min_len_ratio,
        length_penalty=args.recog_length_penalty,
        length_norm=bool(args.recog_length_norm),
        coverage_penalty=args.recog_coverage_penalty,
        coverage_threshold=args.recog_coverage_threshold,
        eos_threshold=args.recog_eos_threshold,
        ctc_weight=args.recog_ctc_weight,
        lm_weight=args.recog_lm_weight,
        state_carry_over=bool(g("recog_state_carry_over", False)),
        ilm_weight=args.recog_ilm_weight,
        softmax_smoothing=args.recog_softmax_smoothing,
        n_best=max(g("recog_n_best", 1),
                   10 if (g("recog_lm_second", "") or g("recog_lm_bwd", ""))
                   else 1),
        lm_second_weight=g("recog_lm_second_weight", 0.3),
        lm_bwd_weight=g("recog_lm_bwd_weight", 0.3),
        fwd_bwd_attention=bool(g("recog_fwd_bwd_attention", False)),
        device_beam=bool(g("recog_device_beam", False)))


def main(argv=None, device=None) -> dict:
    """Evaluate; returns {tsv: metrics} (``eval_unit``'s dicts). The model
    and the LMs go on ``device``: the CUDA card when it is None."""
    args = parse_args_eval(argv if argv is not None else sys.argv[1:])
    logging.basicConfig(level=logging.INFO)
    for name in _NOT_PORTED:
        if getattr(args, name, None):
            raise NotImplementedError(f"{name} is not ported yet, see ROADMAP")
    # float32 computes in float32: cuDNN's convolutions and LSTMs would take
    # TF32 by PyTorch's default (its cuBLAS matmuls do not)
    torch.backends.cudnn.allow_tf32 = False
    model, targs, save_dir = load_model_for_eval(args, device)
    conf = decode_config(args)
    session = Speech2TextSession(
        model, conf, build_lm_session(getattr(args, "recog_lm", ""),
                                      args.recog_lm_weight, device))
    lm_second = build_lm_session(getattr(args, "recog_lm_second", ""),
                                 conf.lm_second_weight, device)
    lm_bwd = build_lm_session(getattr(args, "recog_lm_bwd", ""),
                              conf.lm_bwd_weight, device)
    if lm_second is not None or lm_bwd is not None:
        session.attach_second_pass_lms(lm_second, lm_bwd)

    results = {}
    sets = args.recog_sets if isinstance(args.recog_sets, list) \
        else [args.recog_sets]
    for tsv in sets:
        loader = build_dataloader(
            tsv, dict_path=getattr(args, "recog_dict", None) or targs.dict,
            unit=targs.unit, wp_model=getattr(targs, "wp_model", None),
            batch_size=args.recog_batch_size, bucketing="sort", is_test=True)
        out_dir = os.path.join(getattr(args, "recog_dir", save_dir),
                               os.path.basename(tsv).replace(".tsv", ""))
        m = eval_unit(session, loader, save_dir=out_dir,
                      phone_map=getattr(args, "recog_phone_map", "") or None)
        logger.info("%s: WER %.2f / CER %.2f (RTF %.4f, %d utts)",
                    tsv, m["wer"], m["cer"], m["rtf"], m["n_utts"])
        results[tsv] = m
    return results


if __name__ == "__main__":
    main()
