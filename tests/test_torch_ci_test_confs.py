"""The ``ci_test`` recipe confs (upstream's own CI) and the WSJ TDS / GLU
confs in the port.

* All 13 ``examples/ci_test/conf/asr`` confs and ``wsj/conf/asr/
  {tds_encoder,glu_encoder}.yaml`` build on the meta device at JAX's
  parameter counts (``jax.eval_shape`` of JAX's model at vocab 10,000
  gave the counts held here; the TDS and GLU encoders' own counts are held
  live in ``test_torch_tds_glu.py``). Ten of the ``ci_test`` confs set
  ``dropout_att`` and five the LAS decoder's projection (``dec_n_projs``
  8).
* The ``ci_test`` BLSTM-LAS conf as written (conv front end, BLSTM,
  projections, scheduled sampling 0.1, every dropout 0.1, attention
  dropout included, CTC 0.3) trains one epoch through the port's train
  CLI on a small ``make_ci_corpus`` corpus, on the CPU (the kernels'
  plain versions), with a finite dev loss (``--eval_start_epoch 1``: the
  conf's 2 would leave epoch 1's at inf, as JAX's CLI does), then the
  port's eval CLI decodes the test set with the checkpoint.
"""
import math
import os
from pathlib import Path

import pytest

from neural_sp_tpu.utils.ci_corpus import make_ci_corpus
from neural_sp_tpu_torch.bin.args import parse_args_train
from neural_sp_tpu_torch.bin.asr import eval as port_eval
from neural_sp_tpu_torch.bin.asr import train as port_train
from neural_sp_tpu_torch.models.speech2text import build_speech2text

ROOT = Path(__file__).resolve().parents[1]
COUNTS = {
    "ci_test/conf/asr/blstm_las.yaml": 537858,
    "ci_test/conf/asr/blstm_las_2mtl.yaml": 1050652,
    "ci_test/conf/asr/blstm_las_2mtl_per_batch.yaml": 1050652,
    "ci_test/conf/asr/blstm_transformer.yaml": 374104,
    "ci_test/conf/asr/conformer.yaml": 301328,
    "ci_test/conf/asr/lc_transformer_mma_ma4H_ca4H_w16_from4L_64_128_64.yaml":
        547016,
    "ci_test/conf/asr/lcblstm_transducer.yaml": 534888,
    "ci_test/conf/asr/lstm_ctc.yaml": 160320,
    "ci_test/conf/asr/tds_las.yaml": 2309330,
    "ci_test/conf/asr/transformer.yaml": 300464,
    "ci_test/conf/asr/transformer_2mtl.yaml": 560648,
    "ci_test/conf/asr/transformer_ctc.yaml": 124152,
    "ci_test/conf/asr/transformer_las.yaml": 459642,
    "wsj/conf/asr/glu_encoder.yaml": 13398254,
    "wsj/conf/asr/tds_encoder.yaml": 31584554,
}


def _conf_args(conf):
    args = parse_args_train(["--config", str(ROOT / "examples" / conf)])
    args.vocab = 10000
    return args


def test_every_ci_test_conf_is_held():
    confs = {str(p.relative_to(ROOT / "examples"))
             for p in (ROOT / "examples" / "ci_test").rglob("*.yaml")
             if "/conf/asr/" in str(p)}
    assert len(confs) == 13 and confs <= set(COUNTS)


@pytest.mark.parametrize("conf", sorted(COUNTS))
def test_conf_builds_at_jax_count(conf):
    args = _conf_args(conf)
    model = build_speech2text(args, device="meta")
    assert sum(p.numel() for p in model.parameters()) == COUNTS[conf]
    if getattr(args, "dec_n_projs", 0) and args.dec_type == "lstm":
        step = model.dec_fwd.step
        assert step.projs[0].out_features == args.dec_n_projs
    if getattr(args, "dropout_att", 0) and args.dec_type == "lstm":
        assert model.dec_fwd.step.drop_att.rate == args.dropout_att


def test_blstm_las_conf_trains_and_evaluates(tmp_path):
    corpus = make_ci_corpus(str(tmp_path / "corpus"), n_train=8, n_dev=4,
                            n_test=2, max_words=3, seed=5)
    exp = str(tmp_path / "exp")
    conf = str(ROOT / "examples" / "ci_test/conf/asr/blstm_las.yaml")
    save = port_train.main(
        ["--config", conf, "--train_set", corpus["train"], "--dev_set",
         corpus["dev"], "--dict", corpus["dict_char"], "--unit", "char",
         "--n_epochs", "1", "--eval_start_epoch", "1", "--model_save_dir",
         exp], device="cpu")
    assert os.path.exists(os.path.join(save, "ckpt.epoch-1"))
    with open(os.path.join(save, "history.csv")) as f:
        head, row = f.read().splitlines()[:2]
    hist = dict(zip(head.split(","), map(float, row.split(","))))
    assert hist["step"] > 0
    for key in ("train_loss", "train_loss_att", "train_loss_ctc",
                "dev_loss_mean"):
        assert math.isfinite(hist[key]), key
    results = port_eval.main(
        ["--recog_model", save, "--recog_sets", corpus["test"],
         "--recog_beam_width", "1", "--recog_max_len_ratio", "0.5"],
        device="cpu")
    assert list(results) == [corpus["test"]]
