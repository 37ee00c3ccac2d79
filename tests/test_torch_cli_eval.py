"""Port parity: the ASR eval CLI against the JAX package's, on the tiny
conformer-LAS conf of ``test_torch_cli.py`` (CTC fc "16") and a
``make_ci_corpus`` test set of 4 utterances.

A training directory as the JAX train CLI leaves it: ``conf.yml``, three
epochs of seeded random params saved with the JAX package's
``save_checkpoint``, and a ``history.csv`` whose dev losses rank epochs 1
and 2 best (so averaging takes the best two, not the last two). The port
gets the same directory with each checkpoint through
``convert_checkpoint``. Both eval CLIs decode the test set at beam 2 +
CTC 0.3, from the latest epoch and with ``--recog_n_average 2``, and with
an RNNLM from an LM directory (a seeded tiny LM saved by each package's
``save_checkpoint`` beside its ``conf.yml``) for shallow fusion (0.5,
length norm) and second-pass rescoring of a 10-best (0.3): the hypotheses
(``hyp.trn``, ``ref.trn``) are identical and the WER, CER and their S /
I / D counts equal.
"""
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from neural_sp_tpu.bin.args import save_config as jax_save_config
from neural_sp_tpu.bin.asr import eval as jax_eval
from neural_sp_tpu.models.lm.build import build_lm as jax_build_lm
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu.trainers.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint)
from neural_sp_tpu.trainers.optimizer import (
    build_optimizer as jax_build_optimizer)
from neural_sp_tpu.trainers.reporter import Reporter as JaxReporter
from neural_sp_tpu.utils.ci_corpus import make_ci_corpus
from neural_sp_tpu_torch.bin.asr import eval as port_eval
from neural_sp_tpu_torch.datasets.token_converter.character import load_dict
from neural_sp_tpu_torch.trainers.checkpoint import save_checkpoint
from neural_sp_tpu_torch.bin.args import save_config
from neural_sp_tpu_torch.utils.convert_params import (
    convert_checkpoint, convert_params)

from test_torch_cli import CONF

DEV_LOSSES = {1: 2.0, 2: 1.0, 3: 3.0}
LM_CONF = dict(lm_type="lstm", n_units=16, n_layers=2, emb_dim=16,
               tie_embedding=True, residual=True, use_glu=True)


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_eval")
    mp = pytest.MonkeyPatch()
    # the JAX CLIs turn on a compilation cache: keep it in this directory
    mp.setenv("NSP_COMPILE_CACHE", str(root / "xla_cache"))
    corpus = make_ci_corpus(str(root / "corpus"), n_train=4, n_dev=4,
                            n_test=4, max_words=3, seed=9)
    conf = dict(CONF, dict=corpus["dict_char"], input_dim=80,
                vocab=len(load_dict(corpus["dict_char"])))
    jdir, pdir = str(root / "jax"), str(root / "port")
    model = jax_build(SimpleNamespace(**conf))
    init = jax.jit(model.init)
    xs = jnp.zeros((1, 64, 80))
    reporter = JaxReporter(jdir)
    for epoch, loss in DEV_LOSSES.items():
        params = init(jax.random.PRNGKey(epoch), xs, jnp.array([64]),
                      jnp.full((1, 4), 5), jnp.array([4]))["params"]
        jax_save_checkpoint(jdir, epoch, params)
        reporter.epoch_summary(epoch, {"dev_loss_mean": loss})
        save_checkpoint(pdir, epoch, convert_checkpoint(
            jax.tree.map(np.asarray, params))["model"])
    jax_save_config(conf, os.path.join(jdir, "conf.yml"))
    for name in ("conf.yml", "history.csv"):
        shutil.copy(os.path.join(jdir, name), pdir)
    # an LM directory for each package, as its LM train CLI leaves one
    lm_conf = dict(LM_CONF, vocab=conf["vocab"])
    ys = jnp.full((1, 4), 5)
    lm_params = jax_build_lm(SimpleNamespace(**lm_conf)).init(
        jax.random.PRNGKey(7), ys, ys)["params"]
    jlm, plm = str(root / "jax_lm"), str(root / "port_lm")
    jax_save_checkpoint(jlm, 1, lm_params)
    jax_save_config(lm_conf, os.path.join(jlm, "conf.yml"))
    save_checkpoint(plm, 1, convert_params(jax.tree.map(np.asarray,
                                                        lm_params)))
    save_config(lm_conf, os.path.join(plm, "conf.yml"))
    yield dict(corpus=corpus, jdir=jdir, pdir=pdir, jlm=jlm, plm=plm,
               root=root, params=params)
    mp.undo()


CASES = {
    "latest": ["--recog_ctc_weight", "0.3"],
    "n_average_2": ["--recog_ctc_weight", "0.3", "--recog_n_average", "2"],
    "lm_fusion_and_second_pass": [
        "--recog_lm_weight", "0.5", "--recog_length_norm", "true",
        "--recog_lm_second_weight", "0.3"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_eval_cli_matches_jax(exp, case):
    argv = ["--recog_sets", exp["corpus"]["test"], "--recog_beam_width",
            "2"] + CASES[case]
    lms = {pkg: ["--recog_lm", exp[f"{pkg}lm"], "--recog_lm_second",
                 exp[f"{pkg}lm"]] if case.startswith("lm") else []
           for pkg in ("j", "p")}
    out = exp["root"] / case
    want = jax_eval.main(["--recog_model", exp["jdir"], "--recog_dir",
                          str(out / "jax")] + argv + lms["j"])
    got = port_eval.main(["--recog_model", exp["pdir"], "--recog_dir",
                          str(out / "port")] + argv + lms["p"],
                         device="cpu")
    (mw,), (mg,) = want.values(), got.values()
    for k in ("wer", "cer", "n_sub", "n_ins", "n_del", "n_utts"):
        assert mg[k] == mw[k], k
    assert mg["n_utts"] == 4 and mg["rtf"] > 0
    for name in ("hyp.trn", "ref.trn"):
        assert (out / "port" / "test" / name).read_text() == \
            (out / "jax" / "test" / name).read_text()
    hyps = (out / "port" / "test" / "hyp.trn").read_text().splitlines()
    assert any(not h.startswith(" (") for h in hyps)  # something decoded


def test_eval_averages_the_best_epochs(exp, tmp_path):
    assert port_eval._best_epochs(exp["pdir"], 2) == [1, 2]
    for epoch in (1, 2, 3):
        (tmp_path / f"ckpt.epoch-{epoch}").touch()
    assert port_eval._best_epochs(str(tmp_path), 2) == [2, 3]  # no history


@pytest.mark.parametrize("k", [1, 2])
def test_convert_checkpoint_reads_live_and_restored_states(exp, k,
                                                           tmp_path):
    """The optax state as the JAX CLI holds it (NamedTuples) and as orbax
    restores it (dicts with sorted fields, None for EmptyState) convert
    alike, and as the parameters; without accumulation (k = 1) the
    accumulator is zeros."""
    params = exp["params"]
    tx = jax_build_optimizer("noam", weight_decay=1e-4, accum_grad_n_steps=k,
                         schedule=lambda c: 1e-3)
    state = tx.init(params)
    rng = np.random.default_rng(k)
    state = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype)
        if x.ndim else x + 1, state)     # counts 1, moments random
    jax_save_checkpoint(str(tmp_path), 1, params, state,
                        {"epoch": 1, "topk": [[1.5, 1]]})
    ck = jax_load_checkpoint(str(tmp_path / "ckpt.epoch-1"))
    live = convert_checkpoint(jax.tree.map(np.asarray, params),
                              jax.tree.map(np.asarray, state))
    restored = convert_checkpoint(jax.tree.map(np.asarray, ck["params"]),
                                  jax.tree.map(np.asarray, ck["opt_state"]),
                                  ck["controller"])
    assert set(live["optimizer"]["mu"]) == set(live["model"])
    for key in ("mu", "nu", "acc"):
        for name, v in live["optimizer"][key].items():
            assert torch.equal(v, restored["optimizer"][key][name]), name
    assert live["optimizer"]["count"] == restored["optimizer"]["count"] == 1
    assert live["optimizer"]["mini_step"] == \
        restored["optimizer"]["mini_step"] == (0 if k == 1 else 1)
    if k == 1:
        assert all(float(v.abs().max()) == 0.0
                   for v in live["optimizer"]["acc"].values())
    assert restored["controller"] == {"epoch": 1, "topk": [(1.5, 1)]}
