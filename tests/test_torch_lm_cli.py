"""Port parity: the LM train and eval CLIs, and the ASR eval CLI fused with
a Transformer LM and a Transformer-XL, against the JAX package's.

Training, as ``test_torch_cli.py`` does it for ASR: on a ``make_ci_corpus``
word corpus (40 train, 8 dev, 8 test utterances) the JAX LM train CLI
trains epoch 1 from its conf (dropout on); its checkpoint (params and
controller: the LM CLIs save no optimizer state) goes through
``convert_checkpoint``; then both CLIs ``--resume`` for epoch 2 with
dropout off (the packages draw different masks, ROADMAP C4), each with a
fresh optimizer as the JAX CLI (ROADMAP C36). Two confs: a small
Transformer-XL (noam without ``lr_factor``, C33; the memory carried over
windows and reset each epoch; ``accum_grad_n_steps`` (C34) and
``dropout_layer`` (C35) set and not read, so epoch 2's update is every
window's and dropout-free in both) and a small GCNN (nesterov, weight
decay, "always" decay: lr_scale 0.5 in epoch 2). After epoch 2:

* the parameters' change over epoch 2 to 1e-3 of the summed step sizes
  plus 1e-6 of the leaf's largest value (nesterov: the sum of lr g over
  the windows is bounded by the clip, so the summed step size is lr x
  clip x windows; noam: the sum of the windows' lrs, Adam's step being
  at most a few lr), except where the XL's gradient is zero or all but
  zero in exact arithmetic, so that Adam's first step takes the sign of
  rounding: the attention key biases (a shift of a row's scores), and
  w_pos's columns for the distance features that vary by less than 0.5
  over the distances a window reaches (the low-frequency cosines and
  sines: nearly a shift of a row's scores too); these are held only to
  Adam's bound;
* the controllers equal, their dev PPLs to rtol 2e-4.

Evaluation: both eval CLIs on JAX's epoch-2 weights (the port's through
``convert_params``), the PPL of the test set to rtol 2e-4, and for the
GCNN also with the cache model (``--recog_n_caches``).

Fusion: a char ASR model (``test_torch_cli.py``'s conformer-LAS conf,
seeded JAX weights, converted) decoding two test utterances by both ASR
eval CLIs at beam 2
with ``--recog_lm`` set to a seeded Transformer LM or Transformer-XL
(mem_len 4: the JAX session recompiles its step while the memory grows)
at weight 0.5: the hypotheses are identical.

The JAX CLIs keep their compilation cache in the test's own temporary
directory, and the JAX LM's ``init`` runs under ``jax.jit``.
"""
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml
import jax
import jax.numpy as jnp

from neural_sp_tpu.bin.args import save_config as jax_save_config
from neural_sp_tpu.bin.asr import eval as jax_asr_eval
from neural_sp_tpu.bin.lm import eval as jax_lm_eval
from neural_sp_tpu.bin.lm import train as jax_lm_train
from neural_sp_tpu.models.lm.build import build_lm as jax_build_lm
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu.trainers.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint)
from neural_sp_tpu.utils.ci_corpus import make_ci_corpus
from neural_sp_tpu_torch.bin.args import save_config
from neural_sp_tpu_torch.bin.asr import eval as port_asr_eval
from neural_sp_tpu_torch.bin.lm import eval as port_lm_eval
from neural_sp_tpu_torch.bin.lm import train as port_lm_train
from neural_sp_tpu_torch.datasets.lm import LMDataset
from neural_sp_tpu_torch.datasets.token_converter.character import load_dict
from neural_sp_tpu_torch.models.modules.relative_multihead_attention import (
    rel_distance_table)
from neural_sp_tpu_torch.trainers.checkpoint import (
    load_checkpoint, save_checkpoint)
from neural_sp_tpu_torch.trainers.lr_scheduler import noam_schedule
from neural_sp_tpu_torch.utils.convert_params import (
    convert_checkpoint, convert_params)

from test_torch_cli import CONF as ASR_CONF, _jitted_init

RTOL = 2e-4
# B 5 x bptt 6: the train set's 30 columns and the dev and test sets' 6
# in whole windows, so each JAX CLI compiles its step for fewer shapes
_COMMON = dict(unit="word", batch_size=5, bptt=6, n_epochs=1, print_step=1,
               lsm_prob=0.1, weight_decay=1e-3)
CONFS = {
    "xl": dict(_COMMON, lm_type="transformer_xl", n_layers=2,
               transformer_d_model=32, transformer_d_ff=48,
               transformer_n_heads=2, mem_len=9, tie_embedding=True,
               optimizer="noam", warmup_n_steps=6, lr_factor=10.0,
               accum_grad_n_steps=4, clip_grad_norm=1.0, dropout_in=0.1,
               dropout_hidden=0.3, dropout_att=0.1, dropout_layer=0.1),
    "gcnn": dict(_COMMON, lm_type="gated_conv", emb_dim=16,
                 gated_conv_layers="16:3_24:2:8_24:1", optimizer="nesterov",
                 lr=0.5, clip_grad_norm=0.1, dropout_in=0.2,
                 dropout_hidden=0.2, lr_decay_type="always",
                 lr_decay_rate=0.5, lr_decay_start_epoch=1),
}
NO_DROPOUT = ["--dropout_in", "0.0", "--dropout_hidden", "0.0",
              "--dropout_att", "0.0"]


def _port_dir(jdir, pdir, epoch):
    """The port's directory for JAX's checkpoint of ``epoch``: its
    conf.yml and the checkpoint through ``convert_checkpoint``."""
    ck = jax_load_checkpoint(os.path.join(jdir, f"ckpt.epoch-{epoch}"))
    out = convert_checkpoint(jax.tree.map(np.asarray, ck["params"]), None,
                             ck.get("controller"))
    os.makedirs(pdir, exist_ok=True)
    shutil.copy(os.path.join(jdir, "conf.yml"), pdir)
    save_checkpoint(pdir, epoch, out["model"], None, out.get("controller"))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_lm_cli")
    mp = pytest.MonkeyPatch()
    mp.setenv("NSP_COMPILE_CACHE", str(root / "xla_cache"))
    mp.setattr(jax_lm_train, "build_lm", _jitted_init(jax_lm_train.build_lm))
    try:
        corpus = make_ci_corpus(str(root / "corpus"), n_train=40, n_dev=8,
                                n_test=8, max_words=5, seed=9)
        data = ["--train_set", corpus["train_word"], "--dev_set",
                corpus["dev_word"], "--dict", corpus["dict_word"]]
        out = dict(corpus=corpus, root=root)
        for name, conf in CONFS.items():
            path = root / f"{name}.yml"
            path.write_text(yaml.safe_dump(conf))
            jdir, pdir = str(root / f"jax_{name}"), str(root / f"port_{name}")
            jax_lm_train.main(["--config", str(path), "--model_save_dir",
                               jdir] + data)
            ck1 = _port_dir(jdir, pdir, 1)
            resume = ["--n_epochs", "2"] + NO_DROPOUT + data
            jax_lm_train.main(["--config", os.path.join(jdir, "conf.yml"),
                               "--model_save_dir", jdir, "--resume",
                               os.path.join(jdir, "ckpt.epoch-1")] + resume)
            port_lm_train.main(["--config", os.path.join(pdir, "conf.yml"),
                                "--model_save_dir", pdir, "--resume",
                                os.path.join(pdir, "ckpt.epoch-1")] + resume,
                               device="cpu")
            # the eval CLIs on JAX's epoch-2 weights
            _port_dir(jdir, str(root / f"port_eval_{name}"), 2)
            out[name] = dict(jdir=jdir, pdir=pdir, ck1=ck1)
        yield out
    finally:
        mp.undo()


def _n_windows(corpus, conf):
    return len(LMDataset(corpus["train_word"], corpus["dict_word"],
                         batch_size=conf["batch_size"], bptt=conf["bptt"]))


@pytest.mark.parametrize("name", list(CONFS))
def test_resumed_lm_epoch_matches_jax(runs, name):
    r, conf = runs[name], CONFS[name]
    want = _port_dir(r["jdir"], str(runs["root"] / f"want_{name}"), 2)
    got = load_checkpoint(os.path.join(r["pdir"], "ckpt.epoch-2"))
    assert "optimizer" not in got
    p1 = r["ck1"]["model"]
    n = _n_windows(runs["corpus"], conf)
    if conf["optimizer"] == "noam":
        sched = noam_schedule(conf["transformer_d_model"],
                              conf["warmup_n_steps"])
        steps = sum(sched(i) for i in range(n))
        # Adam's step is at most lr (1 - b1) / sqrt(1 - b2) (Kingma & Ba)
        bound = 1.001 * (1 - 0.9) / (1 - 0.999) ** 0.5 * steps
    else:
        # lr_scale 0.5 after epoch 1's "always" decay; the clipped
        # gradient's norm is at most clip, momentum sums at most 1 / (1 -
        # 0.9) of it
        steps = 0.5 * conf["lr"] * conf["clip_grad_norm"] * n
        bound = 1.001 * steps / (1 - 0.9)
    assert set(got["model"]) == set(want["model"])
    # the XL's position table over the distances a window reaches (Tk <=
    # mem_len + bptt): w_pos's columns for features that are all but
    # constant over them shift a row's scores alike
    varies = np.ptp(rel_distance_table(
        conf.get("mem_len", 0) + conf["bptt"], 32), axis=0) > 0.5
    for key, w in want["model"].items():
        dw = (w - p1[key]).numpy()
        dg = (got["model"][key] - p1[key]).numpy()
        decay = n * conf["weight_decay"] * float(p1[key].abs().max())
        assert float(np.abs(dg).max()) <= bound + decay, key
        if key.endswith("w_key.bias"):
            continue
        if key.endswith("w_pos.weight"):
            dg, dw = dg[:, varies], dw[:, varies]
        np.testing.assert_allclose(
            dg, dw, rtol=0,
            atol=1e-3 * steps + 1e-6 * float(w.abs().max()), err_msg=key)
    cw, cg = want["controller"], got["controller"]
    for k in cw:
        if k not in ("best_value", "topk"):
            assert cg[k] == cw[k], k
    assert cg["epoch"] == 2
    np.testing.assert_allclose(cg["best_value"], cw["best_value"], rtol=RTOL)
    np.testing.assert_allclose([v for v, _ in cg["topk"]],
                               [v for v, _ in cw["topk"]], rtol=RTOL)


@pytest.mark.parametrize("name,caches", [("xl", 0), ("gcnn", 0),
                                         ("gcnn", 6)])
def test_lm_eval_cli_matches_jax(runs, name, caches):
    test = runs["corpus"]["test_word"]
    argv = ["--recog_sets", test, "--recog_n_caches", str(caches)]
    want = jax_lm_eval.main(["--recog_model", runs[name]["jdir"]] + argv)
    got = port_lm_eval.main(
        ["--recog_model", str(runs["root"] / f"port_eval_{name}")] + argv,
        device="cpu")
    assert got[test]["n_tokens"] == want[test]["n_tokens"] > 0
    assert np.isfinite(got[test]["ppl"])
    np.testing.assert_allclose(got[test]["ppl"], want[test]["ppl"],
                               rtol=RTOL)


def test_lm_train_cli_refuses_bf16_and_needs_a_card(runs, monkeypatch):
    c = runs["corpus"]
    argv = ["--config", os.path.join(runs["xl"]["pdir"], "conf.yml"),
            "--train_set", c["train_word"], "--dev_set", c["dev_word"],
            "--dict", c["dict_word"], "--model_save_dir",
            str(runs["root"] / "refused")]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_lm_train.main(argv + ["--train_dtype", "bfloat16"],
                           device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_lm_train.main(argv)


FUSED_LMS = {
    "transformer": dict(lm_type="transformer", n_layers=2,
                        transformer_d_model=32, transformer_d_ff=48,
                        transformer_n_heads=4, tie_embedding=True),
    "transformer_xl": dict(lm_type="transformer_xl", n_layers=2,
                           transformer_d_model=32, transformer_d_ff=48,
                           transformer_n_heads=2, mem_len=4, clamp_len=3),
}


@pytest.fixture(scope="module")
def asr(runs):
    """A char ASR model and the fused LMs, each in a directory per
    package."""
    root, corpus = runs["root"] / "asr", runs["corpus"]
    conf = dict(ASR_CONF, dict=corpus["dict_char"],
                vocab=len(load_dict(corpus["dict_char"])))
    jdir, pdir = str(root / "jax"), str(root / "port")
    params = jax.jit(jax_build(SimpleNamespace(**conf)).init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 64, 80)), jnp.array([64]),
        jnp.full((1, 4), 5), jnp.array([4]))["params"]
    jax_save_checkpoint(jdir, 1, params)
    save_checkpoint(pdir, 1, convert_params(jax.tree.map(np.asarray,
                                                         params)))
    jax_save_config(conf, os.path.join(jdir, "conf.yml"))
    shutil.copy(os.path.join(jdir, "conf.yml"), pdir)
    # two of the test set's utterances: the JAX session compiles its LM
    # step per cache length and its encoder per input length
    rows = open(corpus["test"]).read().splitlines()[:3]
    test = root / "two" / "test.tsv"
    test.parent.mkdir(parents=True)
    test.write_text("\n".join(rows) + "\n")
    out = dict(jdir=jdir, pdir=pdir, root=root, test=str(test))
    ys = jnp.full((1, 4), 5)
    for name, lm_conf in FUSED_LMS.items():
        lm_conf = dict(lm_conf, vocab=conf["vocab"])
        rng = np.random.RandomState(4)
        lm_params = jax.tree.map(
            lambda x: np.asarray(x) + 0.2 * rng.randn(*x.shape).astype(
                np.float32),
            jax.jit(jax_build_lm(SimpleNamespace(**lm_conf)).init)(
                jax.random.PRNGKey(7), ys, ys)["params"])
        jlm, plm = str(root / f"jax_{name}"), str(root / f"port_{name}")
        jax_save_checkpoint(jlm, 1, lm_params)
        jax_save_config(lm_conf, os.path.join(jlm, "conf.yml"))
        save_checkpoint(plm, 1, convert_params(lm_params))
        save_config(lm_conf, os.path.join(plm, "conf.yml"))
        out[name] = (jlm, plm)
    return out


@pytest.mark.parametrize("lm", list(FUSED_LMS))
def test_asr_eval_fused_with_lm_matches_jax(asr, lm):
    argv = ["--recog_sets", asr["test"], "--recog_beam_width", "2",
            "--recog_lm_weight", "0.5", "--recog_max_len_ratio", "0.3"]
    jlm, plm = asr[lm]
    out = asr["root"] / lm
    want = jax_asr_eval.main(["--recog_model", asr["jdir"], "--recog_lm",
                              jlm, "--recog_dir", str(out / "jax")] + argv)
    got = port_asr_eval.main(["--recog_model", asr["pdir"], "--recog_lm",
                              plm, "--recog_dir", str(out / "port")] + argv,
                             device="cpu")
    (mw,), (mg,) = want.values(), got.values()
    for k in ("wer", "cer", "n_sub", "n_ins", "n_del", "n_utts"):
        assert mg[k] == mw[k], k
    hyp = (out / "port" / "test" / "hyp.trn").read_text()
    assert hyp == (out / "jax" / "test" / "hyp.trn").read_text()
    assert any(not h.startswith(" (") for h in hyp.splitlines())


def test_cache_model_is_finite_where_jax_overflows(runs):
    """ROADMAP C37: JAX's cache model exponentiates theta h.h' unshifted,
    and on the XL's hidden states (the residual stream before its last
    norm) that overflows: JAX's PPL is NaN. The port's softmax is shifted
    by its max, equal to JAX's wherever that is finite
    (``test_lm_eval_cli_matches_jax[gcnn-6]``)."""
    test = runs["corpus"]["test_word"]
    argv = ["--recog_sets", test, "--recog_n_caches", "6"]
    want = jax_lm_eval.main(["--recog_model", runs["xl"]["jdir"]] + argv)
    got = port_lm_eval.main(
        ["--recog_model", str(runs["root"] / "port_eval_xl")] + argv,
        device="cpu")
    assert np.isnan(want[test]["ppl"])
    assert np.isfinite(got[test]["ppl"])
