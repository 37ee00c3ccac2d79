"""Port parity: the ASR train and eval CLIs against the JAX package's, on a
tiny conformer-LAS conf (2 layers, d 32, char unit, CTC fc "16",
ctc_lsm_prob 0.1, lsm_prob 0.1, weight decay 1e-4, noam with accumulation
over 2 microsteps, lr decay from epoch 1; dropout and SpecAugment off, as
the two packages draw different masks, ROADMAP C4) and a
``make_ci_corpus`` corpus of 24 train, 8 dev and 4 test utterances.

The JAX CLI trains epoch 1 and its checkpoint (params, optimizer state,
epoch controller) goes through ``convert_checkpoint``. Then both CLIs
``--resume`` for epoch 2 on the same batches (three microbatches of 8 an
epoch: the accumulator is carried across the checkpoint mid-cycle, and the
controller's decay reaches the step as lr_scale 0.9). After epoch 2 the
port's checkpoint is held to the JAX one with
``test_torch_train_step.py``'s tolerance:

* the Adam moments per leaf to 2e-4 (mu, and the accumulator) / 4e-4 (nu)
  of the leaf's largest value, plus 1e-6 of the largest over all leaves;
* the parameters' change over epoch 2 where it is well defined (the
  element's mu above 1e-3 of its leaf's largest and above the moments'
  floor; not so the attention key biases, whose gradient is zero in exact
  arithmetic) to 1e-3 of the summed step sizes, and elsewhere only the
  bound an update can reach;
* the controller exactly, its dev losses to rtol 2e-4; the counts exactly.

The eval CLIs are held to JAX's in ``test_torch_cli_eval.py``. Compile
times are kept down by a JAX compilation cache in the test's own
temporary directory (the JAX CLIs turn it on; NSP_COMPILE_CACHE points it
there) and by running the JAX model's ``init`` under ``jax.jit``: one
compile instead of one per op, which is most of an epoch's wall here.
"""
import os
import shutil

import numpy as np
import pytest
import torch
import yaml
import jax

from neural_sp_tpu.bin.asr import train as jax_train
from neural_sp_tpu.trainers.checkpoint import (
    load_checkpoint as jax_load_checkpoint)
from neural_sp_tpu.utils.ci_corpus import make_ci_corpus
from neural_sp_tpu_torch.bin.asr import eval as port_eval
from neural_sp_tpu_torch.bin.asr import train as port_train
from neural_sp_tpu_torch.trainers.lr_scheduler import noam_schedule
from neural_sp_tpu_torch.trainers.checkpoint import (
    load_checkpoint, save_checkpoint)
from neural_sp_tpu_torch.utils.convert_params import convert_checkpoint

RTOL = 2e-4

CONF = dict(
    enc_type="conv_conformer", input_dim=80, conv_channels="32_32",
    conv_kernel_sizes="(3,3)_(3,3)", conv_poolings="(1,1)_(2,2)",
    enc_n_layers=2, transformer_d_model=32, transformer_d_ff=64,
    transformer_n_heads=2, transformer_enc_pe_type="relative",
    transformer_enc_clamp_len=10, conformer_kernel_size=15,
    subsample="1_2", subsample_type="max_pool",
    dropout_enc=0.0, dropout_dec=0.0, dropout_emb=0.0, dropout_att=0.0,
    dec_type="lstm", dec_n_units=32, dec_n_layers=1, emb_dim=16,
    dec_bottleneck_dim=32, attn_type="location", attn_dim=16,
    attn_conv_width=9, ctc_weight=0.3, ctc_fc_list="16", ctc_lsm_prob=0.1,
    lsm_prob=0.1, weight_decay=1e-4, unit="char", batch_size=8,
    shuffle_bucket=True, min_n_frames=1, max_n_frames=10000,
    optimizer="noam", warmup_n_steps=10, accum_grad_n_steps=2,
    lr_decay_start_epoch=1, print_step=1, n_epochs=1)


def _checkpoint(jdir, epoch):
    """A JAX checkpoint of the train CLI, converted for the port."""
    ck = jax_load_checkpoint(os.path.join(jdir, f"ckpt.epoch-{epoch}"))
    return convert_checkpoint(jax.tree.map(np.asarray, ck["params"]),
                              jax.tree.map(np.asarray, ck["opt_state"]),
                              ck["controller"])


def _jitted_init(build):
    """The JAX CLI's model builder, its model's ``init`` under ``jax.jit``."""
    def wrapped(args):
        model = build(args)
        # flax modules are frozen dataclasses
        object.__setattr__(model, "init", jax.jit(model.init))
        return model
    return wrapped


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    mp = pytest.MonkeyPatch()
    mp.setenv("NSP_COMPILE_CACHE", str(root / "xla_cache"))
    mp.setattr(jax_train, "build_speech2text",
               _jitted_init(jax_train.build_speech2text))
    try:
        corpus = make_ci_corpus(str(root / "corpus"), n_train=24, n_dev=8,
                                n_test=4, max_words=3, seed=9)
        conf = root / "conf.yml"
        conf.write_text(yaml.safe_dump(CONF))
        data = ["--train_set", corpus["train"], "--dev_set", corpus["dev"],
                "--dict", corpus["dict_char"]]
        jdir, pdir = str(root / "jax"), str(root / "port")
        jax_train.main(["--config", str(conf), "--model_save_dir", jdir]
                       + data)
        os.makedirs(pdir)
        for name in ("conf.yml", "history.csv"):
            shutil.copy(os.path.join(jdir, name), pdir)
        ck1 = _checkpoint(jdir, 1)
        save_checkpoint(pdir, 1, ck1["model"], ck1["optimizer"],
                        ck1["controller"])
        resume = ["--n_epochs", "2"] + data
        jax_train.main(["--config", os.path.join(jdir, "conf.yml"),
                        "--model_save_dir", jdir, "--resume",
                        os.path.join(jdir, "ckpt.epoch-1")] + resume)
        port_train.main(["--config", os.path.join(pdir, "conf.yml"),
                         "--model_save_dir", pdir, "--resume",
                         os.path.join(pdir, "ckpt.epoch-1")] + resume,
                        device="cpu")
        yield dict(corpus=corpus, jdir=jdir, pdir=pdir, ck1=ck1, root=root)
    finally:
        mp.undo()


def test_resumed_epoch_matches_jax(runs):
    want = _checkpoint(runs["jdir"], 2)
    got = load_checkpoint(os.path.join(runs["pdir"], "ckpt.epoch-2"))
    ck1 = runs["ck1"]
    ow, og = want["optimizer"], got["optimizer"]
    # epoch 1 ended mid-cycle; epoch 2 emitted two more updates
    assert (ck1["optimizer"]["count"], ck1["optimizer"]["mini_step"]) == (1, 1)
    assert (og["count"], og["mini_step"]) == (ow["count"], ow["mini_step"]) \
        == (3, 0)
    floor = 1e-6 * max(float(v.abs().max()) for v in ow["mu"].values())
    for key, rel in (("mu", 2e-4), ("acc", 2e-4), ("nu", 4e-4)):
        fl = floor if key != "nu" else 1e-6 * max(
            float(v.abs().max()) for v in ow["nu"].values())
        assert set(og[key]) == set(ow[key])
        for name, w in ow[key].items():
            np.testing.assert_allclose(
                og[key][name].numpy(), w.numpy(), rtol=0,
                atol=rel * float(w.abs().max()) + fl,
                err_msg=f"{key} {name}")
    # the parameters' change over epoch 2: two updates at lr_scale 0.9
    cw, cg = want["controller"], got["controller"]
    sched = noam_schedule(CONF["transformer_d_model"],
                          CONF["warmup_n_steps"], factor=5.0)
    lrs = 0.9 * (sched(1) + sched(2))
    assert set(got["model"]) == set(want["model"])
    for name, w in want["model"].items():
        p1 = ck1["model"][name]
        dw, dg = (w - p1).numpy(), (got["model"][name] - p1).numpy()
        mu = ow["mu"][name].abs().numpy()
        sure = mu > max(1e-3 * mu.max(), floor)
        np.testing.assert_allclose(dg[sure], dw[sure], rtol=0,
                                   atol=1e-3 * lrs, err_msg=name)
        # Adam's step is at most lr (1 - b1) / sqrt(1 - b2) (Kingma & Ba)
        bound = 1.001 * ((1 - 0.9) / (1 - 0.999) ** 0.5 * lrs + 0.9 * 2 *
                         CONF["weight_decay"] * float(p1.abs().max()))
        assert float(np.abs(dg).max()) <= bound, name
    for k in cw:
        if k in ("best_value", "topk"):
            continue
        assert cg[k] == cw[k], k
    np.testing.assert_allclose(cg["best_value"], cw["best_value"], rtol=RTOL)
    assert [e for _, e in cg["topk"]] == [e for _, e in cw["topk"]]
    np.testing.assert_allclose([v for v, _ in cg["topk"]],
                               [v for v, _ in cw["topk"]], rtol=RTOL)
    assert cg["epoch"] == 2 and cg["lr"] == pytest.approx(1e-3 * 0.81)
    # history.csv: the same columns, epoch 1 copied, epoch 2 recomputed
    jh = open(os.path.join(runs["jdir"], "history.csv")).read().splitlines()
    ph = open(os.path.join(runs["pdir"], "history.csv")).read().splitlines()
    assert ph[0] == jh[0] and len(ph) == len(jh) == 3


def test_cli_mains_need_the_card_or_an_explicit_cpu(runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = runs["corpus"]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_train.main(["--config", os.path.join(runs["pdir"], "conf.yml"),
                         "--train_set", c["train"], "--dev_set", c["dev"],
                         "--dict", c["dict_char"], "--model_save_dir",
                         str(runs["root"] / "nocard")])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_eval.main(["--recog_model", runs["pdir"], "--recog_sets",
                        c["test"]])


@pytest.mark.parametrize("flag", ["teacher", "mbr_training", "rsp_prob",
                                  "mtl_per_batch", "convert_to_sgd_epoch"])
def test_unported_train_cli_options_raise(runs, flag):
    c = runs["corpus"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_train.main(["--config", os.path.join(runs["pdir"], "conf.yml"),
                         "--train_set", c["train"], "--dev_set", c["dev"],
                         "--dict", c["dict_char"], "--model_save_dir",
                         str(runs["root"] / "unported"), f"--{flag}", "1"],
                        device="cpu")

