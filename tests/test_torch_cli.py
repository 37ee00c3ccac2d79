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

Then the switch to SGD (``convert_to_sgd_epoch``): both CLIs resume from
the JAX epoch-2 checkpoint for epochs 3 and 4 with the switch at the end
of epoch 3. The epoch-3 and epoch-4 checkpoints hold SGD's empty state
(the JAX one converted) and the same controller (decay stopped, lr
``sgd_lr``); epoch 4's three SGD updates are held to JAX's to 2e-3 of each
leaf's largest change (each side starts from its own epoch-3 weights,
which differ by the Adam tolerance above) plus two f32 spacings at the
updated weight (each side rounds its update into its weights; most
updates are below half a spacing). A run resumed past the switch
fails in both CLIs: JAX's restores SGD's state into the conf's Adam and
fails an assertion of ``restore_like``; the port's raises a ValueError
that says so (ROADMAP C10).

The eval CLIs are held to JAX's in ``test_torch_cli_eval.py``. Compile
times are kept down by a JAX compilation cache in the test's own
temporary directory (the JAX CLIs turn it on; NSP_COMPILE_CACHE points it
there) and by running the JAX model's ``init`` under ``jax.jit``: one
compile instead of one per op, which is most of an epoch's wall here.
"""
import contextlib
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
        # epochs 3 (Adam) and 4 (SGD) from the JAX epoch-2 checkpoint
        jsgd, psgd = str(root / "jax_sgd"), str(root / "port_sgd")
        shutil.copytree(os.path.join(jdir, "ckpt.epoch-2"),
                        os.path.join(jsgd, "ckpt.epoch-2"))
        os.makedirs(psgd)
        for d in (jsgd, psgd):
            for name in ("conf.yml", "history.csv"):
                shutil.copy(os.path.join(jdir, name), d)
        ck2 = _checkpoint(jdir, 2)
        save_checkpoint(psgd, 2, ck2["model"], ck2["optimizer"],
                        ck2["controller"])
        switch = ["--n_epochs", "4", "--convert_to_sgd_epoch", "3"] + data
        jax_train.main(["--config", os.path.join(jsgd, "conf.yml"),
                        "--model_save_dir", jsgd, "--resume",
                        os.path.join(jsgd, "ckpt.epoch-2")] + switch)
        port_train.main(["--config", os.path.join(psgd, "conf.yml"),
                         "--model_save_dir", psgd, "--resume",
                         os.path.join(psgd, "ckpt.epoch-2")] + switch,
                        device="cpu")
        yield dict(corpus=corpus, jdir=jdir, pdir=pdir, ck1=ck1, root=root,
                   jsgd=jsgd, psgd=psgd, data=data)
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


def test_switch_to_sgd_matches_jax(runs):
    for epoch in (3, 4):
        want = _checkpoint(runs["jsgd"], epoch)
        got = load_checkpoint(os.path.join(runs["psgd"], f"ckpt.epoch-{epoch}"))
        assert want["optimizer"] == got["optimizer"] == {"optimizer": "sgd"}
        cw, cg = want["controller"], got["controller"]
        assert cg["decay_type"] == cw["decay_type"] == "no"
        assert cg["lr"] == cw["lr"] == 1e-4
        for k in cw:
            if k not in ("best_value", "topk"):
                assert cg[k] == cw[k], (epoch, k)
        np.testing.assert_allclose([v for v, _ in cg["topk"]],
                                   [v for v, _ in cw["topk"]], rtol=RTOL)
    # epoch 4: three SGD updates, -1e-4 times each clipped gradient
    w3, w4 = (_checkpoint(runs["jsgd"], e)["model"] for e in (3, 4))
    g3, g4 = (load_checkpoint(os.path.join(runs["psgd"], f"ckpt.epoch-{e}"))[
        "model"] for e in (3, 4))
    for name in w4:
        dw, dg = (w4[name] - w3[name]).numpy(), (g4[name] - g3[name]).numpy()
        # each side's update is rounded into its parameter: one f32 spacing
        # at the updated value on either side
        spacing = np.spacing(np.maximum(np.abs(w4[name].numpy()),
                                        np.abs(g4[name].numpy())))
        excess = np.abs(dg - dw) - (2e-3 * float(np.abs(dw).max()) +
                                    2 * spacing)
        i = int(excess.argmax())
        assert excess.flat[i] <= 0, (name, float(dg.flat[i]),
                                     float(dw.flat[i]), float(spacing.flat[i]),
                                     float(np.abs(dw).max()))
        assert float(np.abs(dw).max()) <= 3 * 1e-4 * 5.0 * 1.001, name
    jh = open(os.path.join(runs["jsgd"], "history.csv")).read().splitlines()
    ph = open(os.path.join(runs["psgd"], "history.csv")).read().splitlines()
    assert ph[0] == jh[0] and len(ph) == len(jh) == 5


def test_resume_past_the_switch_fails_as_in_jax(runs):
    """Both CLIs build the conf's optimizer (noam Adam) on --resume, so an
    epoch saved after the switch (SGD's state) cannot be restored."""
    past = ["--n_epochs", "5"] + runs["data"]
    with pytest.raises(AssertionError, match="restored shape"):
        jax_train.main(["--config", os.path.join(runs["jsgd"], "conf.yml"),
                        "--model_save_dir", str(runs["root"] / "jax_past"),
                        "--resume",
                        os.path.join(runs["jsgd"], "ckpt.epoch-4")] + past)
    with pytest.raises(ValueError, match="convert_to_sgd_epoch"):
        port_train.main(["--config", os.path.join(runs["psgd"], "conf.yml"),
                         "--model_save_dir", str(runs["root"] / "port_past"),
                         "--resume",
                         os.path.join(runs["psgd"], "ckpt.epoch-4")] + past,
                        device="cpu")


@pytest.mark.parametrize("flag", ["teacher", "mbr_training", "rsp_prob",
                                  "mtl_per_batch", "profile_n_steps"])
def test_unported_train_cli_options_raise(runs, flag):
    """Each raises; ``mtl_per_batch`` and ``rsp_prob`` are ported, and
    raise as the JAX CLI's assertions do for a sub-task weight with no
    encoder tap and for random state passing without an RNN encoder (this
    conf's encoder is a conformer). ``mbr_training`` is ported and trains:
    one MBR epoch of this conf's LAS decoder (MBR against the JAX CLI:
    tests/test_torch_mbr.py)."""
    c = runs["corpus"]
    extra, err = {
        "mtl_per_batch": (["--sub1_weight", "0.2"], pytest.raises(
            AssertionError, match="enc_n_layers_sub1")),
        "rsp_prob": ([], pytest.raises(AssertionError,
                                       match="RNN encoder")),
        "mbr_training": (["--n_epochs", "1", "--resume", "",
                          "--mbr_nbest", "2", "--mbr_ckpt_interval", "2"],
                         contextlib.nullcontext())}.get(
        flag, ([], pytest.raises(NotImplementedError, match="ROADMAP")))
    save_dir = runs["root"] / f"unported_{flag}"
    with err:
        port_train.main(["--config", os.path.join(runs["pdir"], "conf.yml"),
                         "--train_set", c["train"], "--dev_set", c["dev"],
                         "--dict", c["dict_char"], "--model_save_dir",
                         str(save_dir), f"--{flag}", "1"]
                        + extra, device="cpu")
    if flag == "mbr_training":
        # three batches of 8: a checkpoint after the second, and the epoch's
        assert sorted(d for d in os.listdir(save_dir)
                      if d.startswith("ckpt")) == ["ckpt.epoch-1",
                                                   "ckpt.epoch-1-step-2"]
