"""Port parity: the ASR train and eval CLIs on four recipe-shaped confs
(a conv_blstm LAS, an LSTM-MoChA, a transformer, a hierarchical MTL
BLSTM-LAS), each against the JAX package's CLIs from the same weights, on
a ``make_ci_corpus`` corpus of 24 train, 8 dev and 4 test utterances.

The module fixture builds only that corpus (the JAX compilation cache in
the test's own temporary directory, as ``test_torch_cli.py``'s); each test
trains its conf from the JAX CLI's initial weights (converted) and holds
the port's losses and hypotheses to JAX's.
"""
import os
import shutil

import numpy as np
import pytest
import torch
import yaml
import jax

from neural_sp_tpu.bin.asr import eval as jax_eval
from neural_sp_tpu.bin.asr import train as jax_train
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu.utils.ci_corpus import make_ci_corpus
from neural_sp_tpu_torch.bin.asr import eval as port_eval
from neural_sp_tpu_torch.bin.asr import train as port_train
from neural_sp_tpu_torch.parallel.mesh import TrainStep
from neural_sp_tpu_torch.trainers.checkpoint import save_checkpoint
from neural_sp_tpu_torch.utils.convert_params import convert_params

from test_torch_cli import RTOL, _checkpoint


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The corpus the four conf tests train on: its root, the corpus and
    the train CLI's data flags."""
    root = tmp_path_factory.mktemp("torch_cli_confs")
    mp = pytest.MonkeyPatch()
    mp.setenv("NSP_COMPILE_CACHE", str(root / "xla_cache"))
    try:
        corpus = make_ci_corpus(str(root / "corpus"), n_train=24, n_dev=8,
                                n_test=4, max_words=3, seed=9)
        data = ["--train_set", corpus["train"], "--dev_set", corpus["dev"],
                "--dict", corpus["dict_char"]]
        yield dict(corpus=corpus, root=root, data=data)
    finally:
        mp.undo()

# a tiny conv_blstm conf: one pooling block, 2 BLSTM-16 layers (concat),
# drop subsampling, Adam; dropout, sampling and SpecAugment off
BLSTM_CONF = dict(
    enc_type="conv_blstm", input_dim=80, conv_channels="4",
    conv_kernel_sizes="(3,3)", conv_poolings="(2,2)", enc_n_units=16,
    enc_n_layers=2, subsample="1_2", dropout_enc=0.0, dropout_dec=0.0,
    dropout_emb=0.0, dec_type="lstm", dec_n_units=32, dec_n_layers=1,
    emb_dim=16, dec_bottleneck_dim=32, attn_type="location", attn_dim=16,
    attn_conv_width=9, ctc_weight=0.3, lsm_prob=0.1, unit="char",
    batch_size=8, min_n_frames=1, max_n_frames=10000, optimizer="adam",
    lr=1e-3, print_step=1, n_epochs=1)


def test_blstm_conf_trains_and_evaluates(runs, monkeypatch):
    """The port's train CLI on a conv_blstm conf for one epoch, from the JAX
    model's weights (converted): its first microbatch's loss is the JAX
    model's on that batch (rtol 2e-4); then the eval CLI decodes the test
    set from its checkpoint. Each CLI turns cuDNN's TF32 off (the conf is
    float32) where the process had it on, PyTorch's default."""
    root, c = runs["root"], runs["corpus"]
    conf = root / "blstm.yml"
    conf.write_text(yaml.safe_dump(BLSTM_CONF))
    built, first = {}, []

    def jax_weights(model, seed):
        jm = jax_build(built["args"])
        xs = np.zeros((2, 32, 80), np.float32)
        params = jax.jit(jm.init)(jax.random.PRNGKey(seed), xs,
                                  np.array([32, 20]),
                                  np.ones((2, 3), np.int32),
                                  np.array([3, 2]))["params"]
        built.update(jm=jm, params=params)
        model.load_state_dict(convert_params(jax.tree.map(np.asarray,
                                                          params)))
        return model

    build = port_train.build_speech2text

    def record_args(args, device=None):
        built["args"] = args
        return build(args, device=device)

    orig_step = TrainStep.__call__

    def record_step(self, xs, xlens, ys, ylens, *a, **kw):
        m = orig_step(self, xs, xlens, ys, ylens, *a, **kw)
        if not first:
            first.append(((xs, xlens, ys, ylens), float(m["loss"])))
        return m

    monkeypatch.setattr(port_train, "init_params", jax_weights)
    monkeypatch.setattr(port_train, "build_speech2text", record_args)
    monkeypatch.setattr(TrainStep, "__call__", record_step)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    exp = str(root / "blstm")
    port_train.main(["--config", str(conf), "--model_save_dir", exp]
                    + runs["data"], device="cpu")
    assert not torch.backends.cudnn.allow_tf32
    batch, loss = first[0]
    want, _ = built["jm"].apply({"params": built["params"]},
                                *(x.numpy() for x in batch),
                                deterministic=True)
    np.testing.assert_allclose(loss, float(want), rtol=RTOL)
    torch.backends.cudnn.allow_tf32 = True
    got = port_eval.main(["--recog_model", exp, "--recog_sets", c["test"],
                          "--recog_beam_width", "2", "--recog_ctc_weight",
                          "0.3", "--recog_dir", str(root / "blstm_eval")],
                         device="cpu")
    assert not torch.backends.cudnn.allow_tf32
    (m,) = got.values()
    assert m["n_utts"] == 4 and m["rtf"] > 0


# a tiny LSTM-MoChA conf: one pooling block, 2 LSTM-16 layers, MoChA chunk
# 4 with the quantity loss; dropout, the energies' noise and SpecAugment off
# (the packages draw different ones, ROADMAP C4); init_r a float (ROADMAP
# C17: the JAX package cannot train an integer one)
MOCHA_CONF = dict(
    enc_type="conv_lstm", input_dim=80, conv_channels="4",
    conv_kernel_sizes="(3,3)", conv_poolings="(2,2)", enc_n_units=16,
    enc_n_layers=2, subsample="1_2", dropout_enc=0.0, dropout_dec=0.0,
    dropout_emb=0.0, dec_type="lstm", dec_n_units=32, dec_n_layers=1,
    emb_dim=16, dec_bottleneck_dim=32, attn_type="mocha", attn_dim=16,
    mocha_chunk_size=4, mocha_init_r=-4.0, mocha_std=0.0,
    mocha_quantity_loss_weight=0.1, ctc_weight=0.3, lsm_prob=0.1,
    unit="char", batch_size=8, min_n_frames=1, max_n_frames=10000,
    optimizer="adam", lr=1e-3, print_step=1, n_epochs=1)


def test_lstm_mocha_conf_trains_and_evaluates(runs, monkeypatch):
    """The JAX and the port train CLIs for one epoch on an LSTM-MoChA conf
    from the same weights (the JAX CLI's initial ones, converted): the
    epoch's train and dev losses in ``history.csv`` (their parts too) agree
    to rtol 2e-4, the dev loss (MoChA in hard mode) to 1e-5. Then both
    eval CLIs decode the test set at beam 2 + CTC 0.3 from the JAX epoch-1
    weights (the port's through ``convert_checkpoint``): the same
    hypotheses."""
    root, c = runs["root"], runs["corpus"]
    conf = root / "mocha.yml"
    conf.write_text(yaml.safe_dump(MOCHA_CONF))
    initial = {}
    jax_build_cli = jax_train.build_speech2text

    def capture_init(args):
        model = jax_build_cli(args)
        init = jax.jit(model.init)      # one compile, as _jitted_init

        def recorded(*a, **kw):
            out = init(*a, **kw)
            # a host copy: the train step donates the params it is given
            initial.setdefault("params", jax.tree.map(np.asarray,
                                                      out["params"]))
            return out
        object.__setattr__(model, "init", recorded)
        return model

    def jax_weights(model, seed):
        model.load_state_dict(convert_params(initial["params"]), strict=True)
        return model

    monkeypatch.setattr(jax_train, "build_speech2text", capture_init)
    monkeypatch.setattr(port_train, "init_params", jax_weights)
    jdir, pdir = str(root / "mocha_jax"), str(root / "mocha_port")
    jax_train.main(["--config", str(conf), "--model_save_dir", jdir]
                   + runs["data"])
    port_train.main(["--config", str(conf), "--model_save_dir", pdir]
                    + runs["data"], device="cpu")
    rows = []
    for d in (jdir, pdir):
        with open(os.path.join(d, "history.csv")) as f:
            head, *body = f.read().splitlines()
        assert len(body) == 1
        rows.append(dict(zip(head.split(","), body[0].split(","))))
    want, got = rows
    keys = [k for k in want if k.startswith(("train_loss", "dev_loss"))]
    assert {"train_loss", "train_loss_quantity", "dev_loss_mean"} <= \
        set(keys) <= set(got)
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=k)
    # the dev loss is the eval() loss, MoChA in hard mode as JAX's
    # deterministic loss: the two agree to 1e-7 here, where the expected
    # alignment of parallel mode lies 1.1e-4 away, inside RTOL
    for k in ("dev_loss_mean", "dev_loss_att"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)

    # decoding from the JAX weights, in both eval CLIs
    edir = str(root / "mocha_port_eval")
    os.makedirs(edir)
    shutil.copy(os.path.join(jdir, "conf.yml"), edir)
    ck = _checkpoint(jdir, 1)
    save_checkpoint(edir, 1, ck["model"], ck["optimizer"], ck["controller"])
    argv = ["--recog_sets", c["test"], "--recog_beam_width", "2",
            "--recog_ctc_weight", "0.3"]
    out = root / "mocha_eval"
    mw = jax_eval.main(["--recog_model", jdir, "--recog_dir",
                        str(out / "jax")] + argv)
    mg = port_eval.main(["--recog_model", edir, "--recog_dir",
                         str(out / "port")] + argv, device="cpu")
    (mw,), (mg,) = mw.values(), mg.values()
    assert mg["n_utts"] == mw["n_utts"] == 4 and mg["wer"] == mw["wer"]
    for name in ("hyp.trn", "ref.trn"):
        assert (out / "port" / "test" / name).read_text() == \
            (out / "jax" / "test" / name).read_text()


# a tiny LibriSpeech-Transformer conf: one pooling block, 2 transformer
# encoder and 2 decoder blocks of d 16, the recipe's "1dconv3L" decoder
# positions (none, ROADMAP C21), CTC 0.3 with fc 16, noam with
# accumulation; dropout and SpecAugment off (ROADMAP C4)
TRANSFORMER_CONF = dict(
    enc_type="conv_transformer", input_dim=80, conv_channels="4",
    conv_kernel_sizes="(3,3)", conv_poolings="(2,2)", enc_n_layers=2,
    transformer_d_model=16, transformer_d_ff=32, transformer_n_heads=4,
    transformer_enc_pe_type="none", dec_type="transformer", dec_n_layers=2,
    transformer_dec_pe_type="1dconv3L", dropout_enc=0.0, dropout_dec=0.0,
    dropout_emb=0.0, ctc_weight=0.3, ctc_fc_list="16", lsm_prob=0.1,
    unit="char", batch_size=8, min_n_frames=1, max_n_frames=10000,
    optimizer="noam", warmup_n_steps=10, accum_grad_n_steps=2,
    print_step=1, n_epochs=1)


def test_transformer_conf_trains_and_evaluates(runs, monkeypatch):
    """The JAX and the port train CLIs for one epoch on a transformer conf
    from the same weights (the JAX CLI's initial ones, converted): the
    epoch's train and dev losses in ``history.csv`` agree to rtol 2e-4.
    Then both eval CLIs decode the test set at beam 2 + CTC 0.3 (the
    transformer beam; hypotheses of at most 0.3 tokens a frame) from the
    JAX epoch-1 weights (the port's through ``convert_checkpoint``): the
    same hypotheses."""
    root, c = runs["root"], runs["corpus"]
    conf = root / "transformer.yml"
    conf.write_text(yaml.safe_dump(TRANSFORMER_CONF))
    initial = {}
    jax_build_cli = jax_train.build_speech2text

    def capture_init(args):
        model = jax_build_cli(args)
        init = jax.jit(model.init)      # one compile, as _jitted_init

        def recorded(*a, **kw):
            out = init(*a, **kw)
            initial.setdefault("params", jax.tree.map(np.asarray,
                                                      out["params"]))
            return out
        object.__setattr__(model, "init", recorded)
        return model

    def jax_weights(model, seed):
        model.load_state_dict(convert_params(initial["params"]), strict=True)
        return model

    monkeypatch.setattr(jax_train, "build_speech2text", capture_init)
    monkeypatch.setattr(port_train, "init_params", jax_weights)
    jdir, pdir = str(root / "xf_jax"), str(root / "xf_port")
    jax_train.main(["--config", str(conf), "--model_save_dir", jdir]
                   + runs["data"])
    port_train.main(["--config", str(conf), "--model_save_dir", pdir]
                    + runs["data"], device="cpu")
    rows = []
    for d in (jdir, pdir):
        with open(os.path.join(d, "history.csv")) as f:
            head, *body = f.read().splitlines()
        assert len(body) == 1
        rows.append(dict(zip(head.split(","), body[0].split(","))))
    want, got = rows
    keys = [k for k in want if k.startswith(("train_loss", "dev_loss"))]
    assert {"train_loss", "train_loss_att", "dev_loss_mean"} <= \
        set(keys) <= set(got)
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=k)

    edir = str(root / "xf_port_eval")
    os.makedirs(edir)
    shutil.copy(os.path.join(jdir, "conf.yml"), edir)
    ck = _checkpoint(jdir, 1)
    save_checkpoint(edir, 1, ck["model"], ck["optimizer"], ck["controller"])
    argv = ["--recog_sets", c["test"], "--recog_beam_width", "2",
            "--recog_ctc_weight", "0.3", "--recog_max_len_ratio", "0.3"]
    out = root / "xf_eval"
    mw = jax_eval.main(["--recog_model", jdir, "--recog_dir",
                        str(out / "jax")] + argv)
    mg = port_eval.main(["--recog_model", edir, "--recog_dir",
                         str(out / "port")] + argv, device="cpu")
    (mw,), (mg,) = mw.values(), mg.values()
    assert mg["n_utts"] == mw["n_utts"] == 4 and mg["wer"] == mw["wer"]
    for name in ("hyp.trn", "ref.trn"):
        assert (out / "port" / "test" / name).read_text() == \
            (out / "jax" / "test" / name).read_text()


# a tiny hierarchical MTL conf (the SWBD BLSTM-LAS's shape): one pooling
# block, 3 BLSTM-16 layers summed, drop subsampling after the second, the
# sub1 tap after the second with a task-specific layer; the main task in
# characters (the corpus' token ids; CTC 0.2 + LAS), sub1 in words (CTC
# 0.2 + a LAS decoder of 24 units from dec_config_sub1); one task per
# batch; dropout and SpecAugment off (ROADMAP C4)
MTL_CONF = dict(
    enc_type="conv_blstm", input_dim=80, conv_channels="4",
    conv_kernel_sizes="(3,3)", conv_poolings="(2,2)", enc_n_units=16,
    enc_n_layers=3, subsample="1_2_1", bidirectional_sum_fwd_bwd=True,
    enc_n_layers_sub1=2, task_specific_layer=True, dropout_enc=0.0,
    dropout_dec=0.0, dropout_emb=0.0, dec_type="lstm", dec_n_units=32,
    dec_n_layers=1, emb_dim=16, dec_bottleneck_dim=32, attn_type="location",
    attn_dim=16, attn_conv_width=9, ctc_weight=0.2, ctc_weight_sub1=0.2,
    sub1_weight=0.4, dec_config_sub1={"dec_n_units": 24}, lsm_prob=0.1,
    unit="char", unit_sub1="word", batch_size=8, min_n_frames=1,
    max_n_frames=10000, optimizer="adam", lr=1e-3, print_step=1, n_epochs=1,
    mtl_per_batch=True)


def test_mtl_conf_trains_and_evaluates(runs, monkeypatch, caplog):
    """The JAX and the port train CLIs for one epoch on the MTL conf with
    ``--dict_sub1`` (words beside the character task) and ``mtl_per_batch``
    from the same weights (the JAX CLI's initial ones, converted): the
    port's tasks rotate main, sub1, main over the epoch's three batches;
    the epoch's train losses in ``history.csv`` (their parts, the sub1 CTC
    and attention losses included) and the main task's dev losses agree to
    rtol 2e-4; the saved conf carries the sub1 vocabulary. The dev loss
    departs (ROADMAP C40): JAX's dev step takes no sub labels, so its sub
    heads read the main task's character ids (past the word vocabulary:
    NaN), where the port's read the dev set's words. Then both eval CLIs
    decode the test
    set (the main task, beam 2 + CTC 0.3) from the JAX epoch-1 weights:
    the same hypotheses."""
    root, c = runs["root"], runs["corpus"]
    conf = root / "mtl.yml"
    conf.write_text(yaml.safe_dump(MTL_CONF))
    initial = {}
    jax_build_cli = jax_train.build_speech2text

    def capture_init(args):
        model = jax_build_cli(args)
        init = jax.jit(model.init)

        def recorded(*a, **kw):
            out = init(*a, **kw)
            initial.setdefault("params", jax.tree.map(np.asarray,
                                                      out["params"]))
            return out
        object.__setattr__(model, "init", recorded)
        return model

    def jax_weights(model, seed):
        model.load_state_dict(convert_params(initial["params"]), strict=True)
        return model

    monkeypatch.setattr(jax_train, "build_speech2text", capture_init)
    monkeypatch.setattr(port_train, "init_params", jax_weights)
    data = ["--train_set", c["train"], "--dev_set", c["dev"], "--dict",
            c["dict_char"], "--dict_sub1", c["dict_word"]]
    jdir, pdir = str(root / "mtl_jax"), str(root / "mtl_port")
    jax_train.main(["--config", str(conf), "--model_save_dir", jdir] + data)
    with caplog.at_level("INFO", logger=port_train.__name__):
        port_train.main(["--config", str(conf), "--model_save_dir", pdir]
                        + data, device="cpu")
    tasks = [r.getMessage() for r in caplog.records
             if ": task " in r.getMessage()]
    assert tasks == ["step 1: task 0", "step 2: task 1", "step 3: task 0"]
    with open(os.path.join(pdir, "conf.yml")) as f:
        saved = yaml.safe_load(f)
    with open(os.path.join(jdir, "conf.yml")) as f:
        assert saved["vocab_sub1"] == yaml.safe_load(f)["vocab_sub1"] > 4
    rows = []
    for d in (jdir, pdir):
        with open(os.path.join(d, "history.csv")) as f:
            head, *body = f.read().splitlines()
        assert len(body) == 1
        rows.append(dict(zip(head.split(","), body[0].split(","))))
    want, got = rows
    keys = [k for k in want if k.startswith(("train_loss", "dev_loss"))]
    assert {"train_loss_ctc_sub1", "train_loss_att_sub1",
            "dev_loss_ctc_sub1", "dev_loss_att_sub1"} <= set(keys) <= \
        set(got)
    c40 = ("dev_loss", "dev_loss_mean", "dev_loss_ctc_sub1",
           "dev_loss_att_sub1")
    for k in keys:
        if k not in c40:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=RTOL, err_msg=k)
    assert np.isnan(float(want["dev_loss_att_sub1"]))
    assert all(np.isfinite(float(got[k])) for k in c40)

    edir = str(root / "mtl_port_eval")
    os.makedirs(edir)
    shutil.copy(os.path.join(jdir, "conf.yml"), edir)
    ck = _checkpoint(jdir, 1)
    save_checkpoint(edir, 1, ck["model"], ck["optimizer"], ck["controller"])
    argv = ["--recog_sets", c["test"], "--recog_beam_width", "2",
            "--recog_ctc_weight", "0.3"]
    out = root / "mtl_eval"
    mw = jax_eval.main(["--recog_model", jdir, "--recog_dir",
                        str(out / "jax")] + argv)
    mg = port_eval.main(["--recog_model", edir, "--recog_dir",
                         str(out / "port")] + argv, device="cpu")
    (mw,), (mg,) = mw.values(), mg.values()
    assert mg["n_utts"] == mw["n_utts"] == 4 and mg["wer"] == mw["wer"]
    for name in ("hyp.trn", "ref.trn"):
        assert (out / "port" / "test" / name).read_text() == \
            (out / "jax" / "test" / name).read_text()
