"""Port parity: minimum-Bayes-risk (MBR) training, against the JAX package
on the same numpy inputs with the JAX weights converted
(``convert_params``), float32, atol = rtol = 2e-4 (the repo's).

* ``RNNDecoder.sequence_log_prob`` (the teacher-forced sum of the labels'
  and eos's log-probabilities, deterministic) against JAX's for the
  location, triggered (JAX passes T - 1 as every step's trigger: every
  valid frame) and MoChA decoders (hard mode, on perturbed weights so that
  boundaries fire); labels past a row's length (the CLI pads with 3) do
  not score, whatever they are.
* ``Speech2Text.mbr_loss`` in ``eval()`` and every gradient against
  ``jax.value_and_grad`` of the JAX train CLI's ``_mbr_loss`` (encode,
  ``forward_mbr``, plus ``mbr_ce_weight`` times the deterministic loss;
  its six lines are repeated here, the CLI defining it inside ``main``),
  on a given n-best with a one-token hypothesis and the CLI's padding
  (at least 8 labels, then 3 across the batch). For MoChA the hard
  decisions carry no gradient: a leaf JAX leaves at zero is zero here.
* SGD with weight decay, a schedule and accumulation against JAX's
  ``build_optimizer`` (optax), update by update, the port's state carried
  through ``state_dict`` / ``load_state_dict`` mid-cycle.
* One MBR epoch of the port's train CLI against the JAX CLI's on a tiny
  BLSTM-LAS conf (SGD with weight decay, ``mbr_ckpt_interval`` 1), both
  resumed from one JAX checkpoint of epoch 0 (the port's converted by
  ``convert_checkpoint``): the n-best of every utterance (identical), the
  risks, the sub-step checkpoints' names, and the parameters' change over
  the epoch to 2e-3 of each leaf's largest change plus two f32 spacings
  (``test_torch_cli.py``'s SGD rule: each side rounds its updates into its
  own weights). The JAX CLI's ``init`` runs under one ``jax.jit``.
"""
import csv
import functools
import os
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import yaml

import neural_sp_tpu.models.decoders.decoding as jax_decoding
from neural_sp_tpu.bin.asr import train as jax_train
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu.trainers.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint)
from neural_sp_tpu.trainers.lr_scheduler import (
    EpochController as JaxEpochController)
from neural_sp_tpu.trainers.optimizer import (
    build_optimizer as jax_build_optimizer)
from neural_sp_tpu.utils.ci_corpus import make_ci_corpus
from neural_sp_tpu_torch.bin.asr import train as port_train
from neural_sp_tpu_torch.datasets.token_converter.character import (
    load_dict)
from neural_sp_tpu_torch.configs import (librispeech_blstm_las_args,
                                         librispeech_lstm_mocha_args)
from neural_sp_tpu_torch.models.decoders.decoding import Speech2TextSession
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.models.utils import np_pad_lists
from neural_sp_tpu_torch.trainers.checkpoint import (
    load_checkpoint, save_checkpoint)
from neural_sp_tpu_torch.trainers.optimizer import build_optimizer
from neural_sp_tpu_torch.utils.convert_params import (
    convert_checkpoint, convert_params)

ATOL = RTOL = 2e-4
FLOOR = 1e-6
VOCAB = 50
CE_WEIGHT = 0.01


def _tree(params):
    return jax.tree.map(np.asarray, params)


def _leaf_close(got, want, name):
    scale = max(float(np.abs(want).max()), FLOOR)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * scale + FLOOR, err_msg=name)


def small_args(attn_type: str):
    """The LibriSpeech BLSTM-LAS (location, triggered) or LSTM-MoChA with
    the widths cut: one pooling block, 2 (B)LSTM-16 layers, decoder 32,
    attention 16, vocab 50, CTC 0.3; dropout and noise off."""
    mocha = attn_type == "mocha"
    args = vars(librispeech_lstm_mocha_args() if mocha
                else librispeech_blstm_las_args())
    args.update(input_dim=20, conv_channels="4", conv_kernel_sizes="(3,3)",
                conv_poolings="(2,2)", enc_n_units=16, enc_n_layers=2,
                dec_n_units=32, emb_dim=16, dec_bottleneck_dim=32,
                attn_dim=16, vocab=VOCAB, dropout_enc=0.0, dropout_dec=0.0,
                dropout_emb=0.0, ss_prob=0.0)
    if mocha:
        args.update(subsample="1_1", ctc_fc_list="16", mocha_std=0.0,
                    mocha_init_r=-4.0)
    else:
        args.update(attn_type=attn_type)
    return SimpleNamespace(**args)


def batch(seed=0, bs=2, t=40):
    rng = np.random.RandomState(seed)
    xs = rng.randn(bs, t, 20).astype(np.float32)
    xlens = np.array([t, t - 13, t - 23][:bs], np.int32)
    ylens = np.array([5, 3, 2][:bs], np.int32)
    ys = np.full((bs, 5), 3, np.int32)
    for b, u in enumerate(ylens):
        ys[b, :u] = rng.randint(4, VOCAB, u)
    return xs, xlens, ys, ylens


@functools.cache
def models(attn_type: str):
    """JAX's model and the port's on the same weights: JAX's init
    perturbed (for MoChA by 1.0, so that its boundaries fire)."""
    args = small_args(attn_type)
    jm = jax_build(args)
    params = _tree(jax.jit(jm.init)(jax.random.PRNGKey(0), *map(
        jnp.asarray, batch()))["params"])
    rng = np.random.RandomState(5)
    scale = 1.0 if attn_type == "mocha" else 0.5
    params = jax.tree.map(lambda x: x + scale * rng.randn(*x.shape).astype(
        np.float32), params)
    tm = build_speech2text(args, device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    return jm, params, tm.eval()


def nbest(seed=1, bs=2, n=3):
    """A given n-best as the CLI pads it: per utterance np_pad_lists(min_len
    8), then 3 across the batch; hypothesis 0 of row 1 is the one-token
    [eos] the CLI puts for an empty one. Returns (ys [B, N, U], lens
    [B, N], risks [B, N])."""
    rng = np.random.RandomState(seed)
    rows = []
    for b in range(bs):
        hyps = [list(rng.randint(4, VOCAB, rng.randint(1, 11)))
                for _ in range(n)]
        if b == 1:
            hyps[0] = [2]
        rows.append(np_pad_lists(hyps, min_len=8))
    umax = max(y.shape[1] for y, _ in rows)
    ys = np.stack([np.pad(y, ((0, 0), (0, umax - y.shape[1])),
                          constant_values=3) for y, _ in rows])
    lens = np.stack([yl for _, yl in rows])
    risks = rng.randint(0, 6, (bs, n)).astype(np.float32)
    return ys, lens, risks


def jax_encode(jm, params, xs, xlens):
    eouts, _ = jm.apply({"params": params}, jnp.asarray(xs),
                        jnp.asarray(xlens), "ys", method=jm.encode)
    return eouts["ys"]["xs"], eouts["ys"]["xlens"]


@pytest.mark.parametrize("attn_type", ["location", "triggered", "mocha"])
def test_sequence_log_prob_matches_jax(attn_type):
    jm, params, tm = models(attn_type)
    xs, xlens, _, _ = batch(2)
    ys, lens, _ = nbest(3)
    ys, lens = ys.reshape(-1, ys.shape[-1]), lens.reshape(-1)
    ex, el = jax_encode(jm, params, xs, xlens)
    n = ys.shape[0] // xs.shape[0]
    ex, el = jnp.repeat(ex, n, 0), jnp.repeat(el, n, 0)
    want = jax.jit(lambda p, e, l, y, yl: jm.apply(
        {"params": p}, e, l, y, yl,
        method=lambda m, *a: m.dec_fwd.sequence_log_prob(*a)))(
        params, ex, el, jnp.asarray(ys), jnp.asarray(lens))
    e, l = torch.from_numpy(np.asarray(ex)), torch.from_numpy(np.asarray(el))
    with torch.no_grad():
        got = tm.dec_fwd.sequence_log_prob(e, l, torch.from_numpy(ys),
                                           torch.from_numpy(lens))
        # labels past each row's length are never read
        junk = ys.copy()
        for i, u in enumerate(lens):
            junk[i, u:] = np.random.RandomState(i).randint(4, VOCAB,
                                                           len(junk[i, u:]))
        again = tm.dec_fwd.sequence_log_prob(e, l, torch.from_numpy(junk),
                                             torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    assert torch.equal(got, again)
    assert bool((got < 0).all())


def jax_mbr_loss(jm, ce_weight):
    """The JAX train CLI's ``_mbr_loss`` (``bin/asr/train.py:243-252``)."""
    def loss_fn(p, xs, xlens, nbest_ys, nbest_ylens, risks, ys, ylens):
        eouts, _ = jm.apply({"params": p}, xs, xlens, "ys",
                            method=jm.encode)
        ex, el = eouts["ys"]["xs"], eouts["ys"]["xlens"]
        loss_mbr = jm.apply(
            {"params": p}, ex, el, nbest_ys, nbest_ylens, risks,
            method=lambda m, *a: m.dec_fwd.forward_mbr(*a))
        loss_ce, _ = jm.apply({"params": p}, xs, xlens, ys, ylens)
        return loss_mbr + ce_weight * loss_ce
    return loss_fn


@pytest.mark.parametrize("attn_type", ["location", "mocha"])
def test_mbr_loss_and_grads_match_jax(attn_type):
    jm, params, tm = models(attn_type)
    b = batch(4)
    nb = nbest(5)
    args = tuple(map(jnp.asarray, b[:2] + nb + b[2:]))
    want, grads = jax.jit(jax.value_and_grad(jax_mbr_loss(jm, CE_WEIGHT)))(
        params, *args)
    tm.zero_grad(set_to_none=True)
    xs, xlens, ys, ylens = map(torch.from_numpy, b)
    loss, obs = tm.mbr_loss(xs, xlens, *map(torch.from_numpy, nb), ys, ylens,
                            CE_WEIGHT)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=RTOL)
    assert float(obs["loss_mbr"]) > 0 and float(obs["loss_ce"]) > 0
    want_g = convert_params(_tree(grads))
    assert set(want_g) == {n for n, _ in tm.named_parameters()}
    zero = []
    for name, p in tm.named_parameters():
        g = want_g[name].numpy()
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(g)
        _leaf_close(got, g, name)
        if not g.any():
            zero.append(name)
            assert not got.any(), name
    tm.zero_grad(set_to_none=True)
    with pytest.raises(ValueError, match="eval"):
        tm.train().mbr_loss(xs, xlens, *map(torch.from_numpy, nb), ys,
                            ylens, CE_WEIGHT)
    tm.eval()


SCHEDULE = (lambda c: 0.05 / (1.0 + c))


@pytest.mark.parametrize("weight_decay,scheduled,accum", [
    (1e-2, False, 1), (0.0, True, 1), (1e-2, True, 3)])
def test_sgd_with_weight_decay_schedule_and_accumulation_matches_optax(
        weight_decay, scheduled, accum):
    rng = np.random.RandomState(6)
    shapes = [(5, 3), (7,), (2, 2, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    sched = SCHEDULE if scheduled else None
    tx = jax_build_optimizer("sgd", lr=0.05, weight_decay=weight_decay,
                             clip_grad_norm=5.0, schedule=sched,
                             accum_grad_n_steps=accum)
    state = tx.init([jnp.asarray(p) for p in params])
    opt = build_optimizer("sgd", lr=0.05, weight_decay=weight_decay,
                          clip_grad_norm=5.0, schedule=sched,
                          accum_grad_n_steps=accum)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    opt.init(tparams)
    names = [f"p{i}" for i in range(len(shapes))]
    for i, scale in enumerate((3.0, 0.1, 10.0, 0.5, 2.0, 1.0, 4.0)):
        grads = [scale * rng.randn(*s).astype(np.float32) for s in shapes]
        want, state = tx.update([jnp.asarray(g) for g in grads], state,
                                [jnp.asarray(p) for p in params])
        got = opt.update([torch.from_numpy(g) for g in grads])
        emitted = (i + 1) % accum == 0
        assert (got is not None) == emitted
        if emitted:
            for g_, w in zip(got, want):
                np.testing.assert_allclose(g_.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-9)
        else:
            assert not any(np.asarray(w).any() for w in want)
        params = [np.asarray(p + np.asarray(w)) for p, w in zip(params, want)]
        with torch.no_grad():
            for t, g_ in zip(tparams, got or ()):
                t.add_(g_)
        if i == 3:
            # a checkpoint mid-cycle: the state goes on in a fresh optimizer
            sd = opt.state_dict(names)
            opt = build_optimizer("sgd", lr=0.05, weight_decay=weight_decay,
                                  clip_grad_norm=5.0, schedule=sched,
                                  accum_grad_n_steps=accum)
            opt.init(tparams)
            opt.load_state_dict(sd, names)
    if not scheduled and accum == 1:
        assert opt.state_dict(names) == {"optimizer": "sgd"}


# ------------------------------------------------------------ the CLIs
CLI_CONF = dict(
    enc_type="conv_blstm", input_dim=80, conv_channels="4",
    conv_kernel_sizes="(3,3)", conv_poolings="(2,2)", enc_n_units=16,
    enc_n_layers=1, subsample="1", dropout_enc=0.0, dropout_dec=0.0,
    dropout_emb=0.0, dec_type="lstm", dec_n_units=32, dec_n_layers=1,
    emb_dim=16, dec_bottleneck_dim=32, attn_type="location", attn_dim=16,
    attn_conv_width=9, ctc_weight=0.3, lsm_prob=0.0, unit="char",
    batch_size=8, min_n_frames=1, max_n_frames=10000, optimizer="sgd",
    lr=0.1, weight_decay=1e-2, clip_grad_norm=5.0, print_step=1,
    n_epochs=1, eval_start_epoch=1, sort_stop_epoch=100,
    mbr_training=True, mbr_nbest=3, mbr_ce_weight=CE_WEIGHT,
    mbr_ckpt_interval=1)


def _jitted_init(build):
    """The JAX CLI's model builder, its model's ``init`` under
    ``jax.jit``."""
    def wrapped(args):
        model = build(args)
        object.__setattr__(model, "init", jax.jit(model.init))
        return model
    return wrapped


def test_mbr_epoch_of_the_train_cli_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("NSP_COMPILE_CACHE", str(tmp_path / "xla_cache"))
    monkeypatch.setattr(jax_train, "build_speech2text",
                        _jitted_init(jax_train.build_speech2text))
    # one batch of 8: the JAX CLI pads a batch to its device count (8 CPU
    # devices in this suite), and its MBR epoch fails on padded rows (C47)
    corpus = make_ci_corpus(str(tmp_path / "corpus"), n_train=8, n_dev=2,
                            n_test=1, max_words=2, seed=3)
    conf = tmp_path / "conf.yml"
    conf.write_text(yaml.safe_dump(CLI_CONF))
    # the weights both CLIs start from: a JAX checkpoint of epoch 0
    args = SimpleNamespace(**CLI_CONF,
                           vocab=len(load_dict(corpus["dict_char"])))
    jm = jax_build(args)
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 80)), jnp.array([64]),
        jnp.ones((1, 3), jnp.int32), jnp.array([3]))["params"]
    rng = np.random.RandomState(4)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.3 * rng.randn(
        *x.shape).astype(np.float32), _tree(params))
    tx = jax_build_optimizer("sgd", lr=0.1, weight_decay=1e-2)
    controller = JaxEpochController(base_lr=0.1).state_dict()
    j0 = str(tmp_path / "jax0")
    jax_save_checkpoint(j0, 0, params, tx.init(params), controller)
    p0 = str(tmp_path / "port0")
    ck = convert_checkpoint(params, _tree(tx.init(params)), controller)
    save_checkpoint(p0, 0, ck["model"], ck["optimizer"], ck["controller"])

    seen = {"jax": [], "port": []}
    real_j = jax_decoding.Speech2TextSession._beam_one_las
    real_p = Speech2TextSession._beam_one

    def spy_j(self, *a, **kw):
        out = real_j(self, *a, **kw)
        seen["jax"].append(out[1])
        return out

    def spy_p(self, *a, **kw):
        out = real_p(self, *a, **kw)
        seen["port"].append(out[1])
        return out

    monkeypatch.setattr(jax_decoding.Speech2TextSession, "_beam_one_las",
                        spy_j)
    monkeypatch.setattr(Speech2TextSession, "_beam_one", spy_p)
    data = ["--train_set", corpus["train"], "--dev_set", corpus["dev"],
            "--dict", corpus["dict_char"]]
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_train.main(["--config", str(conf), "--model_save_dir", jdir,
                    "--resume", os.path.join(j0, "ckpt.epoch-0")] + data)
    port_train.main(["--config", str(conf), "--model_save_dir", pdir,
                     "--resume", os.path.join(p0, "ckpt.epoch-0")] + data,
                    device="cpu")
    # the n-best of each of the 8 utterances, in the same order
    assert len(seen["port"]) == len(seen["jax"]) == 8
    for got, want in zip(seen["port"], seen["jax"]):
        assert [list(map(int, h)) for h in got] == \
            [list(map(int, h)) for h in want]
    names = sorted(d for d in os.listdir(pdir) if d.startswith("ckpt"))
    assert names == sorted(d for d in os.listdir(jdir)
                           if d.startswith("ckpt")) == \
        ["ckpt.epoch-1", "ckpt.epoch-1-step-1"]
    # the risks reached the loss: the epoch's mean MBR loss (history)
    # agrees
    jh, ph = (list(csv.DictReader(open(os.path.join(d, "history.csv"))))
              for d in (jdir, pdir))
    assert jh[0].keys() == ph[0].keys() and len(jh) == len(ph) == 1
    np.testing.assert_allclose(float(ph[0]["train_loss"]),
                               float(jh[0]["train_loss"]), rtol=RTOL)
    w0 = convert_params(params)
    w1 = load_checkpoint(os.path.join(pdir, "ckpt.epoch-1"))["model"]
    g1 = convert_params(_tree(jax_load_checkpoint(
        os.path.join(jdir, "ckpt.epoch-1"))["params"]))
    step1 = load_checkpoint(os.path.join(pdir, "ckpt.epoch-1-step-1"))
    assert step1["optimizer"] == {"optimizer": "sgd"}
    assert step1["controller"]["epoch"] == 0
    # the epoch's one step: the sub-step checkpoint holds its weights
    assert all(torch.equal(step1["model"][n], w1[n]) for n in w1)
    moved = 0
    for name in w1:
        dw = (w1[name] - w0[name]).numpy()
        dg = (g1[name] - w0[name]).numpy()
        spacing = np.spacing(np.maximum(np.abs(w1[name].numpy()),
                                        np.abs(g1[name].numpy())))
        excess = np.abs(dw - dg) - (2e-3 * float(np.abs(dg).max()) +
                                    2 * spacing)
        assert float(excess.max()) <= 0, name
        moved += bool(np.abs(dg).max() > 0)
    assert moved == len(w1)
