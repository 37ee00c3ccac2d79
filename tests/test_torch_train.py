"""Port parity: the training slice.

* The whole small flagship-shaped model (2 conformer layers, d_model 64,
  LSTM 64, vocab 40, location-attention conv width 201): loss, its parts
  and the gradient of every weight against the JAX ``Speech2Text`` in
  deterministic mode (``jax.grad``; the gradient tree goes through the same
  ``convert_params`` as the weights). Its kernels run their plain versions
  on CPU, their backwards the written-out adjoints.
* The pieces the step's randomness goes through, each on given random
  numbers: the dropout counter hash bit for bit on given key words, and
  SpecAugment applied from the JAX function's own draws.
* The CTC head's options (``ctc_fc_list``, ``ctc_lsm_prob``): the loss
  and every gradient against ``jax.grad``, as above.
* The optimizer against optax (Adam with a Noam schedule, clip by global
  norm, mean accumulation, weight decay), and the options that raise.

Tolerance: float32, atol = rtol = 2e-4 (the repo's); gradients to 2e-4 of
each leaf's largest magnitude, except the self-attention key biases, whose
gradient is zero in exact arithmetic (the softmax's shift invariance) and
so rounding only on both sides: they are held to an absolute 1e-5.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu.ops.dropout import Dropout as JaxDropout
from neural_sp_tpu.ops.dropout import fast_uniform as jax_fast_uniform
from neural_sp_tpu.ops.specaugment import spec_augment
from neural_sp_tpu.trainers.lr_scheduler import noam_schedule as jax_noam
from neural_sp_tpu.trainers.optimizer import (
    build_optimizer as jax_build_optimizer)
import neural_sp_tpu_torch.ops.dropout as port_dropout
from neural_sp_tpu_torch.configs import flagship_args
from neural_sp_tpu_torch.models.speech2text import (
    _NOT_PORTED, build_speech2text)
from neural_sp_tpu_torch.ops.specaugment import SpecAugDraws, apply_masks
from neural_sp_tpu_torch.trainers.lr_scheduler import noam_schedule
from neural_sp_tpu_torch.trainers.optimizer import build_optimizer
from neural_sp_tpu_torch.utils.convert_params import convert_params

ATOL = RTOL = 2e-4
FLOOR = 1e-5


def small_args(**over):
    args = vars(flagship_args(faithful=True))
    args.update(enc_n_layers=2, transformer_d_model=64,
                transformer_d_ff=128, transformer_n_heads=4, dec_n_units=64,
                emb_dim=32, dec_bottleneck_dim=64, attn_dim=32, vocab=40,
                subsample="1_2")
    args.update(over)
    return SimpleNamespace(**args)


def batch(seed=0, bs=3, t=64):
    rng = np.random.RandomState(seed)
    xs = rng.randn(bs, t, 80).astype(np.float32)
    xlens = np.array([t, t - 14, t - 27][:bs], np.int32)
    ylens = np.array([6, 4, 2][:bs], np.int32)
    ys = np.full((bs, 6), 3, np.int32)
    for b, u in enumerate(ylens):
        ys[b, :u] = rng.randint(4, 40, u)
    return xs, xlens, ys, ylens


def assert_grads_close(model, grad_tree):
    want = convert_params(jax.tree.map(np.asarray, grad_tree))
    assert set(want) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        w = want[name].numpy()
        atol = FLOOR if name.endswith(".mha.w_key.bias") else \
            RTOL * float(np.abs(w).max())
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=atol,
                                   err_msg=name)


def test_model_loss_and_grads_match_jax():
    args = small_args()
    xs, xlens, ys, ylens = batch()
    jargs = tuple(map(jnp.asarray, (xs, xlens, ys, ylens)))
    jm = jax_build(args)
    params = jm.init(jax.random.PRNGKey(0), *jargs)["params"]

    def jloss(p):
        return jm.apply({"params": p}, *jargs, deterministic=True)

    (want, jobs), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    # the attention's own key projection is skipped (keys come from
    # RNNDecoder.key_proj), so it has no weight, hence no gradient, in JAX
    assert "w_key" not in grads["dec_fwd"]["step"]["attn"]

    tm = build_speech2text(args, device="cpu")
    tm.load_state_dict(convert_params(jax.tree.map(np.asarray, params)),
                       strict=True)
    tm.eval()
    loss, obs = tm(*map(torch.from_numpy, (xs, xlens, ys, ylens)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=RTOL,
                               atol=0)
    for name in ("loss_ctc", "loss_att", "acc_att", "ppl_att"):
        np.testing.assert_allclose(float(obs[name].detach()),
                                   float(jobs[name]), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    assert_grads_close(tm, grads)


@pytest.mark.parametrize("over", [
    dict(ctc_fc_list="16"), dict(ctc_lsm_prob=0.1),
    dict(ctc_fc_list="24_16", ctc_lsm_prob=0.2)],
    ids=["fc_list", "lsm_prob", "fc_list_and_lsm_prob"])
def test_ctc_head_options_match_jax(over):
    """Loss and every gradient with the CTC head's Linear + ReLU layers
    (``fc0``, ``fc1``) and its label smoothing (K4's nll mixed with the KL
    from uniform over the mean label length), ATOL = RTOL = 2e-4 as above;
    the conformer and the decoder as in the flagship test."""
    args = small_args(**over)
    xs, xlens, ys, ylens = batch(3)
    jargs = tuple(map(jnp.asarray, (xs, xlens, ys, ylens)))
    jm = jax_build(args)
    params = jm.init(jax.random.PRNGKey(1), *jargs)["params"]
    assert ("fc0" in params["ctc"]) == ("ctc_fc_list" in over)

    def jloss(p):
        return jm.apply({"params": p}, *jargs, deterministic=True)

    (want, jobs), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    tm = build_speech2text(args, device="cpu")
    tm.load_state_dict(convert_params(jax.tree.map(np.asarray, params)),
                       strict=True)
    tm.eval()
    loss, obs = tm(*map(torch.from_numpy, (xs, xlens, ys, ylens)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=RTOL,
                               atol=0)
    np.testing.assert_allclose(float(obs["loss_ctc"].detach()),
                               float(jobs["loss_ctc"]), rtol=RTOL, atol=ATOL)
    assert_grads_close(tm, grads)


@pytest.mark.parametrize("key", [(0, 1), (0x9E3779B9, 0xFFFFFFFF),
                                 (123456789, 987654321)])
def test_dropout_hash_bit_for_bit(key):
    shape = (3, 7, 33)
    want = np.asarray(jax_fast_uniform(jnp.asarray(key, jnp.uint32), shape))
    got = port_dropout.fast_uniform(key, shape).numpy()
    np.testing.assert_array_equal(got, want)


def test_dropout_module_matches_jax(monkeypatch):
    key = (2024, 77)
    x = np.random.RandomState(0).randn(4, 5, 6).astype(np.float32)
    want = JaxDropout(0.3).apply({}, jnp.asarray(x), deterministic=False,
                                 rng=jnp.asarray(key, jnp.uint32))
    monkeypatch.setattr(port_dropout, "key_words", lambda gen: key)
    drop = port_dropout.Dropout(0.3).train()
    np.testing.assert_array_equal(drop(torch.from_numpy(x)).numpy(),
                                  np.asarray(want))
    assert torch.equal(drop.eval()(torch.from_numpy(x)), torch.from_numpy(x))


def _jax_specaug_draws(rng, xlens, dim, F, n_f, T, n_t, p):
    """The draws of ``neural_sp_tpu.ops.specaugment.spec_augment``, made
    with its own keys and formulas."""
    bs = xlens.shape[0]
    keys = jax.random.split(rng, 4)
    f_width = jax.random.randint(keys[0], (bs, n_f, 1), 0, F + 1)
    f_start = (jax.random.uniform(keys[1], (bs, n_f, 1))
               * jnp.maximum(dim - f_width, 1)).astype(jnp.int32)
    max_w = jnp.minimum(jnp.asarray(T), jnp.maximum(
        (p * xlens).astype(jnp.int32), 1))[:, None, None]
    t_width = (jax.random.uniform(keys[2], (bs, n_t, 1))
               * (max_w + 1)).astype(jnp.int32)
    t_start = (jax.random.uniform(keys[3], (bs, n_t, 1))
               * jnp.maximum(xlens[:, None, None] - t_width, 1)
               ).astype(jnp.int32)
    return SpecAugDraws(*(torch.from_numpy(np.array(d)[..., 0]).long()
                          for d in (f_width, f_start, t_width, t_start)))


def test_specaugment_applies_jax_draws():
    xs, xlens, _, _ = batch(1, t=120)
    conf = dict(F=27, n_f=2, T=40, n_t=2, p=1.0)
    rng = jax.random.PRNGKey(5)
    want = spec_augment(rng, jnp.asarray(xs), jnp.asarray(xlens),
                        freq_mask_width=27, n_freq_masks=2,
                        time_mask_width=40, n_time_masks=2, p=1.0)
    draws = _jax_specaug_draws(rng, jnp.asarray(xlens), 80, **conf)
    got = apply_masks(torch.from_numpy(xs), torch.from_numpy(xlens), draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert not np.allclose(got.numpy(), xs)     # something was masked


def test_noam_schedule_matches_and_clamps():
    want = jax_noam(512, 25000, factor=5.0)
    got = noam_schedule(512, 25000, factor=5.0)
    for step in (0, 1, 2, 100, 25000, 80000):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step))),
                                   rtol=1e-6)
    assert got(0) == got(1)


@pytest.mark.parametrize("k,clip", [(1, 5.0), (2, 0.3)])
def test_optimizer_matches_optax(k, clip):
    """Updates of the port's Adam against the JAX package's optax chain on
    the same gradients: Noam lr at the count before its increment (updates
    0 and 1 share lr(1)), eps outside the square root, clipping of the
    accumulated mean (active at 0.3), emits every k-th microstep only."""
    rng = np.random.RandomState(k)
    shapes = [(4, 3), (5,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    sched = dict(d_model=64, warmup_n_steps=3, factor=2.0)
    tx = jax_build_optimizer("noam", clip_grad_norm=clip,
                             schedule=jax_noam(**sched),
                             accum_grad_n_steps=k)
    state = tx.init([jnp.asarray(p) for p in params])
    opt = build_optimizer("noam", clip_grad_norm=clip,
                          schedule=noam_schedule(**sched),
                          accum_grad_n_steps=k)
    opt.init([torch.from_numpy(p) for p in params])
    for step in range(3 * k):
        grads = [rng.randn(*s).astype(np.float32) for s in shapes]
        want, state = tx.update([jnp.asarray(g) for g in grads], state)
        got = opt.update([torch.from_numpy(g) for g in grads])
        if (step + 1) % k:
            assert got is None
            assert all(float(jnp.abs(w).max()) == 0.0 for w in want)
            continue
        for g_, w in zip(got, want):
            # float32; the moments and the clipped mean round differently
            np.testing.assert_allclose(g_.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-7)
    assert opt.count == 3


def test_weight_decay_update_matches_optax():
    """The JAX chain's weight decay (ROADMAP C1): ``add_decayed_weights(
    -weight_decay)`` after Adam, not scaled by the lr, inside the
    accumulator (k = 2, clip active at 0.3); three emitted updates against
    optax with the parameters given, rtol 1e-4 / atol 1e-7 as above, and
    each update's decay term alone against -weight_decay * param."""
    rng = np.random.RandomState(7)
    shapes = [(4, 3), (5,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    wd, k = 1e-2, 2
    kw = dict(clip_grad_norm=0.3, accum_grad_n_steps=k, weight_decay=wd)
    tx = jax_build_optimizer("adam", lr=1e-3, **kw)
    state = tx.init([jnp.asarray(p) for p in params])
    opt = build_optimizer("adam", lr=1e-3, **kw)
    plain = build_optimizer("adam", lr=1e-3, **{**kw, "weight_decay": 0.0})
    opt.init([torch.from_numpy(p) for p in params])
    plain.init([torch.from_numpy(p) for p in params])
    for step in range(3 * k):
        grads = [rng.randn(*s).astype(np.float32) for s in shapes]
        want, state = tx.update([jnp.asarray(g) for g in grads], state,
                                [jnp.asarray(p) for p in params])
        got = opt.update([torch.from_numpy(g) for g in grads])
        base = plain.update([torch.from_numpy(g) for g in grads])
        if (step + 1) % k:
            assert got is None
            continue
        for g_, w, b, p in zip(got, want, base, params):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-7)
            np.testing.assert_allclose((g_ - b).numpy(), -wd * p, rtol=1e-4,
                                       atol=1e-7)
    assert opt.count == 3


# options that raised once and are ported now: each case builds
PORTED = ("sub1_weight", "sub2_weight", "dropout_in", "dropout_enc_layer",
          "dropout_att", "dec_n_projs")


@pytest.mark.parametrize("name", _NOT_PORTED + PORTED + ("zoneout",))
def test_unported_training_options_raise(name):
    if name not in PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_speech2text(small_args(**{name: 0.1}), device="cpu")
        return
    if name == "dec_n_projs":
        # the LAS decoder's projection: the query and the readout read it
        # (tests/test_torch_attention_dropout.py holds it to JAX)
        step = build_speech2text(small_args(dec_n_projs=24),
                                 device="cpu").dec_fwd.step
        assert step.projs[0].weight.shape == (24, 64)
        assert step.attn.w_query.in_features == 24
        assert step.w_gen.in_features == 24 + 64
        return
    # a sub-task weight without its encoder tap builds the sub head, which
    # no loss reads (as JAX's); tests/test_torch_mtl.py holds them to JAX;
    # tests/test_torch_attention_dropout.py and test_torch_encoder_dropout
    # .py hold the attention dropout and LayerDrop to JAX
    model = build_speech2text(small_args(**{name: 0.1}), device="cpu")
    blocks = model.encoder.blocks
    if name == "dropout_in":
        assert model.encoder.drop_in.rate == 0.1
    elif name == "dropout_att":
        assert [b.mha.dropout for b in blocks] == [0.1, 0.1]
        assert model.dec_fwd.step.drop_att.rate == 0.1
    elif name == "dropout_enc_layer":
        # layer l of L at dropout_enc_layer (l + 1) / L, as JAX's
        assert [b.dropout_layer for b in blocks] == [0.05, 0.1]
    else:
        assert getattr(model, f"dec_fwd_{name[:4]}") is not None
        assert model.fwd_weight == pytest.approx(0.6)


@pytest.mark.parametrize("opt", ["adagrad", "adamw"])
def test_unported_optimizers_raise(opt):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_optimizer(opt)


def test_sgd_matches_optax():
    """``build_optimizer("sgd")`` (the JAX CLI's switch: clip, then
    -lr * g) against ``optax.chain(clip_by_global_norm, sgd)`` over three
    updates, the second with a gradient below the clip norm; every call
    emits, and the state is empty. SGD with a schedule, weight decay or
    accumulation builds (``tests/test_torch_mbr.py`` holds it to optax)."""
    rng = np.random.RandomState(4)
    shapes = [(5, 3), (7,), (2, 2, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.sgd(1e-4))
    state = tx.init([jnp.asarray(p) for p in params])
    opt = build_optimizer("sgd", lr=1e-4, clip_grad_norm=5.0)
    opt.init([torch.from_numpy(p) for p in params])
    for scale in (3.0, 0.1, 10.0):
        grads = [scale * rng.randn(*s).astype(np.float32) for s in shapes]
        want, state = tx.update([jnp.asarray(g) for g in grads], state)
        got = opt.update([torch.from_numpy(g) for g in grads])
        for g_, w in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-12)
    assert opt.state_dict([]) == {"optimizer": "sgd"}
    accumulating = build_optimizer("sgd", accum_grad_n_steps=2)
    accumulating.init([torch.from_numpy(p) for p in params])
    assert accumulating.update([torch.from_numpy(p) for p in params]) is None


def test_flagship_training_options_are_honoured():
    model = build_speech2text(small_args(), device="cpu")
    assert model.specaug == dict(freq_mask_width=27, n_freq_masks=2,
                                 time_mask_width=100, n_time_masks=2, p=1.0)
    assert model.encoder.blocks[0].drop.rate == 0.1
    assert model.encoder.blocks[0].ff.drop.rate == 0.1
    assert model.encoder.pos_enc.drop.rate == 0.1
    assert model.dec_fwd.step.drop.rate == 0.1
    assert model.dec_fwd.step.drop_emb.rate == 0.1
    assert model.dec_fwd.lsm_prob == 0.1


def test_train_mode_draws_from_the_generator():
    """In train() mode the loss depends on the generator's seed (dropout,
    SpecAugment) and one seed reproduces it; eval() ignores it."""
    model = build_speech2text(small_args(), device="cpu")
    from neural_sp_tpu_torch.utils.init_params import init_params
    init_params(model, 0)
    args = tuple(map(torch.from_numpy, batch(2)))

    def loss(seed):
        with torch.no_grad():
            return float(model(*args, torch.Generator().manual_seed(seed))[0])

    model.train()
    assert loss(1) == loss(1) != loss(2)
    model.eval()
    assert loss(1) == loss(2)
