"""Port parity: additive and triggered attention in the LAS decoder (the
plain twins of K2 / K3 / K3b's additive instantiations), against the JAX
package on the same numpy inputs with the JAX weights converted
(``convert_params``), float32, atol = rtol = 2e-4 (the repo's).

* One attention step: JAX's ``AttentionMechanism(atype="add")`` with its
  trigger mask (frames t <= trigger) against ``attend_ref`` with no
  location weights and the window as a length, ``min(elens, trigger +
  1)``; a row whose window holds no frame takes uniform weights over all
  T frames in both.
* The triggered LAS decoder in training (dropout 0) on given trigger
  points with the collate's -1 past each row's labels, with scheduled
  sampling (``ss_prob`` 0.5 on pinned rows, the conf's option: pass 1
  steps K2's twin with each step's window, pass 2 K3 / K3b's): the loss
  and the gradient of every weight and of the encoder outputs against
  ``jax.grad`` of JAX's ``RNNDecoder(attn_type="triggered")``.
* ``las_scan_bwd_ref`` with the additive energy, with and without a
  window per step, against autograd of ``las_scan_ref`` in float64.
* A small BLSTM-triggered-attention ``Speech2Text`` with a CTC head: the
  eval loss (the dev loss: the trigger points computed from the CTC head,
  as JAX computes them there) and every gradient against ``jax.grad``;
  greedy tokens over a batch and beam 4 + CTC 0.3 over two utterances
  against the JAX session's (which
  decodes with no window, over every valid frame).
* C44: the recipe's ``attn_type: triggered_attention`` makes JAX's
  attention raise at init; the port reads it as ``triggered``, the model
  JAX builds with ``triggered`` (the same parameters, loss and gradients
  above), and the tedlium conf builds at that model's parameter count.
"""
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import neural_sp_tpu_torch.ops.dropout as port_dropout
from neural_sp_tpu.models.decoders.decoding import (
    DecodeConfig as JaxDecodeConfig, Speech2TextSession as JaxSession)
from neural_sp_tpu.models.decoders.las import RNNDecoder as JaxRNNDecoder
from neural_sp_tpu.models.modules.attention import (
    AttentionMechanism as JaxAttention)
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu.ops.masks import make_pad_mask as jax_pad_mask
from neural_sp_tpu_torch.bin.args import parse_args_train
from neural_sp_tpu_torch.configs import librispeech_blstm_las_args
from neural_sp_tpu_torch.models.decoders.decoding import (
    DecodeConfig, Speech2TextSession)
from neural_sp_tpu_torch.models.decoders.las import RNNDecoder
from neural_sp_tpu_torch.models.modules.attention import AttentionMechanism
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.ops.kernels.las_scan import (las_scan_bwd_ref,
                                                      las_scan_ref)
from neural_sp_tpu_torch.ops.kernels.las_step import attend_ref
from neural_sp_tpu_torch.utils.convert_params import convert_params

ATOL = RTOL = 2e-4
FLOOR = 1e-6
ROOT = Path(__file__).resolve().parents[1]
TRIG_CONF = "tedlium/conf/asr/blstm_triggered_attention.yaml"
VOCAB, ENC, UNITS, EMB, BOTTLE, ADIM = 30, 24, 20, 12, 16, 10
KW = dict(vocab=VOCAB, enc_n_units=ENC, n_units=UNITS, emb_dim=EMB,
          bottleneck_dim=BOTTLE, attn_dim=ADIM, attn_type="triggered",
          lsm_prob=0.1)
ROWS = np.array([True, False, True])      # the sampled rows (ss_prob > 0)


def _tree(params):
    return jax.tree.map(np.asarray, params)


def _leaf_close(got, want, name):
    scale = max(float(np.abs(want).max()), FLOOR)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * scale + FLOOR, err_msg=name)


# --------------------------------------------------------- one step
def test_additive_attention_step_with_its_window_matches_jax():
    rng = np.random.RandomState(0)
    bs, t = 3, 13
    keys = rng.randn(bs, t, ENC).astype(np.float32)
    query = rng.randn(bs, UNITS).astype(np.float32)
    elens = np.array([13, 6, 1], np.int32)
    # row 2: frame 0 is past its trigger (-1), its only frame: no frame
    # left, uniform weights over all T
    trig = np.array([4, 9, -1], np.int32)
    jatt = JaxAttention(kdim=ENC, qdim=UNITS, adim=ADIM, atype="add")
    mask = jax_pad_mask(jnp.asarray(elens), t)
    args = (jnp.asarray(keys), jnp.asarray(keys), jnp.asarray(query), mask)
    params = jax.jit(jatt.init)(jax.random.PRNGKey(0), *args)["params"]
    params = jax.tree.map(lambda x: np.asarray(x) + 0.2 * rng.randn(
        *x.shape).astype(np.float32), _tree(params))
    ctx, aw = jax.jit(lambda p: jatt.apply(
        {"params": p}, *args, trigger_points=jnp.asarray(trig)))(params)
    port = AttentionMechanism(kdim=ENC, qdim=UNITS, adim=ADIM,
                              atype="triggered")
    state = convert_params(params)
    w_key = state.pop("w_key.weight"), state.pop("w_key.bias")
    port.load_state_dict(state, strict=True)
    w_q, conv_w, w_f, v = port.kernel_weights()
    assert conv_w is None and w_f is None
    kc = torch.from_numpy(keys) @ w_key[0].t() + w_key[1]
    lens = torch.minimum(torch.from_numpy(elens),
                         torch.from_numpy(trig) + 1)
    with torch.no_grad():
        _, aw_t, ctx_t = attend_ref(torch.from_numpy(query), None, w_q,
                                    None, None, v, kc,
                                    torch.from_numpy(keys), lens)
    np.testing.assert_allclose(aw_t.numpy(), np.asarray(aw), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(ctx_t.numpy(), np.asarray(ctx), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(aw_t[2].numpy(), np.full(t, 1.0 / t),
                               atol=1e-7)
    assert float(aw_t[0, 5:].abs().max()) == 0.0


# --------------------------------------------------------- the decoder
def _inputs(seed):
    rng = np.random.RandomState(seed)
    bs, t = 3, 11
    eouts = rng.randn(bs, t, ENC).astype(np.float32)
    elens = np.array([11, 7, 4], np.int32)
    ylens = np.array([5, 3, 2], np.int32)
    ys = np.full((bs, 5), 3, np.int32)
    for i, n in enumerate(ylens):
        ys[i, :n] = rng.randint(4, VOCAB, n)
    # the collate's trigger points: -1 past each row's labels; row 1's
    # last label past its frames (the window then ends at its length)
    tp = np.array([[0, 2, 4, 6, 8], [1, 3, 9, -1, -1], [0, 2, -1, -1, -1]],
                  np.int32)
    return rng, eouts, elens, ys, ylens, tp


def _pin_sampling(monkeypatch, rows, bs, u1):
    """JAX's per-step sampling draw and the port's [B, U+1] one give
    ``rows`` at every step."""
    def fake_jax_bernoulli(key, p=0.5, shape=None):
        assert tuple(shape) == (bs,)
        return jnp.asarray(rows)

    def fake_uniform(key, shape, device=None):
        assert tuple(shape) == (bs, u1), shape
        u = np.broadcast_to(np.where(rows, 0.0, 0.999)[:, None], shape)
        return torch.from_numpy(np.ascontiguousarray(u, np.float32))

    monkeypatch.setattr(jax.random, "bernoulli", fake_jax_bernoulli)
    monkeypatch.setattr(port_dropout, "fast_uniform", fake_uniform)


def test_triggered_las_loss_and_grads_match_jax(monkeypatch):
    """Scheduled sampling on pinned rows: pass 1 on K2's twin with each
    step's window, pass 2 on K3 / K3b's (teacher forced, the same windowed
    scan, in the small model's test below)."""
    ss_prob = 0.5
    rng, eouts, elens, ys, ylens, tp = _inputs(3)
    bs, u1 = eouts.shape[0], ys.shape[1] + 1
    _pin_sampling(monkeypatch, ROWS, bs, u1)
    jdec = JaxRNNDecoder(ss_prob=ss_prob, **KW)
    jargs = tuple(map(jnp.asarray, (eouts, elens, ys, ylens)))
    v = jdec.init(jax.random.PRNGKey(0), *jargs)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.3 * rng.randn(
        *x.shape).astype(np.float32), _tree(v["params"]))

    def jloss(p, e):
        return jdec.apply({"params": p}, e, *jargs[1:], deterministic=False,
                          trigger_points=jnp.asarray(tp),
                          rngs={"dropout": jax.random.PRNGKey(1)})

    (want, _), (g_p, g_e) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jargs[0])
    port = RNNDecoder(ss_prob=ss_prob, **KW)
    port.load_state_dict(convert_params(params), strict=True)
    port.train()
    e_t = torch.from_numpy(eouts).requires_grad_(True)
    loss, _ = port(e_t, torch.from_numpy(elens), torch.from_numpy(ys),
                   torch.from_numpy(ylens), torch.Generator().manual_seed(0),
                   torch.from_numpy(tp))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=RTOL,
                               atol=ATOL)
    _leaf_close(e_t.grad.numpy(), np.asarray(g_e), "eouts")
    grads = convert_params(_tree(g_p))
    for name, p in port.named_parameters():
        _leaf_close(p.grad.numpy(), grads[name].numpy(), name)
    # the window changes the loss: without trigger points it differs
    with torch.no_grad():
        free, _ = port(e_t, torch.from_numpy(elens), torch.from_numpy(ys),
                       torch.from_numpy(ylens),
                       torch.Generator().manual_seed(0))
    assert abs(float(free) - float(want)) > 1e-3


@pytest.mark.parametrize("window", [False, True])
def test_additive_scan_adjoint_matches_autograd(window):
    """``las_scan_bwd_ref`` with no location weights, the lengths [B] or a
    window per step [U, B] (a step whose window is empty, a klen 0 row),
    against autograd of ``las_scan_ref``, float64, 1e-9 of each leaf's
    max; the location gradients are None."""
    gen = torch.Generator().manual_seed(0)
    u, b, t, h, d, a = 5, 3, 11, 6, 7, 5

    def r(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, dtype=torch.float64)

    ins = [x.requires_grad_(True) for x in (
        r(u, b, 4 * h), r(d, 4 * h, scale=0.3), r(h, 4 * h, scale=0.3),
        r(4 * h, scale=0.1), r(a, h, scale=0.3), r(a, scale=0.5),
        r(b, t, a), r(b, t, d))]
    klens = torch.tensor([11, 6, 0], dtype=torch.int32)
    if window:
        trig = torch.tensor([[0, 1, 0], [3, 2, 0], [5, -1, 0], [8, 4, 0],
                             [10, 9, 0]])
        klens = torch.minimum(klens[None], trig + 1).to(torch.int32)
    keep = (torch.rand(u, b, h, generator=gen) < 0.8).double() / 0.8
    eg, w_ctx, w_h, bias, w_q, v, kc, values = ins
    outs = las_scan_ref(eg, w_ctx, w_h, bias, w_q, None, None, v, kc, values,
                        klens, keep)
    dh, dctx = r(u, b, h), r(u, b, d)
    ((outs[0] * dh).sum() + (outs[5] * dctx).sum()).backward()
    got = las_scan_bwd_ref(*(x.detach() for x in (w_ctx, w_h, w_q)), None,
                           None, *(x.detach() for x in (v, kc, values)),
                           klens, keep, *(x.detach() for x in outs), dh, dctx)
    assert got[5] is None and got[6] is None
    for g, x in zip(got[:5] + got[7:], ins):
        scale = float(x.grad.abs().max())
        assert float((g - x.grad).abs().max()) <= 1e-9 * scale


# --------------------------------------------------------- whole models
def small_triggered(attn_type="triggered_attention", **over):
    """The LibriSpeech BLSTM-LAS's shape with the widths cut (one pooling
    block, 2 BLSTM-16 layers, LSTM 32, attention 16, vocab 50, CTC 0.3),
    triggered attention, dropout off."""
    args = vars(librispeech_blstm_las_args())
    args.update(enc_type="conv_blstm", input_dim=20, conv_channels="4",
                conv_kernel_sizes="(3,3)", conv_poolings="(2,2)",
                enc_n_units=16, enc_n_layers=2, dec_n_units=32, emb_dim=16,
                dec_bottleneck_dim=32, attn_dim=16, vocab=50,
                attn_type=attn_type, dropout_enc=0.0, dropout_dec=0.0,
                dropout_emb=0.0, ss_prob=0.0)
    args.update(over)
    return SimpleNamespace(**args)


def las_batch(seed=0, bs=3, t=40):
    rng = np.random.RandomState(seed)
    xs = rng.randn(bs, t, 20).astype(np.float32)
    xlens = np.array([t, t - 11, t - 23][:bs], np.int32)
    ylens = np.array([5, 3, 2][:bs], np.int32)
    ys = np.full((bs, 5), 3, np.int32)
    for b, u in enumerate(ylens):
        ys[b, :u] = rng.randint(4, 50, u)
    return xs, xlens, ys, ylens


@pytest.fixture(scope="module")
def models():
    """JAX's model built with ``triggered`` (its init perturbed so that the
    hypotheses are not empty) and the port's from the recipe's name."""
    jm = jax_build(small_triggered("triggered"))
    params = _tree(jax.jit(jm.init)(jax.random.PRNGKey(0), *map(
        jnp.asarray, las_batch()))["params"])
    rng = np.random.RandomState(5)
    params = jax.tree.map(lambda x: x + rng.randn(*x.shape).astype(
        np.float32), params)
    tm = build_speech2text(small_triggered(), device="cpu")
    assert tm.dec_fwd.attn_type == "triggered"
    tm.load_state_dict(convert_params(params), strict=True)
    return jm, params, tm


def test_small_triggered_model_eval_loss_and_grads_match_jax(models):
    """The dev loss: the CTC head's trigger points bound the decoder's
    attention in eval mode too."""
    jm, params, tm = models
    b = las_batch(1)

    def jloss(p):
        return jm.apply({"params": p}, *map(jnp.asarray, b),
                        deterministic=True)

    (want, jobs), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    tm.eval()
    loss, obs = tm(*map(torch.from_numpy, b))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=RTOL)
    for name in ("loss_ctc", "loss_att", "acc_att"):
        np.testing.assert_allclose(float(obs[name].detach()),
                                   float(jobs[name]), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    want_g = convert_params(_tree(grads))
    assert set(want_g) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        _leaf_close(p.grad.numpy(), want_g[name].numpy(), name)
    tm.zero_grad(set_to_none=True)
    ex = tm.encoder(*map(torch.from_numpy, b[:2]))["ys"]
    trig = tm.decoder_triggers(ex["xs"], ex["xlens"],
                               *map(torch.from_numpy, b[2:]))
    assert trig is not None and int(trig.max()) > 0


def test_small_triggered_model_decodes_as_jax(models):
    """Greedy over a batch of 3 and beam 4 + CTC 0.3 over its last two:
    the JAX session's tokens (neither passes a trigger at decode)."""
    jm, params, tm = models
    tm.eval()
    xs, xlens, _, _ = las_batch(6, t=60)
    for conf in (dict(beam_width=1), dict(beam_width=4, ctc_weight=0.3)):
        jsess = JaxSession(jm, params, JaxDecodeConfig(**conf))
        tsess = Speech2TextSession(tm, DecodeConfig(**conf))
        rows = slice(0, 3) if conf["beam_width"] == 1 else slice(1, 3)
        want = jsess.decode(xs[rows], xlens[rows])
        got = tsess.decode(xs[rows], xlens[rows])
        assert got == want, conf
        assert all(len(h) > 0 for h in got), conf
    # the beam's hypotheses end (eos) before the length limit (30)
    assert any(len(h) < 30 for h in got)


def test_c44_jax_refuses_the_recipe_name_and_the_port_reads_triggered():
    """JAX passes ``triggered_attention`` to its attention, which raises;
    the port builds the model JAX builds from ``triggered``, and the
    tedlium conf at that model's parameter count (``jax.eval_shape``)."""
    batch = tuple(map(jnp.asarray, las_batch()))
    with pytest.raises(ValueError, match="triggered_attention"):
        jax.eval_shape(lambda: jax_build(small_triggered()).init(
            jax.random.PRNGKey(0), *batch))
    args = parse_args_train(["--config", str(ROOT / "examples" / TRIG_CONF)])
    args.vocab = 10000
    assert args.attn_type == "triggered_attention"
    model = build_speech2text(args, device="meta")
    assert model.dec_fwd.attn_type == "triggered"
    jm = jax_build(SimpleNamespace(**{**vars(args),
                                      "attn_type": "triggered"}))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 80)), jnp.array([64]),
        jnp.ones((1, 3), jnp.int32), jnp.array([3])))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == want == 53061056
