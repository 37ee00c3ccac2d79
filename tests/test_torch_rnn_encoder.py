"""Port parity: the RNN encoder family (``models/modules/recurrent.py::
RNNLayer``, ``models/encoders/rnn.py::RNNEncoder``) and whole BLSTM-LAS and
LSTM-LAS models, against the JAX package on the same numpy inputs with the
JAX weights converted (``convert_params``), float32, atol = rtol = 2e-4
(the repo's).

* ``RNNLayer``: uni- and bidirectional, the directions summed and
  concatenated, ragged lengths with a row of length 1 and a batch padded
  past its longest row, with and without an initial carry: the valid
  frames, the final carries, and the gradients of the input and of every
  weight against ``jax.grad``; and the layer (``torch.lstm``) against its
  written-out loop (``forward_ref``), frames past a row's length included.
* ``RNNEncoder``: a conv front end of one pooling block, 3 layers with
  ``subsample`` (1, 2, 1) by ``drop``, ``enc_n_projs`` and
  ``enc_last_proj_dim``, BLSTM bucket-padded and LSTM packed; ``max_pool`` raises (its last
  window of a row reads past the row's edge, where the JAX layer's outputs
  are not zero and the port's are).
* A small BLSTM-LAS and LSTM-LAS ``Speech2Text``: the loss and every
  gradient leaf in eval mode against ``jax.grad``; greedy (a batch) and
  beam 4 + CTC 0.3 (one utterance) tokens against the JAX session's; one accumulated, clipped Adam
  update against JAX's ``make_train_step`` (``test_torch_train_step.py``'s
  rule).
* The recipe confs that use a location-attention LAS over a (B)LSTM
  encoder build on the meta device; the lcblstm confs raise; the
  LibriSpeech conf's parameter count equals the JAX model's (from
  ``jax.eval_shape`` of its init) and ``configs.librispeech_blstm_las_args``
  equals the conf; bf16 compute raises for the RNN encoder.
"""
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from neural_sp_tpu.models.decoders.decoding import (
    DecodeConfig as JaxDecodeConfig, Speech2TextSession as JaxSession)
from neural_sp_tpu.models.encoders.rnn import RNNEncoder as JaxRNNEncoder
from neural_sp_tpu.models.modules.recurrent import RNNLayer as JaxRNNLayer
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu.parallel.mesh import make_train_step as jax_make_step
from neural_sp_tpu.trainers.optimizer import (
    build_optimizer as jax_build_optimizer)
from neural_sp_tpu_torch.bin.args import parse_args_train
from neural_sp_tpu_torch.configs import librispeech_blstm_las_args
from neural_sp_tpu_torch.models.decoders.decoding import (
    DecodeConfig, Speech2TextSession)
from neural_sp_tpu_torch.models.encoders.rnn import RNNEncoder
from neural_sp_tpu_torch.models.modules.recurrent import RNNLayer
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.parallel.mesh import make_train_step
from neural_sp_tpu_torch.trainers.optimizer import build_optimizer
from neural_sp_tpu_torch.utils.convert_params import convert_params
from neural_sp_tpu_torch.utils.init_params import init_params

from test_torch_train_step import _moments

ATOL = RTOL = 2e-4
ROOT = Path(__file__).resolve().parents[1]
# the recipe confs with a (B)LSTM encoder and a location-attention LAS, no
# streaming
CONFS = ("aishell/conf/asr/blstm_las.yaml",
         "csj/conf/asr/las/lstm_las.yaml",
         "csj/conf/asr/las/blstm_las.yaml",
         "swbd/conf/asr/blstm_las.yaml",
         "swbd/conf/asr/blstm_las_fisher_swbd.yaml",
         "tedlium/conf/asr/lstm_las.yaml",
         "tedlium/conf/asr/las/blstm_las_ctc_sync.yaml",
         "tedlium/conf/asr/las/lstm_las.yaml",
         "tedlium/conf/asr/las/blstm_las.yaml",
         "wsj/conf/asr/blstm_las.yaml",
         "ami/conf/asr/blstm_las.yaml",
         "librispeech/conf/asr/blstm_las.yaml",
         "tedlium3/conf/asr/blstm_las.yaml")
LC_CONFS = ("csj/conf/asr/las/lcblstm_las_chunk4040.yaml",
            "tedlium/conf/asr/lcblstm_las_chunk4020.yaml",
            "tedlium/conf/asr/las/lcblstm_las_chunk4040.yaml")
LIBRISPEECH = "librispeech/conf/asr/blstm_las.yaml"


def _tree(params):
    return jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------- the layer
LAYERS = {"uni": dict(bidirectional=False),
          "bi_sum": dict(bidirectional=True, merge="sum"),
          "bi_concat": dict(bidirectional=True, merge="concat")}
IN, H = 12, 16


def _layer(name, seed=0):
    jl = JaxRNNLayer(H, "lstm", **LAYERS[name])
    v = jax.jit(jl.init)(jax.random.PRNGKey(seed), jnp.zeros((2, 5, IN)),
                         jnp.array([5, 3]))
    params = _tree(v["params"])
    tl = RNNLayer(IN, H, "lstm", **LAYERS[name])
    tl.load_state_dict(convert_params(params), strict=True)
    return jl, params, tl


def _carry0(name, bs, rng):
    one = lambda: (rng.randn(bs, H).astype(np.float32),  # noqa: E731
                   rng.randn(bs, H).astype(np.float32))
    return one() if name == "uni" else (one(), one())


@pytest.mark.parametrize("name,with_carry", [
    ("uni", True), ("bi_sum", False), ("bi_concat", False),
    ("bi_concat", True)])
def test_rnn_layer_matches_jax(name, with_carry):
    jl, params, tl = _layer(name)
    rng = np.random.RandomState(1)
    t, xlens = 9, np.array([7, 1, 4, 6])          # padded past the longest
    xs = rng.randn(4, t, IN).astype(np.float32)
    carry = _carry0(name, 4, rng) if with_carry else None
    out_w = rng.randn(4, t, 2 * H if name == "bi_concat" else H).astype(
        np.float32)
    valid = (np.arange(t)[None] < xlens[:, None]).astype(np.float32)
    n_carry = 1 if name == "uni" else 2
    carry_w = [rng.randn(2, 4, H).astype(np.float32) for _ in range(n_carry)]

    def objective(ys, new_carry, conv):
        """A weighted sum of the valid frames and the final carries."""
        cs = [new_carry] if name == "uni" else list(new_carry)
        total = (ys * conv(out_w * valid[..., None])).sum()
        for (c, h), w in zip(cs, carry_w):
            total = total + (c * conv(w[0])).sum() + (h * conv(w[1])).sum()
        return total

    def jloss(p, x):
        jc = None if carry is None else jax.tree.map(jnp.asarray, carry)
        ys, nc = jl.apply({"params": p}, x, jnp.asarray(xlens), jc)
        return objective(ys, nc, jnp.asarray), (ys, nc)

    (_, (jys, jcarry)), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(xs))

    x = torch.from_numpy(xs).requires_grad_()
    tc = None if carry is None else \
        jax.tree.map(torch.from_numpy, carry)
    ys, nc = tl(x, torch.from_numpy(xlens), tc)
    objective(ys, nc, torch.from_numpy).backward()
    for b, n in enumerate(xlens):
        np.testing.assert_allclose(ys[b, :n].detach().numpy(),
                                   np.asarray(jys)[b, :n], atol=ATOL,
                                   rtol=RTOL)
    for got, want in zip(jax.tree.leaves(jax.tree.map(
            lambda z: z.detach().numpy(), nc)), jax.tree.leaves(jcarry)):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL,
                                   rtol=RTOL)
    gx = np.asarray(gx)
    np.testing.assert_allclose(x.grad.numpy(), gx, rtol=0,
                               atol=RTOL * np.abs(gx).max())
    want = convert_params(_tree(gp))
    for pname, p in tl.named_parameters():
        w = want[pname].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=RTOL * np.abs(w).max(),
                                   err_msg=pname)


@pytest.mark.parametrize("name", list(LAYERS))
def test_rnn_layer_matches_its_loop(name):
    """The layer against its plain version, padded frames (zero) and the
    carries included, and the gradients."""
    _, _, tl = _layer(name, seed=2)
    rng = np.random.RandomState(3)
    xs = torch.from_numpy(rng.randn(3, 8, IN).astype(np.float32))
    xlens = torch.tensor([8, 1, 5])
    for lens in (xlens, None):
        got = tl(xs, lens)
        want = tl.forward_ref(xs, lens)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    x1 = xs.clone().requires_grad_()
    x2 = xs.clone().requires_grad_()
    grads = []
    for fn, x in ((tl, x1), (tl.forward_ref, x2)):
        tl.zero_grad()
        ys, _ = fn(x, xlens)
        (ys * torch.linspace(-1, 1, ys.shape[-1])).sum().backward()
        grads.append([x.grad] + [p.grad.clone() for p in tl.parameters()])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


# -------------------------------------------------------------- the encoder
ENC = dict(input_dim=10, n_units=16, n_projs=12, last_proj_dim=20,
           n_layers=3, subsample=(1, 2, 1), subsample_type="drop",
           conv_channels="4", conv_kernel_sizes="(3,3)",
           conv_poolings="(2,2)")


@pytest.mark.parametrize("rnn_type,t,xlens", [
    ("blstm", 48, [33, 20, 1]),           # concatenated, bucket-padded
    ("lstm", 37, [37, 20, 3])])           # packed
def test_rnn_encoder_matches_jax(rnn_type, t, xlens):
    je = JaxRNNEncoder(rnn_type=rnn_type, bidir_sum_fwd_bwd=False, **ENC)
    rng = np.random.RandomState(4)
    xs = rng.randn(3, t, ENC["input_dim"]).astype(np.float32)
    xlens = np.asarray(xlens, np.int32)
    params = _tree(jax.jit(je.init)(jax.random.PRNGKey(0), jnp.asarray(xs),
                                    jnp.asarray(xlens))["params"])
    te = RNNEncoder(rnn_type=rnn_type, **ENC)
    te.load_state_dict(convert_params(params), strict=True)
    assert te.output_dim == je.output_dim == ENC["last_proj_dim"]
    want, _ = jax.jit(je.apply)({"params": params}, jnp.asarray(xs),
                                jnp.asarray(xlens))
    with torch.no_grad():
        got = te.eval()(torch.from_numpy(xs), torch.from_numpy(xlens))
    wl = np.asarray(want["ys"]["xlens"])
    np.testing.assert_array_equal(got["ys"]["xlens"].numpy(), wl)
    assert got["ys"]["xs"].shape == want["ys"]["xs"].shape
    for b, n in enumerate(wl):
        np.testing.assert_allclose(got["ys"]["xs"][b, :n].numpy(),
                                   np.asarray(want["ys"]["xs"])[b, :n],
                                   atol=ATOL, rtol=RTOL)


def test_rnn_encoder_options_that_raise():
    for over in (dict(subsample_type="max_pool"), dict(rnn_type="bgru")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            RNNEncoder(**{**ENC, "rnn_type": "blstm", **over})
    enc = RNNEncoder(**{**ENC, "rnn_type": "blstm"})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        enc(torch.zeros(1, 8, 10), torch.tensor([8]), task="ys_sub1")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        enc(torch.zeros(1, 8, 10, dtype=torch.bfloat16), torch.tensor([8]))


# ------------------------------------------------------------ whole models
def small_las(enc_type, **over):
    """The LibriSpeech BLSTM-LAS with its widths shrunk: one pooling block,
    2 layers of 16 units, LSTM 32, attention 16, vocab 50."""
    args = vars(librispeech_blstm_las_args())
    args.update(enc_type=enc_type, input_dim=20, conv_channels="4",
                conv_kernel_sizes="(3,3)", conv_poolings="(2,2)",
                enc_n_units=16, enc_n_layers=2, dec_n_units=32, emb_dim=16,
                dec_bottleneck_dim=32, attn_dim=16, attn_conv_width=9,
                vocab=50)
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


_INIT = {}   # (enc_type, seed) -> JAX params: the rates change no shape


def _las_models(enc_type, seed=0, **over):
    args = small_las(enc_type, **over)
    jm = jax_build(args)
    if (enc_type, seed) not in _INIT:
        _INIT[enc_type, seed] = jax.jit(jm.init)(
            jax.random.PRNGKey(seed), *map(jnp.asarray, las_batch()))["params"]
    params = _INIT[enc_type, seed]
    tm = build_speech2text(args, device="cpu")
    tm.load_state_dict(convert_params(_tree(params)), strict=True)
    return jm, params, tm


@pytest.mark.parametrize("enc_type", ["conv_blstm", "conv_lstm"])
def test_las_loss_and_grads_match_jax(enc_type):
    jm, params, tm = _las_models(enc_type)
    b = las_batch(1)

    def jloss(p):
        return jm.apply({"params": p}, *map(jnp.asarray, b),
                        deterministic=True)

    (want, jobs), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    loss, obs = tm.eval()(*map(torch.from_numpy, b))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=RTOL)
    for name in ("loss_ctc", "loss_att", "acc_att"):
        np.testing.assert_allclose(float(obs[name].detach()),
                                   float(jobs[name]), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    want_g = convert_params(_tree(grads))
    assert set(want_g) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        w = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=RTOL * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("enc_type", ["conv_blstm", "conv_lstm"])
def test_las_decode_matches_jax(enc_type):
    """Greedy over the batch and beam 4 + CTC 0.3 on one utterance: the JAX
    session's tokens. The weights are perturbed from flax's init (as in
    test_torch_encoder.py) so that the hypotheses are not empty."""
    jm, params, tm = _las_models(enc_type)
    rng = np.random.RandomState(5)
    # scales at which the hypotheses end before the length limit (30)
    scale = {"conv_blstm": 1.0, "conv_lstm": 0.6}[enc_type]
    params = jax.tree.map(lambda x: np.asarray(x) + scale * rng.randn(
        *x.shape).astype(np.float32), _tree(params))
    tm.load_state_dict(convert_params(params), strict=True)
    tm.eval()
    xs, xlens, _, _ = las_batch(6, t=60)
    for conf in (dict(beam_width=1), dict(beam_width=4, ctc_weight=0.3)):
        jsess = JaxSession(jm, params, JaxDecodeConfig(**conf))
        tsess = Speech2TextSession(tm, DecodeConfig(**conf))
        if conf["beam_width"] == 1:
            want = jsess.decode(xs, xlens)
            got = tsess.decode(xs, xlens)
        else:
            want = jsess.decode(xs[:1], xlens[:1])
            got = tsess.decode(xs[:1], xlens[:1])
        assert got == want, conf
        assert any(0 < len(h) < 30 for h in got), conf


@pytest.mark.parametrize("enc_type", ["conv_blstm", "conv_lstm"])
def test_las_accumulated_clipped_update_matches_jax(enc_type):
    """Two microbatches, Adam with k = 2 accumulation and clip 0.5 (active),
    dropout and sampling off: the metrics of each microstep and the update,
    by test_torch_train_step.py's rule."""
    clip, k, lr = 0.5, 2, 1e-3
    jm, params, tm = _las_models(enc_type, dropout_enc=0.0, dropout_dec=0.0,
                                 dropout_emb=0.0, ss_prob=0.0)
    params0 = convert_params(_tree(params))
    tx = jax_build_optimizer("adam", lr=lr, clip_grad_norm=clip,
                             accum_grad_n_steps=k)
    jstep = jax_make_step(jm, tx, donate=False)
    opt_state = tx.init(params)
    step = make_train_step(tm.train(), build_optimizer(
        "adam", lr=lr, clip_grad_norm=clip, accum_grad_n_steps=k))
    for i, b in enumerate((las_batch(10), las_batch(11))):
        params, opt_state, jmet = jstep(params, opt_state,
                                        jax.random.PRNGKey(i),
                                        *map(jnp.asarray, b))
        met = step(*map(torch.from_numpy, b),
                   gen=torch.Generator().manual_seed(i))
        assert met["emitted"] == (i == k - 1)
        for name in ("loss", "loss_ctc", "loss_att", "grad_norm"):
            np.testing.assert_allclose(float(met[name]), float(jmet[name]),
                                       rtol=RTOL, err_msg=name)
    assert float(met["grad_norm"]) > clip
    new = convert_params(_tree(params))
    mu = convert_params(_tree(_moments(opt_state).mu))
    mu_floor = 1e-6 * max(float(m.abs().max()) for m in mu.values())
    state = tm.state_dict()
    n_sure = n_all = 0
    for name, p0 in params0.items():
        want_u = (new[name] - p0).numpy()
        got_u = (state[name] - p0).numpy()
        # Adam's first step is about -lr sign(g): held where the sign is
        # well defined
        m = np.abs(mu[name].numpy())
        sure = (m > 1e-3 * m.max()) & (m > mu_floor)
        np.testing.assert_allclose(got_u[sure], want_u[sure], rtol=0,
                                   atol=1e-3 * lr, err_msg=name)
        assert np.abs(got_u).max() <= lr * (1 + 1e-5)
        n_sure += int(sure.sum())
        n_all += sure.size
    assert n_sure > 0.9 * n_all


def test_bf16_compute_raises_for_the_rnn_encoder():
    tm = init_params(build_speech2text(small_las("conv_blstm"),
                                       device="cpu"), 0)
    step = make_train_step(tm.train(), build_optimizer("adam", lr=1e-3),
                           compute_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        step(*map(torch.from_numpy, las_batch()),
             gen=torch.Generator().manual_seed(0))


# ---------------------------------------------------------------- the confs
@pytest.mark.parametrize("conf", CONFS)
def test_recipe_conf_builds(conf):
    args = parse_args_train(["--config", str(ROOT / "examples" / conf)])
    args.vocab = 10000
    model = build_speech2text(args, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert model.encoder.rnns[0].bidirectional == ("blstm" in args.enc_type)
    if conf == LIBRISPEECH:
        jm = jax_build(args)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 80)), jnp.array([64]),
            jnp.ones((1, 3), jnp.int32), jnp.array([3])))
        assert n == sum(math.prod(x.shape)
                        for x in jax.tree.leaves(shapes["params"]))
        assert n == 69197722


@pytest.mark.parametrize("conf", LC_CONFS)
def test_lc_blstm_confs_raise(conf):
    args = parse_args_train(["--config", str(ROOT / "examples" / conf)])
    args.vocab = 100
    with pytest.raises(NotImplementedError, match="latency-controlled"):
        build_speech2text(args, device="meta")


def test_librispeech_blstm_las_args_equal_the_conf():
    conf = vars(parse_args_train(["--config",
                                  str(ROOT / "examples" / LIBRISPEECH)]))
    args = vars(librispeech_blstm_las_args())
    assert args.pop("vocab") == 10000
    assert args == {k: conf[k] for k in args}
    assert conf.get("train_dtype") == "float32"
    assert not conf.get("bidirectional_sum_fwd_bwd", False)


def test_init_params_fill_every_rnn_tensor_the_same_way():
    a = init_params(build_speech2text(small_las("conv_blstm"),
                                      device="cpu"), 7).state_dict()
    b = init_params(build_speech2text(small_las("conv_blstm"),
                                      device="cpu"), 7).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["encoder.rnns.1.lstm.weight_ih_l0_reverse"]
    assert w.shape == (64, 32)        # the concat of layer 0's directions
    np.testing.assert_allclose(float(w.std()), 32 ** -0.5, rtol=0.1)
