"""Port parity: the RNN transducer (``ops/rnnt.py`` with K5's plain twin
``ops/kernels/rnnt_loss.py``, ``models/decoders/rnn_transducer.py``, its
searches in ``Speech2TextSession``) against the JAX package on the same
numpy inputs with the JAX weights converted (``convert_params``), float32,
atol = rtol = 2e-4 (the repo's).

* The lattice loss: ``rnnt_loss_from_logits`` and ``rnnt_loss`` per row
  and the gradient w.r.t. the logits (log-probs) against JAX's and
  ``jax.grad``, with a row of U 0, a row of T 1 and U > T; K5's written-out
  backward (``rnnt_loss_bwd_ref``) against autograd through the float64
  twin; the wrapper takes the twin for CPU tensors.
* A small LC-BLSTM-RNN-T (2 LC-BLSTM layers, a 2-layer prediction net with
  projections, CTC 0.3): the loss, its terms and every gradient leaf in
  eval mode against ``jax.grad``; one accumulated, clipped Adam update
  against JAX's ``make_train_step`` (``test_torch_train_step.py``'s rule);
  greedy, ``tsd`` beam 4 (with and without length normalisation) and the
  streamed ``mono`` beam 4 (with a forced CTC-VAD reset: the commit) tokens
  against the JAX session's.
* The recipe transducer confs with an (LC-)BLSTM or LSTM encoder build on
  the meta device at JAX's parameter counts (the joint's width is
  ``dec_n_units``: the confs' ``dec_bottleneck_dim`` is not read, as in
  JAX); the GRU prediction net raises.
"""
import math
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from neural_sp_tpu.frontends import streaming as jax_streaming
from neural_sp_tpu.models.decoders.decoding import (
    DecodeConfig as JaxDecodeConfig, Speech2TextSession as JaxSession)
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu.ops import rnnt as jax_rnnt
from neural_sp_tpu.parallel.mesh import make_train_step as jax_make_step
from neural_sp_tpu.trainers.optimizer import (
    build_optimizer as jax_build_optimizer)
from neural_sp_tpu_torch.bin.args import parse_args_train
from neural_sp_tpu_torch.frontends import streaming as torch_streaming
from neural_sp_tpu_torch.models.decoders.decoding import (
    DecodeConfig, Speech2TextSession)
from neural_sp_tpu_torch.models.decoders.rnn_transducer import RNNTransducer
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.ops import rnnt
from neural_sp_tpu_torch.ops.kernels import rnnt_loss as k5
from neural_sp_tpu_torch.parallel.mesh import make_train_step
from neural_sp_tpu_torch.trainers.optimizer import build_optimizer
from neural_sp_tpu_torch.utils.convert_params import convert_params

from test_torch_train_step import _moments

ATOL = RTOL = 2e-4
ROOT = Path(__file__).resolve().parents[1]


def _tree(params):
    return jax.tree.map(np.asarray, params)


# ----------------------------------------------------------- the lattice
def _lattice(seed=0):
    """B 4, T 7, U 9, V 6: label lengths (9, 0, 4, 2) with logit lengths
    (7, 1, 5, 3): U > T, a row of U 0, a row of T 1."""
    rng = np.random.RandomState(seed)
    logits = (2 * rng.randn(4, 7, 10, 6)).astype(np.float32)
    labels = rng.randint(1, 6, (4, 9)).astype(np.int32)
    tl = np.array([7, 1, 5, 3], np.int32)
    ul = np.array([9, 0, 4, 2], np.int32)
    g = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    return logits, labels, tl, ul, g


@pytest.mark.parametrize("form", ["logits", "log_probs"])
def test_rnnt_loss_matches_jax(form):
    logits, labels, tl, ul, g = _lattice()
    if form == "log_probs":
        logits = np.asarray(jax.nn.log_softmax(logits, -1))
    jfn, tfn = {"logits": (jax_rnnt.rnnt_loss_from_logits,
                           rnnt.rnnt_loss_from_logits),
                "log_probs": (jax_rnnt.rnnt_loss, rnnt.rnnt_loss)}[form]

    def jobjective(x):
        nll = jfn(x, jnp.asarray(labels), jnp.asarray(tl), jnp.asarray(ul),
                  reduction="none")
        return (nll * g).sum(), nll

    (_, want), grad = jax.jit(jax.value_and_grad(jobjective, has_aux=True))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    nll = tfn(x, torch.from_numpy(labels), torch.from_numpy(tl),
              torch.from_numpy(ul), reduction="none")
    (nll * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    grad = np.asarray(grad)
    np.testing.assert_allclose(x.grad.numpy(), grad, rtol=0,
                               atol=RTOL * np.abs(grad).max())
    for red in ("sum_over_batch", "mean"):
        np.testing.assert_allclose(
            float(tfn(x, torch.from_numpy(labels), torch.from_numpy(tl),
                      torch.from_numpy(ul), reduction=red)),
            float(jfn(jnp.asarray(logits), jnp.asarray(labels),
                      jnp.asarray(tl), jnp.asarray(ul), reduction=red)),
            rtol=RTOL)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rnnt_written_out_backward_matches_autograd(dtype):
    """K5's plain backward (betas, then the two occupancies in closed form)
    against autograd through the plain forward, in float64 and in the
    float32 recurrence; zeros past each row's lengths."""
    logits, labels, tl, ul, g = _lattice(1)
    lp = torch.log_softmax(torch.from_numpy(logits).double(), -1)
    blank = lp[..., 0].float()
    emit = torch.gather(lp[:, :, :9], 3, torch.from_numpy(labels).long()[
        :, None, :, None].expand(-1, 7, -1, 1))[..., 0].float()
    emit = rnnt._mask_emit(emit, torch.from_numpy(ul))
    args = (torch.from_numpy(tl), torch.from_numpy(ul))
    b64 = blank.double().requires_grad_()
    e64 = emit.double().requires_grad_()
    nll, alphas = k5.rnnt_forward_alphas(b64, e64, *args, dtype=dtype)
    nll64 = k5._final_nll(alphas, b64.to(dtype), *args)
    (nll64.double() * torch.from_numpy(g).double()).sum().backward()
    gb, ge = k5.rnnt_loss_bwd_ref(blank, emit, *args, alphas.detach(),
                                  torch.from_numpy(g), dtype=dtype)
    # the plain backward returns float32
    tol = 1e-7 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(gb.double(), b64.grad, atol=tol, rtol=0)
    torch.testing.assert_close(ge.double(), e64.grad, atol=tol, rtol=0)
    torch.testing.assert_close(nll, nll64.float(), atol=1e-5, rtol=1e-6)
    assert float(gb[1, 1:].abs().max()) == 0.0       # T_b 1
    assert float(ge[1].abs().max()) == 0.0           # U_b 0
    assert float(ge[2, :, 4:].abs().max()) == 0.0


def test_rnnt_wrapper_takes_the_twin_on_the_cpu():
    logits, labels, tl, ul, _ = _lattice(2)
    before = (k5.rnnt_loss_fwd.launches, k5.rnnt_loss_bwd.launches)
    x = torch.from_numpy(logits).requires_grad_()
    rnnt.rnnt_loss_from_logits(x, torch.from_numpy(labels),
                               torch.from_numpy(tl),
                               torch.from_numpy(ul)).backward()
    assert (k5.rnnt_loss_fwd.launches, k5.rnnt_loss_bwd.launches) == before
    assert torch.isfinite(x.grad).all()


# ------------------------------------------------------------ whole models
def small_rnnt(**over):
    """A small LC-BLSTM-RNN-T without a front end (JAX's RNN encoder streams
    only without one, C31): 2 LC-BLSTM layers of 16 units summed, chunk 6 /
    3; a 2-layer LSTM-24 prediction net with projections of 10, emb 8, the
    joint 24 wide; CTC 0.3 (fc 10), vocab 15; dropout off."""
    kw = dict(enc_type="blstm", input_dim=12, enc_n_layers=2,
              enc_n_units=16, bidirectional_sum_fwd_bwd=True,
              lc_chunk_size_current=6, lc_chunk_size_right=3,
              dec_type="lstm_transducer", dec_n_units=24, dec_n_layers=2,
              dec_n_projs=10, emb_dim=8, vocab=15, ctc_weight=0.3,
              ctc_fc_list="10", dropout_enc=0.0, dropout_dec=0.0,
              dropout_emb=0.0)
    kw.update(over)
    return SimpleNamespace(**kw)


def rnnt_batch(seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.randn(3, 30, 12).astype(np.float32)
    xlens = np.array([30, 17, 9], np.int32)
    ylens = np.array([5, 2, 0], np.int32)
    ys = np.full((3, 5), 3, np.int32)           # PAD
    for b, u in enumerate(ylens):
        ys[b, :u] = rng.randint(4, 15, u)
    return xs, xlens, ys, ylens


_INIT = {}


def _models(**over):
    args = small_rnnt(**over)
    jm = jax_build(args)
    if "params" not in _INIT:
        _INIT["params"] = _tree(jax.jit(jm.init)(
            jax.random.PRNGKey(0), *map(jnp.asarray, rnnt_batch()))["params"])
    params = _INIT["params"]
    tm = build_speech2text(args, device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    return jm, params, tm


def test_transducer_loss_and_grads_match_jax():
    jm, params, tm = _models()
    assert isinstance(tm.dec_fwd, RNNTransducer)
    b = rnnt_batch(1)

    def jloss(p):
        return jm.apply({"params": p}, *map(jnp.asarray, b),
                        deterministic=True)

    (want, jobs), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    loss, obs = tm.eval()(*map(torch.from_numpy, b))
    loss.backward()
    assert set(obs) == set(jobs) == {"loss", "loss_ctc", "loss_transducer"}
    for name in jobs:
        np.testing.assert_allclose(float(obs[name].detach()),
                                   float(jobs[name]), rtol=RTOL, err_msg=name)
    want_g = convert_params(_tree(grads))
    assert set(want_g) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        w = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=RTOL * float(np.abs(w).max()),
                                   err_msg=name)


def test_transducer_accumulated_clipped_update_matches_jax():
    """Two microbatches, Adam with k = 2 accumulation and clip 0.5 (active):
    the metrics of each microstep and the update, by
    test_torch_train_step.py's rule."""
    clip, k, lr = 0.5, 2, 1e-3
    jm, params, tm = _models()
    params0 = convert_params(params)
    tx = jax_build_optimizer("adam", lr=lr, clip_grad_norm=clip,
                             accum_grad_n_steps=k)
    jstep = jax_make_step(jm, tx, donate=False)
    opt_state = tx.init(params)
    step = make_train_step(tm.train(), build_optimizer(
        "adam", lr=lr, clip_grad_norm=clip, accum_grad_n_steps=k))
    for i, b in enumerate((rnnt_batch(10), rnnt_batch(11))):
        params, opt_state, jmet = jstep(params, opt_state,
                                        jax.random.PRNGKey(i),
                                        *map(jnp.asarray, b))
        met = step(*map(torch.from_numpy, b),
                   gen=torch.Generator().manual_seed(i))
        assert met["emitted"] == (i == k - 1)
        for name in ("loss", "loss_ctc", "loss_transducer", "grad_norm"):
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
        m = np.abs(mu[name].numpy())
        sure = (m > 1e-3 * m.max()) & (m > mu_floor)
        np.testing.assert_allclose(got_u[sure], want_u[sure], rtol=0,
                                   atol=1e-3 * lr, err_msg=name)
        assert np.abs(got_u).max() <= lr * (1 + 1e-5)
        n_sure += int(sure.sum())
        n_all += sure.size
    assert n_sure > 0.9 * n_all


def _decode_models():
    """The small model's weights moved by seeded noise, so that the joint
    is far from flat and the hypotheses are not empty."""
    jm, params, tm = _models()
    rng = np.random.RandomState(5)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.5 * rng.randn(
        *x.shape).astype(np.float32), params)
    tm.load_state_dict(convert_params(params), strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("conf", [
    dict(beam_width=1), dict(beam_width=4),
    dict(beam_width=4, length_norm=True)])
def test_transducer_decode_matches_jax(conf):
    """Greedy (beam 1, up to 3 labels a frame) and the time-synchronous
    beam 4 (tsd, up to 3 expansions a frame) over a batch of 3."""
    jm, params, tm = _decode_models()
    xs, xlens, _, _ = rnnt_batch(6)
    want = JaxSession(jm, params, JaxDecodeConfig(**conf)).decode(xs, xlens)
    got = Speech2TextSession(tm, DecodeConfig(**conf)).decode(xs, xlens)
    assert got == want
    assert all(len(h) > 0 for h in got)


def test_transducer_streaming_matches_jax(monkeypatch):
    """``decode_streaming``: the LC-BLSTM block by block and the mono beam
    4; then with a CTC-VAD reset forced at the second block (the beam
    commits its best prefix, the carry restarts warmed on the previous
    block): the tokens and the commit."""
    jm, params, tm = _decode_models()
    x = np.random.RandomState(7).randn(60, 12).astype(np.float32)
    jsess = JaxSession(jm, params, JaxDecodeConfig(beam_width=4))
    tsess = Speech2TextSession(tm, DecodeConfig(beam_width=4))
    want, _ = jsess.decode_streaming(x)
    got, _ = tsess.decode_streaming(x)
    assert got == want and len(got) > 2
    calls = {"jax": 0, "torch": 0}

    def fire_second(pkg):
        def step(self, ids, probs, n_new):
            calls[pkg] += 1
            return calls[pkg] == 2
        return step

    monkeypatch.setattr(jax_streaming.CtcVAD, "step", fire_second("jax"))
    monkeypatch.setattr(torch_streaming.CtcVAD, "step", fire_second("torch"))
    want, jstats = jsess.decode_streaming(x)
    got, stats = tsess.decode_streaming(x)
    assert stats["n_resets"] == jstats["n_resets"] == 1
    assert stats["commits"] == jstats["commits"] and stats["commits"][0]
    assert got == want


# ---------------------------------------------------------------- the confs
def _transducer_confs():
    """The recipe transducer confs with an RNN encoder (the uni-Conformer's
    is held in test_torch_uni_conformer.py): (those without dropout_in,
    those that set it; both build since the input dropout is ported)."""
    out = subprocess.run(["grep", "-rl", "dec_type: lstm_transducer",
                          str(ROOT / "examples")], capture_output=True,
                         text=True, check=True).stdout.split()
    build, raise_ = [], []
    for p in sorted(out):
        if "conformer" in p:
            continue
        args = parse_args_train(["--config", p])
        conf = str(Path(p).relative_to(ROOT / "examples"))
        (raise_ if getattr(args, "dropout_in", 0.0) else build).append(conf)
    return build, raise_


TRANSDUCER_CONFS, DROPOUT_IN_CONFS = _transducer_confs()
_JAX_COUNTS = {}


def test_transducer_confs_are_the_recipes():
    """The two confs with dropout_in build at JAX's parameter counts, the
    input dropout at the conf's rate."""
    assert len(TRANSDUCER_CONFS) == 13
    assert DROPOUT_IN_CONFS == ["ci_test/conf/asr/lcblstm_transducer.yaml",
                                "timit/conf/rnn_transducer.yaml"]
    for conf in DROPOUT_IN_CONFS:
        args = parse_args_train(["--config", str(ROOT / "examples" / conf)])
        args.vocab = 100
        model = build_speech2text(args, device="meta")
        assert model.encoder.drop_in.rate == args.dropout_in > 0
        jm = jax_build(args)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, args.input_dim)),
            jnp.array([64]), jnp.ones((1, 3), jnp.int32), jnp.array([3])))
        assert sum(p.numel() for p in model.parameters()) == sum(
            math.prod(x.shape) for x in jax.tree.leaves(shapes["params"]))


@pytest.mark.parametrize("conf", TRANSDUCER_CONFS)
def test_transducer_conf_builds(conf):
    args = parse_args_train(["--config", str(ROOT / "examples" / conf)])
    args.vocab = 10000
    model = build_speech2text(args, device="meta")
    dec = model.dec_fwd
    assert isinstance(dec, RNNTransducer)
    assert dec.w_pred.out_features == args.dec_n_units
    assert model.encoder.lc == (getattr(args, "lc_chunk_size_left", -1) > 0)
    n = sum(p.numel() for p in model.parameters())
    key = (args.enc_type, args.enc_n_units, args.enc_n_layers,
           args.dec_n_units, args.dec_n_layers)
    if key not in _JAX_COUNTS:
        jm = jax_build(args)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 80)), jnp.array([64]),
            jnp.ones((1, 3), jnp.int32), jnp.array([3])))
        _JAX_COUNTS[key] = sum(math.prod(x.shape)
                               for x in jax.tree.leaves(shapes["params"]))
    assert n == _JAX_COUNTS[key]


def test_gru_transducer_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_speech2text(small_rnnt(dec_type="gru_transducer"),
                          device="cpu")
