"""Port parity: hierarchical multi-task training (the sub1 / sub2 encoder
taps, the CTC and attention sub-heads, ``dropout_in``), against the JAX
package on the same numpy inputs with the JAX weights converted
(``convert_params``), float32, atol = rtol = 2e-4 (the repo's) of each
leaf's largest value.

* The taps against JAX's ``eouts["ys_sub1"]`` / ``["ys_sub2"]``: a
  conformer with the sub1 tap between two interlayer max_pools and
  task-specific blocks (``task="ys_sub1"``'s early return too; the
  AISHELL model below taps without them), a reshape-mode (chunked)
  transformer's tap, and the BLSTM with task-specific layers summed (and,
  without them, concatenated with ``bridge_sub*``).
* ``dropout_in``: the encoders' input mask bit for bit from given key
  words, against JAX's ``Dropout`` with those words as its key.
* Two small models: the AISHELL hierarchical Conformer-LAS
  (``conformer_kernel15_clamp10_hie_subsample8_las_ln_2mtl.yaml``, its
  widths cut: a CTC-only sub1 at layer 3 of 4, between the max_pools),
  and the SWBD BLSTM-LAS (``blstm_las_3mtl.yaml`` cut, with a sub1
  attention decoder built from ``dec_config_sub1`` beside its sub1 CTC,
  and a sub2 CTC): the loss, its parts and every gradient (the sub
  heads' and taps' leaves included) against ``jax.grad``; one clipped
  Adam update with accumulation over two microbatches with sub labels
  against ``make_train_step``, by ``test_torch_train_step.py``'s rule.
* ROADMAP C38 (mirrored): a sub CTC head reads neither ``ctc_fc_list``
  (nor ``dec_config_sub*``'s) nor ``ctc_lsm_prob``.
* The 8 recipe MTL confs on the meta device: 5 build at JAX's parameter
  counts, the 3 ``ci_test`` ones raise on ``dropout_att``.
The CLIs with ``dict_sub1`` and ``mtl_per_batch``: ``tests/
test_torch_cli.py::test_mtl_conf_trains_and_evaluates``.
"""
import functools
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from neural_sp_tpu.models.encoders.rnn import RNNEncoder as JRNNEnc
from neural_sp_tpu.models.encoders.transformer import XformerEncoder as JEnc
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu.ops.dropout import Dropout as JDropout
from neural_sp_tpu.parallel.mesh import make_train_step as jax_make_step
from neural_sp_tpu.trainers.optimizer import (
    build_optimizer as jax_build_optimizer)
from neural_sp_tpu_torch.bin.args import parse_args_train
from neural_sp_tpu_torch.models.encoders.rnn import RNNEncoder
from neural_sp_tpu_torch.models.encoders.transformer import XformerEncoder
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.ops import dropout as tdropout
from neural_sp_tpu_torch.parallel.mesh import make_train_step
from neural_sp_tpu_torch.trainers.optimizer import build_optimizer
from neural_sp_tpu_torch.utils.convert_params import convert_params

from test_torch_train_step import _moments

ATOL = RTOL = 2e-4
ROOT = Path(__file__).resolve().parents[1]
AISHELL = "aishell/conf/asr/conformer_kernel15_clamp10_hie_subsample8_" \
    "las_ln_2mtl.yaml"
SWBD_3MTL = "swbd/conf/asr/blstm_las_3mtl.yaml"
MTL_CONFS = {
    AISHELL: 51104170, "csj/conf/asr/las/blstm_las_2mtl.yaml": 54682106,
    "swbd/conf/asr/blstm_las_2mtl.yaml": 58880506, SWBD_3MTL: 68208906,
    "tedlium/conf/asr/las/blstm_las_2mtl.yaml": 57003930,
    # the ci_test ones, since their attention dropout and the LAS
    # decoder's projections are ported
    "ci_test/conf/asr/blstm_las_2mtl.yaml": 1050652,
    "ci_test/conf/asr/blstm_las_2mtl_per_batch.yaml": 1050652,
    "ci_test/conf/asr/transformer_2mtl.yaml": 560648}


def _tree(params):
    return jax.tree.map(np.asarray, params)


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0,
        atol=RTOL * max(float(np.abs(want).max()), 1e-6), err_msg=err_msg)


def _perturb(params, scale=0.05, seed=0):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: np.asarray(x) + scale * rng.randn(
        *x.shape).astype(np.float32), _tree(params))


def _hold_eouts(got, want, keys):
    assert set(got) == set(want) == set(keys)
    for k in keys:
        wl = np.asarray(want[k]["xlens"])
        np.testing.assert_array_equal(got[k]["xlens"].numpy(), wl)
        assert got[k]["xs"].shape == want[k]["xs"].shape, k
        for b, n in enumerate(wl):
            _close(got[k]["xs"][b, :n].numpy(),
                   np.asarray(want[k]["xs"])[b, :n], k)


# ------------------------------------------------------------------ taps
CONV = dict(conv_channels="4_4", conv_kernel_sizes="(3,3)_(3,3)",
            conv_poolings="(1,1)_(2,2)")
XF_TAPS = {
    # the AISHELL conf's shape (the sub1 tap between the two max_pools),
    # with task-specific blocks and a sub2 tap before the first
    "conformer_tsl": dict(btype="conformer", pe_type="relative",
                          clamp_len=10, conv_kernel_size=3, n_layers=4,
                          n_layers_sub1=3, n_layers_sub2=1,
                          task_specific_layer=True, subsample=(1, 2, 1, 2),
                          subsample_type="max_pool"),
    "reshape_transformer": dict(
        btype="transformer", pe_type="none", n_layers=2, n_layers_sub1=1,
        chunk_size_left=8, chunk_size_current=8, chunk_size_right=4,
        streaming_type="reshape"),
}


@functools.cache
def _xf_encoders(name):
    kw = {**XF_TAPS[name], **CONV}
    je = JEnc(input_dim=16, d_model=32, d_ff=48, n_heads=2, dropout=0.0,
              ffn_activation="swish", **kw)
    params = _perturb(jax.jit(je.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 40, 16)),
        jnp.array([40, 30]))["params"])
    te = XformerEncoder(input_dim=16, d_model=32, d_ff=48, n_heads=2, **kw)
    te.load_state_dict(convert_params(params), strict=True)
    return je, {"params": params}, te.eval()


@pytest.mark.parametrize("name", list(XF_TAPS))
def test_xformer_taps_match_jax(name):
    """Ragged lengths (a 10-frame row), T = 45; every tap and the main
    stream, then ``task="ys_sub1"``: the taps up to sub1, nothing after."""
    je, v, te = _xf_encoders(name)
    rng = np.random.RandomState(1)
    xs = rng.randn(3, 45, 16).astype(np.float32)
    xlens = np.array([45, 37, 10], np.int32)
    keys = ["ys"] + [f"ys_sub{i}" for i in (1, 2)
                     if XF_TAPS[name].get(f"n_layers_sub{i}", 0)]
    want = jax.jit(je.apply)(v, jnp.asarray(xs), jnp.asarray(xlens))
    with torch.no_grad():
        got = te(torch.from_numpy(xs), torch.from_numpy(xlens).long())
        early = te(torch.from_numpy(xs), torch.from_numpy(xlens).long(),
                   task="ys_sub1")
    _hold_eouts(got, want, keys)
    # the early return: the same taps, nothing past sub1's layer
    assert set(early) == set(keys) - {"ys"}
    for k in early:
        assert torch.equal(early[k]["xs"], got[k]["xs"]), k
    if name == "conformer_tsl":
        # the tap reads T / 4: between the max_pools at layers 2 and 4
        assert got["ys_sub1"]["xs"].shape[1] == 12


RNN_TAPS = {
    "blstm_tsl_sum": dict(bidir_sum_fwd_bwd=True, task_specific_layer=True,
                          n_layers_sub1=2, n_layers_sub2=1),
    "blstm_bridge_concat": dict(bidir_sum_fwd_bwd=False, last_proj_dim=12,
                                n_layers_sub1=2),
}


@pytest.mark.parametrize("name", list(RNN_TAPS))
def test_rnn_encoder_taps_match_jax(name):
    kw = dict(input_dim=10, rnn_type="blstm", n_units=16, n_layers=3,
              subsample=(1, 2, 1), subsample_type="drop",
              conv_channels="4", conv_kernel_sizes="(3,3)",
              conv_poolings="(2,2)", **RNN_TAPS[name])
    je = JRNNEnc(**kw)
    rng = np.random.RandomState(4)
    xs = rng.randn(3, 48, 10).astype(np.float32)
    xlens = np.array([48, 33, 9], np.int32)
    params = _tree(jax.jit(je.init)(jax.random.PRNGKey(0), jnp.asarray(xs),
                                    jnp.asarray(xlens))["params"])
    te = RNNEncoder(**kw)
    te.load_state_dict(convert_params(params), strict=True)
    keys = ["ys"] + [f"ys_sub{i}" for i in (1, 2)
                     if kw.get(f"n_layers_sub{i}", 0)]
    for sub in keys[1:]:
        assert getattr(te, f"output_dim_{sub[3:]}") == \
            getattr(je, f"output_dim_{sub[3:]}")
    want, _ = jax.jit(je.apply)({"params": params}, jnp.asarray(xs),
                                jnp.asarray(xlens))
    with torch.no_grad():
        got = te.eval()(torch.from_numpy(xs), torch.from_numpy(xlens))
    _hold_eouts(got, want, keys)
    with torch.no_grad():
        got = te(torch.from_numpy(xs), torch.from_numpy(xlens),
                 task="ys_sub1")
    # the taps up to sub1's layer (sub2's comes first here)
    assert set(got) == set(keys[1:])


@pytest.mark.parametrize("enc", ["conformer", "blstm"])
def test_dropout_in_mask_matches_jax(enc, monkeypatch):
    """The input dropout's mask from given key words: the port's
    ``drop_in`` and JAX's ``Dropout`` keyed by the same two words agree
    bit for bit; in ``train()`` the encoder reads the masked features
    (dropout elsewhere off)."""
    words = (0x1234ABCD, 0x0F0F5A5A)
    monkeypatch.setattr(tdropout, "key_words", lambda gen: words)
    rng = np.random.RandomState(2)
    xs = rng.randn(2, 40, 16).astype(np.float32)
    xlens = torch.tensor([40, 27])
    want = np.asarray(JDropout(0.3).apply(
        {}, jnp.asarray(xs), deterministic=False,
        rng=jnp.asarray(words, jnp.uint32)))
    if enc == "conformer":
        te = XformerEncoder(input_dim=16, d_model=32, d_ff=48, n_heads=2,
                            n_layers=1, dropout_in=0.3, **CONV)
    else:
        te = RNNEncoder(input_dim=16, n_units=8, n_layers=1, dropout_in=0.3,
                        **CONV)
    got = te.drop_in.train()(torch.from_numpy(xs), None).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.2 < float((got == 0).mean()) < 0.4
    with torch.no_grad():
        trained = te.train()(torch.from_numpy(xs), xlens)["ys"]["xs"]
        plain = te.eval()(torch.from_numpy(want.copy()), xlens)["ys"]["xs"]
    np.testing.assert_array_equal(trained.numpy(), plain.numpy())


# ----------------------------------------------------------- whole models
def _conf(conf, **over):
    args = vars(parse_args_train(["--config", str(ROOT / "examples" / conf)]))
    args.update(over)
    return SimpleNamespace(**args)


def small_aishell(**over):
    """The AISHELL hierarchical Conformer-LAS cut: 4 conformer layers of
    d 32 / 2 heads / d_ff 48 with max_pools after layers 2 and 4 and the
    CTC-only sub1 after layer 3, LSTM-32 LAS, vocab 40, sub1 vocab 30;
    the conf's CTC fc "512" cut to "16", its ctc_lsm_prob 0.1 kept;
    dropout and SpecAugment off."""
    return _conf(AISHELL, input_dim=20, conv_channels="4_4", enc_n_layers=4,
                 enc_n_layers_sub1=3, subsample="1_2_1_2",
                 transformer_enc_d_model=32, transformer_enc_d_ff=48,
                 transformer_enc_n_heads=2, dec_n_units=32, emb_dim=16,
                 dec_bottleneck_dim=32, attn_dim=16, attn_conv_width=9,
                 ctc_fc_list="16", vocab=40, vocab_sub1=30, dropout_enc=0.0,
                 dropout_dec=0.0, dropout_emb=0.0, ss_prob=0.0,
                 n_freq_masks=0, n_time_masks=0, **over)


def small_swbd(**over):
    """The SWBD three-task BLSTM-LAS cut: one pooling block, 4 BLSTM-16
    layers summed with drop subsampling after the second and third, taps
    after layers 2 and 1 with task-specific layers; sub1 weight 0.4 of
    which CTC 0.2, so a sub1 LAS decoder from ``dec_config_sub1`` (24
    units, no CTC fc), a sub2 CTC 0.2, and the main LAS alone (CTC 0);
    vocab 40 / 30 / 20."""
    return _conf(SWBD_3MTL, input_dim=20, conv_channels="4",
                 conv_kernel_sizes="(3,3)", conv_poolings="(2,2)",
                 enc_n_units=16, enc_n_layers=4, enc_n_layers_sub1=2,
                 enc_n_layers_sub2=1, subsample="1_2_2_1", dec_n_units=32,
                 emb_dim=16, dec_bottleneck_dim=32, attn_dim=16,
                 attn_conv_width=9, sub1_weight=0.4, vocab=40, vocab_sub1=30,
                 vocab_sub2=20,
                 dec_config_sub1={"ctc_fc_list": "", "dec_n_units": 24},
                 dropout_enc=0.0, dropout_dec=0.0, dropout_emb=0.0,
                 ss_prob=0.0, **over)


MODELS = {"aishell": small_aishell, "swbd": small_swbd}


def mtl_batch(seed=0, bs=3, t=64):
    """Features, lengths and three label streams: the main one (vocab 40)
    and the sub-tasks' longer ones (vocab 30 and 20), within the taps'
    CTC limits."""
    rng = np.random.RandomState(seed)
    xs = rng.randn(bs, t, 20).astype(np.float32)
    xlens = np.array([t, t - 14, t - 27][:bs], np.int32)
    out = [xs, xlens]
    for vocab, lens in ((40, [5, 3, 2]), (30, [8, 6, 3]), (20, [7, 4, 4])):
        ylens = np.array(lens[:bs], np.int32)
        ys = np.full((bs, max(lens)), 3, np.int32)
        for b, u in enumerate(ylens):
            ys[b, :u] = rng.randint(4, vocab, u)
        out += [ys, ylens]
    return out


def _kw(b):
    """The JAX / port keywords of a batch's sub labels."""
    return dict(zip(("ys_sub1", "ylens_sub1", "ys_sub2", "ylens_sub2"),
                    b[4:]))


@functools.cache
def _models(name):
    args = MODELS[name]()
    jm = jax_build(args)
    b = mtl_batch()
    # flax's initial weights perturbed, so that the attention is not
    # uniform and most gradients are away from 0
    params = _perturb(jax.jit(jm.init)(
        jax.random.PRNGKey(0), *map(jnp.asarray, b[:4]),
        **{k: jnp.asarray(v) for k, v in _kw(b).items()})["params"], 0.1)
    return args, jm, params


def _port(name, params):
    tm = build_speech2text(_models(name)[0], device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    return tm


@pytest.mark.parametrize("name", list(MODELS))
def test_mtl_loss_and_grads_match_jax(name):
    args, jm, params = _models(name)
    b = mtl_batch(1)
    jkw = {k: jnp.asarray(v) for k, v in _kw(b).items()}

    def jloss(p):
        return jm.apply({"params": p}, *map(jnp.asarray, b[:4]),
                        deterministic=True, **jkw)

    (want, jobs), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    tm = _port(name, params).eval()
    loss, obs = tm(*map(torch.from_numpy, b[:4]),
                   **{k: torch.from_numpy(v) for k, v in _kw(b).items()})
    loss.backward()
    parts = {"aishell": ("loss_ctc", "loss_att", "loss_ctc_sub1"),
             "swbd": ("loss_att", "loss_ctc_sub1", "loss_att_sub1",
                      "loss_ctc_sub2")}[name]
    assert set(parts) <= set(obs) and set(parts) <= set(jobs)
    assert {k for k in obs if k.startswith("loss")} == \
        {k for k in jobs if k.startswith("loss")}
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=RTOL)
    for k in parts:
        np.testing.assert_allclose(float(obs[k].detach()), float(jobs[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    want_g = convert_params(_tree(grads))
    assert set(want_g) == {n for n, _ in tm.named_parameters()}
    sub_leaves = [n for n in want_g if "sub1" in n or "sub2" in n]
    assert sub_leaves and all(float(want_g[n].abs().max()) > 0
                              for n in sub_leaves if "ctc_sub" in n)
    for n, p in tm.named_parameters():
        if n.endswith(".mha.w_key.bias"):
            # zero in exact arithmetic (a softmax is shift-invariant): held
            # to test_torch_train.py's floor
            np.testing.assert_allclose(p.grad.numpy(), want_g[n].numpy(),
                                       rtol=0, atol=1e-5, err_msg=n)
            continue
        _close(p.grad.numpy(), want_g[n].numpy(), n)


@pytest.mark.parametrize("name", list(MODELS))
def test_mtl_accumulated_clipped_update_matches_jax(name):
    """Two microbatches with sub labels, Adam with k = 2 accumulation and
    clip 0.5 (active): each microstep's loss, its parts and grad_norm, then
    the update where Adam's sign is well defined (as in
    test_torch_rnn_encoder.py)."""
    clip, k, lr = 0.5, 2, 1e-3
    args, jm, params = _models(name)
    params0 = convert_params(params)
    tx = jax_build_optimizer("adam", lr=lr, clip_grad_norm=clip,
                             accum_grad_n_steps=k)
    jstep = jax_make_step(jm, tx, donate=False)
    opt_state = tx.init(params)
    tm = _port(name, params)
    step = make_train_step(tm.train(), build_optimizer(
        "adam", lr=lr, clip_grad_norm=clip, accum_grad_n_steps=k))
    jparams = params
    for i, b in enumerate((mtl_batch(10), mtl_batch(11))):
        jparams, opt_state, jmet = jstep(
            jparams, opt_state, jax.random.PRNGKey(i),
            *map(jnp.asarray, b[:4]),
            **{kk: jnp.asarray(v) for kk, v in _kw(b).items()})
        met = step(*map(torch.from_numpy, b[:4]),
                   gen=torch.Generator().manual_seed(i),
                   **{kk: torch.from_numpy(v) for kk, v in _kw(b).items()})
        assert met["emitted"] == (i == k - 1)
        names = [n for n in jmet if n.startswith("loss")] + ["grad_norm"]
        assert len(names) > 3
        for n in names:
            np.testing.assert_allclose(float(met[n]), float(jmet[n]),
                                       rtol=RTOL, err_msg=n)
    assert float(met["grad_norm"]) > clip
    new = convert_params(_tree(jparams))
    mu = convert_params(_tree(_moments(opt_state).mu))
    mu_floor = 1e-6 * max(float(m.abs().max()) for m in mu.values())
    state = tm.state_dict()
    n_sure = n_all = 0
    for n, p0 in params0.items():
        want_u = (new[n] - p0).numpy()
        got_u = (state[n] - p0).numpy()
        m = np.abs(mu[n].numpy())
        sure = (m > 1e-3 * m.max()) & (m > mu_floor)
        np.testing.assert_allclose(got_u[sure], want_u[sure], rtol=0,
                                   atol=1e-3 * lr, err_msg=n)
        # Adam's bound, plus the rounding of the update into the weight
        # (a LayerNorm scale of 1 has spacing 1.2e-7)
        assert (np.abs(got_u) <= lr * (1 + 1e-5) + np.spacing(
            np.abs(p0.numpy()))).all(), n
        n_sure += int(sure.sum())
        n_all += sure.size
    assert n_sure > 0.9 * n_all


def test_c38_sub_ctc_reads_no_fc_list_or_label_smoothing():
    """ROADMAP C38, mirrored: JAX builds a sub CTC head from the vocabulary
    and the tap's width alone. The AISHELL conf sets ``ctc_fc_list`` and
    ``ctc_lsm_prob`` 0.1; ``dec_config_sub1`` sets its own fc list ('8'
    here, as ``ci_test``'s): the main CTC has its fc layer and label
    smoothing, the sub1 CTC neither, in both packages."""
    args = small_aishell(dec_config_sub1={"ctc_fc_list": "8"})
    jm = jax_build(args)
    assert jm.ctc.fc_list == "16" and jm.ctc.lsm_prob == 0.1
    assert jm.ctc_sub1.fc_list == "" and jm.ctc_sub1.lsm_prob == 0.0
    _, _, params = _models("aishell")
    assert "fc0" in params["ctc"] and set(params["ctc_sub1"]) == {"output"}
    tm = build_speech2text(args, device="cpu")
    assert tm.ctc.lsm_prob == 0.1 and hasattr(tm.ctc, "fc0")
    assert tm.ctc_sub1.lsm_prob == 0.0
    assert [n for n, _ in tm.ctc_sub1.named_parameters()] == \
        ["output.weight", "output.bias"]
    assert tm.ctc_sub1.output.in_features == 32
    assert tm.ctc_sub1.output.out_features == 30


@pytest.mark.parametrize("conf", list(MTL_CONFS))
def test_mtl_recipe_conf_builds(conf):
    """The five recipe MTL confs and the three ``ci_test`` ones build at
    JAX's parameter counts (vocab 10,000 for every task: JAX's default
    ``vocab_sub*``; MTL_CONFS holds them as ``_jax_count`` gives them,
    which this test runs for the AISHELL conf), with the sub heads each
    conf asks for (the ``ci_test`` ones raised until their attention
    dropout and LAS projections were ported)."""
    args = parse_args_train(["--config", str(ROOT / "examples" / conf)])
    args.vocab = 10000
    model = build_speech2text(args, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == MTL_CONFS[conf]
    if conf == AISHELL:
        assert n == _jax_count(args)
    for sub in ("sub1", "sub2"):
        w = getattr(args, f"{sub}_weight", 0.0)
        wc = getattr(args, f"ctc_weight_{sub}", 0.0)
        assert (getattr(model, f"ctc_{sub}") is not None) == (w > 0 < wc)
        assert (getattr(model, f"dec_fwd_{sub}") is not None) == (w - wc > 0)


def _jax_count(args):
    """The JAX model's parameter count from its shapes; a conf that lists
    fewer subsampling factors than layers (the swbd ones) with the missing
    ones 1, as the port reads it (ROADMAP C19)."""
    factors = str(getattr(args, "subsample", "") or "1").split("_")
    if len(factors) < args.enc_n_layers:
        args = SimpleNamespace(**{**vars(args), "subsample": "_".join(
            factors + ["1"] * (args.enc_n_layers - len(factors)))})
    jm = jax_build(args)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 80)), jnp.array([64]),
        jnp.ones((1, 3), jnp.int32), jnp.array([3])))
    return sum(math.prod(x.shape) for x in jax.tree.leaves(shapes["params"]))
