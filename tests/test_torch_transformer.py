"""Port parity: the transformer encoder and decoder with their beam
(``models/modules/{positional_embedding,multihead_attention}.py``,
``models/encoders/transformer.py``, ``models/decoders/transformer.py``,
``Speech2TextSession._beam_one``) and the transformer recipe
confs, against the JAX package on the same numpy inputs with the JAX
weights converted (``convert_params``, strict), float32, atol = rtol =
2e-4 (the repo's).

* ``PositionalEncoding`` with "add", "none" and the recipes' "1dconv3L"
  (ROADMAP C21: no positions, in JAX and so in the port) at offsets 0 and
  7.
* ``MultiheadAttention`` in its three cache modes (full attention, cached
  keys and values with ``key=None``, appending to a cache) and with masks
  of rank 2 and 3.
* The transformer encoder (the LibriSpeech conf's shape, its widths cut)
  with ``pe_type`` none and the interlayer ``drop`` (and, through the
  loss test's gradients, "add" and ``max_pool``).
* A small LibriSpeech-Transformer ``Speech2Text`` in ``train()`` with
  dropout 0: the loss, its parts and every gradient leaf against
  ``jax.grad``, with a bridge (decoder width below the encoder's),
  ``dropout_head`` 0.5 (ROADMAP C23: no builder reads it), the sinusoid in
  both and ``max_pool``; ``sequence_log_prob``; a chain of ``decode_step``
  against JAX's and against the teacher-forced logits.
* The session on perturbed weights (so hypotheses are not empty): beam 10
  + CTC 0.3 with a small RNNLM and length normalisation, beam 10 + CTC
  with ``ilm_weight`` (ROADMAP C24: not read), and beam 1 (the beam, not
  greedy, as JAX): tokens identical to the JAX session's, the top-2
  n-best margin asserted.
* One accumulated clipped noam-Adam update against JAX's
  ``make_train_step``, by ``test_torch_train_step.py``'s rule.
* All 36 recipe confs with ``dec_type: transformer``: the 20 offline ones
  build on the meta device with JAX's parameter counts (the LibriSpeech
  Transformer's and its MMA variant's asserted), the 10 latency-
  controlled ones build, the 6 others raise, each with its reason;
  ``configs.librispeech_transformer_args`` and
  ``librispeech_transformer_mma_args`` equal their confs.
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

from neural_sp_tpu.models.decoders.decoding import (
    DecodeConfig as JaxDecodeConfig, Speech2TextSession as JaxSession)
from neural_sp_tpu.models.lm.rnnlm import RNNLM as JaxRNNLM
from neural_sp_tpu.models.lm.session import LMSession as JaxLMSession
from neural_sp_tpu.models.modules.multihead_attention import (
    MultiheadAttention as JaxMHA)
from neural_sp_tpu.models.modules.positional_embedding import (
    PositionalEncoding as JaxPE)
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu.parallel.mesh import make_train_step as jax_make_step
from neural_sp_tpu.trainers.lr_scheduler import (
    noam_schedule as jax_noam_schedule)
from neural_sp_tpu.trainers.optimizer import (
    build_optimizer as jax_build_optimizer)
from neural_sp_tpu_torch.bin.args import parse_args_train
from neural_sp_tpu_torch.configs import (
    librispeech_transformer_args, librispeech_transformer_mma_args)
from neural_sp_tpu_torch.models.decoders.decoding import (
    DecodeConfig, Speech2TextSession)
from neural_sp_tpu_torch.models.decoders.transformer import (
    TransformerDecoder)
from neural_sp_tpu_torch.models.lm.rnnlm import RNNLM
from neural_sp_tpu_torch.models.lm.session import LMSession
from neural_sp_tpu_torch.models.modules.multihead_attention import (
    MultiheadAttention)
from neural_sp_tpu_torch.models.modules.positional_embedding import (
    PositionalEncoding)
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.parallel.mesh import make_train_step
from neural_sp_tpu_torch.trainers.lr_scheduler import noam_schedule
from neural_sp_tpu_torch.trainers.optimizer import build_optimizer
from neural_sp_tpu_torch.utils.convert_params import convert_params

from test_torch_train_step import _moments

ATOL = RTOL = 2e-4
MARGIN = 1e-3
ROOT = Path(__file__).resolve().parents[1]
LIBRISPEECH = "librispeech/conf/asr/transformer/transformer.yaml"
LIBRISPEECH_MMA = ("librispeech/conf/asr/mma/offline/"
                   "transformer_mma_subsample8_ma4H_ca4H_w16_from4L.yaml")
# the offline recipe confs this slice builds: 15 plain ...
PLAIN_CONFS = (
    "aishell/conf/asr/transformer.yaml",
    "aishell/conf/asr/transformer_hie_subsample8.yaml",
    "ami/conf/asr/transformer.yaml",
    "csj/conf/asr/transformer/transformer.yaml",
    "csj/conf/asr/transformer/transformer_hie_subsample8.yaml",
    LIBRISPEECH,
    "librispeech/conf/asr/transformer/transformer_512dmodel_8H.yaml",
    "librispeech/conf/asr/transformer/transformer_768dmodel_3072dff_8H.yaml",
    "librispeech/conf/asr/transformer/transformer_subsample8.yaml",
    "librispeech/conf/asr/transformer/"
    "transformer_subsample8_512dmodel_8H.yaml",
    "librispeech/conf/asr/transformer/"
    "transformer_subsample8_768dmodel_3072dff_8H.yaml",
    "swbd/conf/asr/transformer.yaml",
    "swbd/conf/asr/transformer_fisher_swbd.yaml",
    "tedlium/conf/asr/transformer/transformer_hie_subsample8.yaml",
    "wsj/conf/asr/transformer.yaml")
# ... and 5 with MMA from decoder layer 4
MMA_CONFS = (
    "aishell/conf/asr/mma/"
    "transformer_mma_hie_subsample8_ma4H_ca4H_w16_from4L.yaml",
    LIBRISPEECH_MMA,
    "librispeech/conf/asr/mma/offline/"
    "transformer_mma_subsample8_ma4H_ca4H_w16_from4L_512dmodel_8H.yaml",
    "librispeech/conf/asr/mma/offline/"
    "transformer_mma_subsample8_ma4H_ca4H_w16_from4L_768dmodel_3072dff_8H"
    ".yaml",
    "tedlium/conf/asr/mma/offline/"
    "transformer_mma_subsample8_ma4H_ca4H_w16_from4L.yaml")
# the 10 latency-controlled (streaming) Transformer-MMA confs build too
# (tests/test_torch_uni_conformer.py holds their counts); so do the other
# 6, the ci_test confs, since their attention dropout is ported (their MTL
# sub-tasks and input dropout were before), at JAX's parameter counts
# (``jax.eval_shape`` of JAX's model at vocab 10,000)
CI_COUNTS = {"blstm_transformer": 374104, "conformer": 301328,
             "lc_transformer_mma_ma4H_ca4H_w16_from4L_64_128_64": 547016,
             "transformer": 300464, "transformer_2mtl": 560648,
             "transformer_ctc": 124152}


def _tree(params):
    return jax.tree.map(np.asarray, params)


def _close(got, want, err_msg="", rel=RTOL):
    """|got - want| <= rel * max|want| (at least rel * 1e-6)."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0,
        atol=rel * max(float(np.abs(want).max()), 1e-6), err_msg=err_msg)


def _perturbed(params, scale, seed=5):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: np.asarray(x) + scale * rng.randn(
        *x.shape).astype(np.float32), params)


# ------------------------------------------------------------------ modules
@pytest.mark.parametrize("pe_type", ["add", "none", "1dconv3L"])
def test_positional_encoding_matches_jax(pe_type):
    x = np.random.RandomState(0).randn(2, 9, 12).astype(np.float32)
    pe = PositionalEncoding(12, pe_type)
    jpe = JaxPE(12, pe_type)
    for offset in (0, 7):
        want = jpe.apply({}, jnp.asarray(x), offset)
        got = pe(torch.from_numpy(x), offset)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=RTOL)
    if pe_type != "add":        # only the scale (C21 for "1dconv3L")
        np.testing.assert_allclose(got.numpy(), x * math.sqrt(12),
                                   rtol=1e-6)


MHA_CASES = ("full_mask2", "full_mask3", "cached", "append")


@pytest.mark.parametrize("case", MHA_CASES)
def test_multihead_attention_matches_jax(case):
    rng = np.random.RandomState(1)
    d, h, b = 16, 4, 3
    q = rng.randn(b, 5, d).astype(np.float32)
    kv = rng.randn(b, 7, d).astype(np.float32)
    jm = JaxMHA(d_model=d, n_heads=h)
    params = _tree(jm.init(jax.random.PRNGKey(2), jnp.asarray(q),
                           jnp.asarray(kv), jnp.asarray(kv))["params"])
    m = MultiheadAttention(d, h)
    m.load_state_dict(convert_params(params), strict=True)
    klens = np.array([7, 4, 1])
    mask2 = np.arange(7)[None] < klens[:, None]                 # [B, Tk]
    cache = {"k": rng.randn(b, 6, h, d // h).astype(np.float32),
             "v": rng.randn(b, 6, h, d // h).astype(np.float32)}
    if case == "full_mask2":
        args, kw = (q, kv), dict(mask=mask2)
    elif case == "full_mask3":   # the decoder's causal mask, [1, Tq, Tk]
        args = (q, q)
        kw = dict(mask=np.tril(np.ones((5, 5), bool))[None])
    elif case == "cached":       # the source attention at decode
        args, kw = (q, None), dict(mask=np.ones((b, 6), bool), cache=cache)
    else:                        # incremental self-attention
        args, kw = (q[:, :1], q[:, :1]), dict(cache=cache)

    def jax_args(x):
        return None if x is None else jnp.asarray(x)

    # the keys are the values at every caller (JAX's value=None)
    want, wcache, waws = jm.apply(
        {"params": params}, *map(jax_args, args),
        **{k: jax.tree.map(jnp.asarray, v) for k, v in kw.items()},
        return_weights=True)
    targs = [None if x is None else torch.from_numpy(x) for x in args]
    tkw = {k: jax.tree.map(torch.from_numpy, v) for k, v in kw.items()}
    got, gcache = m(*targs, **tkw)
    # the weights from the module's parts: its query projection and the
    # keys it attended (the returned cache)
    tq_ = targs[0].shape[1]
    gaws = m.weights(m.w_query(targs[0]).view(b, tq_, h, d // h),
                     gcache["k"], tkw.get("mask"))
    _close(got.detach().numpy(), want, case)
    _close(gaws.detach().numpy(), waws, case)
    for k in ("k", "v"):
        _close(gcache[k].detach().numpy(), wcache[k], case)
    if case == "append":
        assert gcache["k"].shape == (b, 7, h, d // h)


# ------------------------------------------------------------ whole models
def small_transformer(**over):
    """The LibriSpeech Transformer with its widths cut: one pooling block,
    2 encoder blocks d 32 / 4 heads / d_ff 64, 2 decoder blocks d 24 (a
    bridge) / 4 heads / d_ff 48, vocab 50, CTC fc 16; dropout and
    SpecAugment off."""
    args = vars(librispeech_transformer_args())
    args.update(input_dim=20, conv_channels="4", conv_kernel_sizes="(3,3)",
                conv_poolings="(2,2)", enc_n_layers=2,
                transformer_enc_d_model=32, transformer_enc_d_ff=64,
                dec_n_layers=2, transformer_dec_d_model=24,
                transformer_dec_d_ff=48, vocab=50, ctc_fc_list="16",
                dropout_enc=0.0, dropout_dec=0.0, dropout_emb=0.0,
                n_freq_masks=0, n_time_masks=0)
    args.update(over)
    return SimpleNamespace(**args)


def batch(seed=0, bs=3, t=40):
    rng = np.random.RandomState(seed)
    xs = rng.randn(bs, t, 20).astype(np.float32)
    xlens = np.array([t, t - 11, t - 23][:bs], np.int32)
    ylens = np.array([5, 3, 2][:bs], np.int32)
    ys = np.full((bs, 5), 3, np.int32)
    for b, u in enumerate(ylens):
        ys[b, :u] = rng.randint(4, 50, u)
    return xs, xlens, ys, ylens


_INIT = {}   # seed -> JAX params: pe types and subsampling change no shape


def models(seed=0, **over):
    args = small_transformer(**over)
    jm = jax_build(args)
    if seed not in _INIT:
        _INIT[seed] = _tree(jax.jit(jm.init)(
            jax.random.PRNGKey(seed), *map(jnp.asarray, batch()))["params"])
    params = _INIT[seed]
    tm = build_speech2text(args, device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    return jm, params, tm


def test_transformer_encoder_matches_jax():
    """pe none with the interlayer drop (the loss test's model has the
    sinusoid and max_pool)."""
    case = "none_drop"
    jm, params, tm = models(subsample="1_2", subsample_type="drop")
    xs, xlens = batch(3)[:2]
    want = jax.jit(lambda p, x, xl: jm.apply(
        {"params": p}, x, xl, method=jm.encode)[0]["ys"])(
        params, jnp.asarray(xs), jnp.asarray(xlens))
    with torch.no_grad():
        got = tm.eval().encode(torch.from_numpy(xs),
                               torch.from_numpy(xlens))[0]["ys"]
    np.testing.assert_array_equal(got["xlens"].numpy(),
                                  np.asarray(want["xlens"]))
    assert got["xs"].shape[1] == 10
    _close(got["xs"].numpy(), want["xs"], case)


def test_transformer_loss_and_grads_match_jax():
    """A bridge (decoder d 24, encoder 32), the MMA confs' dropout_head
    (C23), the sinusoid in both and the interlayer max_pool."""
    jm, params, tm = models(dropout_head=0.5, transformer_enc_pe_type="add",
                            transformer_dec_pe_type="add", subsample="1_2",
                            subsample_type="max_pool")
    assert tm.dec_fwd.bridge is not None
    b = batch(1)

    def jloss(p):
        return jm.apply({"params": p}, *map(jnp.asarray, b),
                        deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(1),
                              "specaug": jax.random.PRNGKey(2)})

    (want, jobs), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    loss, obs = tm.train()(*map(torch.from_numpy, b),
                           torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=RTOL)
    for name in ("loss_ctc", "loss_att", "acc_att", "ppl_att"):
        np.testing.assert_allclose(float(obs[name].detach()),
                                   float(jobs[name]), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    assert_grads_close(tm, grads)


def assert_grads_close(tm, grads):
    """Each leaf to RTOL of its own max; an attention key bias, whose
    gradient is zero in exact arithmetic (the softmax's shift invariance),
    to 1e-5 of the largest gradient (both sides hold rounding only)."""
    want_g = convert_params(_tree(grads))
    assert set(want_g) == {n for n, _ in tm.named_parameters()}
    floor = 1e-5 * max(float(g.abs().max()) for g in want_g.values())
    for name, p in tm.named_parameters():
        if name.endswith("w_key.bias"):
            np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                       rtol=0, atol=floor, err_msg=name)
        else:
            _close(p.grad.numpy(), want_g[name].numpy(), name)


def test_sequence_log_prob_and_decode_steps_match_jax():
    """``sequence_log_prob`` and a chain of 4 ``decode_step``s (the
    sinusoid added at each step's offset) against JAX's, and the chain's
    logits against the teacher-forced forward's on the same tokens."""
    jm, params, tm = models(transformer_dec_pe_type="add")
    params = _perturbed(params, 0.3)
    tm.load_state_dict(convert_params(params), strict=True)
    tm.eval()
    xs, xlens, ys, ylens = batch(4)
    n_steps = 4
    toks = np.random.RandomState(9).randint(4, 50, (3, n_steps))
    toks[:, 0] = 2                                   # <eos> as <sos>

    @jax.jit
    def jax_side(p):
        """The encoder's output, ``sequence_log_prob`` and the chain of
        decode steps' logits (unrolled: the caches grow a step each), in
        one compile."""
        def dec(method, *a):
            return jm.apply({"params": p}, *a, method=lambda m, *b: getattr(
                m.dec_fwd, method)(*b))
        e = jm.apply({"params": p}, jnp.asarray(xs), jnp.asarray(xlens),
                     method=jm.encode)[0]["ys"]
        slp = dec("sequence_log_prob", e["xs"], e["xlens"], jnp.asarray(ys),
                  jnp.asarray(ylens))
        src = dec("precompute_src", e["xs"])
        caches = dec("init_cache", 3, jnp.float32, e["xs"].shape[1])
        src_mask = (jnp.arange(e["xs"].shape[1])[None]
                    < e["xlens"][:, None])[:, None]
        lgs = []
        for i in range(n_steps):
            caches, lg = dec("decode_step", caches, src,
                             jnp.asarray(toks[:, i]), src_mask, i, e["xs"])
            lgs.append(lg)
        return e, slp, lgs

    e, want, want_lgs = jax_side(params)
    ex, el = np.asarray(e["xs"]), np.asarray(e["xlens"])
    dec: TransformerDecoder = tm.dec_fwd
    tex, tel = torch.from_numpy(ex), torch.from_numpy(el)
    with torch.no_grad():
        got = dec.sequence_log_prob(tex, tel, torch.from_numpy(ys),
                                    torch.from_numpy(ylens))
    _close(got.numpy(), want, "sequence_log_prob")

    loop = dec.decode_loop(tex, tel)
    steps = []
    with torch.no_grad():
        for i in range(n_steps):
            got_lg, _ = loop.step(torch.from_numpy(toks[:, i]))
            _close(got_lg.numpy(), want_lgs[i], f"step {i}")
            steps.append(got_lg)
        # the teacher-forced pass over the same tokens
        h, _ = dec._hidden(tex, tel, torch.from_numpy(toks), None, "hard")
        tf = dec.output(dec.norm_out(h))
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), tf.numpy(),
                               atol=1e-5 * float(tf.abs().max()), rtol=0)


VOCAB = 50
LM_OPTS = dict(n_units=24, n_layers=2, emb_dim=24, tie_embedding=True,
               residual=True, use_glu=True)
BEAM_CASES = {
    "beam10_ctc_lm_length_norm": dict(beam_width=10, ctc_weight=0.3,
                                      lm_weight=0.5, length_norm=True),
    "beam10_ctc_ilm": dict(beam_width=10, ctc_weight=0.3, ilm_weight=0.3),
    "beam1": dict(beam_width=1),
}


@pytest.fixture(scope="module")
def served():
    """The perturbed small model in both packages, the small RNNLM, one
    JAX session whose compiled steps every case reuses."""
    jm, params, tm = models(transformer_dec_pe_type="add")
    params = _perturbed(params, 0.3)
    tm.load_state_dict(convert_params(params), strict=True)
    jlm = JaxRNNLM(vocab=VOCAB, **LM_OPTS)
    y = jnp.ones((1, 3), jnp.int32)
    lm_params = jlm.init(jax.random.PRNGKey(1), y, y)["params"]
    tlm = RNNLM(vocab=VOCAB, device="cpu", **LM_OPTS)
    tlm.load_state_dict(convert_params(_tree(lm_params)), strict=True)
    jsess = JaxSession(jm, params, JaxDecodeConfig(),
                       lm_session=JaxLMSession(jlm, lm_params))
    return jsess, tm.eval(), LMSession(tlm.eval())


@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_transformer_beam_matches_jax(served, case):
    jsess, tm, lm = served
    conf = dict(BEAM_CASES[case], n_best=2, max_len_ratio=0.5)
    jsess.conf = JaxDecodeConfig(**conf)
    tsess = Speech2TextSession(tm, DecodeConfig(**conf), lm_session=lm)
    xs, xlens = batch(6)[:2]
    for b in range(2):
        want = jsess.decode(xs[b:b + 1], xlens[b:b + 1])
        got = tsess.decode(xs[b:b + 1], xlens[b:b + 1])
        assert got == want, (case, b)
        assert len(got[0]) > 0, got
        if conf["beam_width"] > 1:
            sc = tsess._last_nbest_scores
            assert sc[0] - sc[1] > MARGIN, sc
        if case == "beam10_ctc_ilm":     # C24: as without the ILM
            plain = Speech2TextSession(tm, DecodeConfig(
                beam_width=10, ctc_weight=0.3, n_best=2, max_len_ratio=0.5))
            assert plain.decode(xs[b:b + 1], xlens[b:b + 1]) == got
            assert plain._last_nbest_scores == tsess._last_nbest_scores


def test_transformer_accumulated_noam_update_matches_jax():
    """Two microbatches, noam-Adam with k = 2 accumulation and clip 0.5
    (active): the metrics of each microstep and the update, by
    test_torch_train_step.py's rule."""
    clip, k = 0.5, 2
    jm, params, tm = models()
    params0 = convert_params(params)
    lr = float(jax_noam_schedule(32, 10, factor=5.0)(0))
    assert lr == pytest.approx(float(noam_schedule(32, 10, factor=5.0)(0)))
    tx = jax_build_optimizer("noam", lr=1.0, clip_grad_norm=clip,
                             schedule=jax_noam_schedule(32, 10, factor=5.0),
                             accum_grad_n_steps=k)
    jstep = jax_make_step(jm, tx, donate=False)
    opt_state = tx.init(params)
    step = make_train_step(tm.train(), build_optimizer(
        "noam", lr=1.0, clip_grad_norm=clip,
        schedule=noam_schedule(32, 10, factor=5.0), accum_grad_n_steps=k))
    for i, b in enumerate((batch(10), batch(11))):
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
        m = np.abs(mu[name].numpy())
        sure = (m > 1e-3 * m.max()) & (m > mu_floor)
        np.testing.assert_allclose(got_u[sure], want_u[sure], rtol=0,
                                   atol=1e-3 * lr, err_msg=name)
        assert np.abs(got_u).max() <= lr * (1 + 1e-5) + \
            float(np.spacing(np.abs(p0.numpy())).max())
        n_sure += int(sure.sum())
        n_all += sure.size
    assert n_sure > 0.8 * n_all, (n_sure, n_all)


# ---------------------------------------------------------------- the confs
_JAX_COUNTS = {}


# the fields that shape the parameters (pe types, subsampling, dropout and
# the losses' weights shape none)
_SHAPING = ("conv_channels", "conv_kernel_sizes", "conv_poolings",
            "transformer_enc_d_model", "transformer_enc_d_ff",
            "enc_n_layers", "transformer_dec_d_model", "transformer_dec_d_ff",
            "dec_n_layers", "mocha_first_layer", "mocha_n_heads_mono",
            "mocha_n_heads_chunk", "mocha_chunk_size",
            "share_chunkwise_attention", "ctc_fc_list")


def _jax_count(args):
    key = tuple(str(getattr(args, k, None)) for k in _SHAPING)
    if key not in _JAX_COUNTS:
        jm = jax_build(args)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 16, 80)), jnp.array([16]),
            jnp.ones((1, 3), jnp.int32), jnp.array([3])))
        _JAX_COUNTS[key] = sum(math.prod(x.shape)
                               for x in jax.tree.leaves(shapes["params"]))
    return _JAX_COUNTS[key]


def _conf_args(conf):
    args = parse_args_train(["--config", str(ROOT / "examples" / conf)])
    args.vocab = 10000
    return args


@pytest.mark.parametrize("conf", PLAIN_CONFS + MMA_CONFS)
def test_transformer_recipe_conf_builds(conf):
    args = _conf_args(conf)
    with torch.device("meta"):     # no host initialisation to discard
        model = build_speech2text(args, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert isinstance(model.dec_fwd, TransformerDecoder)
    assert any(b.mma for b in model.dec_fwd.blocks) == (conf in MMA_CONFS)
    assert n == _jax_count(args)
    if conf == LIBRISPEECH:
        assert n == 35838144
    if conf == LIBRISPEECH_MMA:
        assert n == 35576204


def _transformer_confs():
    out = subprocess.run(["grep", "-rl", "dec_type: transformer",
                          str(ROOT / "examples")], capture_output=True,
                         text=True, check=True).stdout.split()
    return sorted(str(Path(p).relative_to(ROOT / "examples")) for p in out
                  if "/conf/asr/" in p)


def test_the_other_transformer_confs_raise():
    confs = _transformer_confs()
    assert len(confs) == 36
    assert set(PLAIN_CONFS + MMA_CONFS) <= set(confs)
    lc = [c for c in confs if "lc_transformer" in c and "ci_test" not in c]
    assert len(lc) == 10
    for conf in lc:
        build_speech2text(_conf_args(conf), device="meta")
    others = [c for c in confs if c not in PLAIN_CONFS + MMA_CONFS + tuple(lc)]
    assert len(others) == 6
    assert {Path(c).stem for c in others} == set(CI_COUNTS)
    for conf in others:
        model = build_speech2text(_conf_args(conf), device="meta")
        n = sum(p.numel() for p in model.parameters())
        assert n == CI_COUNTS[Path(conf).stem], conf


@pytest.mark.parametrize("conf, make", [
    (LIBRISPEECH, librispeech_transformer_args),
    (LIBRISPEECH_MMA, librispeech_transformer_mma_args)])
def test_librispeech_transformer_args_equal_the_conf(conf, make):
    full = vars(parse_args_train(["--config", str(ROOT / "examples" / conf)]))
    args = vars(make())
    assert args.pop("vocab") == 10000
    assert args == {k: full[k] for k in args}
    assert full.get("train_dtype") == "float32"
