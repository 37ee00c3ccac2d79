"""Port parity: the latency-controlled BLSTM (``models/encoders/rnn.py::
LCBLSTMLayer``, ``RNNEncoder`` with ``chunk_size_current``) and the RNN
encoders' streaming (``stream_geometry``, ``streaming_step``,
``Speech2TextSession.decode_streaming`` with an RNN encoder), against the
JAX package on the same numpy inputs with the JAX weights converted
(``convert_params``), float32, atol = rtol = 2e-4 (the repo's).

* ``LCBLSTMLayer``: chunked (a chunk that does not divide T) and
  ``single_chunk``, ragged lengths with a row of 1 and a batch padded past
  its longest row, with an initial carry: every frame (those past a row's
  length are JAX's too: the next layer's last window reads them), the
  forward direction's carry at each row's length, and the gradients of
  the input and of every weight against ``jax.grad``; and the layer
  (cuDNN's ``torch.lstm`` on CPU) against its written-out loops
  (``forward_ref``).
* ``RNNEncoder`` in LC mode: a conv front end, 3 layers with an interlayer
  subsample (1, 2, 1) that shrinks the chunk, projections and a bridge,
  against JAX; ``streaming_step`` chains (LC with lookahead, and the
  unidirectional LSTM) with their carries, block by block, against JAX's.
  JAX's RNN encoder cannot stream with a conv front end (its
  ``conv_factor`` builds a ``ConvEncoder`` outside ``setup``, which flax
  refuses: ROADMAP C31); the chains patch that property to the front end's
  factor on the JAX side.
* ``decode_streaming`` tokens of an LC-BLSTM-CTC model (the CTC
  block-synchronous beam), with and without a forced CTC-VAD reset (the
  carry restarts, warmed on the previous block), and C30: an LC-BLSTM
  encoder with a MoChA decoder streams through the CTC beam, as JAX's
  dispatch does (upstream streams it through MoChA).
* The recipe confs with an LC-BLSTM encoder and a LAS or MoChA decoder
  build on the meta device at JAX's parameter counts, their chunk read from
  ``lc_chunk_size_left`` (C13, not mirrored: JAX builds them full-context,
  and the counts do not depend on the chunk).

The JAX side is jitted, one compile per chain.
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
from neural_sp_tpu.models.encoders.conv import (
    parse_cnn_config as jax_parse_cnn_config)
from neural_sp_tpu.models.encoders.rnn import (
    LCBLSTMLayer as JaxLCBLSTMLayer, RNNEncoder as JaxRNNEncoder)
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu_torch.bin.args import parse_args_train
from neural_sp_tpu_torch.frontends import streaming as torch_streaming
from neural_sp_tpu_torch.frontends.streaming import StreamingDriver
from neural_sp_tpu_torch.models.decoders.decoding import (
    DecodeConfig, Speech2TextSession)
from neural_sp_tpu_torch.models.encoders.rnn import LCBLSTMLayer, RNNEncoder
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.utils.convert_params import convert_params

ATOL = RTOL = 2e-4
ROOT = Path(__file__).resolve().parents[1]
IN, H = 6, 8


def _tree(params):
    return jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------- the layer
def _layer(n_c=4, n_r=3, merge="sum"):
    jl = JaxLCBLSTMLayer(H, "lstm", n_c, n_r, merge=merge)
    v = jax.jit(jl.init)(jax.random.PRNGKey(0), jnp.zeros((2, 9, IN)),
                         jnp.array([9, 4]))
    params = _tree(v["params"])
    tl = LCBLSTMLayer(IN, H, n_c, n_r, merge)
    tl.load_state_dict(convert_params(params), strict=True)
    return jl, params, tl


@pytest.mark.parametrize("single_chunk,merge", [
    (False, "sum"), (False, "concat"), (True, "sum")])
def test_lc_blstm_layer_matches_jax(single_chunk, merge):
    """T 11 (chunk 4: not a divisor), lengths (9, 1, 6, 8) in a batch
    padded past its longest row, an initial carry: every frame, the carry
    and the gradients."""
    jl, params, tl = _layer(merge=merge)
    rng = np.random.RandomState(1)
    t, xlens = 11, np.array([9, 1, 6, 8])          # padded past the longest
    xs = rng.randn(4, t, IN).astype(np.float32)
    carry = (rng.randn(4, H).astype(np.float32),
             rng.randn(4, H).astype(np.float32))
    out_w = rng.randn(4, t, 2 * H if merge == "concat" else H).astype(
        np.float32)
    carry_w = rng.randn(2, 4, H).astype(np.float32)

    def objective(ys, c, conv):
        return (ys * conv(out_w)).sum() + (c[0] * conv(carry_w[0])).sum() \
            + (c[1] * conv(carry_w[1])).sum()

    def jloss(p, x):
        ys, c = jl.apply({"params": p}, x, jnp.asarray(xlens),
                         tuple(map(jnp.asarray, carry)),
                         single_chunk=single_chunk)
        return objective(ys, c, jnp.asarray), (ys, c)

    (_, (jys, jc)), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(xs))
    x = torch.from_numpy(xs).requires_grad_()
    ys, c = tl(x, torch.from_numpy(xlens),
               tuple(map(torch.from_numpy, carry)), single_chunk=single_chunk)
    objective(ys, c, torch.from_numpy).backward()
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(jys),
                               atol=ATOL, rtol=RTOL)
    for got, want in zip(c, jc):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)
    gx = np.asarray(gx)
    np.testing.assert_allclose(x.grad.numpy(), gx, rtol=0,
                               atol=RTOL * np.abs(gx).max())
    want = convert_params(_tree(gp))
    assert set(want) == {n for n, _ in tl.named_parameters()}
    for name, p in tl.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=RTOL * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("single_chunk", [False, True])
def test_lc_blstm_layer_matches_its_loop(single_chunk):
    """The layer against its plain version: outputs, carries (lengths 0
    and T+ take the final carry, as flax's clipped gather) and the
    gradients."""
    _, _, tl = _layer(n_c=3, n_r=2)
    rng = np.random.RandomState(3)
    xs = torch.from_numpy(rng.randn(4, 10, IN).astype(np.float32))
    carry = (torch.randn(4, H), torch.randn(4, H))
    for lens in (torch.tensor([10, 1, 0, 7]), torch.tensor([12, 3, 3, 3]),
                 None):
        got = tl(xs, lens, carry, single_chunk=single_chunk)
        want = tl.forward_ref(xs, lens, carry, single_chunk=single_chunk)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    grads = []
    for fn in (tl, tl.forward_ref):
        x = xs.clone().requires_grad_()
        tl.zero_grad()
        ys, (c, h) = fn(x, torch.tensor([10, 1, 5, 7]),
                        single_chunk=single_chunk)
        ((ys * torch.linspace(-1, 1, ys.shape[-1])).sum() + c.sum()
         - 2 * h.sum()).backward()
        grads.append([x.grad] + [p.grad.clone() for p in tl.parameters()])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


# -------------------------------------------------------------- the encoder
ENC = dict(input_dim=10, n_units=16, n_projs=12, last_proj_dim=20,
           n_layers=3, subsample=(1, 2, 1), subsample_type="drop",
           conv_channels="4", conv_kernel_sizes="(3,3)",
           conv_poolings="(2,2)")


def _encoders(**over):
    kw = {**ENC, **over}
    je = JaxRNNEncoder(**kw)
    params = _tree(jax.jit(je.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 40, kw["input_dim"])),
        jnp.array([40, 21]))["params"])
    te = RNNEncoder(**kw)
    te.load_state_dict(convert_params(params), strict=True)
    return je, params, te.eval()


def test_lc_encoder_matches_jax():
    """LC mode (chunk 6 / 3 over the x2 front end's frames, halved after
    layer 1), sum of the directions; every frame, a row of length 1."""
    je, params, te = _encoders(rnn_type="blstm", bidir_sum_fwd_bwd=True,
                               chunk_size_current=6, chunk_size_right=3)
    assert te.lc and [r.n_current for r in te.rnns] == [6, 6, 3]
    rng = np.random.RandomState(4)
    xs = rng.randn(3, 47, 10).astype(np.float32)
    xlens = np.array([47, 20, 1], np.int32)
    want, _ = jax.jit(je.apply)({"params": params}, jnp.asarray(xs),
                                jnp.asarray(xlens))
    with torch.no_grad():
        got = te(torch.from_numpy(xs), torch.from_numpy(xlens))
    np.testing.assert_array_equal(got["ys"]["xlens"].numpy(),
                                  np.asarray(want["ys"]["xlens"]))
    np.testing.assert_allclose(got["ys"]["xs"].numpy(),
                               np.asarray(want["ys"]["xs"]), atol=ATOL,
                               rtol=RTOL)


def _conv_factor(self):
    """The conv front end's factor, as JAX's property would give it (C31)."""
    cfg = jax_parse_cnn_config(self.conv_channels, self.conv_kernel_sizes,
                               self.conv_strides, self.conv_poolings)
    return math.prod(st * max(pt, 1)
                     for (st, _), (pt, _) in zip(cfg.strides, cfg.poolings))


@pytest.mark.parametrize("rnn_type,chunks", [
    ("blstm", dict(chunk_size_current=6, chunk_size_right=3)),
    ("lstm", {})])
def test_streaming_step_chain_matches_jax(monkeypatch, rnn_type, chunks):
    """A 190-frame utterance fed block by block (``StreamingDriver``, the
    conv front end's left context) through ``streaming_step``, the carries
    chained from None: every block's output and carry against JAX's, and
    the geometry."""
    monkeypatch.setattr(JaxRNNEncoder, "conv_factor", property(_conv_factor))
    je, params, te = _encoders(rnn_type=rnn_type, bidir_sum_fwd_bwd=True,
                               **chunks)
    geometry = jax.jit(lambda p: je.apply({"params": p}, method=lambda m: (
        m.stream_geometry(), m.block_input_frames())))
    geo, frames = te.stream_geometry(), te.block_input_frames()
    assert (geo, frames) == tuple(tuple(map(int, g)) for g in
                                  geometry(params))
    step = jax.jit(lambda p, xb, c: je.apply({"params": p}, xb, c,
                                             method=je.streaming_step))
    first = jax.jit(lambda p, xb: je.apply({"params": p}, xb, None,
                                           method=je.streaming_step))
    x = np.random.RandomState(5).randn(190, 10).astype(np.float32)
    jc = tc = None
    n_blocks = 0
    for blk, _, _ in StreamingDriver(x, *frames, geo[1]):
        jy, jc = (first(params, jnp.asarray(blk)[None]) if jc is None else
                  step(params, jnp.asarray(blk)[None], jc))
        with torch.no_grad():
            ty, tc = te.streaming_step(torch.from_numpy(blk)[None], tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                                   rtol=RTOL)
        for got, want in zip(jax.tree.leaves(
                jax.tree.map(lambda z: z.numpy(), tc)), jax.tree.leaves(jc)):
            np.testing.assert_allclose(got, np.asarray(want), atol=ATOL,
                                       rtol=RTOL)
        n_blocks += 1
    assert n_blocks >= 3


# --------------------------------------------------- decode_streaming
def small_lc(dec="ctc", **over):
    """A small LC-BLSTM model without a front end (JAX's streaming needs
    none, C31): 2 layers of 16 units summed, chunk 8 / 4, vocab 20; CTC
    alone, or a MoChA LAS decoder with CTC 0.3."""
    kw = dict(enc_type="blstm", input_dim=12, enc_n_layers=2,
              enc_n_units=16, bidirectional_sum_fwd_bwd=True,
              lc_chunk_size_current=8, lc_chunk_size_right=4, vocab=20,
              ctc_weight=1.0, dec_type="lstm", dropout_enc=0.0,
              dropout_dec=0.0, dropout_emb=0.0)
    if dec == "mocha":
        kw.update(ctc_weight=0.3, dec_n_units=24, emb_dim=8,
                  dec_bottleneck_dim=24, attn_type="mocha", attn_dim=12,
                  mocha_chunk_size=2, mocha_init_r=-1.0, mocha_std=0.0)
    kw.update(over)
    return SimpleNamespace(**kw)


def _models(args, seed=0, scale=0.7):
    """Both packages' models on one set of weights: JAX's init moved by
    seeded noise of ``scale`` (so the hypotheses are not empty)."""
    jm = jax_build(args)
    rng = np.random.RandomState(seed)
    batch = (jnp.zeros((2, 24, args.input_dim)), jnp.array([24, 20]),
             jnp.full((2, 3), 5, jnp.int32), jnp.array([3, 2]))
    params = jax.tree.map(
        lambda x: np.asarray(x) + scale * rng.randn(*x.shape).astype(
            np.float32),
        _tree(jax.jit(jm.init)(jax.random.PRNGKey(seed), *batch)["params"]))
    tm = build_speech2text(args, device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    return jm, params, tm.eval()


def _fire_on(monkeypatch, call: int):
    """CtcVAD.step of both packages fires on its ``call``-th call only."""
    calls = {"jax": 0, "torch": 0}

    def patched(pkg):
        def step(self, ids, probs, n_new):
            calls[pkg] += 1
            return calls[pkg] == call
        return step

    monkeypatch.setattr(jax_streaming.CtcVAD, "step", patched("jax"))
    monkeypatch.setattr(torch_streaming.CtcVAD, "step", patched("torch"))


def test_decode_streaming_lc_blstm_ctc_matches_jax(monkeypatch):
    """The CTC block-synchronous beam 4 over an LC-BLSTM, block by block:
    the tokens, then again with a CTC-VAD reset forced at the second block
    (the beam commits its best, the carry restarts and is warmed on the
    previous block): the tokens and the commit."""
    jm, params, tm = _models(small_lc())
    x = np.random.RandomState(6).randn(150, 12).astype(np.float32)
    jsess = JaxSession(jm, params, JaxDecodeConfig(beam_width=4))
    tsess = Speech2TextSession(tm, DecodeConfig(beam_width=4))
    want, jstats = jsess.decode_streaming(x)
    got, stats = tsess.decode_streaming(x)
    assert got == want and len(got) > 2
    assert stats["n_frames"] == jstats["n_frames"] == 150
    _fire_on(monkeypatch, 2)
    want, jstats = jsess.decode_streaming(x)
    got, stats = tsess.decode_streaming(x)
    assert stats["n_resets"] == jstats["n_resets"] == 1
    assert stats["commits"] == jstats["commits"]
    assert got == want


def test_c30_rnn_encoder_with_mocha_streams_through_the_ctc_beam():
    """C30 (mirrored): with an RNN encoder JAX's ``decode_streaming`` takes
    the CTC block-synchronous beam for a MoChA decoder (the MoChA beam only
    with a transformer / conformer encoder; upstream streams the
    lcblstm_mocha confs through MoChA). The port's tokens equal JAX's and
    its MoChA streaming beam does not run."""
    jm, params, tm = _models(small_lc("mocha"))
    x = np.random.RandomState(7).randn(120, 12).astype(np.float32)
    conf = dict(beam_width=4, ctc_weight=0.3)
    want, _ = JaxSession(jm, params, JaxDecodeConfig(**conf)) \
        .decode_streaming(x)
    tsess = Speech2TextSession(tm, DecodeConfig(**conf))
    tsess.decode_streaming_attention = None     # must not be reached
    got, stats = tsess.decode_streaming(x)
    assert got == want and len(got) > 2
    assert "boundaries" not in stats


# ---------------------------------------------------------------- the confs
def _lc_confs():
    """The recipe confs with an LC-BLSTM encoder and a LAS or MoChA decoder
    that no other option blocks."""
    out = subprocess.run(["grep", "-rl", "lc_chunk_size_left: [1-9]",
                          str(ROOT / "examples")], capture_output=True,
                         text=True, check=True).stdout.split()
    confs = []
    for p in sorted(out):
        args = parse_args_train(["--config", p])
        if "blstm" not in args.enc_type or "transducer" in args.dec_type:
            continue
        if any(k in p for k in ("decot", "minlt", "_mbr")):
            continue
        confs.append(str(Path(p).relative_to(ROOT / "examples")))
    return confs


LC_CONFS = _lc_confs()
_JAX_COUNTS = {}


def _jax_count(args):
    key = (args.enc_type, args.enc_n_units, args.enc_n_layers,
           args.dec_n_units, getattr(args, "attn_type", ""),
           getattr(args, "attn_dim", 0), getattr(args, "dec_bottleneck_dim",
                                                 0))
    if key not in _JAX_COUNTS:
        factors = str(getattr(args, "subsample", "") or "1").split("_")
        # the JAX encoder indexes a factor per layer (ROADMAP C19)
        full = SimpleNamespace(**{**vars(args), "subsample": "_".join(
            factors + ["1"] * (args.enc_n_layers - len(factors)))})
        jm = jax_build(full)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 80)), jnp.array([64]),
            jnp.ones((1, 3), jnp.int32), jnp.array([3])))
        _JAX_COUNTS[key] = sum(math.prod(x.shape)
                               for x in jax.tree.leaves(shapes["params"]))
    return _JAX_COUNTS[key]


def test_lc_confs_are_the_recipes():
    assert len(LC_CONFS) == 20     # 5 lcblstm_las and 15 lcblstm_mocha


@pytest.mark.parametrize("conf", LC_CONFS)
def test_lc_blstm_conf_builds(conf):
    args = parse_args_train(["--config", str(ROOT / "examples" / conf)])
    args.vocab = 10000
    model = build_speech2text(args, device="meta")
    enc = model.encoder
    assert enc.lc and enc.chunk_size_current == args.lc_chunk_size_left
    assert enc.rnns[0].n_right == args.lc_chunk_size_right
    n = sum(p.numel() for p in model.parameters())
    assert n == _jax_count(args)
