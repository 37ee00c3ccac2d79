"""Port parity: the unidirectional and latency-controlled (streaming)
transformer / conformer encoders and streaming decoding, against the JAX
package on the same numpy inputs with the JAX weights converted
(``convert_params``), float32, atol = rtol = 2e-4 (the repo's) unless a
test says otherwise.
* The masks (``make_chunkwise_san_mask``, ``causal_mask`` with an offset)
  and the chunking (``chunkwise`` / ``chunkwise_merge``) against JAX's;
  K1's window mask (``window_mask``) against the masks it replaces,
  with a chunk window that leaves pad queries no key.
* The plain versions of K1 / K1b with a window (causal, chunkwise with an
  empty-window row) and against cached keys: the written-out backward
  against autograd through the forward (1e-5 relative, float64).
* ``RelativeMultiheadAttention`` with the causal window, the chunk window
  and against a cache, and its gradients, against the JAX module and
  ``jax.grad``.
* The causal conformer convolution, offline and block by block with its
  cache (lookahead frames kept out of it), against the JAX module.
* ``XformerEncoder`` in each mode against JAX: unidirectional with an
  interlayer max_pool, clamped and unclamped; ``mask`` mode (conformer and
  transformer, causal and with lookahead); ``reshape`` mode with the conv
  frontend; ragged lengths, T not a multiple of the chunk, and a row whose
  pad queries have an empty window. ``streaming_step`` over the blocks of
  ``StreamingDriver``: outputs and every cache leaf against JAX's.
* The host copies: ``StreamingDriver``, ``CtcVAD``,
  ``ctc_reset_point_detection``, ``CTCBlockSyncBeam`` (with commits and an
  LM hook) and ``CTCPrefixScorer.register_new_chunk`` / ``extend_state``
  against their JAX originals.
* ``decode_streaming``: a small uni-Conformer-MoChA with mask-mode chunks
  (the block-synchronous MoChA beam with CTC 0.3; tokens and boundaries)
  and a small LC-Transformer-MMA (reshape mode; JAX's dispatch runs the
  CTC block-synchronous beam with CTC-VAD resets: tokens and commits),
  each without and with a small RNNLM's shallow fusion, against the JAX
  session on perturbed weights; ``eval_streaming`` against JAX's on
  replayed decodes.
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from neural_sp_tpu.frontends import streaming as jstream
from neural_sp_tpu.models.decoders import ctc as jctc
from neural_sp_tpu.models.decoders.decoding import (
    DecodeConfig as JaxDecodeConfig, Speech2TextSession as JaxSession)
from neural_sp_tpu.models.encoders import utils as jutils
from neural_sp_tpu.models.lm.rnnlm import RNNLM as JaxRNNLM
from neural_sp_tpu.models.lm.session import LMSession as JaxLMSession
from neural_sp_tpu.models.encoders.transformer import XformerEncoder as JEnc
from neural_sp_tpu.models.modules.conformer_convolution import (
    ConformerConvBlock as JConv)
from neural_sp_tpu.models.modules.relative_multihead_attention import (
    RelativeMultiheadAttention as JRelMHA)
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu.ops import masks as jmasks
from neural_sp_tpu_torch.configs import (
    librispeech_lc_transformer_mma_args, uni_conformer_mocha_streaming_args)
from neural_sp_tpu_torch.frontends import streaming as tstream
from neural_sp_tpu_torch.models.decoders import ctc as tctc
from neural_sp_tpu_torch.models.decoders.decoding import (
    DecodeConfig, Speech2TextSession)
from neural_sp_tpu_torch.models.encoders import utils as tutils
from neural_sp_tpu_torch.models.encoders.transformer import (
    XformerEncoder as TEnc)
from neural_sp_tpu_torch.models.lm.rnnlm import RNNLM
from neural_sp_tpu_torch.models.lm.session import LMSession
from neural_sp_tpu_torch.models.modules.conformer_convolution import (
    ConformerConvBlock as TConv)
from neural_sp_tpu_torch.models.modules.relative_multihead_attention import (
    RelativeMultiheadAttention as TRelMHA)
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.ops import masks as tmasks
from neural_sp_tpu_torch.ops.kernels.rel_attention import (
    key_ranges, rel_attention, rel_attention_bwd_ref, rel_attention_ref,
    rel_attention_stats_ref)
from neural_sp_tpu_torch.ops.masks import CAUSAL, window_mask
from neural_sp_tpu_torch.utils.convert_params import convert_params

ATOL = RTOL = 2e-4


def _tree(params):
    return jax.tree.map(np.asarray, params)


def _perturb(params, scale=0.05, seed=0):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: np.asarray(x) + scale * rng.randn(
        *x.shape).astype(np.float32), _tree(params))


# ------------------------------------------------------- masks, chunking
def test_masks_match_jax():
    lens = np.array([13, 9, 2])
    jpad = jmasks.make_pad_mask(jnp.asarray(lens), 13)
    tpad = tmasks.make_pad_mask(torch.from_numpy(lens), 13)
    for window in ((4, 3, 2), (-1, 5, 0), (0, 4, 1), (3, 1, 0)):
        want = jmasks.make_chunkwise_san_mask(jpad, *window)
        got = tmasks.make_chunkwise_san_mask(tpad, *window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # K1's window predicate is the same mask
        np.testing.assert_array_equal(
            window_mask(torch.from_numpy(lens), 13, 13, window).numpy(),
            np.asarray(want))
    want = jmasks.make_san_mask(jpad) & jmasks.causal_mask(13, 13)[None]
    np.testing.assert_array_equal(
        window_mask(torch.from_numpy(lens), 13, 13, CAUSAL).numpy(),
        np.asarray(want))
    np.testing.assert_array_equal(
        tmasks.causal_mask(4, 9, offset=5).numpy(),
        np.asarray(jmasks.causal_mask(4, 9, offset=5)))


def test_window_leaves_pad_queries_no_key():
    """The streaming conf's chunk window in encoder frames (16, 8, 0) at
    klen 10: pad queries from frame 32 on may attend no key (uniform
    rows), the others some."""
    (lo, hi), = key_ranges([10], 100, 100, (16, 8, 0))
    empty = hi <= lo
    assert empty[32:].all() and not empty[:32].any()


@pytest.mark.parametrize("nl,nc,nr,t", [(2, 4, 1, 13), (0, 5, 0, 10),
                                        (3, 3, 2, 1)])
def test_chunkwise_matches_jax(nl, nc, nr, t):
    x = np.random.RandomState(t).randn(2, t, 3).astype(np.float32)
    want = np.asarray(jutils.chunkwise(jnp.asarray(x), nl, nc, nr))
    got = tutils.chunkwise(torch.from_numpy(x), nl, nc, nr).numpy()
    np.testing.assert_array_equal(got, want)
    t_out = max(t - 2, 1)
    np.testing.assert_array_equal(
        tutils.chunkwise_merge(torch.from_numpy(got), 2, nl, nc, nr,
                               t_out).numpy(),
        np.asarray(jutils.chunkwise_merge(jnp.asarray(want), 2, nl, nc, nr,
                                          t_out)))


# --------------------------------------------- K1 / K1b plain, windowed
@pytest.mark.parametrize("window,klens", [
    (CAUSAL, [20, 11, 0]), ((6, 4, 0), [20, 3, 9]), ((-1, 8, 4), [20, 15, 1])])
def test_windowed_plain_backward_matches_autograd(window, klens):
    rng = np.random.RandomState(3)
    b, h, t, dk, r = 3, 2, 20, 8, 5

    def f(*shape):
        return torch.from_numpy(rng.randn(*shape)).requires_grad_()
    q, k, v, p = f(b, h, t, dk), f(b, h, t, dk), f(b, h, t, dk), f(b, h, t, r)
    kl = torch.tensor(klens, dtype=torch.int32)
    o = rel_attention_ref(q, k, v, p, kl, window)
    do = torch.from_numpy(rng.randn(b, h, t, dk))
    want = torch.autograd.grad(o, (q, k, v, p), do)
    m, l = rel_attention_stats_ref(q, k, p, kl, window)
    got = rel_attention_bwd_ref(q, k, v, p, kl, o, m, l, do, window)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-9)
    # the autograd function takes the same path on CPU tensors
    o2 = rel_attention(q, k, v, p, kl, window)
    torch.testing.assert_close(o2, o)
    if 0 in klens or window == (6, 4, 0):
        # a row with no allowed key: uniform over all T keys
        (lo, hi), = key_ranges([min(klens)], t, t, window)
        i = int(np.argmax(hi <= lo))
        bi = int(np.argmin(klens))
        torch.testing.assert_close(o[bi, :, i], v[bi].mean(1))


def test_cached_plain_forward_is_the_tail_of_a_longer_one():
    """K1 against cached keys (Tq < Tk, key_start) is the last Tq rows of
    the square call whose window masks the cache's empty slots."""
    rng = np.random.RandomState(4)
    b, h, tq, tk, dk = 2, 2, 4, 12, 8
    q = torch.from_numpy(rng.randn(b, h, tk, dk))
    k, v = (torch.from_numpy(rng.randn(b, h, tk, dk)) for _ in range(2))
    p = torch.from_numpy(rng.randn(b, h, tk, tk))
    kl = torch.full((b,), tk, dtype=torch.int32)
    got = rel_attention_ref(q[:, :, -tq:].contiguous(), k, v,
                            p[:, :, -tq:].contiguous(), kl, key_start=3)
    want = rel_attention_ref(q, k, v, p, kl, key_start=3)[:, :, -tq:]
    torch.testing.assert_close(got, want)
    with pytest.raises(NotImplementedError, match="cached keys"):
        qq = q[:, :, -tq:].clone().requires_grad_()
        rel_attention(qq, k, v, p[:, :, -tq:].contiguous(), kl,
                      key_start=3).sum().backward()


# ----------------------------------------------- relative MHA, conv module
def _rel_pair(clamp_len, d=16, h=2):
    jm = JRelMHA(d_model=d, n_heads=h, clamp_len=clamp_len, xl_like=False)
    x = jnp.zeros((2, 12, d))
    params = _perturb(jm.init(jax.random.PRNGKey(0), x)["params"], 0.1)
    tm = TRelMHA(d, h, clamp_len)
    tm.load_state_dict(convert_params(params), strict=True)
    return jm, params, tm


@pytest.mark.parametrize("clamp_len", [3, -1])
@pytest.mark.parametrize("window", [CAUSAL, (4, 4, 2), (3, 2, 0)])
def test_rel_mha_window_matches_jax_with_grads(clamp_len, window):
    jm, params, tm = _rel_pair(clamp_len)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 12, 16).astype(np.float32)
    klens = np.array([12, 5], np.int32)
    jmask = np.asarray(window_mask(torch.from_numpy(klens), 12, 12, window))
    g = rng.randn(2, 12, 16).astype(np.float32)

    def jf(p, x):
        out, _, _ = jm.apply({"params": p}, x, mask=jnp.asarray(jmask))
        return jnp.sum(out * g), out

    (_, want), (jgp, jgx) = jax.value_and_grad(jf, argnums=(0, 1),
                                              has_aux=True)(
        params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = tm(tx, torch.from_numpy(klens), window)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=ATOL,
                               rtol=RTOL)
    jg = convert_params(_tree(jgp))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[name].numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("clamp_len", [3, -1])
@pytest.mark.parametrize("cache_len", [0, 3, 6])
def test_rel_mha_cache_matches_jax(clamp_len, cache_len):
    """A streaming block of 4 queries against a 6-slot cache of which
    ``cache_len`` hold keys (JAX's ``key_valid`` mask)."""
    jm, params, tm = _rel_pair(clamp_len)
    rng = np.random.RandomState(6)
    n_l, blk = 6, 4
    x = rng.randn(1, blk, 16).astype(np.float32)
    ck, cv = (rng.randn(1, n_l, 2, 8).astype(np.float32) for _ in range(2))
    k_idx = np.arange(n_l + blk)
    mask = np.broadcast_to((k_idx >= n_l - cache_len) | (k_idx >= n_l),
                           (1, blk, n_l + blk))
    want, jkv, _ = jm.apply({"params": params}, jnp.asarray(x),
                            mask=jnp.asarray(mask),
                            cache={"k": jnp.asarray(ck),
                                   "v": jnp.asarray(cv)})
    with torch.no_grad():
        got, kv = tm.stream(torch.from_numpy(x),
                            {"k": torch.from_numpy(ck),
                             "v": torch.from_numpy(cv)}, n_l - cache_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(kv[name].numpy(), np.asarray(jkv[name]),
                                   atol=ATOL, rtol=RTOL)


def test_causal_conformer_conv_with_cache_matches_jax():
    d, k = 8, 5
    jm = JConv(d_model=d, kernel_size=k, causal=True,
               normalization="layer_norm")
    params = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 10, d)))["params"], 0.1)
    tm = TConv(d, k, "layer_norm", causal=True)
    tm.load_state_dict(convert_params(params), strict=True)
    x = np.random.RandomState(7).randn(2, 12, d).astype(np.float32)
    apply = jax.jit(jm.apply, static_argnums=(4, 5))
    want, _ = apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    # blocks of 4 frames + 2 lookahead, the cache cut after the 4
    jc = np.zeros((2, k - 1, d), np.float32)
    tc = torch.zeros(2, k - 1, d)
    xp = np.concatenate([x, np.zeros((2, 2, d), np.float32)], 1)
    for s in range(0, 12, 4):
        blk = xp[:, s:s + 6]
        jo, jc = apply({"params": params}, jnp.asarray(blk), None,
                       jnp.asarray(jc), True, 4)
        with torch.no_grad():
            to, tc = tm(torch.from_numpy(blk), None, tc, 4)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL,
                                   rtol=RTOL)
        # without lookahead the block's frames are the offline ones
        np.testing.assert_allclose(to.numpy()[:, :4],
                                   np.asarray(want)[:, s:s + 4],
                                   atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------- encoders
CONV = dict(conv_channels="4_4", conv_kernel_sizes="(3,3)_(3,3)",
            conv_poolings="(2,2)_(2,2)")
ENCODERS = {
    "uni_conformer_maxpool": dict(
        btype="conformer", pe_type="relative", clamp_len=3,
        conv_kernel_size=3, unidirectional=True, subsample=(1, 2),
        subsample_type="max_pool"),
    "uni_conformer_unclamped": dict(
        btype="conformer", pe_type="relative", conv_kernel_size=3,
        unidirectional=True),
    "uni_transformer": dict(btype="transformer", pe_type="add",
                            unidirectional=True),
    "mask_uni_conformer": dict(
        btype="conformer", pe_type="relative", conv_kernel_size=3,
        unidirectional=True, chunk_size_left=8, chunk_size_current=8,
        chunk_size_right=0, streaming_type="mask"),
    "mask_conformer_lookahead": dict(
        btype="conformer", pe_type="relative", conv_kernel_size=3,
        chunk_size_left=8, chunk_size_current=8, chunk_size_right=4,
        streaming_type="mask"),
    "mask_transformer": dict(
        btype="transformer", pe_type="add", chunk_size_left=8,
        chunk_size_current=8, chunk_size_right=0, streaming_type="mask"),
    "reshape_transformer": dict(
        btype="transformer", pe_type="none", chunk_size_left=8,
        chunk_size_current=8, chunk_size_right=4, streaming_type="reshape"),
}


@functools.cache
def _encoders(name):
    """(JAX encoder, its variables, the port's encoder in eval()): built
    once per mode, shared by the tests that read it."""
    kw = {**ENCODERS[name], **CONV}
    je = JEnc(input_dim=16, d_model=32, d_ff=48, n_heads=2, n_layers=2,
              dropout=0.0, ffn_activation="swish", **kw)
    params = _perturb(jax.jit(je.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 40, 16)),
        jnp.array([40, 30]))["params"])
    te = TEnc(input_dim=16, d_model=32, d_ff=48, n_heads=2, n_layers=2,
              **kw)
    te.load_state_dict(convert_params(params), strict=True)
    return je, {"params": params}, te.eval()


@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_modes_match_jax(name):
    """Ragged lengths, T = 45 (not a multiple of the 8-frame chunk); the
    10-frame row leaves 3 encoder frames, so in mask mode its pad queries
    from frame 6 on have an empty window (uniform rows)."""
    je, v, te = _encoders(name)
    rng = np.random.RandomState(1)
    xs = rng.randn(3, 45, 16).astype(np.float32)
    xlens = np.array([45, 37, 10], np.int32)
    want = jax.jit(je.apply)(v, jnp.asarray(xs), jnp.asarray(xlens))["ys"]
    with torch.no_grad():
        got = te(torch.from_numpy(xs), torch.from_numpy(xlens).long())["ys"]
    np.testing.assert_array_equal(got["xlens"].numpy(),
                                  np.asarray(want["xlens"]))
    np.testing.assert_allclose(got["xs"].numpy(), np.asarray(want["xs"]),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", [n for n in ENCODERS
                                  if "chunk_size_current" in ENCODERS[n]])
def test_streaming_step_matches_jax(name):
    je, v, te = _encoders(name)
    x = np.random.RandomState(2).randn(45, 16).astype(np.float32)
    jc, tc = je.init_stream_cache(1), te.init_stream_cache(1)
    total, hop = te.block_input_frames()
    assert (total, hop) == je.block_input_frames()
    assert te.stream_geometry() == je.stream_geometry()
    n_blocks = 0
    jstep = jax.jit(lambda v, b, c: je.apply(v, b, c,
                                             method=je.streaming_step))
    for blk, _, _ in tstream.StreamingDriver(x, total, hop, 0):
        jo, jc = jstep(v, jnp.asarray(blk)[None], jc)
        with torch.no_grad():
            to, tc = te.streaming_step(torch.from_numpy(blk)[None], tc)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                                   rtol=RTOL)
        assert (tc["len"], tc["offset"]) == (int(jc["len"]),
                                             int(jc["offset"]))
        for jl, tl in zip(jc["layers"], tc["layers"]):
            assert set(jl) == set(tl)
            for leaf in jl:
                np.testing.assert_allclose(tl[leaf].numpy(),
                                           np.asarray(jl[leaf]), atol=ATOL,
                                           rtol=RTOL, err_msg=leaf)
        n_blocks += 1
    assert n_blocks == 6


# ----------------------------------------------------------- host copies
def test_streaming_driver_and_vad_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(50, 4).astype(np.float32)
    for args in ((16, 8, 0), (20, 8, 4)):
        want = list(jstream.StreamingDriver(x, *args))
        got = list(tstream.StreamingDriver(x, *args))
        assert len(got) == len(want)
        for (gb, gn, gl), (wb, wn, wl) in zip(got, want):
            np.testing.assert_array_equal(gb, wb)
            assert (gn, gl) == (wn, wl)
    jv = jstream.CtcVAD(factor=4, blank_threshold=12, min_accum_frames=8)
    tv = tstream.CtcVAD(factor=4, blank_threshold=12, min_accum_frames=8)
    for i in range(12):
        ids = rng.choice([0, 0, 0, 5, 7], 6)
        probs = rng.rand(6)
        assert tv.step(ids, probs, 24) == jv.step(ids, probs, 24)
        assert tv.n_blanks == jv.n_blanks
        if i % 5 == 4:
            tv.reset()
            jv.reset()
    for ids in (rng.choice([0, 0, 3], 80), np.zeros(60, np.int64)):
        probs = rng.rand(len(ids), 5)
        for kw in (dict(blank_threshold=5, n_accum_frames=2000,
                        min_accum_frames=100),
                   dict(blank_threshold=5, ctc_probs=probs,
                        n_accum_frames=2000, min_accum_frames=100),
                   dict(blank_threshold=5, n_accum_frames=1,
                        min_accum_frames=100)):
            assert tstream.ctc_reset_point_detection(ids, **kw) == \
                jstream.ctc_reset_point_detection(ids, **kw)


def _log_probs(rng, t, v):
    z = rng.randn(t, v) * 3
    z[:, 0] += 2.0
    return (z - np.log(np.exp(z).sum(-1, keepdims=True))).astype(np.float32)


def test_block_sync_beam_and_scorer_match_jax():
    rng = np.random.RandomState(4)
    lm_table = _log_probs(rng, 1, 7)[0]
    lm_fn = lambda prefix: lm_table    # noqa: E731
    blocks = [_log_probs(rng, 4, 7) for _ in range(5)]
    for kw in (dict(), dict(lm_fn=lm_fn, lm_weight=0.3)):
        jb = jctc.CTCBlockSyncBeam(4, **kw)
        tb = tctc.CTCBlockSyncBeam(4, **kw)
        for i, blk in enumerate(blocks):
            jb.step(blk)
            tb.step(blk)
            if i == 2:
                assert tb.commit_and_reset() == jb.commit_and_reset()
        assert tb.hypotheses() == jb.hypotheses()
    # the scorer advanced chunk by chunk
    js = jctc.CTCPrefixScorer(blocks[0])
    ts = tctc.CTCPrefixScorer(blocks[0])
    jr, tr = js.initial_state(), ts.initial_state()
    hyp = [3]
    psi_j, jrn = js([], np.array([3, 5]), jr)
    psi_t, trn = ts([], np.array([3, 5]), tr)
    np.testing.assert_array_equal(psi_t, psi_j)
    jr, tr = jrn[0], trn[0]
    for blk in blocks[1:]:
        js.register_new_chunk(blk)
        ts.register_new_chunk(blk)
        jr, tr = js.extend_state(hyp, jr), ts.extend_state(hyp, tr)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(ts([3], np.array([1, 3, 6]), tr)[0],
                                      js([3], np.array([1, 3, 6]), jr)[0])


# ------------------------------------------------------ streaming decode
def small_streaming_mocha():
    """The repo's streaming uni-Conformer-MoChA conf with its widths cut:
    2 conformer layers of d 32, 2 heads; the front end x4 keeps the
    chunks (left 64, current 32 input frames: 16 / 8 encoder frames);
    decoder 32, attention 16, vocab 30; CTC 0.3."""
    args = vars(uni_conformer_mocha_streaming_args())
    args.update(input_dim=20, conv_channels="4_4", enc_n_layers=2,
                transformer_d_model=32, transformer_d_ff=48,
                transformer_n_heads=2, dec_n_units=32, emb_dim=16,
                dec_bottleneck_dim=32, attn_dim=16, vocab=30,
                dropout_enc=0.0, dropout_dec=0.0, dropout_emb=0.0,
                mocha_std=0.0, mocha_init_r=-4.0)
    return SimpleNamespace(**args)


def small_lc_transformer_mma():
    """The LibriSpeech LC-Transformer-MMA conf (reshape mode, chunks 64 /
    128 / 64 input frames: 8 / 16 / 8 encoder frames) with its widths cut:
    2 + 2 layers of d 32, 2 heads, MMA from layer 2 with 2 x 2 heads,
    chunk 4, vocab 30, CTC fc 16; dropout off."""
    args = vars(librispeech_lc_transformer_mma_args())
    args.update(input_dim=20, conv_channels="4_4_4", enc_n_layers=2,
                transformer_enc_d_model=32, transformer_enc_d_ff=48,
                transformer_enc_n_heads=2, dec_n_layers=2,
                transformer_dec_d_model=32, transformer_dec_d_ff=48,
                transformer_dec_n_heads=2, mocha_first_layer=2,
                mocha_n_heads_mono=2, mocha_n_heads_chunk=2,
                mocha_chunk_size=4, vocab=30, ctc_fc_list="16",
                dropout_enc=0.0, dropout_dec=0.0, dropout_emb=0.0,
                dropout_head=0.0, mocha_std=0.0)
    return SimpleNamespace(**args)


def _model_pair(args, t, scale, seed=0):
    jm = jax_build(args)
    params = _tree(jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                    jnp.zeros((2, t, 20)),
                           jnp.array([t, t - 30]), jnp.ones((2, 3),
                                                            jnp.int32),
                           jnp.array([3, 2]))["params"])
    params = _perturb(params, scale, seed + 7)
    tm = build_speech2text(args, device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    return jm, params, tm.eval()


@functools.cache
def _mocha_pair():
    return _model_pair(small_streaming_mocha(), 160, 1.0)


@functools.cache
def _lc_pair():
    """The LC-Transformer-MMA pair with the blank's output bias raised by
    10, so that runs of blanks fire CTC-VAD resets."""
    jm, params, tm = _model_pair(small_lc_transformer_mma(), 256, 0.3)
    params["ctc"]["output"]["bias"][0] += 10.0
    tm.load_state_dict(convert_params(params), strict=True)
    return jm, params, tm


@functools.cache
def _lm_pair(vocab=30):
    """A small RNNLM as (JAX session, port session) on converted weights:
    the shallow-fusion LM of the streaming beams."""
    opts = dict(n_units=24, n_layers=2, emb_dim=24, tie_embedding=True,
                residual=True, use_glu=True)
    jlm = JaxRNNLM(vocab=vocab, **opts)
    ys = jnp.ones((1, 3), jnp.int32)
    params = _perturb(jlm.init(jax.random.PRNGKey(1), ys, ys)["params"],
                      0.3, 2)
    tlm = RNNLM(vocab=vocab, device="cpu", **opts)
    tlm.load_state_dict(convert_params(params), strict=True)
    return JaxLMSession(jlm, params), LMSession(tlm.eval())


def _sessions(jm, params, tm, conf, lm):
    """The JAX and port sessions of ``conf``, with the LM pair when
    ``lm``."""
    jlm, tlm = _lm_pair() if lm else (None, None)
    return (JaxSession(jm, params, JaxDecodeConfig(**conf), jlm),
            Speech2TextSession(tm, DecodeConfig(**conf), tlm))


@pytest.mark.parametrize("lm", [False, True])
def test_decode_streaming_mocha_matches_jax(lm):
    """The block-synchronous MoChA beam 4 + CTC 0.3 (and LM 0.3 with length
    norm) on perturbed weights (boundaries fire, hypotheses are parked
    and retried): the JAX session's tokens and boundary frames."""
    jm, params, tm = _mocha_pair()
    x = np.random.RandomState(5).randn(150, 20).astype(np.float32)
    conf = dict(beam_width=4, ctc_weight=0.3)
    if lm:
        conf.update(lm_weight=0.3, length_norm=True)
    jsess, tsess = _sessions(jm, params, tm, conf, lm)
    want, wstats = jsess.decode_streaming(x)
    got, gstats = tsess.decode_streaming(x)
    assert got == want
    assert 0 < len(got)
    assert gstats["boundaries"] == wstats["boundaries"]
    assert gstats["n_out_frames"] == wstats["n_out_frames"] == 38


@pytest.mark.parametrize("lm", [False, True])
def test_decode_streaming_transformer_runs_the_ctc_beam(lm, monkeypatch):
    """An LC-Transformer-MMA streamed: JAX's dispatch runs the CTC
    block-synchronous prefix beam (the transformer decoder is not run,
    ROADMAP C26) with CTC-VAD resets that commit the running best, and
    with an LM its prefix hook; the port's tokens, resets and commits are
    JAX's. The blank's output bias is raised by 10 so that runs of blanks
    fire resets between emitted tokens."""
    jm, params, tm = _lc_pair()
    x = np.random.RandomState(6).randn(700, 20).astype(np.float32)
    conf = dict(beam_width=4, ctc_weight=0.3)
    if lm:
        conf.update(lm_weight=0.3)
    jsess, tsess = _sessions(jm, params, tm, conf, lm)
    want, wstats = jsess.decode_streaming(x, blank_threshold=16)
    called = []
    monkeypatch.setattr(tsess.dec, "forward",
                        lambda *a, **k: called.append(1))
    got, gstats = tsess.decode_streaming(x, blank_threshold=16)
    assert got == want and not called
    assert gstats["n_resets"] == wstats["n_resets"] > 0
    assert gstats["commits"] == wstats["commits"]
    assert len(got) > len(gstats["commits"][0]) > 0


def test_eval_streaming_matches_jax():
    """``eval_streaming`` (a copy of the JAX evaluator's) on a session
    whose ``decode_streaming`` replays fixed hypotheses and stats: WER,
    RTF, quantity rate, resets, streamability and the last-success-frame
    ratio equal JAX's on the same loader."""
    from neural_sp_tpu.evaluators.asr import eval_streaming as jax_eval
    from neural_sp_tpu_torch.evaluators.asr import eval_streaming

    words = ["a", "b", "c", "d", "e"]
    batches = [{"utt_ids": ["u0", "u1"], "xs": np.zeros((2, 30, 4)),
                "xlens": [30, 20], "text": ["a b c", "d e"]},
               {"utt_ids": ["u2"], "xs": np.zeros((1, 10, 4)),
                "xlens": [10], "text": ["c c a"]}]
    replies = iter([
        ([4, 5, 6], {"rtf": 0.5, "n_resets": 1, "boundaries": [3, 7, 8],
                     "n_out_frames": 10}),
        ([7], {"rtf": 0.25, "n_resets": 0, "boundaries": [4],
               "n_out_frames": 5}),
        ([], {"rtf": 0.75, "n_resets": 2, "boundaries": [],
              "n_out_frames": 3})] * 2)

    class Session:
        def decode_streaming(self, feats):
            return next(replies)

    class Loader(list):
        def idx2token(self, ids):
            return " ".join(words[i - 4] for i in ids)

    loader = Loader(batches)
    got = eval_streaming(Session(), loader)
    want = jax_eval(Session(), loader)
    assert got == want and want["n_utts"] == 3
    assert 0 < want["streamability"] < 1


def test_eval_streaming_writes_ref_and_hyp(tmp_path):
    """With ``save_dir``, ``eval_streaming`` writes ``ref.trn`` and
    ``hyp.trn`` in ``eval_unit``'s format, one line per utterance."""
    from neural_sp_tpu_torch.evaluators.asr import eval_streaming

    words = ["a", "b", "c"]
    batches = [{"utt_ids": ["u0", "u1"], "speakers": ["s0", "s1"],
                "xs": np.zeros((2, 30, 4)), "xlens": [30, 20],
                "text": ["a b c", "c"]}]
    replies = iter([([4, 6], {"rtf": 0.5, "n_resets": 0}),
                    ([], {"rtf": 0.5, "n_resets": 1})])

    class Session:
        def decode_streaming(self, feats):
            return next(replies)

    class Loader(list):
        def idx2token(self, ids):
            return " ".join(words[i - 4] for i in ids)

    out = eval_streaming(Session(), Loader(batches), save_dir=str(tmp_path))
    assert out["n_utts"] == 2
    assert (tmp_path / "ref.trn").read_text() == "a b c (s0-u0)\nc (s1-u1)\n"
    assert (tmp_path / "hyp.trn").read_text() == "a c (s0-u0)\n (s1-u1)\n"
