"""Port parity: attention dropout (``dropout_att``) and the projection
(``n_projs``) in the LAS decoder.

* One location-attention step with dropout against the JAX
  ``AttentionMechanism`` applied in training mode: the key words JAX's
  ``Dropout`` draws its mask from are read off its jitted call by a
  callback and handed to the port's ``keep_mask``. The mask is the same bit for bit; the context and
  the dropped weights agree within 2e-4.
* The LAS decoder's loss and the gradient of every weight and of the
  encoder outputs against ``jax.grad`` of the JAX ``RNNDecoder`` in
  training mode with ``dropout_att`` 0.1 (the other dropouts 0), teacher
  forced and with scheduled sampling (``ss_prob`` 0.5, a pinned row
  pattern, and the projection of the dropped LSTM output, ``n_projs`` 8,
  the ``ci_test`` confs' width). The two packages key their masks
  differently (ROADMAP C4), so the port is handed JAX's own: each step's
  [B, T] mask is read off JAX's jitted scan by an ordered callback, and
  the port's ``fast_uniform`` gives them for its [B, U+1, T] scale. The
  masks differ between steps, so the test also shows that each step takes
  its own mask and that the dropped weights, not the raw ones, feed the
  next step's location convolution.
* ``las_scan_bwd_ref`` with ``att_keep`` against autograd of
  ``las_scan_ref``, float64, within 1e-9 of each leaf's largest magnitude.
* The projected decoder's decode steps (K2's plain version with the
  projection, through ``decode_step`` and a ``DecodeLoop``) against the
  JAX ``decode_step``, logits within 2e-4.
* The decoder builders: ``dropout_att`` reaches the location attention and
  the transformer decoder, not MoChA (ROADMAP C43).

Tolerance against JAX: float32, atol = rtol = 2e-4 (the repo's); each
gradient within 2e-4 of its leaf's largest magnitude plus 1e-6.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import neural_sp_tpu.ops.dropout as jax_dropout
import neural_sp_tpu_torch.ops.dropout as port_dropout
from neural_sp_tpu.models.decoders.las import RNNDecoder as JaxRNNDecoder
from neural_sp_tpu.models.modules.attention import (
    AttentionMechanism as JaxAttention)
from neural_sp_tpu.ops.masks import make_pad_mask as jax_pad_mask
from neural_sp_tpu_torch.models.decoders.build import build_decoder
from neural_sp_tpu_torch.models.decoders.las import RNNDecoder
from neural_sp_tpu_torch.models.modules.attention import AttentionMechanism
from neural_sp_tpu_torch.ops.kernels.las_scan import (las_scan_bwd_ref,
                                                      las_scan_ref)
from neural_sp_tpu_torch.ops.kernels.las_step import attend_ref
from neural_sp_tpu_torch.utils.convert_params import convert_params

ATOL = RTOL = 2e-4
FLOOR = 1e-6
RATE = 0.1
VOCAB, ENC, UNITS, EMB, BOTTLE, ADIM, CONV_K = 30, 24, 20, 12, 16, 10, 9
KW = dict(vocab=VOCAB, enc_n_units=ENC, n_units=UNITS, emb_dim=EMB,
          bottleneck_dim=BOTTLE, attn_dim=ADIM, attn_conv_kernel_size=CONV_K,
          lsm_prob=0.1, dropout_att=RATE)
ROWS = np.array([True, False, True])      # the sampled rows (ss_prob > 0)


def _leaf_close(got, want, name):
    scale = max(float(np.abs(want).max()), FLOOR)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * scale + FLOOR, err_msg=name)


# --------------------------------------------------------- one step
def test_location_attention_step_dropout_matches_jax(monkeypatch):
    """The JAX module's dropped weights and context from its own key words;
    the port's mask from the same words through ``keep_mask``."""
    rng = np.random.RandomState(0)
    bs, t = 3, 13
    keys = rng.randn(bs, t, ENC).astype(np.float32)
    query = rng.randn(bs, UNITS).astype(np.float32)
    aw_prev = np.abs(rng.randn(bs, t)).astype(np.float32)
    elens = np.array([13, 6, 1], np.int32)
    jatt = JaxAttention(kdim=ENC, qdim=UNITS, adim=ADIM,
                        conv_kernel_size=CONV_K, dropout=RATE)
    mask = jax_pad_mask(jnp.asarray(elens), t)
    args = (jnp.asarray(keys), jnp.asarray(keys), jnp.asarray(query), mask,
            jnp.asarray(aw_prev))
    params = jax.jit(jatt.init)(jax.random.PRNGKey(0), *args)["params"]
    params = jax.tree.map(lambda x: np.asarray(x) + 0.2 * rng.randn(
        *x.shape).astype(np.float32), jax.tree.map(np.asarray, params))
    words = []
    real = jax_dropout.fast_bernoulli

    def spy(key, p, shape):
        jax.debug.callback(lambda kd: words.append(
            (int(kd[0]), int(kd[-1]))), jax_dropout._key_data(key))
        return real(key, p, shape)

    monkeypatch.setattr(jax_dropout, "fast_bernoulli", spy)
    ctx, aw = jax.jit(lambda p: jatt.apply(
        {"params": p}, *args, deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(3)}))(params)
    jax.effects_barrier()
    (key,) = words
    jax_keep = np.asarray(jax_dropout.fast_uniform(
        jnp.asarray(key, jnp.uint32), (bs, t))) < 1.0 - RATE
    monkeypatch.setattr(port_dropout, "key_words", lambda gen: key)
    att_keep = port_dropout.keep_mask(None, RATE, (bs, t))
    np.testing.assert_array_equal(att_keep.numpy() > 0, jax_keep)
    assert 0 < jax_keep.sum() < jax_keep.size

    port = AttentionMechanism(kdim=ENC, qdim=UNITS, adim=ADIM,
                              conv_kernel_size=CONV_K)
    state = convert_params(params)
    w_key = state.pop("w_key.weight"), state.pop("w_key.bias")
    port.load_state_dict(state, strict=True)
    kc = torch.from_numpy(keys) @ w_key[0].t() + w_key[1]
    with torch.no_grad():
        _, aw_t, ctx_t = attend_ref(
            torch.from_numpy(query), torch.from_numpy(aw_prev),
            *port.kernel_weights(), kc, torch.from_numpy(keys),
            torch.from_numpy(elens), att_keep)
    np.testing.assert_allclose((aw_t * att_keep).numpy(), np.asarray(aw),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ctx_t.numpy(), np.asarray(ctx), atol=ATOL,
                               rtol=RTOL)


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
    return rng, eouts, elens, ys, ylens


def _pin(monkeypatch, rows, bs, u1, t):
    """JAX draws its own attention masks, and each step's [B, T] mask is
    read off its jitted scan by an ordered callback; the port's [B, U+1,
    T] uniforms give those masks. The sampling draw is ``rows`` in both.
    Returns the list JAX's masks go to."""
    masks = []
    real_bern = jax_dropout.fast_bernoulli

    def spy_bernoulli(key, p, shape):
        m = real_bern(key, p, shape)
        if tuple(shape) == (bs, t):
            jax.debug.callback(lambda x: masks.append(np.asarray(x)), m,
                               ordered=True)
        return m

    def fake_jax_bernoulli(key, p=0.5, shape=None):
        assert tuple(shape) == (bs,)
        return jnp.asarray(rows)

    def fake_uniform(key, shape, device=None):
        shape = tuple(shape)
        if shape == (bs, u1, t):
            assert len(masks) == u1
            u = np.where(np.stack(masks, 1), 0.0, 0.999)
        else:
            assert shape == (bs, u1), shape
            u = np.broadcast_to(np.where(rows, 0.0, 0.999)[:, None], shape)
        return torch.from_numpy(np.ascontiguousarray(u, np.float32))

    monkeypatch.setattr(jax_dropout, "fast_bernoulli", spy_bernoulli)
    monkeypatch.setattr(jax.random, "bernoulli", fake_jax_bernoulli)
    monkeypatch.setattr(port_dropout, "fast_uniform", fake_uniform)
    return masks


CASES = {"teacher_forced": (0.0, 0), "sampled_projected": (0.5, 8)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_las_loss_and_grads_with_attention_dropout_match_jax(monkeypatch,
                                                             case):
    ss_prob, n_projs = CASES[case]
    rng, eouts, elens, ys, ylens = _inputs(3)
    u1, bs, t = ys.shape[1] + 1, eouts.shape[0], eouts.shape[1]
    masks = _pin(monkeypatch, ROWS, bs, u1, t)
    jdec = JaxRNNDecoder(ss_prob=ss_prob, n_projs=n_projs, **KW)
    jargs = tuple(map(jnp.asarray, (eouts, elens, ys, ylens)))
    v = jdec.init(jax.random.PRNGKey(0), *jargs)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.3 * rng.randn(
        *x.shape).astype(np.float32), jax.tree.map(np.asarray, v["params"]))

    def jloss(p, e):
        return jdec.apply({"params": p}, e, *jargs[1:], deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(1)})

    (want, _), (g_p, g_e) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jargs[0])
    jax.effects_barrier()
    # one mask a step, the steps' masks not all alike
    assert len(masks) == u1 and not all(
        (m == masks[0]).all() for m in masks[1:])
    port = RNNDecoder(ss_prob=ss_prob, n_projs=n_projs, **KW)
    port.load_state_dict(convert_params(params), strict=True)
    port.train()
    e_t = torch.from_numpy(eouts).requires_grad_(True)
    loss, _ = port(e_t, torch.from_numpy(elens), torch.from_numpy(ys),
                   torch.from_numpy(ylens), torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=RTOL,
                               atol=ATOL)
    _leaf_close(e_t.grad.numpy(), np.asarray(g_e), "eouts")
    grads = convert_params(jax.tree.map(np.asarray, g_p))
    for name, p in port.named_parameters():
        _leaf_close(p.grad.numpy(), grads[name].numpy(), name)


def test_scan_adjoint_with_attention_dropout_matches_autograd():
    """``las_scan_bwd_ref`` (the adjoint K3b mirrors) against autograd of
    ``las_scan_ref``, float64, a klen 0 row, 1e-9 of each leaf's max."""
    gen = torch.Generator().manual_seed(0)
    u, b, t, h, d, a, c, k = 5, 3, 11, 6, 7, 5, 3, 5

    def r(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, dtype=torch.float64)

    ins = [x.requires_grad_(True) for x in (
        r(u, b, 4 * h), r(d, 4 * h, scale=0.3), r(h, 4 * h, scale=0.3),
        r(4 * h, scale=0.1), r(a, h, scale=0.3), r(c, k, scale=0.3),
        r(a, c, scale=0.3), r(a, scale=0.5), r(b, t, a), r(b, t, d))]
    klens = torch.tensor([11, 6, 0], dtype=torch.int32)
    keep = (torch.rand(u, b, h, generator=gen) < 0.8).double() / 0.8
    att = (torch.rand(u, b, t, generator=gen) < 0.7).double() / 0.7
    outs = las_scan_ref(*ins, klens, keep, att)
    dh, dctx = r(u, b, h), r(u, b, d)
    ((outs[0] * dh).sum() + (outs[5] * dctx).sum()).backward()
    w_ctx, w_h, _, w_q, conv_w, w_f, v, kc, values = (x.detach()
                                                       for x in ins[1:])
    got = las_scan_bwd_ref(w_ctx, w_h, w_q, conv_w, w_f, v, kc, values,
                           klens, keep, *(x.detach() for x in outs), dh,
                           dctx, att)
    for i, (g, x) in enumerate(zip(got, ins)):
        want = x.grad
        scale = float(want.abs().max())
        assert float((g - want).abs().max()) <= 1e-9 * scale, i


def test_projected_decode_steps_match_jax():
    """Three decode steps of the projected decoder (``n_projs`` 8), fed
    the same tokens, ragged lengths: ``decode_step`` and a ``DecodeLoop``
    (K2's workspace form) against JAX's ``decode_step``."""
    rng, eouts, elens, ys, ylens = _inputs(5)
    jdec = JaxRNNDecoder(n_projs=8, **KW)
    jargs = tuple(map(jnp.asarray, (eouts, elens, ys, ylens)))
    v = jdec.init(jax.random.PRNGKey(0), *jargs)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.3 * rng.randn(
        *x.shape).astype(np.float32), jax.tree.map(np.asarray, v["params"]))
    port = RNNDecoder(n_projs=8, **KW)
    port.load_state_dict(convert_params(params), strict=True)
    port.eval()
    bs, t = eouts.shape[:2]
    kc = jdec.apply({"params": params}, jargs[0],
                    method=jdec.precompute_keys)
    mask = jax_pad_mask(jargs[1], t)
    carry = jdec.init_carry(bs, t)
    e_t, el_t = torch.from_numpy(eouts), torch.from_numpy(elens)
    with torch.no_grad():
        kc_t = port.precompute_keys(e_t)
        carry_t = port.init_carry(bs, t, "cpu")
        loop = port.decode_loop(kc_t, e_t, el_t.int())
        for y in (2, 7, 11):
            y_np = np.full(bs, y, np.int32)
            carry, logits, _ = jdec.apply(
                {"params": params}, carry, jnp.asarray(y_np), kc, jargs[0],
                mask, method=jdec.decode_step)
            y_t = torch.from_numpy(y_np).long()
            carry_t, logits_t, _ = port.decode_step(carry_t, y_t, kc_t, e_t,
                                                    el_t)
            looped, _ = loop.step(y_t)
            for got in (logits_t, looped):
                np.testing.assert_allclose(got.numpy(), np.asarray(logits),
                                           atol=ATOL, rtol=RTOL)


def test_dropout_att_reaches_the_decoders():
    """The LAS location attention and the transformer decoder's attention
    read ``dropout_att``; a MoChA decoder does not (C43, as JAX's builder)."""
    base = dict(enc_type="blstm", dec_type="lstm", dec_n_units=8,
                emb_dim=8, attn_dim=8, dropout_att=RATE)
    las = build_decoder(SimpleNamespace(**base), 10, 8)
    assert las.step.drop_att.rate == RATE
    mocha = build_decoder(SimpleNamespace(**base, attn_type="mocha"), 10, 8)
    assert mocha.step.drop_att.rate == 0.0
    xf = build_decoder(SimpleNamespace(
        dec_type="transformer", transformer_dec_d_model=8,
        transformer_dec_n_heads=2, transformer_dec_d_ff=16, dec_n_layers=1,
        dropout_att=RATE), 10, 8)
    assert xf.blocks[0].self_attn.drop.rate == RATE
