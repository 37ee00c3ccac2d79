"""Port parity: the transformer / conformer encoder blocks with relative
positions (``transformer_enc_pe_type`` "relative" and "relative_xl", as
JAX's ``_make_mha`` builds them on ``RelativeMultiheadAttention``), and
the plain bf16 K1 / K1b with dropout of the attention probabilities.

* ``XformerEncoder`` (conv front end, 2 blocks) against JAX's on the same
  converted weights (perturbed), float32, atol = rtol = 2e-4 (the
  repo's): the outputs on a ragged batch and the gradients of every
  weight and of the input (``jax.grad``); the transformer block with
  "relative" unclamped (R = T, the timit conf's) and clamped, with
  "relative_xl" (``w_pos``, the u / v biases), and the conformer block
  with "relative_xl". The attention key biases' gradient is zero in exact
  arithmetic (the softmax's shift invariance): both sides hold rounding
  noise there, held at 2e-4 of the key weights' largest gradient.
* ``RelativeMultiheadAttention`` at bf16 with ``dropout`` 0.1 (its K1 /
  K1b plain versions at bf16: P rounded, then dropped and rounded again)
  against the JAX module with ``cast_floating`` weights and its
  ``Dropout`` on the same key words (JAX's ``fast_bernoulli`` handed the
  words the port's ``key_words`` gives): the output and the gradients of
  the input and every weight, by ``tests/test_torch_bf16.py``'s rule
  (|port - jax bf16| <= 2 |jax bf16 - jax f32| + 1e-3 |jax f32|, L2, per
  leaf), the float32 run on the same mask too.
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch.func import functional_call

import neural_sp_tpu.ops.dropout as jax_dropout
import neural_sp_tpu_torch.models.modules.relative_multihead_attention as \
    port_rel
from neural_sp_tpu.models.encoders.transformer import XformerEncoder as JEnc
from neural_sp_tpu.models.modules.relative_multihead_attention import (
    RelativeMultiheadAttention as JaxRelMHA)
from neural_sp_tpu.ops.masks import make_pad_mask as jax_pad_mask, \
    make_san_mask as jax_san_mask
from neural_sp_tpu.parallel.mesh import cast_floating
from neural_sp_tpu_torch.models.encoders.transformer import XformerEncoder
from neural_sp_tpu_torch.models.modules.relative_multihead_attention import (
    RelativeMultiheadAttention)
from neural_sp_tpu_torch.utils.convert_params import convert_params

from test_torch_bf16 import _converted, assert_leaves, assert_rule

ATOL = RTOL = 2e-4
FLOOR = 1e-6
ZERO_GRAD_LEAF = ".mha.w_key.bias"
CONV = dict(conv_channels="4_4", conv_kernel_sizes="(3,3)_(3,3)",
            conv_poolings="(1,1)_(2,2)")
CASES = {
    "transformer_relative": dict(btype="transformer", pe_type="relative",
                                 clamp_len=-1),
    "transformer_relative_clamped": dict(btype="transformer",
                                         pe_type="relative", clamp_len=5),
    "transformer_relative_xl": dict(btype="transformer",
                                    pe_type="relative_xl", clamp_len=-1),
    "conformer_relative_xl": dict(btype="conformer", pe_type="relative_xl",
                                  clamp_len=10, conv_kernel_size=3),
}


def _leaf_close(got, want, name):
    scale = max(float(np.abs(want).max()), FLOOR)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * scale + FLOOR, err_msg=name)


@functools.cache
def _encoders(name):
    kw = dict(input_dim=16, d_model=32, d_ff=48, n_heads=2, n_layers=2,
              dropout=0.0, ffn_activation="swish" if "conformer" in name
              else "relu", **CASES[name], **CONV)
    je = JEnc(**kw)
    rng = np.random.RandomState(0)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.1 * rng.randn(*x.shape).astype(
            np.float32),
        jax.tree.map(np.asarray, jax.jit(je.init)(
            jax.random.PRNGKey(0), jnp.zeros((2, 40, 16)),
            jnp.array([40, 30]))["params"]))
    te = XformerEncoder(**kw)
    te.load_state_dict(convert_params(params), strict=True)
    return je, params, te.eval()


@pytest.mark.parametrize("name", sorted(CASES))
def test_relative_encoder_matches_jax(name):
    je, params, te = _encoders(name)
    assert all(b.relative for b in te.blocks)
    if "xl" in name:
        assert all(b.mha.xl_like for b in te.blocks)
    rng = np.random.RandomState(1)
    xs = rng.randn(3, 45, 16).astype(np.float32)
    xlens = np.array([45, 37, 10], np.int32)
    w = rng.randn(3, 23, 32).astype(np.float32)

    def jloss(p, x):
        out = je.apply({"params": p}, x, jnp.asarray(xlens))["ys"]
        mask = jax_pad_mask(out["xlens"], out["xs"].shape[1])
        return jnp.sum(jnp.where(mask[..., None], out["xs"], 0.0) * w), \
            out["xs"]

    (_, want), (g_p, g_x) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(xs))
    x = torch.from_numpy(xs).requires_grad_(True)
    te.zero_grad(set_to_none=True)
    eouts = te(x, torch.from_numpy(xlens))["ys"]
    out, el = eouts["xs"], eouts["xlens"]
    valid = torch.arange(out.shape[1])[None] < el[:, None]
    (torch.where(valid[..., None], out, 0.0) * torch.from_numpy(w)).sum() \
        .backward()
    for b, n in enumerate(el.tolist()):
        np.testing.assert_allclose(out[b, :n].detach().numpy(),
                                   np.asarray(want)[b, :n], atol=ATOL,
                                   rtol=RTOL)
    _leaf_close(x.grad.numpy(), np.asarray(g_x), "input")
    want_g = {k: v.numpy() for k, v in convert_params(
        jax.tree.map(np.asarray, g_p)).items()}
    assert set(want_g) == {n for n, _ in te.named_parameters()}
    for n, p in te.named_parameters():
        if n.endswith(ZERO_GRAD_LEAF):
            # zero in exact arithmetic (the softmax's shift invariance):
            # rounding noise on both sides, held at the weight's scale
            scale = np.abs(want_g[n[:-len("bias")] + "weight"]).max()
            np.testing.assert_allclose(p.grad.numpy(), want_g[n], rtol=0,
                                       atol=RTOL * scale, err_msg=n)
        else:
            _leaf_close(p.grad.numpy(), want_g[n], n)


KEY_WORDS = (0x2545F491, 0x9E3779B9)


@pytest.mark.parametrize("t,xlens,xl_like", [
    (40, [40, 37, 1], False),    # clamped, ragged, klen 1
    (23, [23, 9, 17], True),     # the XL form, unclamped (R = T)
])
def test_rel_attention_bf16_with_dropout_matches_jax(monkeypatch, t, xlens,
                                                     xl_like):
    d, h, rate = 64, 4, 0.1
    clamp = -1 if xl_like else 10
    real_bern = jax_dropout.fast_bernoulli

    def words_bernoulli(key, p, shape):
        return real_bern(jnp.asarray(KEY_WORDS, jnp.uint32), p, shape)

    drawn = []

    def words(gen):
        drawn.append(1)
        return KEY_WORDS

    monkeypatch.setattr(jax_dropout, "fast_bernoulli", words_bernoulli)
    monkeypatch.setattr(port_rel, "key_words", words)
    rng = np.random.RandomState(t)
    xs = rng.randn(3, t, d).astype(np.float32)
    dout = rng.randn(3, t, d).astype(np.float32)
    xl = np.asarray(xlens, np.int32)
    jm = JaxRelMHA(d_model=d, n_heads=h, clamp_len=clamp, xl_like=xl_like,
                   dropout=rate)
    mask = jax_san_mask(jax_pad_mask(jnp.asarray(xl), t))
    params = jm.init(jax.random.PRNGKey(t), jnp.asarray(xs), mask=mask)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.randn(*x.shape).astype(
            np.float32), jax.tree.map(np.asarray, params))

    def jrun(dt):
        def loss(p, x):
            if dt is not None:
                p, x = cast_floating(p, dt), x.astype(dt)
            out, _, _ = jm.apply(p, x, mask=mask, deterministic=False,
                                 rngs={"dropout": jax.random.PRNGKey(0)})
            return jnp.sum(out.astype(jnp.float32) * dout), out
        (_, out), (g_p, g_x) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(xs))
        return (np.asarray(out, np.float32), np.asarray(g_x, np.float32),
                _converted(g_p["params"]))

    out_b, gx_b, gp_b = jrun(jnp.bfloat16)
    out_f, gx_f, gp_f = jrun(None)
    tm = RelativeMultiheadAttention(d, h, clamp_len=clamp, xl_like=xl_like,
                                    dropout=rate)
    tm.load_state_dict(convert_params(params["params"]), strict=True)
    tm.train()
    # float32: the same mask as JAX's, at the repo's float32 tolerance
    x = torch.from_numpy(xs).requires_grad_(True)
    out = tm(x, torch.from_numpy(xl))
    np.testing.assert_allclose(out.detach().numpy(), out_f, atol=ATOL,
                               rtol=RTOL)
    # bf16: the plain K1 / K1b at bf16 with the mask
    x = torch.from_numpy(xs).requires_grad_(True)
    bf16 = {n: p.to(torch.bfloat16) for n, p in tm.named_parameters()}
    out = functional_call(tm, bf16, (x.to(torch.bfloat16),
                                     torch.from_numpy(xl)))
    assert out.dtype == torch.bfloat16 and len(drawn) == 2
    (out.float() * torch.from_numpy(dout)).sum().backward()
    assert_rule(out.detach().float().numpy(), out_b, out_f, "output")
    assert_rule(x.grad.numpy(), gx_b, gx_f, "input gradient")
    assert_leaves({n: p.grad.numpy() for n, p in tm.named_parameters()},
                  gp_b, gp_f, "gradient")
