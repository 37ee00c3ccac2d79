"""Port parity: attention dropout (``dropout_att``) and LayerDrop
(``dropout_enc_layer``) in the transformer / conformer encoders.

Both packages draw in training mode; their keys differ (ROADMAP C4), so
the draws are pinned:

* attention dropout: the i-th attention's mask in both packages is the
  counter hash under the i-th of a fixed list of key words (JAX's
  ``fast_bernoulli`` is handed those words, the port's ``key_words`` gives
  them): the masks are the same bits, and K1's plain version (the
  conformer) or ``MultiheadAttention`` (the transformer) drops with them;
* LayerDrop: the j-th residual branch's keep decision is the j-th of a
  pinned list in both (JAX's ``jax.random.bernoulli`` of a scalar, the
  port's ``bernoulli_mask``), with some branches dropped.

The per-layer rate is ``dropout_enc_layer (l + 1) / L`` (JAX's formula),
and a kept branch's sum is scaled by 1 / (1 - p). Every other dropout is
0. Cases: the offline conformer (K1 with dropout) and the
latency-controlled transformer in the reshape mode (each chunk's
attention dropped); the outputs within float32's atol = rtol = 2e-4 (the
repo's). K1b's written-out backward with dropout is held to autograd and
``jax.grad`` in ``test_torch_rel_attention.py``, K1 / K1b with a window
and dropout to their plain versions on the card.
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import neural_sp_tpu.ops.dropout as jax_dropout
import neural_sp_tpu_torch.models.encoders.transformer as port_transformer
import neural_sp_tpu_torch.models.modules.relative_multihead_attention as \
    port_rel
import neural_sp_tpu_torch.ops.dropout as port_dropout
from neural_sp_tpu.models.encoders.transformer import XformerEncoder as JEnc
from neural_sp_tpu_torch.models.encoders.transformer import XformerEncoder
from neural_sp_tpu_torch.utils.convert_params import convert_params

ATOL = RTOL = 2e-4
CONV = dict(conv_channels="4_4", conv_kernel_sizes="(3,3)_(3,3)",
            conv_poolings="(1,1)_(2,2)")
CASES = {
    "conformer": dict(btype="conformer", pe_type="relative", clamp_len=10,
                      conv_kernel_size=3, n_layers=2),
    "reshape_transformer": dict(
        btype="transformer", pe_type="none", n_layers=2,
        chunk_size_left=8, chunk_size_current=8, chunk_size_right=4,
        streaming_type="reshape"),
}
DROP_ATT, DROP_LAYER = 0.3, 0.6
# LayerDrop decisions in call order: 4 branches a conformer block, 2 a
# transformer block
DECISIONS = [True, False, True, True, False, True, True, False, True, True,
             True, False]
KEY_WORDS = [(0x1234567 * (i + 1) & 0xFFFFFFFF, 0x9E3779B9 ^ i)
             for i in range(8)]


def _pin(monkeypatch):
    """Both packages' draws as the module docstring says. Returns the
    port's call counters, reset before each forward."""
    jax_att, jax_ld = [], []
    real_bern = jax_dropout.fast_bernoulli

    def fake_fast_bernoulli(key, p, shape):
        jax_att.append(len(jax_att))
        words = jnp.asarray(KEY_WORDS[jax_att[-1]], jnp.uint32)
        return real_bern(words, p, shape)

    def fake_jax_bernoulli(key, p=0.5, shape=None):
        assert shape is None
        jax_ld.append(len(jax_ld))
        return jnp.asarray(DECISIONS[jax_ld[-1]])

    port = {"att": 0, "ld": 0}

    def fake_key_words(gen):
        port["att"] += 1
        return KEY_WORDS[port["att"] - 1]

    def fake_bernoulli_mask(gen, p, shape, device=None):
        port["ld"] += 1
        return torch.tensor(DECISIONS[port["ld"] - 1])

    monkeypatch.setattr(jax_dropout, "fast_bernoulli", fake_fast_bernoulli)
    monkeypatch.setattr(jax.random, "bernoulli", fake_jax_bernoulli)
    monkeypatch.setattr(port_rel, "key_words", fake_key_words)
    monkeypatch.setattr(port_dropout, "key_words", fake_key_words)
    monkeypatch.setattr(port_transformer, "bernoulli_mask",
                        fake_bernoulli_mask)
    return jax_att, jax_ld, port


@functools.cache
def _encoders(name):
    kw = {**CASES[name], **CONV}
    je = JEnc(input_dim=16, d_model=32, d_ff=48, n_heads=2, dropout=0.0,
              dropout_att=DROP_ATT, dropout_layer=DROP_LAYER,
              ffn_activation="swish", **kw)
    rng = np.random.RandomState(0)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.randn(*x.shape).astype(
            np.float32),
        jax.tree.map(np.asarray, jax.jit(je.init)(
            jax.random.PRNGKey(0), jnp.zeros((2, 40, 16)),
            jnp.array([40, 30]))["params"]))
    te = XformerEncoder(input_dim=16, d_model=32, d_ff=48, n_heads=2,
                        dropout=0.0, dropout_att=DROP_ATT,
                        dropout_layer=DROP_LAYER, ffn_activation="swish",
                        **kw)
    te.load_state_dict(convert_params(params), strict=True)
    return je, params, te.train()


@pytest.mark.parametrize("name", sorted(CASES))
def test_encoder_dropout_matches_jax_on_pinned_draws(monkeypatch, name):
    je, params, te = _encoders(name)
    n_layers = CASES[name]["n_layers"]
    assert [b.dropout_layer for b in te.blocks] == pytest.approx(
        [DROP_LAYER * (l + 1) / n_layers for l in range(n_layers)])
    jax_att, jax_ld, port = _pin(monkeypatch)
    rng = np.random.RandomState(1)
    xs = rng.randn(3, 45, 16).astype(np.float32)
    xlens = np.array([45, 37, 10], np.int32)
    want = jax.jit(lambda p: je.apply(
        {"params": p}, jnp.asarray(xs), jnp.asarray(xlens),
        deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(2)})["ys"]["xs"])(params)
    with torch.no_grad():
        out = te(torch.from_numpy(xs), torch.from_numpy(xlens),
                 gen=torch.Generator().manual_seed(0))["ys"]["xs"]
    assert (len(jax_att), len(jax_ld)) == (port["att"], port["ld"])
    assert 0 < port["att"] and not all(DECISIONS[:port["ld"]])
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_eval_draws_nothing(monkeypatch):
    """``eval()`` drops no attention probability and no branch."""
    _, _, te = _encoders("conformer")
    _, _, port = _pin(monkeypatch)
    te.eval()
    try:
        with torch.no_grad():
            te(torch.zeros(1, 20, 16), torch.tensor([20]))
    finally:
        te.train()
    assert port == {"att": 0, "ld": 0}
