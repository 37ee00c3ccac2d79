"""Port parity: the whole serving slice, ``Speech2TextSession.decode``.

The small flagship-shaped model (2 conformer layers, d_model 64, 4 heads,
d_ff 128, LSTM 64, attention 32, vocab 40, conv width 201) with the JAX
weights converted, fed the same numpy utterances: greedy decoding and beam
3 with joint CTC weight 0.3 must give identical token sequences, and the
n-best scores must agree to the float32 tolerance (atol = rtol = 2e-4).
The seed is chosen so that the top-2 beam-score margin exceeds 1e-3, and
the test asserts that margin: a flipped hypothesis is then a bug, not a
tie.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from neural_sp_tpu.models.decoders.decoding import (
    DecodeConfig as JaxDecodeConfig, Speech2TextSession as JaxSession)
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu_torch.configs import flagship_args
from neural_sp_tpu_torch.models.decoders.decoding import (
    DecodeConfig, Speech2TextSession)
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.utils.convert_params import convert_params

ATOL = RTOL = 2e-4
SEED = 0
MARGIN = 1e-3


@pytest.fixture(scope="module")
def models():
    args = vars(flagship_args(faithful=True))
    args.update(enc_n_layers=2, transformer_d_model=64,
                transformer_d_ff=128, transformer_n_heads=4, dec_n_units=64,
                emb_dim=32, dec_bottleneck_dim=64, attn_dim=32, vocab=40,
                subsample="1_2")
    args = SimpleNamespace(**args)
    rng = np.random.RandomState(SEED)
    xs = rng.randn(2, 120, 80).astype(np.float32)
    xlens = np.array([120, 90], np.int32)
    jm = jax_build(args)
    v = jm.init(jax.random.PRNGKey(SEED), jnp.asarray(xs),
                jnp.asarray(xlens), jnp.ones((2, 5), jnp.int32),
                jnp.array([5, 3]))
    tm = build_speech2text(args, device="cpu")
    tm.load_state_dict(
        convert_params(jax.tree.map(np.asarray, v["params"])), strict=True)
    return jm, v["params"], tm.eval(), xs, xlens


def test_decode_greedy_parity(models):
    jm, params, tm, xs, xlens = models
    conf = dict(beam_width=1)
    want = JaxSession(jm, params, JaxDecodeConfig(**conf)).decode(xs, xlens)
    got = Speech2TextSession(tm, DecodeConfig(**conf)).decode(xs, xlens)
    assert got == want
    assert all(len(h) > 0 for h in got)
    assert all(len(h) > 0 for h in got)


def test_decode_beam_ctc_parity(models):
    jm, params, tm, xs, xlens = models
    conf = dict(beam_width=3, ctc_weight=0.3, n_best=3)
    jsess = JaxSession(jm, params, JaxDecodeConfig(**conf))
    tsess = Speech2TextSession(tm, DecodeConfig(**conf))
    for b in range(xs.shape[0]):   # one request per utterance
        want = jsess.decode(xs[b:b + 1], xlens[b:b + 1])
        got = tsess.decode(xs[b:b + 1], xlens[b:b + 1])
        assert got == want
        js, ts = jsess._last_nbest_scores, tsess._last_nbest_scores
        assert len(ts) == len(js) == 3
        assert js[0] - js[1] > MARGIN and ts[0] - ts[1] > MARGIN
        np.testing.assert_allclose(ts, js, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tsess._last_nbest_scores_att,
                                   jsess._last_nbest_scores_att,
                                   atol=ATOL, rtol=RTOL)


def test_decode_ctc_greedy_parity(models):
    jm, params, tm, xs, xlens = models
    want = JaxSession(jm, params).decode_ctc_greedy(xs, xlens)
    got = Speech2TextSession(tm).decode_ctc_greedy(xs, xlens)
    assert got == want


@pytest.mark.parametrize("field,value", [
    ("fwd_bwd_attention", True), ("state_carry_over", True),
    ("ensemble", True)])
def test_unported_decode_options_raise(models, field, value):
    """A ``DecodeConfig`` field, or the session's ``ensemble``, that is not
    ported yet (LM fusion and rescoring are: tests/test_torch_lm_fusion.py)."""
    tm = models[2]
    if field == "ensemble":
        kwargs = dict(ensemble=[Speech2TextSession(tm)])
    else:
        kwargs = dict(conf=DecodeConfig(**{field: value}))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Speech2TextSession(tm, **kwargs)


@pytest.mark.parametrize("conf", [
    dict(beam_width=3, min_len_ratio=0.1),
    dict(beam_width=4, length_penalty=0.5, min_len_ratio=0.2),
    dict(beam_width=3, length_norm=True, eos_threshold=1.2),
])
def test_decode_device_beam_parity(models, conf):
    """The batched on-device beam (fusion-free decoding), the whole batch
    at once, dispatched by ``decode`` as in the JAX session."""
    jm, params, tm, xs, xlens = models
    conf = dict(conf, device_beam=True)
    want = JaxSession(jm, params, JaxDecodeConfig(**conf)).decode(xs, xlens)
    got = Speech2TextSession(tm, DecodeConfig(**conf)).decode(xs, xlens)
    assert got == want
    assert all(len(h) > 0 for h in got)
