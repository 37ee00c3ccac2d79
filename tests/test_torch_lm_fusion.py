"""Port parity: the LAS beam with an LM, ``Speech2TextSession.decode``.

The small flagship-shaped model of ``test_torch_decode.py`` and small
RNNLMs (rnnlm_6L's shape at width 24: tied, residual, GLU), each with the
JAX weights converted, fed the same numpy utterances one request at a
time: shallow fusion, with joint CTC and length normalisation, with
internal-LM subtraction, second-pass and backward-LM rescoring of the
n-best, and ``device_beam`` with an LM (which takes the host beam, as the
JAX session does). Tokens must be identical and the n-best's joint and
attention scores agree to atol = rtol = 2e-4; the top-2 joint-score
margin is asserted above 1e-3, so a flipped hypothesis is a bug, not a
tie.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from neural_sp_tpu.models.decoders.decoding import (
    DecodeConfig as JaxDecodeConfig, Speech2TextSession as JaxSession)
from neural_sp_tpu.models.lm.rnnlm import RNNLM as JaxRNNLM
from neural_sp_tpu.models.lm.session import LMSession as JaxLMSession
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu_torch.configs import flagship_args
from neural_sp_tpu_torch.models.decoders.decoding import (
    DecodeConfig, Speech2TextSession)
from neural_sp_tpu_torch.models.lm.rnnlm import RNNLM
from neural_sp_tpu_torch.models.lm.session import LMSession
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.utils.convert_params import convert_params

ATOL = RTOL = 2e-4
SEED = 0
MARGIN = 1e-3
VOCAB = 40
LM_OPTS = dict(n_units=24, n_layers=2, emb_dim=24, tie_embedding=True,
               residual=True, use_glu=True)


@pytest.fixture(scope="module")
def models():
    args = vars(flagship_args(faithful=True))
    args.update(enc_n_layers=2, transformer_d_model=64,
                transformer_d_ff=128, transformer_n_heads=4, dec_n_units=64,
                emb_dim=32, dec_bottleneck_dim=64, attn_dim=32, vocab=VOCAB,
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
    lms = {}
    for name, seed in (("lm", 1), ("second", 4), ("bwd", 3)):
        jlm = JaxRNNLM(vocab=VOCAB, **LM_OPTS)
        ys = jnp.ones((1, 3), jnp.int32)
        params = jlm.init(jax.random.PRNGKey(seed), ys, ys)["params"]
        tlm = RNNLM(vocab=VOCAB, device="cpu", **LM_OPTS)
        tlm.load_state_dict(convert_params(jax.tree.map(np.asarray, params)),
                            strict=True)
        lms[name] = (JaxLMSession(jlm, params), LMSession(tlm.eval()))
    return jm, v["params"], tm.eval(), lms, xs, xlens


CASES = {
    "lm": dict(beam_width=3, lm_weight=0.3),
    "ctc_lm_length_norm": dict(beam_width=3, ctc_weight=0.3, lm_weight=0.5,
                               length_norm=True),
    "lm_ilm": dict(beam_width=3, lm_weight=0.3, ilm_weight=0.2),
    "rescore": dict(beam_width=3, lm_weight=0.3, lm_second_weight=1.0,
                    lm_bwd_weight=0.3),
    "device_beam_lm": dict(beam_width=3, lm_weight=0.3, device_beam=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_decode_with_lm_parity(models, case):
    jm, params, tm, lms, xs, xlens = models
    conf = dict(CASES[case], n_best=3)
    jsess = JaxSession(jm, params, JaxDecodeConfig(**conf),
                       lm_session=lms["lm"][0])
    tsess = Speech2TextSession(tm, DecodeConfig(**conf),
                               lm_session=lms["lm"][1])
    if case == "rescore":
        jsess.attach_second_pass_lms(lms["second"][0], lms["bwd"][0])
        tsess.attach_second_pass_lms(lms["second"][1], lms["bwd"][1])
    # the beam's own first hypotheses, before any rescoring
    firsts = Speech2TextSession(tm, DecodeConfig(**conf),
                                lm_session=lms["lm"][1]).decode(xs, xlens)
    changed = False
    for b in range(xs.shape[0]):   # one request per utterance
        want = jsess.decode(xs[b:b + 1], xlens[b:b + 1])
        got = tsess.decode(xs[b:b + 1], xlens[b:b + 1])
        assert got == want
        changed |= got != [firsts[b]]
        # the host beam ran (the on-device beam keeps no n-best scores)
        js, ts = jsess._last_nbest_scores, tsess._last_nbest_scores
        assert len(ts) == len(js) == 3
        assert js[0] - js[1] > MARGIN and ts[0] - ts[1] > MARGIN
        np.testing.assert_allclose(ts, js, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tsess._last_nbest_scores_att,
                                   jsess._last_nbest_scores_att,
                                   atol=ATOL, rtol=RTOL)
        tsess._last_nbest_scores = None
    # rescoring picked another than the beam's first hypothesis at least
    # once, so the parity above covers its choice
    assert changed == (case == "rescore")
