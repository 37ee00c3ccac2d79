"""Port parity: the RNNLM, its session and ``build_lm``.

A JAX ``RNNLM`` initialised from a seed, its params carried by
``convert_params`` into the port's ``RNNLM(device="cpu")`` (loaded with
``strict=True``), fed the same numpy token ids: hidden states, logits,
loss / ppl / acc and the carried state over a second BPTT window, for each
option set; ``LMSession.predict`` chained token by token (with beam
reorders) against JAX's chain and the port's own parallel ``decode``;
``score_sequence``, ``ppl_with_cache`` and ``rescore_nbest`` against
JAX's. float32, atol = rtol = 2e-4 (the repo's tolerance).
"""
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import yaml

from neural_sp_tpu.models.lm.rnnlm import RNNLM as JaxRNNLM
from neural_sp_tpu.models.lm.session import (
    LMSession as JaxLMSession, rescore_nbest as jax_rescore_nbest)
from neural_sp_tpu_torch.configs import flagship_args, librispeech_rnnlm_args
from neural_sp_tpu_torch.models.lm.build import build_lm
from neural_sp_tpu_torch.models.lm.rnnlm import RNNLM
from neural_sp_tpu_torch.models.lm.session import LMSession, rescore_nbest
from neural_sp_tpu_torch.utils.convert_params import convert_params
from neural_sp_tpu_torch.utils.init_params import init_params

ATOL = RTOL = 2e-4
VOCAB = 40
ROOT = Path(__file__).resolve().parents[1]

# option sets of the JAX class; "tied_residual_glu" is rnnlm_6L's shape
# (emb_dim == n_units, so the first layer could take a residual and must
# not)
OPTIONS = {
    "plain": dict(n_units=24, n_layers=2, emb_dim=16),
    "tied_residual_glu": dict(n_units=24, n_layers=3, emb_dim=24,
                              tie_embedding=True, residual=True,
                              use_glu=True),
    "tied_bridge": dict(n_units=24, n_projs=12, n_layers=2, emb_dim=16,
                        tie_embedding=True),
    "n_projs": dict(n_units=24, n_projs=12, n_layers=3, emb_dim=16,
                    residual=True),
    "null_context": dict(n_units=16, n_layers=2, emb_dim=16,
                         n_units_null_context=8),
    "adaptive_softmax": dict(n_units=32, n_layers=2, emb_dim=16,
                             adaptive_softmax=True,
                             adaptive_softmax_cutoffs=(10, 30)),
    "lsm": dict(n_units=24, n_layers=2, emb_dim=16, lsm_prob=0.1),
}


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def _pair(opts, seed=0):
    """(JAX module, its params, the port's RNNLM with them)."""
    jlm = JaxRNNLM(vocab=VOCAB, **opts)
    ys = jnp.ones((2, 5), jnp.int32)
    params = jlm.init(jax.random.PRNGKey(seed), ys, ys)["params"]
    tlm = RNNLM(vocab=VOCAB, device="cpu", **opts)
    tlm.load_state_dict(convert_params(jax.tree.map(np.asarray, params)),
                        strict=True)
    return jlm, params, tlm.eval()


def _tokens(rng, shape):
    return rng.integers(4, VOCAB, shape).astype(np.int32)


def _jstate(state):
    return [(np.asarray(c), np.asarray(h)) for c, h in state]


@pytest.mark.parametrize("name", list(OPTIONS))
def test_rnnlm_matches_jax(name):
    jlm, params, tlm = _pair(OPTIONS[name])
    rng = np.random.default_rng(1)
    ys_in = _tokens(rng, (2, 9))
    ys_out = np.roll(ys_in, -1, axis=1)
    ys_out[1, 6:] = 3                           # PAD, ignored by the loss
    v = {"params": params}
    # window 1 from the zero state, window 2 from window 1's carry
    jstate, tstate = None, None
    for window in range(2):
        jh, jnew = jlm.apply(v, jnp.asarray(ys_in), jstate,
                             method=jlm.decode)
        jlogits = jlm.apply(v, jh, method=jlm.logits_from_hidden)
        jloss, _, jobs = jlm.apply(v, jnp.asarray(ys_in),
                                   jnp.asarray(ys_out), jstate)
        with torch.no_grad():
            th, tnew = tlm.decode(torch.from_numpy(ys_in).long(), tstate)
            tlogits = tlm.logits_from_hidden(th)
            tloss, _, tobs = tlm(torch.from_numpy(ys_in).long(),
                                 torch.from_numpy(ys_out).long(), tstate)
        _close(th, jh, f"window {window}: hidden")
        _close(tlogits, jlogits, f"window {window}: logits")
        _close(tloss, jloss, f"window {window}: loss")
        for key in ("loss", "ppl", "acc"):
            _close(tobs[key], jobs[key], f"window {window}: {key}")
        for (tc, th_), (jc, jh_) in zip(tnew, _jstate(jnew)):
            _close(tc, jc, f"window {window}: c")
            _close(th_, jh_, f"window {window}: h")
        jstate, tstate = jnew, tnew
        ys_in = _tokens(rng, (2, 9))
        ys_out = np.roll(ys_in, -1, axis=1)


def test_first_layer_takes_no_residual():
    """rnnlm_6L's shape: emb_dim == n_units; a residual on layer 0 would
    change the hidden states (held against JAX above), and layer 0's output
    is exactly its LSTM's."""
    _, _, tlm = _pair(OPTIONS["tied_residual_glu"])
    tlm.n_layers = 1
    tlm.use_glu = False
    ys = torch.from_numpy(_tokens(np.random.default_rng(2), (2, 5))).long()
    with torch.no_grad():
        h, _ = tlm.decode(ys)
        want, _ = tlm.rnns[0](tlm.embed(ys))
    torch.testing.assert_close(h, want, atol=0, rtol=0)


@pytest.mark.parametrize("name", ["plain", "tied_residual_glu",
                                  "adaptive_softmax"])
def test_predict_chain_matches_jax_and_parallel_decode(name):
    """LMSession.predict token by token at B = 3, beam reorders between
    steps, against JAX's session chain reordered the same way; without
    reorders, against the port's parallel decode over the sequence."""
    jlm, params, tlm = _pair(OPTIONS[name])
    jsess, tsess = JaxLMSession(jlm, params), LMSession(tlm)
    rng = np.random.default_rng(3)
    ys = _tokens(rng, (3, 7))
    jstate, tstate = jsess.initial_state(3), tsess.initial_state(3)
    for t in range(ys.shape[1]):
        jlp, jstate = jsess.predict(ys[:, t], jstate)
        tlp, tstate = tsess.predict(ys[:, t], tstate)
        assert tlp.dtype == np.float32 and tlp.shape == (3, VOCAB)
        _close(tlp, jlp, f"step {t}")
        par = rng.integers(0, 3, 3)
        jstate = jax.tree.map(lambda x: x[jnp.asarray(par)], jstate)
        tstate = tsess.select(tstate, par)
    # no reorders: the chain is the parallel decode
    tstate, chain = None, []
    for t in range(ys.shape[1]):
        lp, tstate = tsess.predict(ys[:, t], tstate)
        chain.append(lp)
    with torch.no_grad():
        h, _ = tlm.decode(torch.from_numpy(ys).long())
        logits = tlm.logits_from_hidden(h).float()
        par_lp = logits if name == "adaptive_softmax" else \
            torch.log_softmax(logits, -1)
    _close(np.stack(chain, 1), par_lp, "chain vs parallel decode")


def test_session_scores_match_jax():
    jlm, params, tlm = _pair(OPTIONS["tied_residual_glu"])
    jsess = JaxLMSession(jlm, params, cache_size=8)
    tsess = LMSession(tlm, cache_size=8)
    ids = [int(t) for t in _tokens(np.random.default_rng(4), 13)]
    _close(tsess.score_sequence(ids), jsess.score_sequence(ids),
           "score_sequence")
    _close(tsess.ppl_with_cache(ids), jsess.ppl_with_cache(ids),
           "ppl_with_cache")
    _, h = tsess.predict_with_hidden(np.asarray([ids[0]]), None)[1:]
    _, jh = jsess.predict_with_hidden(np.asarray([ids[0]]), None)[1:]
    _close(h, jh, "hidden")


def test_rescore_nbest_matches_jax():
    jlm, params, tlm = _pair(OPTIONS["plain"], seed=5)
    jlm_b, params_b, tlm_b = _pair(OPTIONS["plain"], seed=6)
    rng = np.random.default_rng(5)
    nbest = [[int(t) for t in _tokens(rng, n)] for n in (6, 4, 7, 5)]
    scores = [-3.1, -3.2, -3.25, -4.0]
    for w, w_bwd in ((0.5, 0.0), (0.3, 0.3), (2.0, 1.0)):
        want = jax_rescore_nbest(nbest, scores, JaxLMSession(jlm, params), w,
                                 JaxLMSession(jlm_b, params_b), w_bwd)
        got = rescore_nbest(nbest, scores, LMSession(tlm), w,
                            LMSession(tlm_b), w_bwd)
        assert got == want


def test_build_lm():
    args = SimpleNamespace(lm_type="lstm", vocab=VOCAB, n_units=16,
                           n_layers=2, emb_dim=16, tie_embedding=True,
                           use_glu=True)
    lm = build_lm(args, device="cpu")
    assert isinstance(lm, RNNLM) and lm.tie_embedding and lm.use_glu
    assert {p.device.type for p in lm.parameters()} == {"cpu"}
    # the other families raised here until they were ported: they build
    # (tests/test_torch_lm_families.py holds them to JAX)
    tlm = build_lm(SimpleNamespace(lm_type="transformer", vocab=VOCAB,
                                   transformer_d_model=16, n_layers=1),
                   device="cpu")
    assert type(tlm).__name__ == "TransformerLM"
    assert {p.device.type for p in tlm.parameters()} == {"cpu"}


def test_build_lm_needs_the_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = SimpleNamespace(lm_type="lstm", vocab=VOCAB, n_units=16,
                           n_layers=1, emb_dim=16)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_lm(args)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        RNNLM(vocab=VOCAB, n_units=16, n_layers=1, emb_dim=16)


def test_librispeech_rnnlm_args_equal_the_recipe():
    conf = yaml.safe_load((ROOT / "examples/librispeech/conf/lm/"
                           "rnnlm_6L.yaml").read_text())
    args = vars(librispeech_rnnlm_args())
    assert args.pop("vocab") == flagship_args().vocab == 10000
    assert args == {k: conf[k] for k in args}
    topology = ("lm_type", "n_units", "n_projs", "n_layers", "emb_dim",
                "n_units_null_context", "tie_embedding", "residual",
                "use_glu", "bptt", "param_init", "adaptive_softmax")
    assert set(topology) <= set(args)


def test_convert_and_init_fill_every_lm_tensor():
    """convert_params: the LM's paths (rnns_{l}/fwd, projs_{l}, glu/Dense_0,
    asm/tails_{i}_{j}) and the top-level output_bias fill every tensor;
    init_params: the free output_bias gets zeros, every weight a seeded
    draw."""
    for name in ("tied_bridge", "adaptive_softmax", "tied_residual_glu"):
        jlm = JaxRNNLM(vocab=VOCAB, **OPTIONS[name])
        ys = jnp.ones((1, 3), jnp.int32)
        params = jax.tree.map(np.asarray, jlm.init(
            jax.random.PRNGKey(0), ys, ys)["params"])
        sd = convert_params(params)
        assert set(sd) == set(RNNLM(vocab=VOCAB, device="cpu",
                                    **OPTIONS[name]).state_dict())
    opts = OPTIONS["tied_residual_glu"]
    a = init_params(RNNLM(vocab=VOCAB, device="cpu", **opts), 7).state_dict()
    b = init_params(RNNLM(vocab=VOCAB, device="cpu", **opts), 7).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["output_bias"].abs().max()) == 0.0
    assert float(a["rnns.1.lstm.weight_hh_l0"].std()) > 0.0
