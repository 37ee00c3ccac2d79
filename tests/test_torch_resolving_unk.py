"""Port parity: the MTL evaluation's ``resolving_unk``
(``evaluators/asr.py::eval_word(resolving_unk=True)`` and
``resolve_unk_text``) against the JAX evaluator's.

* ``resolve_unk_text`` on given hypotheses, attention peaks and char CTC
  paths (an ``<unk>`` at the start, in the middle and at the end, one whose
  window holds no char, no peaks) against JAX's: the same text.
* ``eval_word(resolving_unk=True)`` over a tiny hierarchical model (the
  AISHELL hierarchical Conformer-LAS cut: a word main task, a char sub1
  CTC on the tap after layer 3 of 4, max_pools after layers 2 and 4) on
  the same converted weights, the JAX weights perturbed and the output
  bias of ``<unk>`` raised so that the beam emits it, a ``make_ci_corpus``
  test set read through a word dictionary without two of its words
  (``<unk>`` in the references' vocabulary), beam 4 + CTC 0.3: each
  utterance's best hypothesis, peaks and resolved text equal to JAX's, and
  the WER.
* C46: JAX compares the main decoder's attention-peak frames (encoder
  frames) with the sub1 head's first-emission frames (its tap's, twice as
  many here) as they are; the port mirrors it: the frames reach
  ``resolve_unk_text`` unscaled, on their two grids.
"""
import functools
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import neural_sp_tpu.evaluators.asr as jax_asr
import neural_sp_tpu_torch.evaluators.asr as port_asr
from neural_sp_tpu.datasets.asr.build import (
    build_dataloader as jax_build_dataloader)
from neural_sp_tpu.models.decoders.decoding import (
    DecodeConfig as JaxDecodeConfig, Speech2TextSession as JaxSession)
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu.utils.ci_corpus import make_ci_corpus
from neural_sp_tpu_torch.datasets.asr.build import build_dataloader
from neural_sp_tpu_torch.models.decoders.decoding import (
    DecodeConfig, Speech2TextSession)
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.utils.convert_params import convert_params

from test_torch_mtl import _conf, AISHELL

UNK = 1
DROPPED = ("gon", "huk")     # the words the dictionary leaves out
PERTURB, UNK_SHIFT, CHAR_SCALE, BLANK_SHIFT = 0.3, 4.0, 30.0, -3.0


def test_resolve_unk_text_matches_jax():
    words = {4: "aba", 5: "bec", UNK: "<unk>"}
    chars = {4: "a", 5: "b", 6: "c", 7: "<space>"}

    def idx2word(ids):
        return " ".join(words[i] for i in ids)

    def idx2char(ids):
        return "".join(chars[i] for i in ids).replace("<space>", " ")

    cases = [
        ([UNK, 4, UNK, 5, UNK], [1, 4, 8, 12, 15],
         [4, 5, 7, 6, 6, 4, 5, 7, 4], [0, 1, 3, 6, 9, 10, 12, 13, 16]),
        ([4, UNK, 5], [2, 3, 9], [5, 6], [20, 21]),    # no char in window
        ([UNK, 4], [], [4, 5], [0, 1]),                 # no peaks
        ([5, 4], [2, 5], [4], [3]),                     # no <unk>
    ]
    for hyp, peaks, path, frames in cases:
        want = jax_asr.resolve_unk_text(hyp, peaks, idx2word, path, frames,
                                        idx2char)
        assert port_asr.resolve_unk_text(hyp, peaks, idx2word, path, frames,
                                         idx2char) == want


def small_hierarchical(vocab, vocab_sub1):
    """The AISHELL hierarchical Conformer-LAS cut: one pooling block of
    the front end, 4 conformer layers of d 32 with max_pools after layers
    2 and 4 and the char CTC sub1 after layer 3, LSTM-32 LAS; dropout and
    SpecAugment off."""
    return _conf(AISHELL, input_dim=80, conv_channels="4_4",
                 conv_poolings="(1,1)_(2,2)", enc_n_layers=4, enc_n_layers_sub1=3, subsample="1_2_1_2",
                 transformer_enc_d_model=32, transformer_enc_d_ff=48,
                 transformer_enc_n_heads=2, dec_n_units=32, emb_dim=16,
                 dec_bottleneck_dim=32, attn_dim=16, attn_conv_width=9,
                 ctc_fc_list="16", vocab=vocab, vocab_sub1=vocab_sub1,
                 dropout_enc=0.0, dropout_dec=0.0, dropout_emb=0.0,
                 ss_prob=0.0, n_freq_masks=0, n_time_masks=0)


@functools.cache
def setup(root):
    corpus = make_ci_corpus(os.path.join(root, "corpus"), n_train=2,
                            n_dev=1, n_test=6, max_words=5, seed=2)
    word_dict = os.path.join(root, "dict_word.txt")
    with open(corpus["dict_word"]) as f, open(word_dict, "w") as g:
        g.writelines(line for line in f if line.split()[0] not in DROPPED)
    kw = dict(tsv_path=corpus["test_word"], dict_path=word_dict,
              unit="word", batch_size=3, is_test=True,
              dict_path_sub1=corpus["dict_char"], unit_sub1="char")
    jl, pl = jax_build_dataloader(**kw), build_dataloader(**kw)
    args = small_hierarchical(pl.vocab, pl.vocab_sub1)
    jm = jax_build(args)
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64, 80)), jnp.array([64, 50]),
        jnp.ones((2, 3), jnp.int32), jnp.array([3, 2]),
        ys_sub1=jnp.ones((2, 5), jnp.int32),
        ylens_sub1=jnp.array([5, 4]))["params"]
    rng = np.random.RandomState(3)
    params = jax.tree.map(lambda x: np.asarray(x) + PERTURB * rng.randn(
        *x.shape).astype(np.float32), jax.tree.map(np.asarray, params))
    # more <unk> from the decoder
    out = params["dec_fwd"]["step"]["output"]
    out["bias"] = out["bias"].copy()
    out["bias"][UNK] += UNK_SHIFT
    # a char head whose best path moves from frame to frame: the tap's
    # outputs are mostly a part common to every frame, which the head's
    # bias takes out, and its kernel scaled up; fewer blanks
    out = params["ctc_sub1"]["output"]
    out["kernel"] = out["kernel"] * CHAR_SCALE
    tm = build_speech2text(args, device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    frames = []
    with torch.no_grad():
        for b in pl:
            tap = tm.encode(torch.from_numpy(b["xs"]),
                            torch.from_numpy(b["xlens"]))[0]["ys_sub1"]
            frames += [x[:n] for x, n in zip(tap["xs"], tap["xlens"])]
    mean = torch.cat(frames).mean(0).numpy()
    out["bias"] = (BLANK_SHIFT * (np.arange(len(out["bias"])) == 0)
                   - mean.dot(out["kernel"])).astype(np.float32)
    tm.load_state_dict(convert_params(params), strict=True)
    conf = dict(beam_width=4, ctc_weight=0.3)
    return (JaxSession(jm, params, JaxDecodeConfig(**conf)), jl,
            Speech2TextSession(tm.eval(), DecodeConfig(**conf)), pl)


def _spied(monkeypatch, module):
    calls = []
    real = module.resolve_unk_text

    def spy(hyp, peaks, idx2word, path, frames, idx2char, *a):
        calls.append((list(map(int, hyp)), list(peaks), list(path),
                      list(frames)))
        calls[-1] += (real(hyp, peaks, idx2word, path, frames, idx2char,
                           *a),)
        return calls[-1][-1]

    monkeypatch.setattr(module, "resolve_unk_text", spy)
    return calls


def test_eval_word_resolving_unk_matches_jax(tmp_path_factory, monkeypatch):
    js, jl, ps, pl = setup(str(tmp_path_factory.mktemp("resolving_unk")))
    jcalls, pcalls = _spied(monkeypatch, jax_asr), _spied(monkeypatch,
                                                          port_asr)
    want = jax_asr.eval_word(js, jl, resolving_unk=True)
    got = port_asr.eval_word(ps, pl, resolving_unk=True)
    assert len(pcalls) == len(jcalls) == 6
    for p, j in zip(pcalls, jcalls):
        assert p == j
    # the <unk>s were there to resolve, and some were resolved
    assert sum(c[0].count(UNK) for c in pcalls) >= 2
    assert any("<unk>" not in c[4] and UNK in c[0] for c in pcalls)
    assert got == pytest.approx(want, rel=1e-12)
    assert got["n_utts"] == 6


def test_c46_frames_reach_resolve_unk_text_on_their_own_grids(
        tmp_path_factory, monkeypatch):
    """The peaks are encoder frames, the char emissions the tap's (twice
    as many: one max_pool between them), passed unscaled, as JAX does."""
    _, _, ps, pl = setup(str(tmp_path_factory.mktemp("resolving_unk")))
    calls = _spied(monkeypatch, port_asr)
    port_asr.eval_word(ps, pl, resolving_unk=True)
    grids = []
    for b in pl:
        e = ps.encode(b["xs"], b["xlens"])
        grids += zip(e["ys"]["xlens"].tolist(),
                     e["ys_sub1"]["xlens"].tolist())
    assert len(grids) == len(calls) == 6
    for (_, peaks, _, frames, _), (n_main, n_tap) in zip(calls, grids):
        assert n_tap == 2 * n_main or n_tap == 2 * n_main - 1
        assert all(p < n_main for p in peaks)
        assert all(f < n_tap for f in frames)
    # emissions past the encoder's last frame: on the tap's grid only
    assert any(f >= n_main for (_, _, _, frames, _), (n_main, _) in
               zip(calls, grids) for f in frames)
