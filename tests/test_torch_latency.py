"""Port parity: trigger points from alignments and MoChA's latency training
(DeCoT, MinLT), against the JAX package on the same numpy inputs with the
JAX weights converted (``convert_params``), float32, atol = rtol = 2e-4
(the repo's).

* ``datasets/alignment.py`` against its original: word alignments to
  token boundaries (by characters and uniform, a speed-perturbed copy, a
  missing file and a word count that does not match), CTC alignments.
* The loaders with ``word_alignment_dir`` (wordpiece and char units) and
  ``ctc_alignment_dir``: each item's trigger points and the collated
  ``trigger_points`` (-1 for an utterance without an alignment file) equal
  JAX's. With the word unit JAX splits a word into its characters (one
  boundary per character, not per token: ROADMAP C45); the port takes a
  word as one piece.
* A small LSTM-MoChA ``Speech2Text`` in ``train()`` (dropout and noise
  off) with DeCoT (lookahead 1) and with MinLT on given trigger points
  with a -1 row: the loss, its parts and every gradient leaf against
  ``jax.grad``; without given points DeCoT takes the CTC head's forced
  alignment and MinLT none (no latency loss), JAX's rule. The DeCoT mask
  zeroes each step's alignment past its window.
* The port's train CLI with ``--train_word_alignment`` on a MinLT conf:
  the batches' trigger points reach the latency loss.
"""
import math
import os
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from neural_sp_tpu.datasets import alignment as jax_alignment
from neural_sp_tpu.datasets.asr.dataloader import collate as jax_collate
from neural_sp_tpu.datasets.asr.dataset import ASRDataset as JaxDataset
from neural_sp_tpu.utils.ci_corpus import make_ci_corpus
from neural_sp_tpu_torch.bin.args import save_config
from neural_sp_tpu_torch.bin.asr import train as port_train
from neural_sp_tpu_torch.datasets import alignment
from neural_sp_tpu_torch.datasets.asr.dataloader import collate
from neural_sp_tpu_torch.datasets.asr.dataset import ASRDataset
from neural_sp_tpu_torch.parallel.mesh import TrainStep
from neural_sp_tpu_torch.utils.convert_params import convert_params

from test_torch_mocha import _close, _models, _tree, mocha_batch, small_mocha

RTOL = ATOL = 2e-4


def _write_alignment(root, speaker, utt_id, lines):
    d = Path(root) / speaker
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{utt_id}.txt").write_text("".join(f"{ln}\n" for ln in lines))


def _pieces(word):
    """A wordpiece split: the word's first two characters with the word
    start mark, then the rest."""
    return ["▁" + word[:2]] + ([word[2:]] if len(word) > 2 else [])


@pytest.mark.parametrize("split", ["character_length", "uniform"])
def test_word_alignment_converter_matches_jax(tmp_path, split):
    _write_alignment(tmp_path, "spk1", "u1",
                     ["hello 0.10 0.52", "a 0.52 0.60", "world 0.61 1.234"])
    _write_alignment(tmp_path, "spk1", "u2", ["hello 0.1 0.5"])
    want_conv = jax_alignment.WordAlignmentConverter(_pieces, split)
    got_conv = alignment.WordAlignmentConverter(_pieces, split)
    for spk, utt, text in (("spk1", "u1", "hello a world"),
                           ("sp0.9-spk1", "sp0.9-u1", "hello a world"),
                           ("spk1", "u2", "hello a"),      # mismatched
                           ("spk2", "u1", "hello a world")):   # no file
        want = want_conv(str(tmp_path), spk, utt, text)
        got = got_conv(str(tmp_path), spk, utt, text)
        if want is None:
            assert got is None, (spk, utt)
        else:
            np.testing.assert_array_equal(got, want)
            assert got.dtype == np.int32 and len(got) == 5
    _write_alignment(tmp_path / "ctc", "spk1", "u1", ["3", "7.0", "x 12"])
    np.testing.assert_array_equal(
        alignment.load_ctc_alignment(str(tmp_path / "ctc"), "spk1", "u1"),
        jax_alignment.load_ctc_alignment(str(tmp_path / "ctc"), "spk1",
                                         "u1"))
    assert alignment.load_ctc_alignment(str(tmp_path), "x", "y") is None


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A small corpus (wordpiece, char and word TSVs) with word alignments
    at even boundaries for every training utterance but the first (its
    row is -1), and CTC alignments for the first two."""
    root = tmp_path_factory.mktemp("latency")
    paths = make_ci_corpus(str(root / "corpus"), n_train=6, n_dev=2,
                           n_test=1, max_words=4, seed=3)
    import csv
    with open(paths["train"], newline="") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    for i, r in enumerate(rows):
        words = r["text"].split()
        sec = int(r["xlen"]) / 100.0
        edges = np.linspace(0.05, sec - 0.05, len(words) + 1)
        if i > 0:
            _write_alignment(root / "words", r["speaker"], r["utt_id"], [
                f"{w} {edges[j]:.3f} {edges[j + 1]:.3f}"
                for j, w in enumerate(words)])
        if i < 2:
            _write_alignment(root / "ctc", r["speaker"], r["utt_id"],
                             [str(3 * j + 1) for j in range(len(words))])
    paths["words"], paths["ctc"] = str(root / "words"), str(root / "ctc")
    paths["root"] = root
    return paths


UNITS = {"wp": ("train_wp", "dict_wp", True), "char": ("train", "dict_char",
                                                        False)}


@pytest.mark.parametrize("unit", sorted(UNITS))
def test_loader_trigger_points_match_jax(corpus, unit):
    """Items and the collated batch, with the subsampling factor 4 (word
    alignments in input frames are divided, as JAX's)."""
    tsv, dic, wp = UNITS[unit]
    kw = dict(tsv_path=corpus[tsv], dict_path=corpus[dic], unit=unit,
              wp_model=corpus["wp_model"] if wp else None,
              subsample_factor=4, word_alignment_dir=corpus["words"])
    want = JaxDataset(**kw, sort_by="input", short2long=True)
    got = ASRDataset(**kw, short2long=True)
    assert len(got) == len(want)
    items_w = [want[i] for i in range(len(want))]
    items_g = [got[i] for i in range(len(got))]
    assert sum("trigger_points" not in it for it in items_g) == 1
    for a, b in zip(items_g, items_w):
        assert ("trigger_points" in a) == ("trigger_points" in b)
        if "trigger_points" in a:
            np.testing.assert_array_equal(a["trigger_points"],
                                          b["trigger_points"])
    out_g = collate(items_g, 16, 8)
    out_w = jax_collate(items_w, 16, 8)
    np.testing.assert_array_equal(out_g["trigger_points"],
                                  out_w["trigger_points"])
    assert (out_g["trigger_points"] == -1).all(1).sum() == 1
    # CTC alignments: read as stored, only without word alignments
    kw.update(word_alignment_dir=None, ctc_alignment_dir=corpus["ctc"])
    want = JaxDataset(**kw, sort_by="input", short2long=True)
    got = ASRDataset(**kw, short2long=True)
    batch_w = jax_collate([want[i] for i in range(len(want))], 16, 8)
    batch_g = collate([got[i] for i in range(len(got))], 16, 8)
    np.testing.assert_array_equal(batch_g["trigger_points"],
                                  batch_w["trigger_points"])


def test_c45_the_word_unit_takes_a_word_as_one_piece(corpus):
    """JAX's loader splits a word into its characters when the unit has no
    wordpiece model: a word-unit utterance gets one boundary per character.
    The port's gets one per word (token)."""
    kw = dict(tsv_path=corpus["train_word"], dict_path=corpus["dict_word"],
              unit="word", subsample_factor=1,
              word_alignment_dir=corpus["words"])
    want = JaxDataset(**kw, sort_by="input", short2long=True)
    got = ASRDataset(**kw, short2long=True)
    for i in range(len(got)):
        it_g, it_w = got[i], want[i]
        if "trigger_points" not in it_g:
            continue
        words = it_g["text"].split()
        assert len(it_g["trigger_points"]) == len(it_g["ys"]) == len(words)
        assert len(it_w["trigger_points"]) == sum(map(len, words))


# ------------------------------------------------------------ the losses
def _trigger_points(ylens, frames, u):
    """Boundaries spread over each row's frames, -1 past its labels; the
    last row without an alignment (-1 throughout)."""
    tp = np.full((len(ylens), u), -1, np.int32)
    for b, (n, t) in enumerate(zip(ylens, frames)):
        tp[b, :n] = (np.arange(1, n + 1) * (t - 1)) // n
    tp[-1] = -1
    return tp


LATENCY_CASES = {
    "decot": dict(mocha_latency_metric="decot", mocha_decot_lookahead=1),
    "minlt": dict(mocha_latency_metric="minlt",
                  mocha_latency_loss_weight=0.5),
}


@pytest.mark.parametrize("case", sorted(LATENCY_CASES))
def test_latency_losses_match_jax(case):
    """On given trigger points (a -1 row); then the port without any:
    DeCoT takes the CTC head's forced alignment (JAX's rule, held against
    JAX in test_torch_triggered.py's eval test), MinLT none, so no
    latency loss."""
    jm, params, tm = _models(**LATENCY_CASES[case])
    assert tm.dec_fwd.trigger_lookahead == LATENCY_CASES[case].get(
        "mocha_decot_lookahead", 2)
    xs, xlens, ys, ylens = mocha_batch(1)
    frames = [(int(n) + 1) // 2 for n in xlens]     # the x2 front end
    tp = _trigger_points(ylens, frames, ys.shape[1])
    b = (xs, xlens, ys, ylens)

    def jloss(p):
        return jm.apply({"params": p}, *map(jnp.asarray, b),
                        deterministic=False, trigger_points=jnp.asarray(tp),
                        rngs={"dropout": jax.random.PRNGKey(1),
                              "specaug": jax.random.PRNGKey(2)})

    (want, jobs), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    tm.train()
    loss, obs = tm(*map(torch.from_numpy, b),
                   torch.Generator().manual_seed(0),
                   trigger_points=torch.from_numpy(tp))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=RTOL)
    assert ("loss_latency" in obs) == ("loss_latency" in jobs) == \
        (case == "minlt")
    for name in ("loss_ctc", "loss_att", "loss_quantity", "loss_latency"):
        if name in jobs:
            np.testing.assert_allclose(float(obs[name].detach()),
                                       float(jobs[name]), rtol=RTOL,
                                       atol=ATOL, err_msg=name)
    want_g = convert_params(_tree(grads))
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), want_g[name].numpy(), name)
    ex = tm.encoder(*map(torch.from_numpy, b[:2]))["ys"]
    trig = tm.decoder_triggers(ex["xs"], ex["xlens"],
                               *map(torch.from_numpy, b[2:]))
    if case == "minlt":
        assert trig is None
        _, obs = tm(*map(torch.from_numpy, b),
                    torch.Generator().manual_seed(0))
        assert "loss_latency" not in obs
    else:
        want_t = tm.ctc.trigger_points(ex["xs"], ex["xlens"],
                                       *map(torch.from_numpy, b[2:]))
        assert torch.equal(trig, want_t)


def test_decot_masks_past_the_window():
    """The DeCoT mask bounds each step's expected alignment: a trigger at
    frame 0 with lookahead 0 leaves the labels' steps mass on frames 0-2
    only (MoChA's decot_delta 2); without trigger points the same model
    puts mass past them."""
    _, _, tm = _models(mocha_latency_metric="decot", mocha_decot_lookahead=0)
    dec = tm.dec_fwd.train()
    e = torch.randn(2, 12, 16, generator=torch.Generator().manual_seed(0))
    seen = []
    real = dec.step.attn.forward

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append(out[1].detach())
        return out

    dec.step.attn.forward = spy
    args = (e, torch.tensor([12, 9]), torch.tensor([[5, 6], [7, 3]]),
            torch.tensor([2, 2]))
    dec(*args, None, torch.zeros(2, 2, dtype=torch.int32))
    assert all(float(a[..., 3:].abs().max()) == 0.0 for a in seen[:2])
    seen.clear()
    dec(*args)
    assert max(float(a[..., 3:].abs().max()) for a in seen[:2]) > 0


def test_train_cli_reads_word_alignments(corpus, tmp_path, monkeypatch):
    """A small LSTM-MoChA MinLT conf (char unit) one epoch on the CPU with
    ``--train_word_alignment``: every microstep takes the batch's trigger
    points, and carries the latency loss."""
    conf = {k: v for k, v in vars(small_mocha(
        mocha_latency_metric="minlt", mocha_latency_loss_weight=0.5,
        input_dim=80, vocab=None)).items() if v is not None}
    conf.update(batch_size=3, n_epochs=1, print_step=1, unit="char")
    path = str(tmp_path / "conf.yml")
    save_config(conf, path)
    seen = []
    real = TrainStep.__call__

    def watched(self, *args, **kwargs):
        seen.append(kwargs.get("trigger_points"))
        return real(self, *args, **kwargs)

    monkeypatch.setattr(TrainStep, "__call__", watched)
    save = port_train.main(
        ["--config", path, "--train_set", corpus["train"], "--dev_set",
         corpus["dev"], "--dict", corpus["dict_char"],
         "--train_word_alignment", corpus["words"], "--model_save_dir",
         str(tmp_path / "exp")], device="cpu")
    assert seen and all(tp is not None for tp in seen)
    with open(os.path.join(save, "history.csv")) as f:
        head, row = f.read().splitlines()[:2]
    hist = dict(zip(head.split(","), map(float, row.split(","))))
    assert math.isfinite(hist["train_loss_latency"])
    assert hist["train_loss_latency"] > 0
