"""Port parity: the host code under the CLIs, each piece against the JAX
package's on the same inputs.

* the TSV reader, the sampler and the loader (csv and numpy in the port,
  pandas in JAX): the same batches, index for index, and the same padded
  arrays, bit for bit, for sort (ascending and descending), shuffle,
  dynamic seq batches and frame bins, over three epochs across a
  ``sort_stop_epoch``, on a ``make_ci_corpus`` corpus;
* the char, word and wordpiece converters both ways, and ``train_bpe``;
* the feature readers (.npy, .npz:key, kaldi ark);
* ``compute_wer`` / ``compute_cer`` / ``wer_align`` on random strings
  (long pairs reach the JAX package's native path);
* the ``EpochController`` over a fixed sequence of dev losses per decay
  type, and the ``Reporter``'s ``history.csv``;
* the config reader on every recipe conf, and ``parse_cli``;
* the port's checkpoints: save, load, top-k retention, averaging, and
  MBR training's sub-step checkpoints; ``np_pad_lists``.

Everything here is exact: equality, no tolerance.
"""
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_sp_tpu.bin import args as jax_args
from neural_sp_tpu.datasets.asr.build import (
    build_dataloader as jax_build_dataloader)
from neural_sp_tpu.datasets.token_converter import (
    character as jax_char, word as jax_word, wordpiece as jax_wp)
from neural_sp_tpu.evaluators import edit_distance as jax_ed
from neural_sp_tpu.trainers.lr_scheduler import (
    EpochController as JaxEpochController)
from neural_sp_tpu.trainers.reporter import Reporter as JaxReporter
from neural_sp_tpu.utils import io as jax_io
from neural_sp_tpu.utils.ci_corpus import make_ci_corpus
from neural_sp_tpu_torch.bin import args as port_args
from neural_sp_tpu_torch.datasets.asr.build import build_dataloader
from neural_sp_tpu_torch.datasets.token_converter import (
    character, word, wordpiece)
from neural_sp_tpu_torch.evaluators import edit_distance
from neural_sp_tpu_torch.trainers import checkpoint
from neural_sp_tpu_torch.trainers.lr_scheduler import EpochController
from neural_sp_tpu_torch.trainers.reporter import Reporter
from neural_sp_tpu_torch.utils import io as port_io

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_ci_corpus(str(tmp_path_factory.mktemp("torch_data")),
                          n_train=40, n_dev=4, n_test=4, max_words=5, seed=3)


# (bucketing, batch_size_type, batch_size, dynamic_batching, short2long)
LOADER_CASES = {
    "sort_ascending": ("sort", "seq", 6, False, True),
    "sort_descending": ("sort", "seq", 6, False, False),
    "shuffle": ("shuffle", "seq", 7, False, True),
    "seq_dynamic": ("shuffle", "seq", 8, True, True),
    "frame": ("sort", "frame", 400, False, True),
    "frame_shuffle": ("shuffle", "frame", 300, False, False),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_matches_jax(corpus, case):
    bucketing, bs_type, bs, dynamic, short2long = LOADER_CASES[case]
    kw = dict(tsv_path=corpus["train"], dict_path=corpus["dict_char"],
              unit="char", batch_size=bs, batch_size_type=bs_type,
              dynamic_batching=dynamic, bucketing=bucketing,
              min_n_frames=30, max_n_frames=150, subsample_factor=4,
              short2long=short2long, seed=5, pad_xlen_multiple=16,
              pad_ylen_multiple=8, sort_stop_epoch=2)
    want, got = jax_build_dataloader(**kw), build_dataloader(**kw)
    # the filters and the stable sort (ties included) keep the same rows
    assert list(got.dataset.df["utt_id"]) == \
        list(want.dataset.df["utt_id"])
    assert 0 < len(got.dataset) < 40
    assert got.vocab == want.vocab
    for epoch in (1, 2, 3):           # sort turns to shuffle at epoch 2
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        assert got._batches == want._batches
        n = 0
        for g, w in zip(got, want):
            for key in ("xs", "xlens", "ys", "ylens"):
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            for key in ("utt_ids", "speakers", "text"):
                assert g[key] == w[key]
            n += 1
        assert n == len(want) == len(got)


def test_loader_reads_test_sets_unfiltered_and_wordpiece(corpus):
    kw = dict(tsv_path=corpus["test_wp"], dict_path=corpus["dict_wp"],
              unit="wp", wp_model=corpus["wp_model"], is_test=True,
              min_n_frames=10**6, batch_size=3)
    want, got = jax_build_dataloader(**kw), build_dataloader(**kw)
    assert len(got.dataset) == len(want.dataset) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["ys"], w["ys"])
        assert [got.idx2token(y[:n]) for y, n in zip(g["ys"], g["ylens"])] \
            == g["text"]


@pytest.mark.parametrize("unit", ["char", "word", "wp"])
def test_token_converters_match_jax(corpus, unit):
    texts = [line.split("\t")[5] for line in
             open(corpus["train"]).read().splitlines()[1:]]
    texts += ["aba zzz cid", "", "q"]
    if unit == "char":
        pairs = [(jax_char.Char2idx(corpus["dict_char"]),
                  character.Char2idx(corpus["dict_char"])),
                 (jax_char.Idx2char(corpus["dict_char"]),
                  character.Idx2char(corpus["dict_char"]))]
    elif unit == "word":
        pairs = [(jax_word.Word2idx(corpus["dict_word"]),
                  word.Word2idx(corpus["dict_word"])),
                 (jax_word.Idx2word(corpus["dict_word"]),
                  word.Idx2word(corpus["dict_word"]))]
    else:
        d, m = corpus["dict_wp"], corpus["wp_model"]
        pairs = [(jax_wp.Wp2idx(d, m), wordpiece.Wp2idx(d, m)),
                 (jax_wp.Idx2wp(d, m), wordpiece.Idx2wp(d, m)),
                 (jax_wp.Wp2idx(None, m), wordpiece.Wp2idx(None, m)),
                 (jax_wp.Idx2wp(None, m), wordpiece.Idx2wp(None, m))]
    (j_enc, p_enc), (j_dec, p_dec) = pairs[:2]
    for text in texts:
        ids = p_enc(text)
        assert ids == j_enc(text)
        assert p_dec(ids) == j_dec(ids)
        assert p_dec(ids, return_list=True) == j_dec(ids, return_list=True)
    for (j_e, p_e), (j_d, p_d) in zip(pairs[2::2], pairs[3::2]):
        for text in texts:
            assert p_e(text) == j_e(text)
            assert p_d(p_e(text)) == j_d(j_e(text))


def test_train_bpe_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    letters = list("abcdefghij")
    sents = [" ".join("".join(rng.choice(letters, rng.integers(1, 7)))
                      for _ in range(rng.integers(1, 9))) for _ in range(60)]
    want = jax_wp.train_bpe(sents, 80, str(tmp_path / "j.json"))
    got = wordpiece.train_bpe(sents, 80, str(tmp_path / "p.json"))
    assert got == want
    assert (tmp_path / "j.json").read_text() == \
        (tmp_path / "p.json").read_text()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        wordpiece.Wp2idx(None, str(tmp_path / "sp.model"))


def test_feature_readers_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    feats = {f"u{i}": rng.standard_normal((5 + i, 3)).astype(np.float32)
             for i in range(3)}
    offsets = jax_io.write_kaldi_ark(str(tmp_path / "f.ark"), feats)
    for k, loc in offsets.items():
        np.testing.assert_array_equal(port_io.load_feat(loc),
                                      jax_io.load_feat(loc))
        np.testing.assert_array_equal(port_io.load_feat(loc), feats[k])
    # an ark read from offset 0 skips its first key
    np.testing.assert_array_equal(
        port_io.read_kaldi_matrix(str(tmp_path / "f.ark")), feats["u0"])
    np.save(tmp_path / "a.npy", feats["u1"])
    np.savez(tmp_path / "b.npz", x=feats["u2"])
    for loc in (str(tmp_path / "a.npy"), f"{tmp_path / 'b.npz'}:x"):
        np.testing.assert_array_equal(port_io.load_feat(loc),
                                      jax_io.load_feat(loc))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_io.load_feat(str(tmp_path / "a.wav"))


def test_edit_distance_matches_jax():
    rng = np.random.default_rng(2)
    for n in list(range(12)) + [30, 45, 70]:     # past 64 tokens JAX goes
        ref = list(rng.integers(0, 5, rng.integers(0, n + 1)))  # native
        hyp = list(rng.integers(0, 5, rng.integers(0, n + 1)))
        assert edit_distance.compute_wer(ref, hyp) == \
            jax_ed.compute_wer(ref, hyp)
        assert edit_distance.wer_align(ref, hyp) == \
            jax_ed.wer_align(ref, hyp)
        r = "".join("ab c"[i % 4] for i in ref)
        h = "".join("ab c"[i % 4] for i in hyp)
        assert edit_distance.compute_cer(r, h) == jax_ed.compute_cer(r, h)


DEV_LOSSES = [5.0, 4.0, 4.5, 4.6, 3.9, 4.2, 4.3, 4.4, 4.1]


@pytest.mark.parametrize("decay_type", ["always", "metric", "warmup", "no"])
def test_epoch_controller_matches_jax(decay_type, tmp_path):
    kw = dict(base_lr=1e-3, decay_type=decay_type, decay_rate=0.8,
              decay_patient_n_epochs=1, decay_start_epoch=2,
              early_stop_patient_n_epochs=3)
    want, got = JaxEpochController(**kw), EpochController(**kw)
    for value in DEV_LOSSES:
        assert got.step_epoch(value) == want.step_epoch(value)
        assert got.topk_epochs(3) == want.topk_epochs(3)
        assert got.state_dict() == want.state_dict()
    assert got.n_early_stop >= 3        # the sequence reaches early stop
    resumed = EpochController(base_lr=1.0)
    path = checkpoint.save_checkpoint(str(tmp_path), 1, {},
                                      controller_state=got.state_dict())
    resumed.load_state_dict(checkpoint.load_checkpoint(path)["controller"])
    assert resumed.state_dict() == got.state_dict()
    assert resumed.convert_to_sgd(0.1) == want.convert_to_sgd(0.1)
    assert resumed.state_dict() == want.state_dict()


def test_reporter_history_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    want, got = JaxReporter(str(tmp_path / "j")), Reporter(str(tmp_path / "p"))
    for epoch in (1, 2):
        for _ in range(3):
            obs = {k: float(rng.random()) for k in ("loss", "loss_ctc",
                                                    "acc_att")}
            want.add_observation(obs)
            got.add_observation({k: torch.tensor(v, dtype=torch.float64)
                                 for k, v in obs.items()})
            want.step_forward()
            got.step_forward()
        dev = {"loss": float(rng.random())}
        want.add_observation(dev, is_eval=True)
        got.add_observation(dev, is_eval=True)
        extra = {"dev_loss_mean": dev["loss"], "lr": 0.1 * epoch}
        assert got.epoch_summary(epoch, extra) == \
            want.epoch_summary(epoch, extra)
    assert (tmp_path / "p" / "history.csv").read_text() == \
        (tmp_path / "j" / "history.csv").read_text()
    assert Reporter(str(tmp_path / "p")).step == 6     # a resumed run


CONF_DIRS = sorted(p.parent.name for p in ROOT.glob("examples/*/conf"))


@pytest.mark.parametrize("recipe", CONF_DIRS)
def test_config_reader_matches_jax(recipe, tmp_path):
    confs = sorted((ROOT / "examples" / recipe / "conf").rglob("*.yaml"))
    assert confs
    for path in confs:
        got = port_args.load_config(str(path))
        assert got == jax_args.load_config(str(path)), path
        port_args.save_config(got, str(tmp_path / "conf.yml"))
        assert jax_args.load_config(str(tmp_path / "conf.yml")) == got


def test_parse_cli_matches_jax(tmp_path):
    base, over = tmp_path / "base.yml", tmp_path / "over.yml"
    base.write_text("lr: 1e-3\nunit: char\nbatch_size: 4\n")
    over.write_text("batch_size: 8\nweight_decay: 1e-6\n")
    argv = ["--config", str(base), "--config2", str(over), "--recog_sets",
            "a.tsv", "b.tsv", "--recog_length_norm", "--beam", "4",
            "--ratio", "0.5", "--flag", "false", "--name", "x"]
    assert vars(port_args.parse_cli(argv)) == vars(jax_args.parse_cli(argv))
    assert vars(port_args.parse_args_train(argv)) == \
        vars(jax_args.parse_args_train(argv))
    assert port_args.TRAIN_DEFAULTS == jax_args.TRAIN_DEFAULTS
    assert port_args.EVAL_DEFAULTS == jax_args.EVAL_DEFAULTS
    # eval: the training conf.yml fills what the flags leave unset
    port_args.save_config({"unit": "word", "recog_beam_width": 3},
                          str(tmp_path / "exp" / "conf.yml"))
    argv = ["--recog_model", str(tmp_path / "exp" / "ckpt.epoch-1"),
            "--recog_beam_width", "5"]
    assert vars(port_args.parse_args_eval(argv)) == \
        vars(jax_args.parse_args_eval(argv))


def test_checkpoints_round_trip_retain_and_average(tmp_path):
    rng = np.random.default_rng(5)
    states = {e: {"w": torch.from_numpy(rng.standard_normal((3, 2))
                                        .astype(np.float32)),
                  "b": torch.from_numpy(rng.standard_normal(2)
                                        .astype(np.float32))}
              for e in (1, 2, 3)}
    opt = {"count": 4, "mini_step": 1, "mu": {"w": torch.ones(3, 2)},
           "nu": {"w": torch.zeros(3, 2)}, "acc": {"w": torch.ones(3, 2)}}
    ctl = EpochController(1e-3)
    ctl.step_epoch(2.0)
    for e, sd in states.items():
        path = checkpoint.save_checkpoint(str(tmp_path), e, sd, opt,
                                          ctl.state_dict(),
                                          keep_epochs=[1, 3])
        assert os.path.basename(path) == f"ckpt.epoch-{e}"
    # epoch 2 went when 3 was saved; the newest is always kept
    assert sorted(os.listdir(tmp_path)) == ["ckpt.epoch-1", "ckpt.epoch-3"]
    assert checkpoint.latest_epoch(str(tmp_path)) == 3
    ck = checkpoint.load_checkpoint(str(tmp_path / "ckpt.epoch-3"))
    for k in states[3]:
        assert torch.equal(ck["model"][k], states[3][k])
    assert ck["optimizer"]["count"] == 4 and \
        torch.equal(ck["optimizer"]["mu"]["w"], opt["mu"]["w"])
    assert ck["controller"] == ctl.state_dict()
    avg = checkpoint.average_checkpoints(str(tmp_path), [1, 3])
    for k in avg:
        want = ((states[1][k].numpy().astype(np.float64) +
                 states[3][k].numpy().astype(np.float64)) / 2
                ).astype(np.float32)
        assert avg[k].dtype == torch.float32
        np.testing.assert_array_equal(avg[k].numpy(), want)
    with pytest.raises(ValueError):
        checkpoint.average_checkpoints(str(tmp_path), [])


def test_sub_step_checkpoints_are_apart_from_the_epochs(tmp_path):
    """MBR training's ``ckpt.epoch-N-step-M`` (``sub_step``): written
    beside the epochs' checkpoints, read back, and neither counted by
    ``latest_epoch`` nor deleted by the top-k retention."""
    sd = {"w": torch.arange(6.0).view(3, 2)}
    for step in (1, 2):
        path = checkpoint.save_checkpoint(str(tmp_path), 2, sd,
                                          {"optimizer": "sgd"},
                                          sub_step=step)
        assert os.path.basename(path) == f"ckpt.epoch-2-step-{step}"
    checkpoint.save_checkpoint(str(tmp_path), 1, sd, keep_epochs=[])
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt.epoch-1", "ckpt.epoch-2-step-1", "ckpt.epoch-2-step-2"]
    assert checkpoint.latest_epoch(str(tmp_path)) == 1
    ck = checkpoint.load_checkpoint(str(tmp_path / "ckpt.epoch-2-step-2"))
    assert torch.equal(ck["model"]["w"], sd["w"])
    assert ck["optimizer"] == {"optimizer": "sgd"}


@pytest.mark.parametrize("seqs,min_len", [
    ([[4, 5, 6], [], [7]], 1), ([[4]], 8), ([], 3), ([[2], [9, 8]], 8)])
def test_np_pad_lists_matches_jax(seqs, min_len):
    from neural_sp_tpu.models.utils import np_pad_lists as jax_pad_lists
    from neural_sp_tpu_torch.models.utils import np_pad_lists
    got, want = np_pad_lists(seqs, min_len=min_len), \
        jax_pad_lists(seqs, min_len=min_len)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
