"""TSV-backed ASR dataset (counterpart of
``neural_sp_tpu/datasets/asr/dataset.py``), read with ``csv`` and numpy
instead of pandas.

TSV columns: utt_id, speaker, feat_path, xlen, xdim, text, token_id, ylen,
ydim. ``feat_path``: .npy, .npz:key or kaldi 'ark:offset'.

The table is a dict of columns (numpy int64 arrays for xlen, xdim and
ylen; lists of str for the rest) in the order the JAX dataset's DataFrame
has after its filters and its stable sort, ties included. A ``token_id``
column that holds only numbers (one id per row, or empty cells) is read by
pandas as numbers, and the JAX dataset then tokenizes ``text`` instead; so
does this one.

The hierarchical sub-tasks' label streams (``dict_path_sub1`` /
``_sub2``, their units and models) re-tokenise ``text`` with their own
converters, as JAX's: an item holds "ys_sub1" / "ys_sub2". Frame
stacking and splicing are not ported (ROADMAP).

Trigger points, as JAX's: with ``word_alignment_dir`` an item holds
"trigger_points", its tokens' boundary frames from the word alignments
(``datasets/alignment.py``), clipped to the utterance's last frame and
divided by the encoder's subsampling factor; with ``ctc_alignment_dir``
(read only without word alignments) the CTC trigger frames as they are
stored. An utterance without an alignment file has none. A word's pieces
come from the wordpiece model; for the word unit a word is one piece (JAX
splits it into its characters, which gives a word unit one boundary per
character: ROADMAP C45), for the char unit its characters, as JAX.
"""
from __future__ import annotations

import csv
import logging

import numpy as np

from ...utils.io import load_feat
from ..alignment import WordAlignmentConverter, load_ctc_alignment
from ..token_converter.character import Char2idx, Idx2char
from ..token_converter.word import Idx2word, Word2idx
from ..token_converter.wordpiece import Idx2wp, Wp2idx

logger = logging.getLogger(__name__)

_INT_COLUMNS = ("xlen", "xdim", "ylen", "ydim")


def build_converters(unit: str, dict_path: str, wp_model: str | None = None):
    """(text -> ids, ids -> text) for a token unit."""
    if unit == "word":
        return Word2idx(dict_path), Idx2word(dict_path)
    if unit in ("wp", "wordpiece"):
        return Wp2idx(dict_path, wp_model), Idx2wp(dict_path, wp_model)
    if unit in ("char", "character"):
        return Char2idx(dict_path), Idx2char(dict_path)
    if unit == "phone":
        raise NotImplementedError(
            "the phone unit is not ported yet, see ROADMAP")
    raise ValueError(f"unknown unit: {unit}")


def _is_number(s: str) -> bool:
    try:
        float(s)
    except ValueError:
        return False
    return True


def read_tsv(tsv_path: str) -> dict:
    """All rows of a TSV as a dict of columns."""
    with open(tsv_path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    fields = list(rows[0]) if rows else []
    table = {}
    for name in fields:
        col = [r[name] or "" for r in rows]
        if name in _INT_COLUMNS:
            table[name] = np.asarray([int(v) for v in col], np.int64)
        else:
            table[name] = col
    tid = table.get("token_id")
    if tid is not None and all(v == "" or _is_number(v) for v in tid):
        table["token_id"] = [""] * len(tid)
    return table


def take(table: dict, index) -> dict:
    """Rows ``index`` (an int array) of every column."""
    return {k: v[index] if isinstance(v, np.ndarray) else
            [v[i] for i in index] for k, v in table.items()}


def stable_order(keys: np.ndarray, ascending: bool) -> np.ndarray:
    """pandas' ``sort_values(kind="stable")`` order: ties keep their row
    order in both directions (descending sorts the reversed array and
    reverses the result, as pandas' ``nargsort``)."""
    if ascending:
        return np.argsort(keys, kind="stable")
    rev = np.arange(len(keys))[::-1]
    return rev[np.argsort(keys[::-1], kind="stable")][::-1]


class ASRDataset:
    def __init__(
        self,
        tsv_path: str,
        dict_path: str,
        unit: str = "char",
        wp_model: str | None = None,
        min_n_frames: int = 1,
        max_n_frames: int = 10**9,
        subsample_factor: int = 1,
        is_test: bool = False,
        short2long: bool = True,
        dict_path_sub1: str | None = None,
        unit_sub1: str = "char",
        wp_model_sub1: str | None = None,
        dict_path_sub2: str | None = None,
        unit_sub2: str = "char",
        wp_model_sub2: str | None = None,
        word_alignment_dir: str | None = None,
        ctc_alignment_dir: str | None = None,
    ):
        """Rows outside [min_n_frames, max_n_frames] or longer in labels
        than in subsampled frames are dropped (not from a test set); the
        rest sorted by frames, ascending with ``short2long``. The alignment
        directories: see the module docstring."""
        self.token2idx, self.idx2token = build_converters(
            unit, dict_path, wp_model)
        # the sub-tasks' converters (None without a dictionary)
        self.token2idx_sub1 = self.idx2token_sub1 = None
        self.token2idx_sub2 = self.idx2token_sub2 = None
        for sub, d, u, wp in (("sub1", dict_path_sub1, unit_sub1,
                               wp_model_sub1),
                              ("sub2", dict_path_sub2, unit_sub2,
                               wp_model_sub2)):
            if d:
                conv = build_converters(u, d, wp)
                setattr(self, f"token2idx_{sub}", conv[0])
                setattr(self, f"idx2token_{sub}", conv[1])
        df = read_tsv(tsv_path)
        n0 = len(df["xlen"])
        if not is_test:
            keep = (df["xlen"] >= min_n_frames) & (df["xlen"] <= max_n_frames)
            # CTC length compatibility
            if subsample_factor > 1:
                keep &= df["ylen"] <= df["xlen"] // subsample_factor
            df = take(df, np.flatnonzero(keep))
        if len(df["xlen"]) != n0:
            logger.info("removed %d utterances (length filters)",
                        n0 - len(df["xlen"]))
        self.df = take(df, stable_order(df["xlen"], short2long))
        self.subsample_factor = subsample_factor
        self.word_alignment_dir = word_alignment_dir
        self.ctc_alignment_dir = ctc_alignment_dir
        self.word_alignment_converter = None
        if word_alignment_dir:
            bpe = getattr(self.token2idx, "_bpe", None)
            encode = bpe.encode if bpe is not None else \
                (lambda w: [w]) if unit == "word" else list
            self.word_alignment_converter = WordAlignmentConverter(encode)

    def __len__(self):
        return len(self.df["xlen"])

    def token_ids(self, i: int) -> np.ndarray:
        tid = self.df["token_id"][i] if "token_id" in self.df else ""
        if tid:
            return np.asarray([int(t) for t in tid.split()], np.int32)
        return np.asarray(self.token2idx(self.df["text"][i]), np.int32)

    def token_ids_sub(self, i: int, sub: str) -> np.ndarray | None:
        """Row i's text in the sub-task's units (None without them)."""
        conv = getattr(self, f"token2idx_{sub}")
        if conv is None:
            return None
        return np.asarray(conv(self.df["text"][i]), np.int32)

    def __getitem__(self, i: int):
        out = {
            "utt_id": self.df["utt_id"][i],
            "speaker": self.df["speaker"][i],
            "xs": load_feat(self.df["feat_path"][i]).astype(np.float32),
            "ys": self.token_ids(i),
            "text": self.df["text"][i],
        }
        for sub in ("sub1", "sub2"):
            ys_s = self.token_ids_sub(i, sub)
            if ys_s is not None:
                out[f"ys_{sub}"] = ys_s
        tp = self.trigger_points(i)
        if tp is not None:
            out["trigger_points"] = tp
        return out

    def trigger_points(self, i: int) -> np.ndarray | None:
        """Row i's token boundary frames (int32, encoder frames), or None
        without an alignment (see the module docstring)."""
        speaker, utt_id = self.df["speaker"][i], self.df["utt_id"][i]
        if self.word_alignment_converter is not None:
            tp = self.word_alignment_converter(
                self.word_alignment_dir, speaker, utt_id, self.df["text"][i])
            if tp is None:
                return None
            # input frames (10 ms) to encoder frames, as JAX's
            tp = np.minimum(tp, max(int(self.df["xlen"][i]) - 1, 0))
            return tp // self.subsample_factor
        if self.ctc_alignment_dir:
            return load_ctc_alignment(self.ctc_alignment_dir, speaker, utt_id)
        return None
