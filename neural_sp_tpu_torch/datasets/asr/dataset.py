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

Frame stacking, splicing, the sub-task label streams and the alignment
directories are not ported (ROADMAP).
"""
from __future__ import annotations

import csv
import logging

import numpy as np

from ...utils.io import load_feat
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
    ):
        """Rows outside [min_n_frames, max_n_frames] or longer in labels
        than in subsampled frames are dropped (not from a test set); the
        rest sorted by frames, ascending with ``short2long``."""
        self.token2idx, self.idx2token = build_converters(
            unit, dict_path, wp_model)
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

    def __len__(self):
        return len(self.df["xlen"])

    def token_ids(self, i: int) -> np.ndarray:
        tid = self.df["token_id"][i] if "token_id" in self.df else ""
        if tid:
            return np.asarray([int(t) for t in tid.split()], np.int32)
        return np.asarray(self.token2idx(self.df["text"][i]), np.int32)

    def __getitem__(self, i: int):
        return {
            "utt_id": self.df["utt_id"][i],
            "speaker": self.df["speaker"][i],
            "xs": load_feat(self.df["feat_path"][i]).astype(np.float32),
            "ys": self.token_ids(i),
            "text": self.df["text"][i],
        }
