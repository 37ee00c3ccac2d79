"""LM dataset (counterpart of ``neural_sp_tpu/datasets/lm.py``): the
corpus concatenated into a [B, n] token matrix and cut into BPTT windows,
read with ``csv`` (``datasets/asr/dataset.py::read_tsv``) instead of
pandas.

Each row's ``token_id`` (when it is a string of ids) or else its ``text``
through the unit's converter, followed by ``<eos>``, are joined into one
stream (reversed for a ``backward`` LM; rows ordered by ``utt_id``, ties
kept, for ``serialize``). The stream's first n B + 1 tokens, n = (len -
1) // B, give the inputs ``xs`` and the targets ``ys`` (shifted by one),
each reshaped row-major to [B, n]; iteration yields (xs, ys) windows of
``bptt`` columns (the last one shorter), int32, as the JAX dataset.
"""
from __future__ import annotations

import numpy as np

from .. import EOS
from .asr.dataset import build_converters, read_tsv, stable_order


class LMDataset:
    def __init__(self, tsv_path: str, dict_path: str, unit: str = "word",
                 wp_model: str | None = None, batch_size: int = 32,
                 bptt: int = 64, backward: bool = False,
                 serialize: bool = False, num_replicas: int = 1):
        self.bptt = bptt
        self.batch_size = batch_size * num_replicas
        self.backward = backward
        self.token2idx, self.idx2token = build_converters(
            unit, dict_path, wp_model)
        table = read_tsv(tsv_path)
        n_rows = len(table["text"]) if "text" in table else 0
        order = range(n_rows)
        if serialize:
            order = stable_order(np.asarray(table["utt_id"]), True)
        tids = table.get("token_id", [""] * n_rows)
        ids: list[int] = []
        for i in order:
            tid = tids[i]
            utt = [int(t) for t in tid.split()] if tid and tid != "nan" \
                else self.token2idx(table["text"][i])
            ids.extend(utt + [EOS])
        if backward:
            ids = ids[::-1]
        n = (len(ids) - 1) // self.batch_size
        self.n_tokens = len(ids)
        data = np.asarray(ids[: n * self.batch_size + 1], np.int32)
        self.xs = data[:-1][: n * self.batch_size].reshape(
            self.batch_size, n)
        self.ys = data[1:][: n * self.batch_size].reshape(
            self.batch_size, n)

    @property
    def vocab(self):
        return len(self.token2idx.token2idx) if hasattr(
            self.token2idx, "token2idx") else None

    def __len__(self):
        return max((self.xs.shape[1] + self.bptt - 1) // self.bptt, 0)

    def __iter__(self):
        for i in range(0, self.xs.shape[1], self.bptt):
            yield (self.xs[:, i:i + self.bptt],
                   self.ys[:, i:i + self.bptt])
