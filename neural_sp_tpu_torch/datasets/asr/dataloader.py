"""ASR data loader (counterpart of ``neural_sp_tpu/datasets/asr/
dataloader.py``): the bucketing iterator, the padded numpy collate and a
prefetch thread that keeps batches ahead of the training step.

Padded shapes are rounded up to multiples (``pad_xlen_multiple``,
``pad_ylen_multiple``, ``pad_batch_multiple``), as the JAX loader does, so
the two give the same arrays. Labels pad with PAD (3), features with 0.
Sorted batches switch to shuffled ones from ``sort_stop_epoch`` on.
Where any item of a batch has trigger points, the batch holds
"trigger_points" [B, U] int32, -1 where an utterance has none, as JAX's.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from ... import PAD
from .sampler import make_batches

PREFETCH = 2      # batches loaded ahead of the consumer


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_labels(seqs, bs_pad: int, multiple: int):
    """Label lists -> (ys [B, U] int32 PAD-padded, U rounded up to
    ``multiple``; ylens [B])."""
    ymax = _round_up(max(max(len(y), 1) for y in seqs), multiple)
    ys = np.full((bs_pad, ymax), PAD, np.int32)
    ylens = np.zeros(bs_pad, np.int32)
    for i, y in enumerate(seqs):
        ys[i, :len(y)] = y
        ylens[i] = len(y)
    return ys, ylens


def collate(items, pad_xlen_multiple: int = 16, pad_ylen_multiple: int = 8,
            pad_batch_multiple: int = 1) -> dict:
    """Dataset items -> padded numpy arrays xs [B, T, D] float32, xlens
    [B], ys [B, U] int32, ylens [B] (and ys_sub1 / ylens_sub1, ys_sub2 /
    ylens_sub2 where the items have them, padded as ys), trigger_points
    [B, U] int32 where any item has them (-1 past a row's points and for
    a row without any), and the utt_ids, speakers and text."""
    bs_pad = _round_up(len(items), pad_batch_multiple)
    xmax = _round_up(max(it["xs"].shape[0] for it in items),
                     pad_xlen_multiple)
    dim = items[0]["xs"].shape[1]
    xs = np.zeros((bs_pad, xmax, dim), np.float32)
    xlens = np.zeros(bs_pad, np.int32)
    for i, it in enumerate(items):
        t = it["xs"].shape[0]
        xs[i, :t] = it["xs"]
        xlens[i] = t
    ys, ylens = _pad_labels([it["ys"] for it in items], bs_pad,
                            pad_ylen_multiple)
    out = {
        "xs": xs, "xlens": xlens, "ys": ys, "ylens": ylens,
        "utt_ids": [it["utt_id"] for it in items],
        "speakers": [it["speaker"] for it in items],
        "text": [it["text"] for it in items],
    }
    for sub in ("sub1", "sub2"):
        if f"ys_{sub}" in items[0]:
            out[f"ys_{sub}"], out[f"ylens_{sub}"] = _pad_labels(
                [it[f"ys_{sub}"] for it in items], bs_pad, pad_ylen_multiple)
    if any("trigger_points" in it for it in items):
        # -1 rows for the utterances without an alignment (the latency
        # loss leaves them out), cut to the labels' width, as JAX's
        tp = np.full(ys.shape, -1, np.int32)
        for i, it in enumerate(items):
            if "trigger_points" in it:
                u = min(len(it["trigger_points"]), ys.shape[1])
                tp[i, :u] = it["trigger_points"][:u]
        out["trigger_points"] = tp
    return out


class ASRDataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        batch_size_type: str = "seq",
        dynamic_batching: bool = False,
        bucketing: str = "sort",
        seed: int = 1,
        pad_xlen_multiple: int = 16,
        pad_ylen_multiple: int = 8,
        pad_batch_multiple: int = 1,
        sort_stop_epoch: int = 10000,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.batch_size_type = batch_size_type
        self.dynamic_batching = dynamic_batching
        self.bucketing = bucketing
        self.seed = seed
        self.pad_xlen_multiple = pad_xlen_multiple
        self.pad_ylen_multiple = pad_ylen_multiple
        self.pad_batch_multiple = pad_batch_multiple
        self.sort_stop_epoch = sort_stop_epoch
        self.epoch = 0
        self._batches = self._make_batches()

    @property
    def vocab(self) -> int:
        return len(self.dataset.token2idx.token2idx)

    @property
    def idx2token(self):
        return self.dataset.idx2token

    @property
    def vocab_sub1(self):
        """The sub1 vocabulary's size, None without one."""
        c = self.dataset.token2idx_sub1
        return None if c is None else len(c.token2idx)

    @property
    def vocab_sub2(self):
        c = self.dataset.token2idx_sub2
        return None if c is None else len(c.token2idx)

    def _make_batches(self):
        bucketing = self.bucketing
        if bucketing == "sort" and self.epoch >= self.sort_stop_epoch:
            bucketing = "shuffle"
        return make_batches(
            self.dataset.df, batch_size=self.batch_size,
            batch_size_type=self.batch_size_type,
            dynamic_batching=self.dynamic_batching, bucketing=bucketing,
            seed=self.seed + self.epoch)

    def __len__(self):
        return len(self._batches)

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self._batches = self._make_batches()

    def _load(self, batch):
        return collate([self.dataset[i] for i in batch],
                       self.pad_xlen_multiple, self.pad_ylen_multiple,
                       self.pad_batch_multiple)

    def __iter__(self):
        """The epoch's batches, loaded by a thread two batches ahead."""
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = object()
        batches = list(self._batches)

        def worker():
            try:
                for b in batches:
                    q.put(self._load(b))
            except Exception as e:   # raised in the consumer below
                q.put(e)
            finally:
                q.put(stop)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, Exception):
                th.join()
                raise item
            yield item
        th.join()
