"""ASR data loader (counterpart of ``neural_sp_tpu/datasets/asr/
dataloader.py``): the bucketing iterator, the padded numpy collate and a
prefetch thread that keeps batches ahead of the training step.

Padded shapes are rounded up to multiples (``pad_xlen_multiple``,
``pad_ylen_multiple``, ``pad_batch_multiple``), as the JAX loader does, so
the two give the same arrays. Labels pad with PAD (3), features with 0.
Sorted batches switch to shuffled ones from ``sort_stop_epoch`` on.
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


def collate(items, pad_xlen_multiple: int = 16, pad_ylen_multiple: int = 8,
            pad_batch_multiple: int = 1) -> dict:
    """Dataset items -> padded numpy arrays xs [B, T, D] float32, xlens
    [B], ys [B, U] int32, ylens [B], and the utt_ids, speakers and text."""
    bs_pad = _round_up(len(items), pad_batch_multiple)
    xmax = _round_up(max(it["xs"].shape[0] for it in items),
                     pad_xlen_multiple)
    ymax = _round_up(max(max(len(it["ys"]), 1) for it in items),
                     pad_ylen_multiple)
    dim = items[0]["xs"].shape[1]
    xs = np.zeros((bs_pad, xmax, dim), np.float32)
    ys = np.full((bs_pad, ymax), PAD, np.int32)
    xlens = np.zeros(bs_pad, np.int32)
    ylens = np.zeros(bs_pad, np.int32)
    for i, it in enumerate(items):
        t, u = it["xs"].shape[0], len(it["ys"])
        xs[i, :t] = it["xs"]
        ys[i, :u] = it["ys"]
        xlens[i] = t
        ylens[i] = u
    return {
        "xs": xs, "xlens": xlens, "ys": ys, "ylens": ylens,
        "utt_ids": [it["utt_id"] for it in items],
        "speakers": [it["speaker"] for it in items],
        "text": [it["text"] for it in items],
    }


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
