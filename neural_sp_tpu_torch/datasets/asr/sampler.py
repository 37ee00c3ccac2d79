"""Batch assembly (counterpart of ``neural_sp_tpu/datasets/asr/sampler.py``):
a batch size per batch (``seq``, with optional dynamic scaling by length,
or ``frame`` bins) and sort or shuffle bucketing, over the rows of a
dataset table (a dict of columns, ``dataset.read_tsv``).

The JAX sampler's token bins, discourse and longform bucketing, its
padded-area frame bins (``shape_grid_t``) and its multi-replica striping
are not ported (ROADMAP).
"""
from __future__ import annotations

import numpy as np


def _batch_size_seq(xlen: np.ndarray, offset: int, base_bs: int,
                    dynamic: bool) -> int:
    if not dynamic:
        return base_bs
    t = int(xlen[offset])
    scale = 1.0 if t <= 800 else 0.5 if t <= 1600 else 0.25
    return max(int(base_bs * scale), 1)


def _batch_size_bin(lens: np.ndarray, offset: int, batch_bin: int) -> int:
    """#utts from ``offset`` whose summed frames stay within ``batch_bin``;
    at least one, and the one that crosses the bin is the last taken only
    when it is the first."""
    total, bs = 0, 0
    n = len(lens)
    while offset + bs < n:
        total += int(lens[offset + bs])
        if total > batch_bin and bs > 0:
            break
        bs += 1
        if total > batch_bin:
            break
    return max(bs, 1)


def make_batches(table: dict, batch_size: int = 1,
                 batch_size_type: str = "seq",     # seq | frame
                 dynamic_batching: bool = False,
                 bucketing: str = "sort",          # sort | shuffle
                 seed: int = 1) -> list[list[int]]:
    """Row positions of ``table`` cut into batches, in table order; with
    ``shuffle`` the batches (not the rows) are shuffled by
    ``numpy.random.default_rng(seed)``."""
    if bucketing not in ("sort", "shuffle"):
        raise NotImplementedError(
            f"bucketing {bucketing!r} is not ported yet, see ROADMAP")
    xlen = table["xlen"]
    n = len(xlen)
    batches: list[list[int]] = []
    offset = 0
    while offset < n:
        if batch_size_type == "seq":
            bs = _batch_size_seq(xlen, offset, batch_size, dynamic_batching)
        elif batch_size_type == "frame":
            bs = _batch_size_bin(xlen, offset, batch_size)
        else:
            raise NotImplementedError(
                f"batch_size_type {batch_size_type!r} is not ported yet (seq "
                f"and frame are), see ROADMAP")
        batches.append(list(range(offset, min(offset + bs, n))))
        offset += bs
    if bucketing == "shuffle":
        np.random.default_rng(seed).shuffle(batches)
    return batches
