"""Streaming interface: block extraction and CTC-VAD reset detection
(counterpart of ``neural_sp_tpu/frontends/streaming.py``, host numpy,
copied as it is: the port imports nothing of the JAX package; a CPU test
holds the copy to its original).

The driver slices fixed-geometry feature blocks (conv left context +
current + lookahead, zero-padded at the edges), so the encoder's
``streaming_step`` sees one shape for the whole stream.
"""
from __future__ import annotations

import numpy as np


class StreamingDriver:
    def __init__(self, x_whole: np.ndarray, block_total_in: int,
                 block_hop_in: int, cnn_ctx_in: int):
        """x_whole: [T, D]; block_total_in = cnn_ctx + (N_c+N_r)*f;
        block_hop_in = N_c*f (new frames consumed per block)."""
        self.x = np.asarray(x_whole, np.float32)
        self.total = block_total_in
        self.hop = block_hop_in
        self.cnn_ctx = cnn_ctx_in
        self.offset = 0

    def __iter__(self):
        t = self.x.shape[0]
        d = self.x.shape[1]
        while self.offset < t:
            start = self.offset - self.cnn_ctx
            end = self.offset + (self.total - self.cnn_ctx)
            block = np.zeros((self.total, d), np.float32)
            lo, hi = max(start, 0), min(end, t)
            block[lo - start: lo - start + hi - lo] = self.x[lo:hi]
            n_new = min(self.hop, t - self.offset)
            is_last = self.offset + self.hop >= t
            self.offset += self.hop
            yield block, n_new, is_last

    def reset(self, offset: int | None = None):
        self.offset = self.offset if offset is None else offset


class CtcVAD:
    """Stateful CTC-VAD with cross-block blank accounting — exact semantics
    of the reference's ``Streaming.ctc_reset_point_detection``
    (streaming.py:159-218): ``n_blanks`` persists across blocks, a weak
    non-blank spike (max prob < spike_threshold) counts as blank, a strong
    spike resets the counter, and a reset fires when
    ``n_blanks * factor >= blank_threshold`` (threshold in INPUT frames,
    counters in encoder frames) once ``min_accum_frames`` input frames have
    accumulated.
    """

    def __init__(self, factor: int = 1, blank: int = 0,
                 blank_threshold: int = 40, spike_threshold: float = 0.1,
                 min_accum_frames: int = 0):
        self.factor = factor
        self.blank = blank
        self.blank_threshold = blank_threshold
        self.spike_threshold = spike_threshold
        self.min_accum_frames = min_accum_frames
        self.reset()

    def reset(self):
        self.n_blanks = 0
        self.n_accum_frames = 0

    def step(self, topk_ids: np.ndarray, max_probs: np.ndarray | None,
             n_new_input_frames: int) -> bool:
        """Feed one block's [T_block] argmax ids (+ max posterior per frame);
        returns is_reset. Counters carry across calls until ``reset()``."""
        self.n_accum_frames += n_new_input_frames
        ids = np.asarray(topk_ids)
        t = len(ids)
        if t == 0:
            return False
        is_blank = ids == self.blank
        if max_probs is not None:
            weak = ~is_blank & (np.asarray(max_probs) < self.spike_threshold)
            eff_blank = is_blank | weak
        else:
            eff_blank = is_blank
        # run[i] = consecutive effective-blanks ending at i, seeded with the
        # carried-in count when the block opens with blanks
        idx = np.arange(t)
        strong = ~eff_blank
        last_strong = np.maximum.accumulate(np.where(strong, idx, -1))
        run = np.where(eff_blank, idx - last_strong, 0)
        opening = last_strong < 0  # no strong spike yet in this block
        run = np.where(opening & eff_blank, run + self.n_blanks, run)
        self.n_blanks = int(run[-1]) if eff_blank[-1] else 0
        if self.n_accum_frames < self.min_accum_frames:
            return False
        return bool(np.any(run * self.factor >= self.blank_threshold))


def ctc_reset_point_detection(
    ctc_topk_ids: np.ndarray,
    blank: int = 0,
    blank_threshold: int = 40,
    spike_threshold: float = 0.1,
    ctc_probs: np.ndarray | None = None,
    n_accum_frames: int = 0,
    min_accum_frames: int = 1600,
) -> tuple[bool, int]:
    """CTC-VAD: detect a reset point inside a block
    (reference streaming.py:159-218).

    ctc_topk_ids: [T_block] argmax ids for the block; a reset fires when a
    run of >= blank_threshold blank frames follows at least one non-blank
    spike (prob >= spike_threshold if ctc_probs given) and enough frames
    accumulated. Returns (is_reset, boundary_offset_in_block).
    """
    t = len(ctc_topk_ids)
    if n_accum_frames < min_accum_frames:
        return False, -1
    ids = np.asarray(ctc_topk_ids)
    is_blank = ids == blank
    nonblank = ~is_blank
    if ctc_probs is not None:
        spike = nonblank & (np.max(np.asarray(ctc_probs), -1)
                            >= spike_threshold)
    else:
        spike = nonblank
    if not spike.any():
        return False, -1
    # vectorised run-length of blanks: run[i] = #consecutive blanks ending i
    idx = np.arange(t)
    last_nonblank = np.maximum.accumulate(np.where(nonblank, idx, -1))
    run = np.where(is_blank, idx - last_nonblank, 0)
    first_spike = int(np.argmax(spike))
    fire = (run >= blank_threshold) & (idx > first_spike)
    if not fire.any():
        return False, -1
    return True, int(np.argmax(fire))
