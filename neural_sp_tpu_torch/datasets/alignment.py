"""Word alignments -> token boundary frames, and CTC alignments (a copy of
``neural_sp_tpu/datasets/alignment.py``, numpy only; a CPU test holds it
to the original).

``WordAlignmentConverter`` turns per-word (start, end) alignments in
seconds into per-token frame boundaries: the trigger points of MoChA's
MinLT / DeCoT latency training and of triggered attention. The file
format is one ``word start end`` line per word, ``dir/speaker/utt_id.txt``;
a word's boundary is spread over its pieces in proportion to their
characters (or uniformly). Frames are 10 ms. ``load_ctc_alignment`` reads
precomputed CTC trigger frames, one per token and line.
"""
from __future__ import annotations

import codecs
import os

import numpy as np

FRAMES_PER_SEC = 100.0


class WordAlignmentConverter:
    """Convert word time alignments into wordpiece boundary frames.

    wp_encode: callable text -> list of piece strings (``Wp2idx`` pieces or
    any tokenizer whose pieces mark word starts with "▁").
    split_type: 'character_length' | 'uniform'.
    """

    def __init__(self, wp_encode, split_type: str = "character_length"):
        assert split_type in ("character_length", "uniform")
        self.encode = wp_encode
        self.split_type = split_type

    def _word_boundaries(self, pieces: list[str], start: float, end: float):
        """Boundary frame for each piece of one word."""
        chars = "".join(p.lstrip("▁") for p in pieces)
        n = len(pieces)
        out = []
        consumed = 0
        for j, p in enumerate(pieces):
            if self.split_type == "character_length" and len(chars) > 0:
                consumed += len(p.lstrip("▁"))
                frac = consumed / len(chars)
            else:
                frac = (j + 1) / n
            out.append(start + (end - start) * frac)
        return out

    def __call__(self, alignment_dir: str, speaker: str, utt_id: str,
                 text: str) -> np.ndarray | None:
        """Returns per-token boundary frames [U] (int32), or None when the
        utterance has no alignment file."""
        # speed-perturbed copies reuse the base alignment, rescaled
        # (reference alignment.py:40-45)
        speed_rate = 1.0
        if speaker[:2] == "sp" and "-" in speaker:
            try:
                speed_rate = 1.0 / float(speaker[2:5])
                speaker = "-".join(speaker.split("-")[1:])
                utt_id = "-".join(utt_id.split("-")[1:])
            except ValueError:
                speed_rate = 1.0
        path = os.path.join(alignment_dir, speaker, utt_id + ".txt")
        if not os.path.isfile(path):
            return None
        with codecs.open(path, "r", "utf-8") as f:
            word_aligns = [ln.strip().split() for ln in f if ln.strip()]

        words = text.strip().split()
        if len(word_aligns) != len(words):
            return None  # mismatched alignment; skip this utterance
        boundaries: list[float] = []
        for word, (aword, start, end) in zip(words, word_aligns):
            pieces = self.encode(word)
            s = float(start) * FRAMES_PER_SEC * speed_rate
            e = float(end) * FRAMES_PER_SEC * speed_rate
            boundaries += self._word_boundaries(pieces, s, e)
        b = np.ceil(np.asarray(boundaries)).astype(np.int32)
        assert (np.diff(b) >= 0).all(), "non-monotonic alignment"
        return b


def load_ctc_alignment(alignment_dir: str, speaker: str,
                       utt_id: str) -> np.ndarray | None:
    """Load precomputed CTC trigger frames, one int per token per line
    (reference alignment.py:101-114)."""
    path = os.path.join(alignment_dir, speaker, utt_id + ".txt")
    if not os.path.isfile(path):
        return None
    with codecs.open(path, "r", "utf-8") as f:
        vals = [int(float(ln.strip().split()[-1])) for ln in f if ln.strip()]
    return np.asarray(vals, np.int32)
