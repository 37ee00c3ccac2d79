"""Edit distance and WER with the S / I / D backtrace (counterpart of
``neural_sp_tpu/evaluators/edit_distance.py``), in numpy. The JAX package
hands long pairs to its native library, whose dynamic programme and
backtrace are the same as this one's, so both split the errors alike.
"""
from __future__ import annotations

import numpy as np


def _table(ref: list, hyp: list) -> np.ndarray:
    nr, nh = len(ref), len(hyp)
    d = np.zeros((nr + 1, nh + 1), np.int32)
    d[:, 0] = np.arange(nr + 1)
    d[0, :] = np.arange(nh + 1)
    for i in range(1, nr + 1):
        for j in range(1, nh + 1):
            d[i, j] = min(d[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]),
                          d[i - 1, j] + 1, d[i, j - 1] + 1)
    return d


def _backtrace(ref: list, hyp: list, d: np.ndarray) -> list:
    """Aligned (ref token, hyp token, op) triples, op " " / S / D / I;
    matches first, then substitutions, deletions, insertions."""
    i, j = len(ref), len(hyp)
    pairs = []
    while i > 0 or j > 0:
        if i > 0 and j > 0 and d[i, j] == d[i - 1, j - 1] and \
                ref[i - 1] == hyp[j - 1]:
            pairs.append((ref[i - 1], hyp[j - 1], " "))
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and d[i, j] == d[i - 1, j - 1] + 1:
            pairs.append((ref[i - 1], hyp[j - 1], "S"))
            i, j = i - 1, j - 1
        elif i > 0 and d[i, j] == d[i - 1, j] + 1:
            pairs.append((ref[i - 1], "*", "D"))
            i -= 1
        else:
            pairs.append(("*", hyp[j - 1], "I"))
            j -= 1
    pairs.reverse()
    return pairs


def compute_wer(ref: list, hyp: list) -> tuple[float, int, int, int]:
    """(wer %, n_sub, n_ins, n_del) of two token lists."""
    ops = [op for _, _, op in _backtrace(ref, hyp, _table(ref, hyp))]
    n_sub, n_ins, n_del = ops.count("S"), ops.count("I"), ops.count("D")
    return 100.0 * (n_sub + n_ins + n_del) / max(len(ref), 1), \
        n_sub, n_ins, n_del


def compute_cer(ref: str, hyp: str) -> float:
    """Character error rate (%) of two strings, spaces removed."""
    return compute_wer(list(ref.replace(" ", "")),
                       list(hyp.replace(" ", "")))[0]


def compute_per(ref: list, hyp: list) -> float:
    return compute_wer(ref, hyp)[0]


def wer_align(ref: list, hyp: list) -> str:
    """Aligned REF / HYP printout with S / I / D markers."""
    pairs = [(str(a), str(b), o)
             for a, b, o in _backtrace(ref, hyp, _table(ref, hyp))]
    w = [max(len(a), len(b)) for a, b, _ in pairs]
    ref_l = " ".join(a.ljust(n) for (a, _, _), n in zip(pairs, w))
    hyp_l = " ".join(b.ljust(n) for (_, b, _), n in zip(pairs, w))
    op_l = " ".join(o.ljust(n) for (_, _, o), n in zip(pairs, w))
    return f"REF: {ref_l}\nHYP: {hyp_l}\nOP : {op_l}"
