"""CTC head with its training loss, greedy collapse and the joint-decoding
prefix scorer (counterpart of ``neural_sp_tpu/models/decoders/ctc.py``).
The loss is kernel K4 (``ops.ctc.ctc_loss``); the scorer is host numpy in
the JAX package and is copied as it is. ``trigger_points`` is the forced
alignment of ``ops.ctc.ctc_forced_align`` (MoChA's ``ctc_sync``).

``best_path_frames`` is the best path with its first-emission frames that
``evaluators/asr.py::eval_word`` reads off a char sub1 head.

The block-synchronous CTC prefix beam (``CTCBlockSyncBeam``) and the
scorer's ``register_new_chunk`` / ``extend_state`` (streaming decoding)
are host numpy copied from the JAX package too; a CPU test holds each to
its original.

``fc_list`` ("512" or "512_512") puts Linear + ReLU + dropout layers
``fc0``, ``fc1``, ... before the output layer; ``lsm_prob`` mixes K4's loss
with the KL divergence of the posteriors from the uniform distribution
(``ops.criterion.kldiv_lsm_ctc``), divided by the mean label length, as
the JAX head does. The dropout is the decoder's (``dropout_dec``)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ... import BLANK, EOS
from ...ops.criterion import kldiv_lsm_ctc
from ...ops.ctc import ctc_forced_align, ctc_loss
from ...ops.dropout import Dropout
from ..modules.promote import Linear

LOG0 = -1.0e10


class CTC(nn.Module):
    def __init__(self, vocab: int, enc_n_units: int, fc_list: str = "",
                 lsm_prob: float = 0.0, dropout: float = 0.0):
        super().__init__()
        self.lsm_prob = lsm_prob
        self.n_fc = 0
        d_in = enc_n_units
        for dim in (int(d) for d in fc_list.split("_")) if fc_list else ():
            self.add_module(f"fc{self.n_fc}", Linear(d_in, dim))
            self.n_fc += 1
            d_in = dim
        self.drop = Dropout(dropout)
        self.output = Linear(d_in, vocab)

    def forward(self, eouts, elens, ys, ylens,
                gen: Optional[torch.Generator] = None):
        """Returns (loss, logits [B, T, V]): the CTC nll of the f32
        log-softmax, summed over utterances and divided by B (mixed with
        the label-smoothing term when ``lsm_prob`` > 0)."""
        logits = self.logits(eouts, gen)
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        nll = ctc_loss(log_probs, ys, elens, ylens)
        loss = nll.sum() / eouts.shape[0]
        if self.lsm_prob > 0:
            loss = (1 - self.lsm_prob) * loss + \
                self.lsm_prob * kldiv_lsm_ctc(logits, elens) / \
                ylens.float().mean().clamp(min=1.0)
        return loss, logits

    def logits(self, eouts: torch.Tensor,
               gen: Optional[torch.Generator] = None,
               deterministic: bool = False) -> torch.Tensor:
        """[B, T, V]; the fc layers' dropout in ``train()`` unless
        ``deterministic``."""
        h = eouts
        for i in range(self.n_fc):
            h = torch.relu(getattr(self, f"fc{i}")(h))
            if not deterministic:
                h = self.drop(h, gen)
        return self.output(h)

    def log_probs(self, eouts: torch.Tensor) -> torch.Tensor:
        """f32 log-softmax of the logits without dropout (JAX's
        ``deterministic=True`` default)."""
        return torch.log_softmax(
            self.logits(eouts, deterministic=True).float(), dim=-1)

    @torch.no_grad()
    def trigger_points(self, eouts, elens, ys, ylens) -> torch.Tensor:
        """The frame [B, U] at which the forced alignment of the labels to
        the deterministic log-probabilities first emits each label (0 past
        ylens): MoChA's ``ctc_sync`` latency targets."""
        trig, _ = ctc_forced_align(self.log_probs(eouts), ys, elens, ylens,
                                   blank=BLANK)
        return trig


def collapse_path(path, blank: int = BLANK) -> list[int]:
    """CTC collapse: merge repeats then drop blanks (host-side)."""
    out, prev = [], -1
    for p in path:
        p = int(p)
        if p != prev and p != blank:
            out.append(p)
        prev = p
    return out


def best_path_frames(log_probs: np.ndarray, blank: int = BLANK
                     ) -> tuple[list[int], list[int]]:
    """The collapsed best path of log_probs [T, V] (one utterance's valid
    frames) and the frame each of its tokens is first emitted at, as the
    JAX ``eval_word`` reads the char sub1 head for ``resolving_unk``."""
    path, frames = [], []
    prev = blank
    for f, c in enumerate(np.argmax(log_probs, -1)):
        if c != blank and c != prev:
            path.append(int(c))
            frames.append(f)
        prev = c
    return path, frames


def ctc_greedy(best_paths: np.ndarray, elens: np.ndarray) -> list[list[int]]:
    return [collapse_path(best_paths[b, : int(elens[b])])
            for b in range(best_paths.shape[0])]


def _logsumexp(*xs):
    m = max(xs)
    if m <= LOG0:
        return LOG0
    return m + np.log(sum(np.exp(x - m) for x in xs))


class CTCBlockSyncBeam:
    """Block-synchronous (resumable) CTC prefix beam search
    (reference ``beam_search_block_sync`` ctc.py:485-531).

    Feed posterior blocks as they arrive with ``step``; ``hypotheses`` gives
    the current n-best; ``commit_and_reset`` finalises the running best
    (CTC-VAD segment boundary) and restarts the beam for the next segment.
    """

    def __init__(self, beam_width: int = 10, blank: int = BLANK,
                 lm_fn=None, lm_weight: float = 0.0):
        self.beam_width = beam_width
        self.blank = blank
        self.lm_fn = lm_fn
        self.lm_weight = lm_weight
        self.committed: list[int] = []
        self._reset_beam()

    def _reset_beam(self):
        self.beam = {(): (0.0, LOG0, 0.0)}

    def step(self, log_probs_block: np.ndarray, n_frames: int | None = None):
        lp_all = np.asarray(log_probs_block)
        t_max = n_frames if n_frames is not None else lp_all.shape[0]
        for t in range(t_max):
            lp = lp_all[t]
            topk = np.argsort(lp)[::-1][: max(self.beam_width * 2, 8)]
            new_beam: dict = {}

            def add(prefix, pb, pnb, plm):
                if prefix in new_beam:
                    opb, opnb, _ = new_beam[prefix]
                    new_beam[prefix] = (_logsumexp(opb, pb),
                                        _logsumexp(opnb, pnb), plm)
                else:
                    new_beam[prefix] = (pb, pnb, plm)

            for prefix, (pb, pnb, plm) in self.beam.items():
                p_total = _logsumexp(pb, pnb)
                add(prefix, p_total + lp[self.blank],
                    LOG0 if not prefix else pnb + lp[prefix[-1]], plm)
                lm_row = None
                for k in topk:
                    k = int(k)
                    if k == self.blank:
                        continue
                    if prefix and k == prefix[-1]:
                        p_new = pb + lp[k]
                    else:
                        p_new = p_total + lp[k]
                    plm_new = plm
                    if self.lm_fn is not None and self.lm_weight > 0:
                        if lm_row is None:
                            lm_row = self.lm_fn(prefix)
                        plm_new = plm + float(lm_row[k])
                    add(prefix + (k,), LOG0, p_new, plm_new)
            scored = sorted(
                new_beam.items(),
                key=lambda kv: -(_logsumexp(kv[1][0], kv[1][1])
                                 + self.lm_weight * kv[1][2]))
            self.beam = dict(scored[: self.beam_width])

    def hypotheses(self) -> list[dict]:
        out = []
        for prefix, (pb, pnb, plm) in self.beam.items():
            out.append({"hyp": self.committed + list(prefix),
                        "score": _logsumexp(pb, pnb) + self.lm_weight * plm})
        return sorted(out, key=lambda d: -d["score"])

    def commit_and_reset(self):
        best = self.hypotheses()[0]["hyp"]
        self.committed = best
        self._reset_beam()
        return best


class CTCPrefixScorer:
    """Watanabe-style joint CTC/attention prefix scorer (reference
    CTCPrefixScore ctc.py:756-871), vectorized over candidate tokens.

    Usage per utterance: init with [T, V] log probs; ``initial_state()``;
    ``__call__(hyp_ids, candidate_ids, state)`` -> (scores [n_cands], states).
    ``register_new_chunk`` extends T for block-synchronous streaming.
    """

    def __init__(self, log_probs: np.ndarray, blank: int = BLANK,
                 eos: int = EOS):
        self.lp = np.asarray(log_probs, np.float32)  # [T, V]
        self.blank = blank
        self.eos = eos
        self.T = self.lp.shape[0]

    def register_new_chunk(self, log_probs_chunk: np.ndarray):
        self.lp = np.concatenate([self.lp, np.asarray(log_probs_chunk)], 0)
        self.T = self.lp.shape[0]

    def extend_state(self, hyp: list[int], r_prev: np.ndarray) -> np.ndarray:
        """Extend a beam state over frames appended by
        ``register_new_chunk`` (block-synchronous decoding: the prefix is
        fixed, only T grows — reference CTCPrefixScore streaming usage,
        ctc.py:803-806)."""
        t_old = r_prev.shape[0]
        if t_old >= self.T:
            return r_prev
        r = np.concatenate(
            [r_prev, np.full((self.T - t_old, 2), LOG0, np.float32)], 0)
        last = hyp[-1] if hyp else -1
        for t in range(t_old, self.T):
            if last >= 0:
                r[t, 0] = r[t - 1, 0] + self.lp[t, last]
            r[t, 1] = np.logaddexp(r[t - 1, 0], r[t - 1, 1]) + \
                self.lp[t, self.blank]
        return r

    def initial_state(self):
        # r[t, 0]: prob of prefix ending in nonblank, r[t, 1]: in blank
        r = np.full((self.T, 2), LOG0, np.float32)
        r[0, 1] = self.lp[0, self.blank]
        for t in range(1, self.T):
            r[t, 1] = r[t - 1, 1] + self.lp[t, self.blank]
        return r

    def __call__(self, hyp: list[int], cands: np.ndarray, r_prev: np.ndarray):
        """Score extending ``hyp`` (without eos) by each candidate id:
        ``score_batch`` for one hypothesis.

        Returns (scores [n_cands] — log p(prefix+c..) for joint scoring,
        r_new [n_cands, T, 2]).
        """
        psi, r = self.score_batch([hyp], np.asarray(cands)[None], [r_prev])
        return psi[0], r[0]

    def score_batch(self, hyps: list[list[int]], cands: np.ndarray,
                    r_prev: list[np.ndarray]):
        """Score extending each of K hypotheses of one length (a
        label-synchronous beam's step) by its candidate ids, in one pass
        over T: cands [K, n], r_prev K states [T, 2]. Returns (psi [K, n],
        r_new [K, n, T, 2]); an eos candidate scores its hypothesis's full
        prefix probability."""
        if len({len(h) for h in hyps}) != 1:
            raise ValueError("score_batch: hypotheses of one length")
        cands = np.asarray(cands)
        k, n = cands.shape
        T = self.T
        hlen = len(hyps[0])
        last = np.asarray([h[-1] if h else -1 for h in hyps])
        rp = np.stack(r_prev)                                   # [K, T, 2]
        # frames first, so that each frame's [K, n] rows are contiguous
        r = np.full((T, 2, k, n), LOG0, np.float32)
        r_sum_prev = np.logaddexp(rp[:, :, 0], rp[:, :, 1])     # [K, T]
        lp_c = self.lp[:, cands]                                # [T, K, n]
        start = max(hlen, 1)
        psi = np.full((k, n), LOG0, np.float32)
        if hlen == 0:
            r[0, 0] = lp_c[0]
            psi = r[0, 0].copy()
        phi = np.where((cands == last[:, None])[None],
                       rp[:, :, 1].T[:, :, None],
                       r_sum_prev.T[:, :, None])                # [T, K, n]
        for t in range(start, T):
            r[t, 0] = np.logaddexp(r[t - 1, 0], phi[t - 1]) + lp_c[t]
            r[t, 1] = np.logaddexp(r[t - 1, 0], r[t - 1, 1]) + \
                self.lp[t, self.blank]
            psi = np.logaddexp(psi, phi[t - 1] + lp_c[t])
        r = r.transpose(2, 3, 0, 1)                             # [K, n, T, 2]
        is_eos = cands == self.eos
        if is_eos.any():
            full = np.logaddexp(rp[:, -1, 0], rp[:, -1, 1])     # [K]
            psi = np.where(is_eos, full[:, None], psi)
        return psi, r
