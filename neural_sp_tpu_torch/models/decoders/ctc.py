"""CTC head with its training loss, greedy collapse and the joint-decoding
prefix scorer (counterpart of ``neural_sp_tpu/models/decoders/ctc.py``).
The loss is kernel K4 (``ops.ctc.ctc_loss``); the scorer is host numpy in
the JAX package and is copied as it is. ``trigger_points`` is the forced
alignment of ``ops.ctc.ctc_forced_align`` (MoChA's ``ctc_sync``).

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

LOG0 = -1.0e10


class CTC(nn.Module):
    def __init__(self, vocab: int, enc_n_units: int, fc_list: str = "",
                 lsm_prob: float = 0.0, dropout: float = 0.0):
        super().__init__()
        self.lsm_prob = lsm_prob
        self.n_fc = 0
        d_in = enc_n_units
        for dim in (int(d) for d in fc_list.split("_")) if fc_list else ():
            self.add_module(f"fc{self.n_fc}", nn.Linear(d_in, dim))
            self.n_fc += 1
            d_in = dim
        self.drop = Dropout(dropout)
        self.output = nn.Linear(d_in, vocab)

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


def ctc_greedy(best_paths: np.ndarray, elens: np.ndarray) -> list[list[int]]:
    return [collapse_path(best_paths[b, : int(elens[b])])
            for b in range(best_paths.shape[0])]


class CTCPrefixScorer:
    """Watanabe-style joint CTC/attention prefix scorer (reference
    CTCPrefixScore ctc.py:756-871), vectorized over candidate tokens.

    Usage per utterance: init with [T, V] log probs; ``initial_state()``;
    ``__call__(hyp_ids, candidate_ids, state)`` -> (scores [n_cands], states).
    """

    def __init__(self, log_probs: np.ndarray, blank: int = BLANK,
                 eos: int = EOS):
        self.lp = np.asarray(log_probs, np.float32)  # [T, V]
        self.blank = blank
        self.eos = eos
        self.T = self.lp.shape[0]

    def initial_state(self):
        # r[t, 0]: prob of prefix ending in nonblank, r[t, 1]: in blank
        r = np.full((self.T, 2), LOG0, np.float32)
        r[0, 1] = self.lp[0, self.blank]
        for t in range(1, self.T):
            r[t, 1] = r[t - 1, 1] + self.lp[t, self.blank]
        return r

    def __call__(self, hyp: list[int], cands: np.ndarray, r_prev: np.ndarray):
        """Score extending ``hyp`` (without eos) by each candidate id.

        Returns (scores [n_cands] — log p(prefix+c..) for joint scoring,
        r_new [n_cands, T, 2]).
        """
        n = len(cands)
        T = self.T
        last = hyp[-1] if hyp else -1
        r = np.full((n, T, 2), LOG0, np.float32)
        # psi: accumulated prefix score per candidate
        r_sum_prev = np.logaddexp(r_prev[:, 0], r_prev[:, 1])  # [T]
        lp_c = self.lp[:, cands]                                # [T, n]
        start = max(len(hyp), 1)
        psi = np.full(n, LOG0, np.float32)
        if len(hyp) == 0:
            r[:, 0, 0] = lp_c[0]
            psi = r[:, 0, 0].copy()
        phi = np.where(np.asarray(cands)[None, :] == last,
                       r_prev[:, 1:2], r_sum_prev[:, None])     # [T, n]
        for t in range(start, T):
            r[:, t, 0] = np.logaddexp(r[:, t - 1, 0], phi[t - 1]) + lp_c[t]
            r[:, t, 1] = np.logaddexp(r[:, t - 1, 0], r[:, t - 1, 1]) + \
                self.lp[t, self.blank]
            psi = np.logaddexp(psi, phi[t - 1] + lp_c[t])
        # eos candidate scores the full prefix probability
        is_eos = np.asarray(cands) == self.eos
        if is_eos.any():
            psi[is_eos] = np.logaddexp(r_prev[-1, 0], r_prev[-1, 1])
        return psi, r
