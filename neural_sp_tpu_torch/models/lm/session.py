"""LMSession (counterpart of ``neural_sp_tpu/models/lm/session.py``): one
LM step at a time over a batch of hypotheses, sequence scoring and the
unigram cache model, for shallow fusion, second-pass n-best rescoring and
perplexity.

Any of the four LM families serves (``models/lm/build.py``). The LM runs
where its parameters lie (the card, unless it was built with
``device="cpu"``); token ids come in and log-probs go out as numpy, one
copy to the host per step. The state stays on the LM's device, as the LM
keeps it: the RNNLM's per-layer (c, h) tensors [B, n_units] (None for the
zero state), the TransformerLM's per-layer K / V caches, the
Transformer-XL's memories, the GCNN's per-block input caches; a beam's
reorder is ``select``, an ``index_select`` of every tensor of that tree.
Serve an LM in ``eval()`` mode (dropout off), as the JAX session's steps
are deterministic.

The cache model interpolates p = (1 - lambda) p_lm + lambda p_cache, where
p_cache puts the softmax of theta * (the current hidden state against the
last ``cache_size`` ones) on the tokens that followed them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ... import EOS


class LMSession:
    def __init__(self, lm, cache_size: int = 0, cache_lambda: float = 0.2,
                 cache_theta: float = 0.3):
        self.lm = lm
        self.device = next(lm.parameters()).device
        self.cache_size = cache_size
        self.cache_lambda = cache_lambda
        self.cache_theta = cache_theta

    @torch.inference_mode()
    def initial_state(self, bs: int):
        """The LM's empty state of ``bs`` rows (``init_state``), as the
        JAX session's."""
        return self.lm.init_state(bs)

    @torch.inference_mode()
    def select(self, state, index):
        """Rows ``index`` [B'] (ints on any device) of every tensor of the
        state tree (lists, tuples, dicts; None stays None): a beam's
        reorder."""
        index = torch.as_tensor(index, device=self.device)

        def rows(x):
            if x is None:
                return None
            if isinstance(x, dict):
                return {k: rows(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(rows(v) for v in x)
            return x.index_select(0, index)
        return rows(state)

    @torch.inference_mode()
    def _step(self, y, state):
        y = torch.from_numpy(np.asarray(y, np.int64)).to(self.device)
        return self.lm.predict(y, state)

    def predict(self, y: np.ndarray, state):
        """y [B] ints -> (log-probs [B, V] numpy float32, new state)."""
        lp, new_state, _ = self._step(y, state)
        return lp.cpu().numpy(), new_state

    def predict_with_hidden(self, y: np.ndarray, state):
        lp, new_state, h = self._step(y, state)
        return lp.cpu().numpy(), new_state, h.float().cpu().numpy()

    def score_sequence(self, ids: list[int], sos: int = EOS) -> float:
        """Sum of log p(ids) with sos prepended (for n-best rescoring), one
        token per step at B = 1."""
        state = self.initial_state(1)
        seq = [sos] + list(ids)
        total = 0.0
        for t in range(len(seq) - 1):
            lp, state = self.predict(np.asarray([seq[t]]), state)
            total += float(lp[0, seq[t + 1]])
        return total

    def ppl_with_cache(self, ids: list[int], sos: int = EOS) -> float:
        """Per-token perplexity with the unigram cache model."""
        state = self.initial_state(1)
        seq = [sos] + list(ids)
        hist_h: list[np.ndarray] = []
        hist_y: list[int] = []
        total = 0.0
        for t in range(len(seq) - 1):
            lp, state, h = self.predict_with_hidden(
                np.asarray([seq[t]]), state)
            probs = np.exp(lp[0])
            if self.cache_size > 0 and hist_h:
                hs = np.stack(hist_h[-self.cache_size:])    # [M, D]
                ys = hist_y[-self.cache_size:]
                # shifted by its max: the JAX session's unshifted exp
                # overflows to NaN on a Transformer-XL's hidden states
                # (ROADMAP C37); equal to it wherever that is finite
                e = self.cache_theta * (hs @ h[0])
                att = np.exp(e - e.max())
                att /= att.sum()
                p_cache = np.zeros_like(probs)
                for w, yid in zip(att, ys):
                    p_cache[yid] += w
                probs = (1 - self.cache_lambda) * probs + \
                    self.cache_lambda * p_cache
            total += np.log(max(probs[seq[t + 1]], 1e-12))
            hist_h.append(h[0])
            hist_y.append(seq[t + 1])
        n = max(len(seq) - 1, 1)
        return float(np.exp(-total / n))


def rescore_nbest(nbest: list[list[int]], scores: list[float],
                  lm_session: LMSession, lm_weight: float,
                  lm_session_bwd: Optional[LMSession] = None,
                  lm_weight_bwd: float = 0.0) -> list[int]:
    """Second-pass (and backward) LM rescoring of an n-best list with its
    scores; returns the best hypothesis. The backward LM scores each
    hypothesis reversed."""
    best, best_score = nbest[0] if nbest else [], -np.inf
    for hyp, sc in zip(nbest, scores):
        total = sc + lm_weight * lm_session.score_sequence(hyp)
        if lm_session_bwd is not None and lm_weight_bwd > 0:
            total += lm_weight_bwd * lm_session_bwd.score_sequence(
                list(reversed(hyp)))
        if total > best_score:
            best, best_score = hyp, total
    return best
