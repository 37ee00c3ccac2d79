"""Decoding session: greedy and beam search over the LAS decoder, and the
beam search over the transformer decoder (counterpart of
``neural_sp_tpu/models/decoders/decoding.py``).

Served: ``Speech2TextSession.decode`` dispatching as the JAX session does,
attention greedy, the batched on-device beam (``device_beam``, fusion-free
decoding), and the label-synchronous LAS beam search with joint CTC prefix
scores (one utterance at a time, the reference eval protocol), with
length / coverage penalties, length normalisation, eos threshold, min/max
length ratios and softmax smoothing, LM shallow fusion (an ``LMSession``,
one batched LM step per decode step), internal-LM subtraction (a second
decode loop over zeroed keys and encoder outputs) and second-pass and
backward-LM rescoring of the n-best (``attach_second_pass_lms``). The
neural work of a step runs on the model's (and the LM's) device; host
Python reorders indices, scores candidates and keeps end-of-sentence
bookkeeping, as in the JAX session.

One host beam (``_beam_one``) serves both decoders, as JAX's
``_beam_one_las`` and ``_beam_one_transformer`` do (the same children,
pruning and CTC pairing quirk); with a transformer it has no coverage
penalty and no internal-LM term (``ilm_weight`` is not read: ROADMAP C24),
and beam width 1 runs the beam, not greedy.

The RNN transducer (JAX's ``_rnnt_fns`` and searches): greedy
(``decode_transducer_greedy``, up to ``MAX_SYMBOLS`` labels a frame) and
the time-synchronous beam (``transducer_beam_frames``: ``tsd`` with up to
``MAX_EXP`` expansions a frame, ``mono`` with one), its hypotheses merged
in log space; the prediction network's state is cached by prefix, the
uncached prefixes of a frame go through it in one batch, and the joint
takes every prefix of the beam in one batch padded to the beam width, as
JAX's.

Streaming (``decode_streaming``, one utterance fed block by block
through the encoder's ``streaming_step`` and its caches or carries): with
a transformer / conformer encoder and a MoChA LAS decoder, the
block-synchronous attention beam (``decode_streaming_attention``:
hypotheses with no boundary in the frames seen so far are parked with
their decoder state rolled back, joint CTC advances chunk by chunk, LM
fusion through the ``LMSession``); with a transducer, its ``mono`` beam
block by block; with any other decoder (an RNN encoder with MoChA
included: JAX's dispatch, ROADMAP C30; a transformer decoder, C26), the
block-synchronous CTC prefix beam. CTC-VAD resets commit the running best
and restart the beam; an RNN encoder's carry restarts too, warmed on the
previous block. The device-side streaming beams
(``recog_device_beam``) raise.

Not ported yet (ROADMAP), and raising ``NotImplementedError``: ensembles,
forward-backward merging, speaker state carry-over and CTC prefix beam
search over a whole utterance.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ... import BLANK, EOS, PAD
from ...frontends.streaming import CtcVAD, StreamingDriver
from ...ops.masks import make_pad_mask
from .ctc import CTCBlockSyncBeam, CTCPrefixScorer, ctc_greedy
from .las import RNNDecoder
from .rnn_transducer import RNNTransducer


@dataclass
class DecodeConfig:
    beam_width: int = 10
    max_len_ratio: float = 1.0
    min_len_ratio: float = 0.0
    length_penalty: float = 0.0
    length_norm: bool = False
    coverage_penalty: float = 0.0
    coverage_threshold: float = 0.0
    eos_threshold: float = 1.5
    ctc_weight: float = 0.0          # joint CTC score weight at decode
    lm_weight: float = 0.0
    ilm_weight: float = 0.0          # internal LM subtraction
    softmax_smoothing: float = 1.0
    n_best: int = 1
    lm_second_weight: float = 0.0    # second-pass n-best rescoring
    lm_bwd_weight: float = 0.0       # backward-LM rescoring
    fwd_bwd_attention: bool = False  # merge fwd/bwd decoder n-bests
    state_carry_over: bool = False   # speaker-keyed decoder state carry-over
    device_beam: bool = False        # fully on-device batched beam search


_NOT_PORTED = ("fwd_bwd_attention", "state_carry_over")
# the streaming MoChA beam pads the encoder frames it has seen to a
# multiple of this many blocks, as the JAX session (its keys re-projected
# over them each block)
T_PAD_BLOCKS = 8
# the transducer searches, as JAX's: labels a frame in greedy decoding,
# expansions a frame in the ``tsd`` beam
MAX_SYMBOLS = 3
MAX_EXP = 3


class Speech2TextSession:
    """Wraps a ``Speech2Text`` (weights on its device) with the decode
    loops; ``lm_session`` (an ``LMSession``) is the shallow-fusion LM.
    Inputs may be numpy arrays or tensors; they are moved to the model's
    device."""

    def __init__(self, model, conf: DecodeConfig | None = None,
                 lm_session=None, ensemble=None):
        self.model = model
        self.conf = conf or DecodeConfig()
        for name in _NOT_PORTED:
            if getattr(self.conf, name):
                raise NotImplementedError(
                    f"DecodeConfig.{name} is not ported yet, see ROADMAP")
        if ensemble:
            raise NotImplementedError(
                "ensembles are not ported yet, see ROADMAP")
        self.lm = lm_session
        self.lm_second = None        # set via attach_second_pass_lms
        self.lm_bwd = None
        self.dec = model.dec_fwd
        self.device = next(model.parameters()).device

    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def encode(self, xs, xlens):
        xs = torch.as_tensor(np.asarray(xs, np.float32) if not
                             isinstance(xs, torch.Tensor) else xs,
                             dtype=torch.float32, device=self.device)
        xlens = torch.as_tensor(xlens, device=self.device).long()
        return self.model.encode(xs, xlens)[0]

    @torch.inference_mode()
    def _ctc_logp(self, e):
        return self.model.ctc.log_probs(e)

    def decode_ctc_greedy(self, xs, xlens):
        eouts = self.encode(xs, xlens)
        lp = self._ctc_logp(eouts["ys"]["xs"])
        paths = lp.argmax(-1).cpu().numpy()
        return ctc_greedy(paths, eouts["ys"]["xlens"].cpu().numpy())

    @torch.inference_mode()
    def decode_attention_greedy(self, xs, xlens):
        assert isinstance(self.dec, RNNDecoder)
        eouts = self.encode(xs, xlens)
        e, el = eouts["ys"]["xs"], eouts["ys"]["xlens"]
        max_len = max(int(e.shape[1] * self.conf.max_len_ratio), 2)
        toks, lens = self.dec.greedy_scan(e, el, max_len)
        toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
        return [[int(t) for t in toks[b, :lens[b]] if t not in (EOS, PAD)]
                for b in range(toks.shape[0])]

    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def decode_attention_beam_device(self, xs, xlens):
        """Batched beam search with every hypothesis on the device: the
        whole batch's [B, K, L] hypotheses advance together, one decode
        step per output position, beams reordered by gather, no host
        round trip until the end. The path for fusion-free decoding (no
        joint CTC, coverage or LM); supports length penalty / norm,
        eos_threshold and min / max length, as the JAX session's."""
        conf, dec = self.conf, self.dec
        eouts = self.encode(xs, xlens)
        e, el = eouts["ys"]["xs"], eouts["ys"]["xlens"]
        b, tmax, _ = e.shape
        k = conf.beam_width
        max_len = max(int(tmax * conf.max_len_ratio), 2)
        dev = e.device
        neg = torch.tensor(-1e30, dtype=torch.float32, device=dev)
        rows = torch.arange(b, device=dev)

        ebk = e.repeat_interleave(k, dim=0)                  # [B*K, T, D]
        klens = el.repeat_interleave(k).to(torch.int32)
        kc = dec.precompute_keys(ebk)
        # the carry lives in the loop's workspace; the beams are reordered
        # inside the next step (``parent``), not copied
        loop = dec.decode_loop(kc, ebk, klens)
        flat_parent = None
        row0 = (rows * k)[:, None]
        scores = torch.full((b, k), -1e30, device=dev)
        scores[:, 0] = 0.0
        toks = torch.full((b, k, max_len), PAD, dtype=torch.long, device=dev)
        lens = torch.zeros((b, k), dtype=torch.long, device=dev)
        y = torch.full((b * k,), EOS, dtype=torch.long, device=dev)
        best_tok = torch.full((b, max_len), PAD, dtype=torch.long,
                              device=dev)
        best_sc = torch.full((b,), -1e30, device=dev)
        min_lens = (el.float() * conf.min_len_ratio).long()

        for i in range(max_len):
            logits, _ = loop.step(y, flat_parent)
            logp = torch.log_softmax(conf.softmax_smoothing * logits.float(),
                                     -1).view(b, k, -1)
            vocab = logp.shape[-1]
            total = scores[:, :, None] + logp
            # eos gating (reference las.py:1296-1313)
            best_non = logp.index_fill(2, torch.tensor([EOS], device=dev),
                                       -1e30).amax(-1)
            ok_eos = (logp[:, :, EOS] >= conf.eos_threshold * best_non) & \
                (i >= min_lens)[:, None]
            # finished candidates: the best eos extension of each row
            n_tok = lens + 1
            fin = total[:, :, EOS]
            fin = fin / n_tok.clamp(min=1) if conf.length_norm else \
                fin + conf.length_penalty * n_tok
            fin = torch.where(ok_eos, fin, neg)
            k_best = fin.argmax(1)
            sc_best = fin[rows, k_best]
            cand_tok = toks[rows, k_best].clone()
            cand_tok[rows, lens[rows, k_best]] = EOS
            upd = sc_best > best_sc
            best_sc = torch.where(upd, sc_best, best_sc)
            best_tok = torch.where(upd[:, None], cand_tok, best_tok)
            # survivors: the top K non-eos extensions
            total[:, :, EOS] = neg
            scores, top_ix = total.view(b, k * vocab).topk(k, dim=1)
            parent, tok = top_ix // vocab, top_ix % vocab
            flat_parent = (row0 + parent).view(-1)
            toks = toks.gather(1, parent[:, :, None].expand(-1, -1, max_len))
            lens = lens.gather(1, parent)
            toks.scatter_(2, lens[:, :, None], tok[:, :, None])
            lens, y = lens + 1, tok.view(-1)

        # force-finish fallback: the best live row when nothing ended
        use_alive = best_sc <= -1e30 / 2
        out = torch.where(use_alive[:, None], toks[:, 0], best_tok).cpu()
        return [[int(t) for t in row if t not in (PAD, EOS)]
                for row in out.numpy()]

    def decode_attention_beam(self, xs, xlens):
        """Batched-beam label-synchronous search, one utterance at a time
        (reference eval protocol, bs=1)."""
        eouts_all = self.encode(xs, xlens)
        results = []
        for b in range(eouts_all["ys"]["xs"].shape[0]):
            e = eouts_all["ys"]["xs"][b:b + 1]
            el = eouts_all["ys"]["xlens"][b:b + 1]
            _, nbest = self._beam_one(e, el)
            results.append(self._post_process_nbest(nbest))
        return results

    def attach_second_pass_lms(self, lm_second=None, lm_bwd=None):
        """``LMSession``s that rescore the n-best: a second-pass LM and a
        backward LM (weights ``lm_second_weight`` / ``lm_bwd_weight``)."""
        self.lm_second = lm_second
        self.lm_bwd = lm_bwd

    def _post_process_nbest(self, nbest: list[list[int]]) -> list[int]:
        """Second-pass LM and backward-LM rescoring over the n-best; the
        backward LM scores the reversed hypothesis, and -0.001 per rank
        keeps the beam's order as the tiebreak. As in the JAX session, the
        beam's own scores do not enter the ranking (ROADMAP C7): mirrored
        for parity."""
        conf = self.conf
        if not nbest or (self.lm_second is None and self.lm_bwd is None):
            return nbest[0] if nbest else []
        best, best_score = nbest[0], -np.inf
        for i, hyp in enumerate(nbest):
            score = -0.001 * i
            if self.lm_second is not None and conf.lm_second_weight > 0:
                score += conf.lm_second_weight * \
                    self.lm_second.score_sequence(hyp)
            if self.lm_bwd is not None and conf.lm_bwd_weight > 0:
                score += conf.lm_bwd_weight * \
                    self.lm_bwd.score_sequence(list(reversed(hyp)))
            if score > best_score:
                best, best_score = hyp, score
        return best

    def _ctc_scorer(self, e, el):
        if self.conf.ctc_weight <= 0 or self.model.ctc is None:
            return None
        lp = self._ctc_logp(e)[0][: int(el[0])].cpu().numpy()
        return CTCPrefixScorer(lp)

    @torch.inference_mode()
    def _beam_one(self, e, el):
        """Beam search of one utterance e [1, T, d], el [1], over the LAS or
        the transformer decoder. Returns (best hypothesis, n-best list);
        the n-best's scores are kept in ``_last_nbest_scores`` (joint) and
        ``_last_nbest_scores_att``, and with the LAS decoder each emitted
        token's attention-peak frame (the argmax of the step's weights,
        MoChA's averaged over its heads; encoder frames) in
        ``_last_nbest_peaks``, as JAX's ``_beam_one_las`` (MBR training's
        n-best and ``resolving_unk`` read them); ``_last_margins`` holds
        each step's pruning margin (the least score kept over the best
        dropped, inf when none was dropped), with which a caller holds two
        runs' n-bests to the first close decision. As JAX's
        ``_beam_one_transformer``, the transformer's beam has no internal-LM
        term (``ilm_weight`` is not read: ROADMAP C24), no coverage penalty
        and no peaks."""
        conf = self.conf
        dec = self.dec
        las = isinstance(dec, RNNDecoder)
        beam = conf.beam_width
        tmax = e.shape[1]
        max_len = max(int(int(el[0]) * conf.max_len_ratio), 2)
        min_len = int(int(el[0]) * conf.min_len_ratio)

        e_t = e.repeat_interleave(beam, dim=0)
        klens = el.repeat_interleave(beam).to(torch.int32)
        if las:
            kc = dec.precompute_keys(e_t)
            loop = dec.decode_loop(kc, e_t, klens)
        else:
            loop = dec.decode_loop(e_t, klens)
        par = None
        # internal-LM estimation: a second decode loop over zeroed keys and
        # encoder outputs (so a zero context) with the real lengths, stepped
        # with the same tokens and parents
        use_ilm = las and conf.ilm_weight > 0
        use_cov = las and conf.coverage_penalty > 0
        if use_ilm:
            # every entry of MoChA's key dict zeroed (JAX tree.map)
            kc_zero = {k: torch.zeros_like(v) for k, v in kc.items()} \
                if isinstance(kc, dict) else torch.zeros_like(kc)
            ilm_loop = dec.decode_loop(kc_zero, torch.zeros_like(e_t), klens)
        # the LM state is ONE batched state over the beam: one LM step per
        # decode step, rows reordered by ``select``
        use_lm = self.lm is not None and conf.lm_weight > 0
        lm_state = self.lm.initial_state(beam) if self.lm else None

        ctc_scorer = self._ctc_scorer(e, el)
        ctc_states = [ctc_scorer.initial_state() if ctc_scorer else None] * beam

        hyps = [[] for _ in range(beam)]
        peaks = [[] for _ in range(beam)]   # attention-peak frame per token
        scores = np.full(beam, -1e30, np.float32)
        scores[0] = 0.0
        scores_att = np.zeros(beam, np.float32)  # cumulative att (raw)
        scores_ctc = np.zeros(beam, np.float32)
        scores_ilm = np.zeros(beam, np.float32)  # cumulative internal-LM
        scores_lm = np.zeros(beam, np.float32)
        aw_sums = np.zeros((beam, tmax), np.float32)
        y = torch.full((beam,), EOS, dtype=torch.long, device=e.device)
        finished: list[dict] = []
        margins = []

        for step_i in range(max_len):
            logits, aw = loop.step(y, par)
            logp = torch.log_softmax(
                conf.softmax_smoothing * logits.float(), -1).cpu().numpy()
            if las:
                aw_h = aw.float()
                if aw_h.dim() == 3:     # MoChA's heads: their mean
                    aw_h = aw_h.mean(1)
                peak_t = aw_h.argmax(-1).cpu().numpy()
            if use_ilm:
                ilm_logits, _ = ilm_loop.step(y, par)
                ilm_logp = torch.log_softmax(ilm_logits.float(),
                                             -1).cpu().numpy()
                logp_eff = logp - conf.ilm_weight * ilm_logp
            else:
                ilm_logp = np.zeros_like(logp)
                logp_eff = logp
            lm_logp = np.zeros_like(logp)
            if use_lm:
                y_in = np.asarray([h[-1] if h else EOS for h in hyps])
                lm_logp, lm_state = self.lm.predict(y_in, lm_state)

            # ---- children generation (reference las.py:1240-1360) ------
            # Per live beam: the top-``beam`` candidates by the (att - ilm)
            # score ALONE; LM and CTC join after that selection, so a token
            # outside the top-k is never hypothesized, however strong its
            # LM or CTC score. Totals are rebuilt each step from the carried
            # att / ilm / lm / ctc components. QUIRK MIRRORED EXACTLY (see
            # the JAX session): the reference's add_ctc_score re-sorts the
            # joint scores and CTC states but not the token ids, so the
            # att-rank-j TOKEN is paired with the joint-rank-j PRUNING SCORE
            # and CTC STATE, while the carried ctc score stays att-rank-j.
            # Parity requires it verbatim.
            if step_i < min_len:
                bad_eos = np.ones(beam, bool)
            else:
                best_non_eos = np.max(np.delete(logp, EOS, axis=1), axis=1)
                bad_eos = logp[:, EOS] < conf.eos_threshold * best_non_eos

            w_ctc = conf.ctc_weight
            children = []
            live = [k for k in range(beam) if scores[k] > -1e29]
            top = {k: np.argsort(-logp_eff[k], kind="stable")[:beam]
                   for k in live}
            if ctc_scorer is not None and live:
                # one pass over the frames for every live hypothesis (they
                # have one length), each row as the per-hypothesis call's
                ctc_psi, ctc_r = ctc_scorer.score_batch(
                    [hyps[k] for k in live], np.stack([top[k] for k in live]),
                    [ctc_states[k] for k in live])
                ctc_rows = dict(zip(live, zip(ctc_psi, ctc_r)))
            for k in live:
                cands = top[k]
                # total = att (1 - w) - ilm w_ilm (1 - w) + lm w_lm
                base = ((1.0 - w_ctc) * (scores_att[k] + logp[k, cands])
                        - (1.0 - w_ctc) * conf.ilm_weight
                        * (scores_ilm[k] + ilm_logp[k, cands])
                        + conf.lm_weight * (scores_lm[k] + lm_logp[k, cands]))
                if conf.length_penalty != 0:
                    base = base + conf.length_penalty * (step_i + 1)
                if ctc_scorer is not None:
                    psi, r_new = ctc_rows[k]
                    joint = base + w_ctc * psi
                    perm = np.argsort(-joint, kind="stable")
                    prune_sc = joint[perm]
                else:
                    psi = r_new = None
                    prune_sc = base
                for j in range(len(cands)):
                    c = int(cands[j])
                    if c == EOS and bad_eos[k]:
                        continue
                    sc = float(prune_sc[j])
                    if conf.length_norm:
                        sc = sc / (step_i + 1)
                    children.append({
                        "parent": k, "tok": c, "score": sc,
                        "att": float(scores_att[k] + logp[k, c]),
                        "ilm": float(scores_ilm[k] + ilm_logp[k, c]),
                        "lm": float(scores_lm[k] + lm_logp[k, c]),
                        "psi": float(psi[j]) if psi is not None
                        else float(scores_ctc[k]),
                        "state": r_new[perm[j]] if psi is not None
                        else ctc_states[k]})

            # local pruning to the top ``beam`` children TOTAL; eos-enders
            # move to ``finished`` so the live beam shrinks
            children.sort(key=lambda d: -d["score"])
            margins.append(children[beam - 1]["score"] -
                           children[beam]["score"]
                           if len(children) > beam else float("inf"))
            children = children[:beam]
            new_hyps, new_scores, new_satt, new_y, parents = [], [], [], [], []
            new_silm, new_slm, new_ctc_beam, new_peaks = [], [], [], []
            for ch in children:
                k, v, sc = ch["parent"], ch["tok"], ch["score"]
                pk = peaks[k] + [int(peak_t[k])] if las else []
                if v == EOS:
                    cand = {"hyp": hyps[k] + [EOS], "score": sc,
                            "score_att": float(ch["att"]), "peaks": pk}
                    if use_cov:
                        cov = np.sum(np.minimum(
                            aw_sums[k], conf.coverage_threshold or 0.5))
                        cand["score"] += conf.coverage_penalty * cov
                    finished.append(cand)
                    continue
                new_hyps.append(hyps[k] + [v])
                new_peaks.append(pk)
                new_scores.append(sc)
                new_satt.append(ch["att"])
                new_silm.append(ch["ilm"])
                new_slm.append(ch["lm"])
                new_y.append(v)
                parents.append(k)
                new_ctc_beam.append((ch["state"], ch["psi"]))
            # stop once ``beam`` hypotheses completed (reference
            # remove_complete_hyp: end_hyps pruned to beam_width in
            # arrival order)
            if len(finished) >= beam:
                finished = finished[:beam]
                break
            if not new_hyps:
                break
            while len(new_hyps) < beam:  # pad beam with dead entries
                new_hyps.append(new_hyps[-1])
                new_peaks.append(new_peaks[-1])
                new_scores.append(-1e30)
                new_satt.append(new_satt[-1])
                new_silm.append(new_silm[-1])
                new_slm.append(new_slm[-1])
                new_y.append(new_y[-1])
                parents.append(parents[-1])
                new_ctc_beam.append(new_ctc_beam[-1])

            # the next step reads each survivor's parent row of the carry
            # (the ILM loop's too)
            par = torch.tensor(parents, dtype=torch.int32)
            if self.lm is not None:
                lm_state = self.lm.select(lm_state, parents)
            if use_cov:
                aw_np = aw.float().cpu().numpy()
                if aw_np.ndim == 3:       # MoChA: [beam, H, T] -> head mean
                    aw_np = aw_np.mean(1)
                aw_sums = aw_sums[parents] + aw_np[parents]
            hyps = new_hyps
            peaks = new_peaks
            scores = np.asarray(new_scores, np.float32)
            scores_att = np.asarray(new_satt, np.float32)
            scores_ilm = np.asarray(new_silm, np.float32)
            scores_lm = np.asarray(new_slm, np.float32)
            if ctc_scorer is not None:
                ctc_states = [c[0] for c in new_ctc_beam]
                scores_ctc = np.asarray([c[1] for c in new_ctc_beam],
                                        np.float32)
            y = torch.as_tensor(new_y, dtype=torch.long, device=e.device)

        # global pruning: top up with live hypotheses when fewer than
        # ``beam`` completed
        if len(finished) < beam:
            live = [{"hyp": hyps[i] + [EOS], "score": float(scores[i]),
                     "score_att": float(scores_att[i]), "peaks": peaks[i]}
                    for i in range(len(hyps)) if scores[i] > -1e29]
            finished.extend(live[: beam - len(finished)])
        finished.sort(key=lambda d: -d["score"])
        top = finished[: conf.n_best]
        nbest = [[t for t in f["hyp"] if t != EOS] for f in top]
        self._last_nbest_scores = [float(f["score"]) for f in top]
        self._last_nbest_scores_att = [float(f["score_att"]) for f in top]
        self._last_nbest_peaks = [f["peaks"][:len(nb)]
                                  for f, nb in zip(top, nbest)]
        self._last_margins = margins
        return nbest[0], nbest

    # ------------------------------------------------------------------ #
    def decode(self, xs, xlens):
        """Dispatch like the JAX session (reference Speech2Text.decode)."""
        if isinstance(xs, dict):  # batch dict passthrough
            xlens = xs["xlens"]
            xs = xs["xs"]
        if self.model.dec_fwd is None or self.model.ctc_weight >= 1.0:
            if self.conf.beam_width > 1:
                raise NotImplementedError(
                    "CTC prefix beam search is not ported yet, see ROADMAP")
            return self.decode_ctc_greedy(xs, xlens)
        if isinstance(self.dec, RNNTransducer):
            if self.conf.beam_width > 1:
                return self.decode_transducer_beam(xs, xlens)
            return self.decode_transducer_greedy(xs, xlens)
        if self.conf.beam_width <= 1 and isinstance(self.dec, RNNDecoder):
            return self.decode_attention_greedy(xs, xlens)
        conf = self.conf
        fusion_free = (conf.lm_weight == 0 and conf.ctc_weight == 0
                       and conf.ilm_weight == 0 and self.lm_second is None
                       and self.lm_bwd is None
                       and conf.coverage_penalty == 0)
        if conf.device_beam and fusion_free and \
                isinstance(self.dec, RNNDecoder):
            return self.decode_attention_beam_device(xs, xlens)
        return self.decode_attention_beam(xs, xlens)

    # ------------------------------------------------------------------ #
    def _make_ctc_lm_fn(self):
        """prefix tuple -> the LM's [V] log-probabilities after it,
        memoised by prefix: each new prefix costs one LM step from its
        parent's cached state (the JAX session's hook)."""
        cache: dict = {}

        def lm_fn(prefix):
            if prefix not in cache:
                if prefix:
                    lm_fn(prefix[:-1])        # the parent's state exists
                    state = cache[("state",) + prefix[:-1]]
                    y = prefix[-1]
                else:
                    state = self.lm.initial_state(1)
                    y = EOS
                lp, state = self.lm.predict(np.asarray([y], np.int32), state)
                cache[prefix] = np.asarray(lp[0])
                cache[("state",) + prefix] = state
            return cache[prefix]

        return lm_fn

    @torch.inference_mode()
    def _stream_step(self, block: np.ndarray, cache: dict):
        """One block [T_block, D] of input frames through the encoder's
        ``streaming_step`` (and the CTC head): (eouts [n_c, d] tensor, CTC
        log-probs [n_c, V] numpy or None, new cache)."""
        xb = torch.as_tensor(np.asarray(block, np.float32),
                             device=self.device)[None]
        eouts, cache = self.model.encoder.streaming_step(xb, cache)
        lp = self.model.ctc.log_probs(eouts)[0].cpu().numpy() \
            if self.model.ctc is not None else None
        return eouts[0], lp, cache


    def decode_streaming(self, x_whole, blank_threshold: int = 40):
        """Block-synchronous streaming decode of ONE utterance x_whole
        [T, D] (the JAX session's): the encoder's ``streaming_step`` over
        ``StreamingDriver``'s blocks with its caches (transformer) or
        carries (RNN), then with a transformer / conformer encoder and a
        MoChA decoder ``decode_streaming_attention``; with a transducer
        its ``mono`` beam; else the block-synchronous CTC prefix beam. On a
        CTC-VAD reset the running best prefix is committed and the beam
        restarts; a transformer's caches persist across resets, an RNN
        encoder's carry restarts, warmed on the previous block; the blank
        count carries across blocks. Returns (hypothesis ids, stats: rtf,
        n_resets, n_frames, commits)."""
        from ..encoders.transformer import XformerEncoder
        conf = self.conf
        enc = self.model.encoder
        is_xformer = isinstance(enc, XformerEncoder)
        # JAX's dispatch: the MoChA beam with a transformer / conformer
        # encoder only; an RNN encoder with MoChA takes the CTC beam (C30)
        if is_xformer and isinstance(self.dec, RNNDecoder) and \
                self.dec.attn_type == "mocha":
            if conf.device_beam and conf.lm_weight == 0 and \
                    conf.ctc_weight == 0:
                raise NotImplementedError(
                    "the device-side streaming MoChA beam "
                    "(recog_device_beam) is not ported yet, see ROADMAP")
            return self.decode_streaming_attention(x_whole)
        use_rnnt = isinstance(self.dec, RNNTransducer)
        if not use_rnnt and self.model.ctc is None:
            raise ValueError("streaming without a MoChA decoder or a "
                             "transducer runs the CTC head, which this "
                             "model lacks")
        total_in, hop_in = enc.block_input_frames()
        cnn_ctx_in = enc.stream_geometry()[1]
        factor = enc.subsampling_factor
        # an RNN encoder's carry: None starts a segment
        state = enc.init_stream_cache(1) if is_xformer else None
        if use_rnnt:
            rnnt_beam: dict = {(): 0.0}
            rnnt_cache: dict = {}
            committed: list[int] = []
        else:
            lm_fn = self._make_ctc_lm_fn() if (
                self.lm is not None and conf.lm_weight > 0) else None
            beam = CTCBlockSyncBeam(conf.beam_width, lm_fn=lm_fn,
                                    lm_weight=conf.lm_weight)
        vad = CtcVAD(factor=factor, blank_threshold=blank_threshold)
        t0 = time.time()
        n_frames = n_resets = 0
        is_reset = False
        prev_block = None
        commits: list[list[int]] = []
        for block, n_new, is_last in StreamingDriver(x_whole, total_in,
                                                     hop_in, cnn_ctx_in):
            if is_reset and not is_xformer:
                # a segment starts: a fresh carry, warmed on the previous
                # block
                state = None
                if prev_block is not None:
                    _, _, state = self._stream_step(prev_block, state)
            is_reset = False
            eouts_blk, lp_blk, state = self._stream_step(block, state)
            prev_block = block
            n_out = -(-n_new // factor)
            n_frames += n_new
            if use_rnnt:
                rnnt_beam = self.transducer_beam_frames(
                    eouts_blk[:n_out], rnnt_beam, rnnt_cache, version="mono")
            else:
                beam.step(lp_blk[:n_out])
            if lp_blk is not None:
                lp = lp_blk[:n_out]
                is_reset = vad.step(np.argmax(lp, -1), np.exp(lp).max(-1),
                                    n_new)
            if is_reset and not is_last:
                if use_rnnt:
                    committed.extend(_best_prefix(rnnt_beam))
                    commits.append(list(committed))
                    rnnt_beam = {(): 0.0}
                    rnnt_cache.clear()
                else:
                    commits.append(list(beam.commit_and_reset()))
                vad.reset()
                n_resets += 1
            else:
                is_reset = False
        hyp = committed + list(_best_prefix(rnnt_beam)) if use_rnnt else \
            beam.hypotheses()[0]["hyp"]
        elapsed = time.time() - t0
        return hyp, {"rtf": elapsed / max(n_frames * 0.01, 1e-6),
                     "n_resets": n_resets, "n_frames": n_frames,
                     "commits": commits}

    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def _rnnt_pred(self, ys, carry):
        """One prediction-network step of ids ys [N] from ``carry`` (None
        = zeros): (pred_out [N, d_pred], new carry)."""
        y = torch.as_tensor(np.asarray(ys, np.int64), device=self.device)
        po, new = self.dec.pred_net(y.view(-1, 1), carry)
        return po[:, 0], new

    def _pred_state(self, prefix: tuple, cache: dict):
        """The prediction network's (output [1, d_pred], carry) after a
        hypothesis prefix, cached by prefix."""
        if prefix not in cache:
            if not prefix:
                cache[prefix] = self._rnnt_pred([EOS], None)
            else:
                _, carry = self._pred_state(prefix[:-1], cache)
                cache[prefix] = self._rnnt_pred([prefix[-1]], carry)
        return cache[prefix]

    def _ensure_states(self, prefixes, cache: dict, kpad: int) -> None:
        """One batched prediction step for the uncached prefixes whose
        parents are cached (at most ``kpad``, the batch padded to it with
        the last one)."""
        missing = [p for p in prefixes
                   if p not in cache and p and p[:-1] in cache]
        if not missing:
            return
        carries = [cache[p[:-1]][1] for p in missing]
        ys = [p[-1] for p in missing]
        while len(carries) < kpad:
            carries.append(carries[-1])
            ys.append(ys[-1])
        carries, ys = carries[:kpad], ys[:kpad]
        batch = [tuple(torch.cat(xs, 0) for xs in zip(*layer))
                 for layer in zip(*carries)]
        po, new = self._rnnt_pred(ys, batch)
        for i, p in enumerate(missing[:kpad]):
            cache[p] = (po[i:i + 1], [(c[i:i + 1], h[i:i + 1])
                                      for c, h in new])

    @torch.inference_mode()
    def _joint_logps(self, et, prefixes, cache: dict, kpad: int
                     ) -> np.ndarray:
        """Log-probs [len(prefixes), V] of the joint at frame et [1, De]
        for every prefix, in one batch padded to ``kpad``."""
        self._ensure_states(prefixes, cache, kpad)
        pts = [self._pred_state(p, cache)[0] for p in prefixes]
        n = len(pts)
        while len(pts) < kpad:
            pts.append(pts[-1])
        pt = torch.cat(pts[:kpad], 0)
        lg = self.dec.joint_step(et.expand(pt.shape[0], -1), pt)
        return torch.log_softmax(lg.float(), -1).cpu().numpy()[:n]

    def transducer_beam_frames(self, e_frames, beam: dict, pred_cache: dict,
                               version: str = "tsd") -> dict:
        """Advance a transducer beam (prefix tuple -> log score, merged in
        log space) over the encoder frames e_frames [T, De] (a tensor on
        the model's device): the time-synchronous search, ``tsd`` (up to
        ``MAX_EXP`` expansions a frame) or ``mono`` (one). Returns the
        updated beam."""
        conf = self.conf
        n_exp = 1 if version == "mono" else MAX_EXP
        kpad = conf.beam_width
        e_frames = torch.as_tensor(e_frames, device=self.device)
        for t in range(e_frames.shape[0]):
            et = e_frames[t:t + 1]
            next_beam: dict = {}
            cur = dict(beam)
            for _ in range(n_exp):
                expansions: dict = {}
                prefixes = list(cur.keys())[:kpad]
                lps = self._joint_logps(et, prefixes, pred_cache, kpad)
                for prefix, lp in zip(prefixes, lps):
                    sc = cur[prefix]
                    # blank: the hypothesis waits for the next frame
                    b_sc = sc + float(lp[BLANK])
                    next_beam[prefix] = np.logaddexp(
                        next_beam.get(prefix, -np.inf), b_sc)
                    for k in np.argsort(lp)[::-1][: conf.beam_width + 1]:
                        k = int(k)
                        if k == BLANK:
                            continue
                        new = prefix + (k,)
                        expansions[new] = np.logaddexp(
                            expansions.get(new, -np.inf), sc + float(lp[k]))
                if not expansions:
                    break
                cur = dict(sorted(expansions.items(),
                                  key=lambda kv: -kv[1])[: conf.beam_width])
                # expanded hypotheses also wait for the next frame
                for p, sc in cur.items():
                    next_beam[p] = np.logaddexp(
                        next_beam.get(p, -np.inf), sc)
            beam = dict(sorted(next_beam.items(),
                               key=lambda kv: -kv[1])[: conf.beam_width])
        return beam

    def decode_transducer_beam(self, xs, xlens):
        """Offline time-synchronous transducer beam search (``tsd``), one
        utterance at a time; the best by score (by score per label with
        ``length_norm``)."""
        eouts = self.encode(xs, xlens)
        e = eouts["ys"]["xs"]
        el = eouts["ys"]["xlens"].cpu().numpy()
        out = []
        for b in range(e.shape[0]):
            beam = self.transducer_beam_frames(
                e[b, :int(el[b])], {(): 0.0}, {})
            if self.conf.length_norm:
                best = max(beam.items(),
                           key=lambda kv: kv[1] / max(len(kv[0]), 1))[0]
            else:
                best = _best_prefix(beam)
            out.append(list(best))
        return out

    @torch.inference_mode()
    def decode_transducer_greedy(self, xs, xlens):
        """Frame-synchronous greedy transducer decoding: at each frame up to
        ``MAX_SYMBOLS`` labels, each the argmax of the joint's logits,
        until blank."""
        eouts = self.encode(xs, xlens)
        e = eouts["ys"]["xs"]
        el = eouts["ys"]["xlens"].cpu().numpy()
        out = []
        for b in range(e.shape[0]):
            hyp: list[int] = []
            pt, carry = self._rnnt_pred([EOS], None)
            for t in range(int(el[b])):
                et = e[b:b + 1, t]
                for _ in range(MAX_SYMBOLS):
                    k = int(self.dec.joint_step(et, pt)[0].argmax())
                    if k == BLANK:
                        break
                    hyp.append(k)
                    pt, carry = self._rnnt_pred([k], carry)
            out.append(hyp)
        return out

    @torch.inference_mode()
    def decode_streaming_attention(self, x_whole):
        """The block-synchronous MoChA beam over a streamed utterance (the
        JAX session's, reference ``beam_search_block_sync``): per encoder
        block, label-synchronous expansion; a hypothesis whose hard
        monotonic attention finds no boundary in the frames seen so far is
        parked with its decoder state rolled back and retried on the next
        block; parked and expanded hypotheses compete for the beam; joint
        CTC prefix scores and LM fusion advance chunk by chunk. The
        encoder frames seen so far stay on the device, zero-padded to a
        multiple of ``T_PAD_BLOCKS`` blocks (64 frames at least). Returns
        (hypothesis ids, stats with each token's boundary frame)."""
        conf = self.conf
        dec: RNNDecoder = self.dec
        beam = conf.beam_width
        enc = self.model.encoder
        total_in, hop_in = enc.block_input_frames()
        _, cnn_ctx_in, _, n_c, _ = enc.stream_geometry()
        factor = enc.subsampling_factor
        t_pad_mult = max(n_c * T_PAD_BLOCKS, 64)
        dev = self.device

        t0 = time.time()
        cache = enc.init_stream_cache(1)
        e_acc: list[torch.Tensor] = []     # encoder frames, on the device
        t_acc = t_pad = 0
        use_ctc = conf.ctc_weight > 0 and self.model.ctc is not None
        ctc_scorer = None
        use_lm = self.lm is not None and conf.lm_weight > 0

        hyps: list[list[int]] = [[] for _ in range(beam)]
        bounds: list[list[int]] = [[] for _ in range(beam)]
        scores = np.full(beam, -1e30, np.float32)
        scores[0] = 0.0
        scores_ctc = np.zeros(beam, np.float32)
        ctc_states = [None] * beam
        lm_states = [self.lm.initial_state(1) if use_lm else None] * beam
        alive = np.zeros(beam, bool)
        alive[0] = True
        y = torch.full((beam,), EOS, dtype=torch.long, device=dev)
        carry = None
        finished: list[dict] = []
        n_frames = 0

        for block, n_new, _ in StreamingDriver(x_whole, total_in, hop_in,
                                               cnn_ctx_in):
            eouts_blk, lp_blk, cache = self._stream_step(block, cache)
            n_out = -(-n_new // factor)
            e_acc.append(eouts_blk[:n_out])
            n_frames += n_new
            if use_ctc:
                lp_new = lp_blk[:n_out]
                if ctc_scorer is None:
                    ctc_scorer = CTCPrefixScorer(lp_new)
                    ctc_states = [ctc_scorer.initial_state() if alive[k]
                                  else None for k in range(beam)]
                else:
                    ctc_scorer.register_new_chunk(lp_new)
                    ctc_states = [
                        ctc_scorer.extend_state(hyps[k], ctc_states[k])
                        if ctc_states[k] is not None else None
                        for k in range(beam)]
            t_acc += n_out

            # the padded frames seen so far; the alpha carry grows with
            # the pad bucket
            new_t_pad = -(-t_acc // t_pad_mult) * t_pad_mult
            e_np = torch.cat(e_acc, 0)
            e_pad = torch.zeros((new_t_pad, e_np.shape[1]), dtype=e_np.dtype,
                                device=dev)
            e_pad[:t_acc] = e_np
            e_t = e_pad[None].expand(beam, -1, -1).contiguous()
            kc = dec.precompute_keys(e_t)
            if carry is None:
                carry = dec.init_carry(beam, new_t_pad, dev, e_t.dtype)
            elif new_t_pad != t_pad:
                carry = (carry[0], torch.nn.functional.pad(
                    carry[1], (0, new_t_pad - t_pad)), carry[2])
            t_pad = new_t_pad
            mask = make_pad_mask(torch.full((beam,), t_acc, device=dev),
                                 t_pad)

            max_tokens = max(int(t_acc * conf.max_len_ratio), 2)
            parked = ~alive.copy()
            while not parked.all():
                carry_post, logits, aw = dec.step.mocha_step(
                    carry, y, kc, mask)
                alpha = aw.float().cpu().numpy()      # [beam, H, T] one-hot
                fired = alpha.sum(axis=(1, 2)) > 0
                under_cap = np.asarray([len(h) < max_tokens for h in hyps])
                expand = alive & ~parked & fired & under_cap
                parked |= ~fired | ~under_cap         # no boundary: wait
                if not expand.any():
                    break
                logp = torch.log_softmax(
                    conf.softmax_smoothing * logits.float(), -1).cpu().numpy()
                vocab = logp.shape[-1]
                lm_logp = np.zeros_like(logp)
                new_lm_states = lm_states
                if use_lm:
                    new_lm_states = list(lm_states)
                    for k in np.where(expand)[0]:
                        lp_k, st = self.lm.predict(
                            np.asarray([hyps[k][-1] if hyps[k] else EOS],
                                       np.int32), lm_states[k])
                        lm_logp[k] = np.asarray(lp_k[0])
                        new_lm_states[k] = st

                total = scores[:, None] + logp + conf.lm_weight * lm_logp
                best_non_eos = np.max(np.delete(logp, EOS, axis=1), axis=1)
                bad_eos = logp[:, EOS] < conf.eos_threshold * best_non_eos
                if len(max(hyps, key=len)) < int(t_acc * conf.min_len_ratio):
                    bad_eos[:] = True
                total[bad_eos, EOS] = -1e30

                new_ctc = None
                if use_ctc and ctc_scorer is not None:
                    ctc_cand = min(beam * 4, vocab)
                    tot2 = np.full_like(total, -1e30)
                    new_ctc = [[None] * vocab for _ in range(beam)]
                    for k in np.where(expand)[0]:
                        cands = np.argsort(logp[k])[::-1][:ctc_cand]
                        psi, r_new = ctc_scorer(hyps[k], cands, ctc_states[k])
                        tot2[k, cands] = (
                            scores[k]
                            + (1 - conf.ctc_weight) * logp[k, cands]
                            + conf.ctc_weight * (psi - scores_ctc[k])
                            + conf.lm_weight * lm_logp[k, cands])
                        for ci, c in enumerate(cands):
                            new_ctc[k][c] = (r_new[ci], float(psi[ci]))
                        tot2[k, EOS] = -1e30 if bad_eos[k] else tot2[k, EOS]
                    total = tot2
                total[~expand, :] = -1e30

                # the candidate pool: parked survivors keep their scores
                cands = [("keep", int(k), -1, float(scores[k]))
                         for k in np.where(alive & parked)[0]]
                flat = total.reshape(-1)
                n_take = beam * 2
                top = np.argpartition(-flat, min(n_take, flat.size - 1))[
                    :n_take]
                top = top[np.argsort(-flat[top])]
                for idx in top:
                    k, v = divmod(int(idx), vocab)
                    sc = float(flat[idx])
                    if sc <= -1e29:
                        continue
                    cands.append(("exp", k, v, sc))
                cands.sort(key=lambda c: -c[3])

                sel, par, take_post, new_y = [], [], [], []
                n_hyps, n_bounds = [], []
                n_scores, n_sctc, n_cstates, n_lmst, n_alive = \
                    [], [], [], [], []
                for kind, k, v, sc in cands:
                    if kind == "exp" and v == EOS:
                        n_tok = len(hyps[k]) + 1
                        fsc = sc / max(n_tok, 1) if conf.length_norm else \
                            sc + conf.length_penalty * n_tok
                        finished.append(
                            {"hyp": hyps[k] + [EOS], "score": fsc,
                             "bounds": list(bounds[k])})
                        continue
                    if len(sel) == beam:
                        continue
                    sel.append(kind)
                    par.append(k)
                    take_post.append(kind == "exp")
                    if kind == "keep":
                        new_y.append(hyps[k][-1] if hyps[k] else EOS)
                        n_hyps.append(hyps[k])
                        n_bounds.append(bounds[k])
                        n_scores.append(scores[k])
                        n_sctc.append(scores_ctc[k])
                        n_cstates.append(ctc_states[k])
                        n_lmst.append(lm_states[k])
                        n_alive.append(True)
                    else:
                        t_bd = int(np.argmax(alpha[k].mean(0)))
                        new_y.append(v)
                        n_hyps.append(hyps[k] + [v])
                        n_bounds.append(bounds[k] + [t_bd])
                        n_scores.append(sc)
                        if new_ctc is not None and \
                                new_ctc[k][v] is not None:
                            n_cstates.append(new_ctc[k][v][0])
                            n_sctc.append(new_ctc[k][v][1])
                        else:
                            n_cstates.append(ctc_states[k])
                            n_sctc.append(scores_ctc[k])
                        n_lmst.append(new_lm_states[k] if use_lm else None)
                        n_alive.append(True)
                if not any(x == "exp" for x in sel):
                    break
                while len(sel) < beam:   # dead padding rows
                    sel.append("keep")
                    par.append(par[-1] if par else 0)
                    take_post.append(False)
                    new_y.append(EOS)
                    n_hyps.append([])
                    n_bounds.append([])
                    n_scores.append(-1e30)
                    n_sctc.append(0.0)
                    n_cstates.append(ctc_states[0])
                    n_lmst.append(lm_states[0])
                    n_alive.append(False)

                carry = _mix_carry(carry, carry_post,
                                   torch.as_tensor(par, device=dev),
                                   torch.as_tensor(take_post, device=dev))
                hyps, bounds = n_hyps, n_bounds
                scores = np.asarray(n_scores, np.float32)
                scores_ctc = np.asarray(n_sctc, np.float32)
                ctc_states, lm_states = n_cstates, n_lmst
                alive = np.asarray(n_alive)
                parked = np.asarray([x == "keep" for x in sel]) | ~alive
                y = torch.as_tensor(new_y, dtype=torch.long, device=dev)
                if len(finished) >= beam * 2:
                    parked[:] = True
            # the next block: every surviving hypothesis may retry

        for k in np.where(alive)[0]:     # force-finish at the stream's end
            sc = float(scores[k])
            n_tok = len(hyps[k]) + 1
            fsc = sc / max(n_tok, 1) if conf.length_norm else \
                sc + conf.length_penalty * n_tok
            finished.append({"hyp": hyps[k] + [EOS], "score": fsc,
                             "bounds": list(bounds[k])})
        if not finished:
            finished = [{"hyp": [EOS], "score": 0.0, "bounds": []}]
        finished.sort(key=lambda d: -d["score"])
        best = finished[0]
        elapsed = time.time() - t0
        stats = {"rtf": elapsed / max(n_frames * 0.01, 1e-6),
                 "n_resets": 0, "n_frames": n_frames,
                 "boundaries": best["bounds"], "n_out_frames": t_acc}
        return [t for t in best["hyp"] if t != EOS], stats


def _best_prefix(beam: dict) -> tuple:
    """The highest-scoring prefix of a transducer beam."""
    return max(beam.items(), key=lambda kv: kv[1])[0]


def _mix_carry(pre, post, par: torch.Tensor, take_post: torch.Tensor):
    """Each leaf of a decode carry: row k from ``post`` (the expanded
    step's) where take_post[k], else from ``pre`` (rolled back), both
    from parent row par[k]."""
    if isinstance(pre, (tuple, list)):
        return type(pre)(_mix_carry(a, b, par, take_post)
                         for a, b in zip(pre, post))
    m = take_post.view((-1,) + (1,) * (pre.ndim - 1))
    return torch.where(m, post[par], pre[par])
