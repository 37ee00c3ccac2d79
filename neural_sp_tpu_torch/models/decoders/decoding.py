"""Decoding session: greedy and beam search over the LAS decoder
(counterpart of ``neural_sp_tpu/models/decoders/decoding.py``).

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

Not ported yet (ROADMAP), and raising ``NotImplementedError``: ensembles,
forward-backward merging, speaker state carry-over, CTC prefix beam
search (with its LM hook), transducer and transformer decoders.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ... import EOS, PAD
from .ctc import CTCPrefixScorer, ctc_greedy
from .las import RNNDecoder


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
            _, nbest = self._beam_one_las(e, el)
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
    def _beam_one_las(self, e, el):
        """Beam search of one utterance e [1, T, d], el [1]. Returns
        (best hypothesis, n-best list); the n-best's scores are kept in
        ``_last_nbest_scores`` (joint) and ``_last_nbest_scores_att``."""
        conf = self.conf
        dec: RNNDecoder = self.dec
        beam = conf.beam_width
        tmax = e.shape[1]
        max_len = max(int(int(el[0]) * conf.max_len_ratio), 2)
        min_len = int(int(el[0]) * conf.min_len_ratio)

        e_t = e.repeat_interleave(beam, dim=0)
        klens = el.repeat_interleave(beam).to(torch.int32)
        kc = dec.precompute_keys(e_t)
        loop = dec.decode_loop(kc, e_t, klens)
        par = None
        # internal-LM estimation: a second decode loop over zeroed keys and
        # encoder outputs (so a zero context) with the real lengths, stepped
        # with the same tokens and parents
        use_ilm = conf.ilm_weight > 0
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
        scores = np.full(beam, -1e30, np.float32)
        scores[0] = 0.0
        scores_att = np.zeros(beam, np.float32)  # cumulative att (raw)
        scores_ctc = np.zeros(beam, np.float32)
        scores_ilm = np.zeros(beam, np.float32)  # cumulative internal-LM
        scores_lm = np.zeros(beam, np.float32)
        aw_sums = np.zeros((beam, tmax), np.float32)
        y = torch.full((beam,), EOS, dtype=torch.long, device=e.device)
        finished: list[dict] = []

        for step_i in range(max_len):
            logits, aw = loop.step(y, par)
            logp = torch.log_softmax(
                conf.softmax_smoothing * logits.float(), -1).cpu().numpy()
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
            for k in range(beam):
                if scores[k] <= -1e29:
                    continue
                cands = np.argsort(-logp_eff[k], kind="stable")[:beam]
                # total = att (1 - w) - ilm w_ilm (1 - w) + lm w_lm
                base = ((1.0 - w_ctc) * (scores_att[k] + logp[k, cands])
                        - (1.0 - w_ctc) * conf.ilm_weight
                        * (scores_ilm[k] + ilm_logp[k, cands])
                        + conf.lm_weight * (scores_lm[k] + lm_logp[k, cands]))
                if conf.length_penalty != 0:
                    base = base + conf.length_penalty * (step_i + 1)
                if ctc_scorer is not None:
                    psi, r_new = ctc_scorer(hyps[k], cands, ctc_states[k])
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
            children = children[:beam]
            new_hyps, new_scores, new_satt, new_y, parents = [], [], [], [], []
            new_silm, new_slm, new_ctc_beam = [], [], []
            for ch in children:
                k, v, sc = ch["parent"], ch["tok"], ch["score"]
                if v == EOS:
                    cand = {"hyp": hyps[k] + [EOS], "score": sc,
                            "score_att": float(ch["att"])}
                    if conf.coverage_penalty > 0:
                        cov = np.sum(np.minimum(
                            aw_sums[k], conf.coverage_threshold or 0.5))
                        cand["score"] += conf.coverage_penalty * cov
                    finished.append(cand)
                    continue
                new_hyps.append(hyps[k] + [v])
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
            if conf.coverage_penalty > 0:
                aw_np = aw.float().cpu().numpy()
                if aw_np.ndim == 3:       # MoChA: [beam, H, T] -> head mean
                    aw_np = aw_np.mean(1)
                aw_sums = aw_sums[parents] + aw_np[parents]
            hyps = new_hyps
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
                     "score_att": float(scores_att[i])}
                    for i in range(len(hyps)) if scores[i] > -1e29]
            finished.extend(live[: beam - len(finished)])
        finished.sort(key=lambda d: -d["score"])
        top = finished[: conf.n_best]
        nbest = [[t for t in f["hyp"] if t != EOS] for f in top]
        self._last_nbest_scores = [float(f["score"]) for f in top]
        self._last_nbest_scores_att = [float(f["score_att"]) for f in top]
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
        if self.conf.beam_width <= 1:
            return self.decode_attention_greedy(xs, xlens)
        conf = self.conf
        fusion_free = (conf.lm_weight == 0 and conf.ctc_weight == 0
                       and conf.ilm_weight == 0 and self.lm_second is None
                       and self.lm_bwd is None
                       and conf.coverage_penalty == 0)
        if conf.device_beam and fusion_free:
            return self.decode_attention_beam_device(xs, xlens)
        return self.decode_attention_beam(xs, xlens)
