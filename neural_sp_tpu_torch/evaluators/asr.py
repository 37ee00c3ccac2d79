"""ASR evaluation over a loader (counterpart of ``eval_unit`` in
``neural_sp_tpu/evaluators/asr.py``): decode each batch, turn ids into
text, and count corpus WER and CER with their S / I / D, writing
``ref.trn`` and ``hyp.trn`` as the JAX evaluator does, and the real-time
factor (decode wall over 10 ms per input frame).

``eval_streaming`` decodes each utterance block by block through
``Speech2TextSession.decode_streaming``: WER, RTF, the quantity rate and,
for the MoChA beam, streamability and the last-success-frame ratio (the
JAX evaluator's, copied as it is).

``eval_word``, ``eval_char`` and ``eval_wordpiece`` are the JAX
evaluator's wrappers; ``eval_word(resolving_unk=True)`` recovers each
``<unk>`` word of the beam's best hypothesis from the char sub1 CTC
head's best path (``resolve_unk_text``, copied as it is), between the
midpoints of the neighbouring words' attention peaks. As JAX's, it
compares the main decoder's peaks (encoder frames) with the sub1 head's
emission frames (its tap's frames) as they are, whatever the two rates
(ROADMAP C46).

The oracle WER, the WER by length and TIMIT phone mapping are not ported
(ROADMAP).
"""
from __future__ import annotations

import codecs
import os
import time

import numpy as np

from .. import UNK
from ..models.decoders.ctc import best_path_frames
from .edit_distance import compute_wer


def eval_unit(session, loader, save_dir: str | None = None,
              phone_map: str | None = None) -> dict:
    """{wer, cer, n_sub, n_ins, n_del, rtf, n_utts} of ``session`` on
    ``loader``'s utterances."""
    if phone_map:
        raise NotImplementedError(
            "phone mapping is not ported yet, see ROADMAP")
    idx2token = loader.idx2token
    n_w_err = n_w_tok = n_sub = n_ins = n_del = 0
    cer_num = cer_den = n_utts = n_frames = 0
    ref_f = hyp_f = None
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        ref_f = codecs.open(os.path.join(save_dir, "ref.trn"), "w", "utf-8")
        hyp_f = codecs.open(os.path.join(save_dir, "hyp.trn"), "w", "utf-8")
    decode_s = 0.0
    try:
        for batch in loader:
            t0 = time.time()
            hyps = session.decode(batch["xs"], batch["xlens"])
            decode_s += time.time() - t0
            n_frames += int(np.sum(batch["xlens"]))
            for b, utt_id in enumerate(batch["utt_ids"]):
                spk, ref_text = batch["speakers"][b], batch["text"][b]
                hyp_text = idx2token(hyps[b])
                if ref_f:
                    ref_f.write(f"{ref_text} ({spk}-{utt_id})\n")
                    hyp_f.write(f"{hyp_text} ({spk}-{utt_id})\n")
                ref_toks = ref_text.split()
                _, s, i, d = compute_wer(ref_toks, hyp_text.split())
                n_w_err += s + i + d
                n_w_tok += len(ref_toks)
                n_sub += s
                n_ins += i
                n_del += d
                r = ref_text.replace(" ", "")
                _, cs, ci, cd = compute_wer(list(r),
                                            list(hyp_text.replace(" ", "")))
                cer_num += cs + ci + cd
                cer_den += len(r)
                n_utts += 1
    finally:
        if ref_f:
            ref_f.close()
            hyp_f.close()
    return {
        "wer": 100.0 * n_w_err / max(n_w_tok, 1),
        "cer": 100.0 * cer_num / max(cer_den, 1),
        "n_sub": n_sub, "n_ins": n_ins, "n_del": n_del,
        "rtf": decode_s / max(n_frames * 0.01, 1e-6),
        "n_utts": n_utts,
    }


def eval_streaming(session, loader, save_dir: str | None = None) -> dict:
    """Streaming decode evaluation: WER + RTF + quantity rate +
    streamability diagnostics (reference wordpiece.py:155-208 +
    las.py:1386-1435): ``streamability`` is the fraction of utterances
    whose every token boundary fired before the final encoder frame
    arrived; ``last_success_frame_ratio`` is the mean position of the last
    emitted boundary relative to the utterance end. With ``save_dir`` it
    writes ``ref.trn`` and ``hyp.trn`` there, as ``eval_unit``."""
    idx2token = loader.idx2token
    n_err = n_tok = n_hyp_tok = 0
    rtfs = []
    n_resets_total = 0
    n_utts = 0
    n_streamable = 0
    lsf_ratios = []
    has_diag = False
    ref_f = hyp_f = None
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        ref_f = codecs.open(os.path.join(save_dir, "ref.trn"), "w", "utf-8")
        hyp_f = codecs.open(os.path.join(save_dir, "hyp.trn"), "w", "utf-8")
    try:
        for batch in loader:
            for b, utt_id in enumerate(batch["utt_ids"]):
                feats = batch["xs"][b][: batch["xlens"][b]]
                hyp_ids, stats = session.decode_streaming(feats)
                ref_text = batch["text"][b]
                hyp_text = idx2token(hyp_ids)
                if ref_f:
                    spk = batch["speakers"][b]
                    ref_f.write(f"{ref_text} ({spk}-{utt_id})\n")
                    hyp_f.write(f"{hyp_text} ({spk}-{utt_id})\n")
                ref = ref_text.split()
                _, s, i, d = compute_wer(ref, hyp_text.split())
                n_err += s + i + d
                n_tok += len(ref)
                n_hyp_tok += len(hyp_ids)
                rtfs.append(stats["rtf"])
                n_resets_total += stats["n_resets"]
                bounds = stats.get("boundaries")
                t_out = stats.get("n_out_frames", 0)
                if bounds is not None:
                    has_diag = True
                    if bounds and t_out:
                        lsf_ratios.append(bounds[-1] / max(t_out, 1))
                        if bounds[-1] < t_out - 1:
                            n_streamable += 1
                    # an utterance with NO boundaries is non-streamable
                n_utts += 1
    finally:
        if ref_f:
            ref_f.close()
            hyp_f.close()
    out = {"wer": 100.0 * n_err / max(n_tok, 1),
           "rtf": float(sum(rtfs) / max(len(rtfs), 1)),
           "quantity_rate": n_hyp_tok / max(n_tok, 1),
           "n_resets": n_resets_total, "n_utts": n_utts}
    if has_diag:
        out["streamability"] = n_streamable / max(n_utts, 1)
        if lsf_ratios:
            out["last_success_frame_ratio"] = float(
                sum(lsf_ratios) / len(lsf_ratios))
    return out


def eval_wordpiece(session, loader, save_dir: str | None = None) -> dict:
    return eval_unit(session, loader, save_dir)


def eval_char(session, loader, save_dir: str | None = None) -> dict:
    return eval_unit(session, loader, save_dir)


def resolve_unk_text(hyp_ids, peaks, idx2word, char_path, char_frames,
                     idx2char, unk_id: int = UNK) -> str:
    """Replace ``<unk>`` word tokens with character substrings recovered
    from the char-level CTC path, aligned by attention-peak frames
    (reference ``evaluators/resolving_unk.py`` + word.py wiring).

    char_path/char_frames: collapsed char ids and their first-emission
    frames. Each <unk> at word position i takes the chars whose frames lie
    between the midpoints to the neighbouring words' peaks.
    """
    words = idx2word(hyp_ids).split()
    if len(words) != len(hyp_ids):
        # idx2word may merge; fall back to per-id conversion
        words = [idx2word([t]) for t in hyp_ids]
    out = []
    for i, (tok, w) in enumerate(zip(hyp_ids, words)):
        if tok != unk_id or not peaks:
            out.append(w)
            continue
        peak = peaks[min(i, len(peaks) - 1)]
        lo = (peaks[i - 1] + peak) / 2 if i > 0 else -1
        hi = (peak + peaks[i + 1]) / 2 if i + 1 < len(peaks) else 10**9
        chars = [idx2char([c]) for c, f in zip(char_path, char_frames)
                 if lo < f <= hi]
        repl = "".join(chars).replace(" ", "")
        out.append(repl if repl else w)
    return " ".join(out)


def eval_word(session, loader, save_dir: str | None = None,
              resolving_unk: bool = False, sub1_loader=None) -> dict:
    """Word-level WER (``eval_unit``'s dict); with ``resolving_unk``,
    {wer, n_utts} with each ``<unk>`` of the LAS beam's best hypothesis
    recovered from the char sub1 CTC head (``resolve_unk_text``), as the
    JAX evaluator: the sub1 head's log-probabilities on its tap's outputs
    (the main outputs when the encoder has no tap), its best path and
    first-emission frames (``best_path_frames``) against the beam's
    attention peaks. The char converter is the loader's
    ``idx2token_sub1`` (``dict_sub1``), else ``sub1_loader``'s."""
    if not resolving_unk:
        return eval_unit(session, loader, save_dir)
    import torch
    idx2word = loader.idx2token
    src = sub1_loader or loader
    idx2char = src.dataset.idx2token_sub1 \
        if getattr(src.dataset, "idx2token_sub1", None) \
        else (sub1_loader.idx2token if sub1_loader else None)
    if idx2char is None:
        raise ValueError("resolving_unk needs a char-level converter "
                         "(dict_sub1 or sub1_loader)")
    if session.model.ctc_sub1 is None:
        raise ValueError("resolving_unk needs a char-level CTC sub1 head")
    n_err = n_tok = n_utts = 0
    for batch in loader:
        eouts_all = session.encode(batch["xs"], batch["xlens"])
        key = "ys_sub1" if "ys_sub1" in eouts_all else "ys"
        with torch.inference_mode():
            lp_sub = session.model.ctc_sub1.log_probs(
                eouts_all[key]["xs"]).cpu().numpy()
        el_sub = eouts_all[key]["xlens"].cpu().numpy()
        for b in range(len(batch["utt_ids"])):
            e = eouts_all["ys"]["xs"][b:b + 1]
            el = eouts_all["ys"]["xlens"][b:b + 1]
            best, _ = session._beam_one(e, el)
            peaks = session._last_nbest_peaks[0]
            char_path, char_frames = best_path_frames(
                lp_sub[b][: el_sub[b]])
            hyp_text = resolve_unk_text(best, peaks, idx2word, char_path,
                                        char_frames, idx2char)
            ref = batch["text"][b].split()
            _, s, i, d = compute_wer(ref, hyp_text.split())
            n_err += s + i + d
            n_tok += len(ref)
            n_utts += 1
    return {"wer": 100.0 * n_err / max(n_tok, 1), "n_utts": n_utts}
