"""ASR evaluation over a loader (counterpart of ``eval_unit`` in
``neural_sp_tpu/evaluators/asr.py``): decode each batch, turn ids into
text, and count corpus WER and CER with their S / I / D, writing
``ref.trn`` and ``hyp.trn`` as the JAX evaluator does, and the real-time
factor (decode wall over 10 ms per input frame).

The oracle WER, the WER by length, streaming evaluation and TIMIT phone
mapping are not ported (ROADMAP).
"""
from __future__ import annotations

import codecs
import os
import time

import numpy as np

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
