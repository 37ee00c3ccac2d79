"""Wordpiece tokenization with the dependency-free BPE model (counterpart
of ``neural_sp_tpu/datasets/token_converter/wordpiece.py``).

"▁" (U+2581) marks a word's start; decoding joins the pieces and maps "▁"
to a space. A model is a JSON file (vocab and ordered merges) that
``train_bpe`` writes. A SentencePiece ``.model`` file raises until the
JAX package's ``spm_model.py`` is ported (ROADMAP).
"""
from __future__ import annotations

import codecs
import json
import os
from collections import Counter

from .character import load_dict

WORD_BOUNDARY = "▁"

_SPECIALS = ["<blank>", "<unk>", "<eos>", "<pad>"]


def train_bpe(sentences, vocab_size: int, model_path: str,
              character_coverage: float = 1.0) -> dict:
    """Train a BPE model over an iterable of sentences and write it as
    JSON. Vocab: ids 0-3 specials, then the single characters, then the
    merged pieces in merge order (deterministic: the most frequent pair,
    ties broken by the larger pair)."""
    word_freq: Counter = Counter()
    for s in sentences:
        for w in s.strip().split():
            word_freq[WORD_BOUNDARY + w] += 1

    char_freq: Counter = Counter()
    for w, f in word_freq.items():
        for c in w:
            char_freq[c] += f
    chars = [c for c, _ in char_freq.most_common()]
    if character_coverage < 1.0:
        chars = chars[: max(int(len(chars) * character_coverage), 1)]
    charset = set(chars)

    # rare characters drop out here and become <unk> when encoding
    words = {w: [c for c in w if c in charset] for w in word_freq}
    merges: list[tuple[str, str]] = []
    vocab = list(_SPECIALS) + sorted(charset)
    max_merges = max(vocab_size - len(vocab), 0)

    pair_freq: Counter = Counter()
    for w, syms in words.items():
        f = word_freq[w]
        for a, b in zip(syms, syms[1:]):
            pair_freq[(a, b)] += f

    for _ in range(max_merges):
        if not pair_freq:
            break
        (a, b), best_f = max(pair_freq.items(),
                             key=lambda kv: (kv[1], kv[0]))
        if best_f < 2:
            break
        merges.append((a, b))
        new_sym = a + b
        vocab.append(new_sym)
        for w, syms in words.items():
            if a not in syms:
                continue
            f = word_freq[w]
            i, out = 0, []
            changed = False
            while i < len(syms):
                if i + 1 < len(syms) and syms[i] == a and syms[i + 1] == b:
                    out.append(new_sym)
                    i += 2
                    changed = True
                else:
                    out.append(syms[i])
                    i += 1
            if changed:
                for x, y in zip(syms, syms[1:]):
                    pair_freq[(x, y)] -= f
                    if pair_freq[(x, y)] <= 0:
                        del pair_freq[(x, y)]
                for x, y in zip(out, out[1:]):
                    pair_freq[(x, y)] += f
                words[w] = out
        if len(vocab) >= vocab_size:
            break

    model = {"type": "bpe", "vocab": vocab,
             "merges": [[a, b] for a, b in merges]}
    os.makedirs(os.path.dirname(os.path.abspath(model_path)), exist_ok=True)
    with codecs.open(model_path, "w", "utf-8") as f:
        json.dump(model, f, ensure_ascii=False)
    return model


class BPEModel:
    def __init__(self, model_path: str):
        with codecs.open(model_path, "r", "utf-8") as f:
            model = json.load(f)
        self.vocab = model["vocab"]
        self.piece2id = {p: i for i, p in enumerate(self.vocab)}
        self.rank = {tuple(m): r for r, m in enumerate(model["merges"])}

    def encode_word(self, word: str) -> list[str]:
        syms = [c if c in self.piece2id else "<unk>"
                for c in WORD_BOUNDARY + word]
        while len(syms) > 1:
            best, best_rank = None, None
            for i, pair in enumerate(zip(syms, syms[1:])):
                r = self.rank.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            syms = syms[:best] + [syms[best] + syms[best + 1]] + \
                syms[best + 2:]
        return syms

    def encode(self, text: str) -> list[str]:
        out = []
        for w in text.strip().split():
            out.extend(self.encode_word(w))
        return out

    def decode_pieces(self, pieces) -> str:
        return "".join(pieces).replace(WORD_BOUNDARY, " ").strip()


def _bpe_model(wp_model: str) -> BPEModel:
    if wp_model.endswith(".model") and not wp_model.endswith(".json.model"):
        raise NotImplementedError(
            f"{wp_model}: SentencePiece models are not ported yet (the JSON "
            f"BPE model of train_bpe is), see ROADMAP")
    return BPEModel(wp_model)


class Wp2idx:
    """Text -> wordpiece ids; a dictionary file, when given, maps the
    pieces to ids (the reference's dict.txt), else the model's vocab does."""

    def __init__(self, dict_path: str | None, wp_model: str):
        self._bpe = _bpe_model(wp_model)
        self.token2idx = load_dict(dict_path) if dict_path else None

    def __call__(self, text: str) -> list[int]:
        pieces = self._bpe.encode(text)
        if self.token2idx is not None:
            return [self.token2idx.get(p, self.token2idx["<unk>"])
                    for p in pieces]
        return [self._bpe.piece2id.get(p, 1) for p in pieces]


class Idx2wp:
    def __init__(self, dict_path: str | None, wp_model: str):
        self._bpe = _bpe_model(wp_model)
        self.idx2token = (
            {v: k for k, v in load_dict(dict_path).items()} if dict_path
            else dict(enumerate(self._bpe.vocab)))

    def __call__(self, ids, return_list: bool = False):
        pieces = [self.idx2token.get(int(i), "<unk>") for i in ids]
        if return_list:
            return pieces
        return "".join(pieces).replace(WORD_BOUNDARY, " ").strip()
