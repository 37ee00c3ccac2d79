"""Word <-> id converters (counterpart of
``neural_sp_tpu/datasets/token_converter/word.py``)."""
from __future__ import annotations

from .character import load_dict


class Word2idx:
    def __init__(self, dict_path: str, word_char_mix: bool = False):
        self.token2idx = load_dict(dict_path)
        self.word_char_mix = word_char_mix

    def __call__(self, text: str) -> list[int]:
        unk = self.token2idx["<unk>"]
        ids = []
        for w in text.split(" "):
            if not w:
                continue
            if w in self.token2idx:
                ids.append(self.token2idx[w])
            elif self.word_char_mix:
                ids.extend(self.token2idx.get(c, unk) for c in w)
            else:
                ids.append(unk)
        return ids


class Idx2word:
    def __init__(self, dict_path: str):
        self.idx2token = {v: k for k, v in load_dict(dict_path).items()}

    def __call__(self, ids, return_list: bool = False):
        toks = [self.idx2token.get(int(i), "<unk>") for i in ids]
        if return_list:
            return toks
        return " ".join(toks)
