"""Character <-> id converters (counterpart of
``neural_sp_tpu/datasets/token_converter/character.py``).

Dictionary file: one ``<token> <id>`` per line; ids 0-3 are reserved
(blank, unk, eos, pad).
"""
from __future__ import annotations

import codecs


def load_dict(dict_path: str) -> dict[str, int]:
    token2idx = {"<blank>": 0, "<unk>": 1, "<eos>": 2, "<pad>": 3}
    with codecs.open(dict_path, "r", "utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            tok, idx = line.rstrip("\n").split(" ")
            token2idx[tok] = int(idx)
    return token2idx


class Char2idx:
    def __init__(self, dict_path: str, nlsyms: list[str] | None = None,
                 remove_space: bool = False):
        self.token2idx = load_dict(dict_path)
        self.nlsyms = nlsyms or []
        self.remove_space = remove_space

    def __call__(self, text: str) -> list[int]:
        unk = self.token2idx["<unk>"]
        ids = []
        words = text.split(" ")
        for i, w in enumerate(words):
            if w in self.nlsyms:
                ids.append(self.token2idx.get(w, unk))
            else:
                ids.extend(self.token2idx.get(c, unk) for c in w)
            if i < len(words) - 1 and not self.remove_space:
                ids.append(self.token2idx.get("<space>", unk))
        return ids


class Idx2char:
    def __init__(self, dict_path: str):
        self.idx2token = {v: k for k, v in load_dict(dict_path).items()}

    def __call__(self, ids, return_list: bool = False):
        toks = [self.idx2token.get(int(i), "<unk>") for i in ids]
        if return_list:
            return toks
        return "".join(toks).replace("<space>", " ")
