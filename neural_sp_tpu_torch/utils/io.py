"""Feature readers (counterpart of the readers in
``neural_sp_tpu/utils/io.py``): ``.npy``, ``.npz:key`` and binary Kaldi
matrices (``path:offset``), parsed without kaldiio. Audio inputs
(``.wav``, ``.flac``, ``.sph``) raise until the audio front end is
ported (ROADMAP).
"""
from __future__ import annotations

import struct

import numpy as np

_AUDIO = (".wav", ".flac", ".sph")


def _read_kaldi_token(f) -> str:
    tok = b""
    while True:
        c = f.read(1)
        if c in (b" ", b""):
            break
        tok += c
    return tok.decode()


def read_kaldi_matrix(path_with_offset: str) -> np.ndarray:
    """One matrix (binary FM / DM) or vector (FV / DV) from ``path`` or
    ``path:offset``, as float32."""
    if ":" in path_with_offset and \
            path_with_offset.rsplit(":", 1)[1].isdigit():
        path, off = path_with_offset.rsplit(":", 1)
        offset = int(off)
    else:
        path, offset = path_with_offset, 0
    with open(path, "rb") as f:
        f.seek(offset)
        if offset == 0:
            # an ark may start with "key <binary>": skip the key
            first = f.read(1)
            f.seek(0)
            if first != b"\0":
                _read_kaldi_token(f)
        if f.read(2) != b"\0B":
            raise ValueError(f"non-binary kaldi data at {path_with_offset}")
        typ = _read_kaldi_token(f)
        if typ not in ("FM", "DM", "FV", "DV"):
            raise ValueError(
                f"unsupported kaldi matrix type {typ!r} (compressed CM not "
                f"supported; re-dump as npy)")
        dt = np.float32 if typ[0] == "F" else np.float64
        shape = []
        for _ in range(2 if typ[1] == "M" else 1):
            if f.read(1) != b"\x04":
                raise ValueError(f"bad kaldi size field at {path_with_offset}")
            shape.append(struct.unpack("<i", f.read(4))[0])
        n = int(np.prod(shape))
        data = np.frombuffer(f.read(n * np.dtype(dt).itemsize), dt)
        return data.reshape(shape).astype(np.float32)


def load_feat(feat_path: str) -> np.ndarray:
    """Dispatch on the path: .npy | .npz:key | kaldi 'path:offset'."""
    if feat_path.endswith(".npy"):
        return np.load(feat_path)
    if ".npz:" in feat_path:
        path, key = feat_path.rsplit(":", 1)
        with np.load(path) as z:
            return z[key]
    if feat_path.lower().endswith(_AUDIO):
        raise NotImplementedError(
            f"{feat_path}: audio input needs the audio front end, which is "
            f"not ported yet, see ROADMAP")
    return read_kaldi_matrix(feat_path)
