"""Build the port's CUDA kernels into one shared library and load it.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a`` (the
H100), all of them at once, and the objects are linked into
``build/libnsp_kernels_<hash>.so`` beside this file, on first use in a
process; the hash covers the sources, the headers (``csrc/*.cuh``) and the
flags, so an edited source is rebuilt and an unchanged one is loaded as it
is. The library has a plain C interface (no PyTorch headers, so a build
takes seconds) and is bound with ``ctypes``: pointers are
``tensor.data_ptr()``, the stream is the current CUDA stream's raw handle,
both passed as ``c_void_p``.

Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# a dropout of the attention probabilities: its rate and two key words
_DROP = [ctypes.c_float, ctypes.c_uint, ctypes.c_uint]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels need "
            "the CUDA toolkit")
    return str(path)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; raise if one fails. Returns their output,
    standard error included."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


@functools.cache
def build_library() -> tuple[Path, str]:
    """Compile the kernels if needed. Returns (path of the .so, nvcc's
    output: ``-Xptxas -v`` register and shared-memory use per kernel, or
    "" when the library was already built)."""
    sources = _sources()
    lib = BUILD_DIR / f"libnsp_kernels_{_digest(sources + _headers())}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources]
        out = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                        for src, obj in zip(sources, objs)])
        _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", f"{tmp}/lib.so",
                   *objs]])
        # atomic: a reader never sees half a library
        os.replace(f"{tmp}/lib.so", lib)
    return lib, out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument and result types declared."""
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    entry_points = {
        "nsp_rel_attention_f32": [_P] * 9 + [_I] * 10 + _DROP + [_P],
        "nsp_rel_attention_bwd_f32": [_P] * 15 + [_I] * 9 + _DROP + [_P],
        "nsp_rel_attention_bf16": [_P] * 8 + [_I] * 10 + _DROP + [_P],
        "nsp_rel_attention_bwd_bf16": [_P] * 15 + [_I] * 9 + _DROP + [_P],
        "nsp_las_step_f32": [_P] * 27 + [_I] * 8 + [_P],
        "nsp_las_step_plan_f32": [_P, _I, _I, _P, _P, _P, _P],
        "nsp_las_scan_f32": [_P] * 29 + [_I] * 10 + [_P],
        "nsp_las_scan_bwd_f32": [_P] * 36 + [_I] * 10 + [_P],
        "nsp_ctc_alpha_f32": [_P] * 6 + [_I] * 4 + [_P],
        "nsp_ctc_beta_grad_f32": [_P] * 8 + [_I] * 4 + [_P],
        "nsp_rnnt_alpha_f32": [_P] * 6 + [_I] * 3 + [_P],
        "nsp_rnnt_beta_grad_f32": [_P] * 8 + [_I] * 3 + [_P],
    }
    for name, argtypes in entry_points.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    lib.nsp_las_step_smem_bytes.argtypes = [_I] * 6
    lib.nsp_las_step_smem_bytes.restype = ctypes.c_longlong
    lib.nsp_las_step_scratch_floats.argtypes = [_I] * 5
    lib.nsp_las_step_scratch_floats.restype = ctypes.c_longlong
    lib.nsp_las_scan_bwd_smem_bytes.argtypes = [_I] * 5
    lib.nsp_las_scan_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.nsp_las_scan_bwd_parts.argtypes = [_I]
    lib.nsp_las_scan_bwd_parts.restype = _I
    lib.nsp_ctc_max_labels.argtypes = []
    lib.nsp_ctc_max_labels.restype = _I
    lib.nsp_rnnt_max_labels.argtypes = []
    lib.nsp_rnnt_max_labels.restype = _I
    return lib
