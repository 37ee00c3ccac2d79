"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrapper then takes its
    plain twin); False when all lie on one CUDA device. Anything else
    raises: a wrapper never moves data and never falls back."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"kernel arguments must all lie on the CPU or all on one CUDA "
            f"device, got {sorted(str(t.device) for t in tensors)}")
    return False


def check(name: str, t: torch.Tensor, shape: tuple,
          dtype: torch.dtype = torch.float32) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


def raise_on_error(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t "
                           f"{err}")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream on t's device (the accessor
    PyTorch's own generated kernels use: no Stream object is built)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)
