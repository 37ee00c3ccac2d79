"""The least time an NVIDIA H100 (SXM, 700 W) could take for a kernel's
work: its bound, for comparing a measured kernel time against.

Each kernel module has a ``*_cost(shapes...) -> (flops, bytes)`` beside its
wrapper. It counts what the algorithm needs at those shapes: each input
byte read once, each output byte written once, and only the keys, frames
and states that the lengths leave valid. ``bound_ms`` turns that into
time at the card's published peaks (NVIDIA's data sheet).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
# float32 accuracy on the tensor cores: the 3xTF32 split runs three TF32
# products (495 TFLOP/s dense) for each float32 one
F32_TENSOR_FLOPS = 495e12 / 3
# float32 on the SIMT pipes, for work that is not a matrix product
F32_SIMT_FLOPS = 67e12
# bf16 operands on the tensor cores, float32 accumulation (dense)
BF16_TENSOR_FLOPS = 989e12


def bound_ms(flops: float, nbytes: float,
             peak: float = F32_TENSOR_FLOPS) -> tuple[float, str]:
    """(max(flops / peak, bytes / HBM rate) in ms, "operations" or "bytes":
    which of the two bounds it)."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def valid_lengths(lengths, t: int) -> list[int]:
    """Lengths clipped to [0, t], as plain ints."""
    return [min(max(int(n), 0), t) for n in lengths]
