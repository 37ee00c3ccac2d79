"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
twin. A wrapper takes the twin for CPU tensors only; for CUDA tensors it
launches its kernel or raises, and counts the launch."""
from .las_step import las_step, las_step_ref
from .rel_attention import rel_attention, rel_attention_ref

KERNELS = (rel_attention, las_step)


def reset_launches() -> None:
    for kernel in KERNELS:
        kernel.launches = 0
