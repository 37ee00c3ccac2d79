"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
twin. A wrapper takes the twin for CPU tensors only; for CUDA tensors it
launches its kernel or raises, and counts the launch."""
from .ctc_loss import ctc_loss_bwd, ctc_loss_fwd
from .las_scan import las_scan, las_scan_bwd
from .las_step import las_step, las_step_ref
from .rel_attention import rel_attention, rel_attention_bwd, rel_attention_ref

# launch counters by kernel name (``ctc_loss`` is K4's forward entry)
KERNELS = {"rel_attention": rel_attention,
           "rel_attention_bwd": rel_attention_bwd, "las_step": las_step,
           "las_scan": las_scan, "las_scan_bwd": las_scan_bwd,
           "ctc_loss": ctc_loss_fwd, "ctc_loss_bwd": ctc_loss_bwd}


def reset_launches() -> None:
    for kernel in KERNELS.values():
        kernel.launches = 0
    las_scan_bwd.kernel_launches_per_call = 0


def launches() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
