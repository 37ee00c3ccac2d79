"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
twin. A wrapper takes the twin for CPU tensors only; for CUDA tensors it
launches its kernel or raises, and counts the launch."""
from .ctc_loss import ctc_loss_bwd, ctc_loss_fwd
from .las_scan import las_scan, las_scan_bwd
from .las_step import las_step, las_step_ref
from .rel_attention import rel_attention, rel_attention_bwd, rel_attention_ref
from .rnnt_loss import rnnt_loss_bwd, rnnt_loss_fwd

# launch counters by kernel entry: (wrapper, its counter's attribute)
# (``ctc_loss`` is K4's forward entry, ``rnnt_loss`` K5's; K1 / K1b count
# their float32 and bf16 entries apart, and count again the launches with
# a window on the keys, those dropping attention probabilities (their own
# instantiations, float32 and bf16 apart) and those without dropout with fewer queries than keys
# (against cached keys, or the Transformer-XL's memory), and those at a
# head width below 16, padded; K2 / K3 / K3b count again their launches
# with attention dropout, those with the decoder's projection and those
# with the additive energy, and K3 / K3b those with a length per step,
# triggered attention's window)
KERNELS = {"rel_attention": (rel_attention, "launches"),
           "rel_attention_bf16": (rel_attention, "launches_bf16"),
           "rel_attention_window": (rel_attention, "launches_window"),
           "rel_attention_offset": (rel_attention, "launches_offset"),
           "rel_attention_dropout": (rel_attention, "launches_dropout"),
           "rel_attention_padded": (rel_attention, "launches_padded"),
           "rel_attention_bf16_dropout": (rel_attention,
                                          "launches_bf16_dropout"),
           "rel_attention_bwd": (rel_attention_bwd, "launches"),
           "rel_attention_bwd_bf16": (rel_attention_bwd, "launches_bf16"),
           "rel_attention_bwd_window": (rel_attention_bwd,
                                        "launches_window"),
           "rel_attention_bwd_offset": (rel_attention_bwd,
                                        "launches_offset"),
           "rel_attention_bwd_dropout": (rel_attention_bwd,
                                         "launches_dropout"),
           "rel_attention_bwd_padded": (rel_attention_bwd,
                                        "launches_padded"),
           "rel_attention_bwd_bf16_dropout": (rel_attention_bwd,
                                              "launches_bf16_dropout"),
           "las_step": (las_step, "launches"),
           "las_step_dropout": (las_step, "launches_dropout"),
           "las_step_proj": (las_step, "launches_proj"),
           "las_step_add": (las_step, "launches_add"),
           "las_scan": (las_scan, "launches"),
           "las_scan_dropout": (las_scan, "launches_dropout"),
           "las_scan_proj": (las_scan, "launches_proj"),
           "las_scan_add": (las_scan, "launches_add"),
           "las_scan_window": (las_scan, "launches_window"),
           "las_scan_bwd": (las_scan_bwd, "launches"),
           "las_scan_bwd_dropout": (las_scan_bwd, "launches_dropout"),
           "las_scan_bwd_proj": (las_scan_bwd, "launches_proj"),
           "las_scan_bwd_add": (las_scan_bwd, "launches_add"),
           "las_scan_bwd_window": (las_scan_bwd, "launches_window"),
           "ctc_loss": (ctc_loss_fwd, "launches"),
           "ctc_loss_bwd": (ctc_loss_bwd, "launches"),
           "rnnt_loss": (rnnt_loss_fwd, "launches"),
           "rnnt_loss_bwd": (rnnt_loss_bwd, "launches")}


def reset_launches() -> None:
    for kernel, counter in KERNELS.values():
        setattr(kernel, counter, 0)
    for kernel in (las_scan, las_scan_bwd):
        kernel.kernel_launches_per_call = 0


def launches() -> dict[str, int]:
    return {name: getattr(kernel, counter)
            for name, (kernel, counter) in KERNELS.items()}
