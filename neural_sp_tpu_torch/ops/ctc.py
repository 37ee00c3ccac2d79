"""CTC loss (counterpart of ``neural_sp_tpu/ops/ctc.py::ctc_loss``).

The nll and its gradient are kernel K4 (``ops.kernels.ctc_loss``), with the
semantics of the JAX package's custom VJP ``_ctc_nll_fb``; this module
adds ``zero_infinity``, as there. The caller reduces.
"""
from __future__ import annotations

import torch

from .kernels.ctc_loss import NEG_INF, ctc_nll


def ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor,
             logit_lengths: torch.Tensor, label_lengths: torch.Tensor
             ) -> torch.Tensor:
    """CTC negative log-likelihood of f32 log-softmax outputs [B, T, V]
    against PAD-padded labels [B, U], blank = 0, per utterance [B]. As the
    JAX default ``zero_infinity=True``, an infeasible utterance (U +
    repeats > T, or U = 0) gives 0 and no gradient."""
    dev = log_probs.device
    labels = labels.to(dev, torch.int32).contiguous()
    logit_lengths = logit_lengths.to(dev, torch.int32).contiguous()
    label_lengths = label_lengths.to(dev, torch.int32).contiguous()
    nll = ctc_nll(log_probs.float().contiguous(), labels, logit_lengths,
                  label_lengths)
    u_idx = torch.arange(labels.shape[1], device=dev)[None]
    valid_pos = (u_idx < label_lengths[:, None]) & (u_idx > 0)
    repeats = (valid_pos & (labels == torch.roll(labels, 1, 1))).sum(1)
    feasible = (label_lengths + repeats <= logit_lengths) & (label_lengths > 0)
    zero = torch.zeros_like(nll)
    nll = torch.where(feasible, nll, zero)
    return torch.where(nll >= -NEG_INF / 2, zero, nll)
