"""RNN-Transducer lattice loss (counterpart of ``neural_sp_tpu/ops/rnnt.py``).

The lattice's nll and its gradient are kernel K5 (``ops.kernels.
rnnt_loss``; its plain float64 versions on the CPU). This module gathers
the two moves' log-probabilities as the JAX functions do and reduces.
"""
from __future__ import annotations

import torch

from .kernels.rnnt_loss import NEG_INF, rnnt_nll


def _reduce(nll: torch.Tensor, reduction: str, bs: int) -> torch.Tensor:
    if reduction == "none":
        return nll
    if reduction == "mean":
        return nll.mean()
    return nll.sum() / bs


def rnnt_alphas_from_pair(blank_lp: torch.Tensor, emit_lp: torch.Tensor,
                          logit_lengths: torch.Tensor,
                          label_lengths: torch.Tensor) -> torch.Tensor:
    """nll [B] from pre-gathered log-probs: blank_lp [B, T, U+1], emit_lp
    [B, T, U] (already NEG_INF past each row's label length)."""
    dev = blank_lp.device
    return rnnt_nll(blank_lp.float().contiguous(),
                    emit_lp.float().contiguous(),
                    logit_lengths.to(dev, torch.int32).contiguous(),
                    label_lengths.to(dev, torch.int32).contiguous())


def _mask_emit(emit_lp: torch.Tensor, label_lengths: torch.Tensor
               ) -> torch.Tensor:
    """NEG_INF past each row's label length (forbids emitting there)."""
    u = emit_lp.shape[-1]
    u_ids = torch.arange(u, device=emit_lp.device)[None, None, :]
    lens = label_lengths.to(emit_lp.device)[:, None, None]
    return torch.where(u_ids < lens, emit_lp,
                       torch.full_like(emit_lp, NEG_INF))


def rnnt_loss(log_probs: torch.Tensor, labels: torch.Tensor,
              logit_lengths: torch.Tensor, label_lengths: torch.Tensor,
              blank: int = 0, reduction: str = "sum_over_batch"
              ) -> torch.Tensor:
    """Transducer nll of joint log-softmax outputs [B, T, U+1, V] against
    labels [B, U] (warp_rnnt's semantics)."""
    log_probs = log_probs.float()
    u = labels.shape[1]
    blank_lp = log_probs[..., blank]
    emit_lp = torch.gather(log_probs[:, :, :u, :], 3,
                           labels.long()[:, None, :, None].expand(
                               -1, log_probs.shape[1], -1, 1))[..., 0]
    nll = rnnt_alphas_from_pair(blank_lp, _mask_emit(emit_lp, label_lengths),
                                logit_lengths, label_lengths)
    return _reduce(nll, reduction, log_probs.shape[0])


def rnnt_loss_from_logits(logits: torch.Tensor, labels: torch.Tensor,
                          logit_lengths: torch.Tensor,
                          label_lengths: torch.Tensor, blank: int = 0,
                          reduction: str = "sum_over_batch") -> torch.Tensor:
    """Transducer loss straight from joint logits [B, T, U+1, V]: a
    logsumexp and two gathers make the [B, T, U+1] log-probs of the two
    moves; the [B, T, U+1, V] gradient comes from autograd through them."""
    logits = logits.float()
    u = labels.shape[1]
    lse = torch.logsumexp(logits, -1)                        # [B, T, U+1]
    blank_lp = logits[..., blank] - lse
    emit_raw = torch.gather(logits[:, :, :u, :], 3,
                            labels.long()[:, None, :, None].expand(
                                -1, logits.shape[1], -1, 1))[..., 0]
    emit_lp = _mask_emit(emit_raw - lse[:, :, :u], label_lengths)
    nll = rnnt_alphas_from_pair(blank_lp, emit_lp, logit_lengths,
                                label_lengths)
    return _reduce(nll, reduction, logits.shape[0])
