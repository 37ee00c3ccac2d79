"""Loss criteria (counterpart of ``neural_sp_tpu/ops/criterion.py``):
label-smoothed cross entropy, the CTC label-smoothing term and
teacher-forcing accuracy, f32."""
from __future__ import annotations

import math

import torch

from .masks import make_pad_mask


def cross_entropy_lsm(logits: torch.Tensor, ys: torch.Tensor,
                      lsm_prob: float = 0.0, ignore_index: int = -1,
                      normalize_length: bool = False):
    """logits [B, T, V], ys [B, T] ids. The target gets (1 - lsm_prob),
    every OTHER class lsm_prob / (V - 1); ``ignore_index`` positions drop
    out. Returns (loss summed over tokens / B, or / #tokens when
    ``normalize_length``; mean nll over valid tokens)."""
    logits = logits.float()
    v = logits.shape[-1]
    log_probs = torch.log_softmax(logits, dim=-1)
    mask = ys != ignore_index
    ys_safe = torch.where(mask, ys, torch.zeros_like(ys))
    nll = -torch.gather(log_probs, -1, ys_safe[..., None].long())[..., 0]
    if lsm_prob > 0.0:
        sum_neg_lp = -log_probs.sum(-1)
        per_tok = (1.0 - lsm_prob) * nll + \
            lsm_prob / (v - 1) * (sum_neg_lp - nll)
    else:
        per_tok = nll
    per_tok = torch.where(mask, per_tok, torch.zeros_like(per_tok))
    n_tok = mask.sum().clamp(min=1)
    denom = n_tok if normalize_length else logits.shape[0]
    loss = per_tok.sum() / denom
    mean_nll = torch.where(mask, nll, torch.zeros_like(nll)).sum() / n_tok
    return loss, mean_nll


def compute_accuracy(logits: torch.Tensor, ys: torch.Tensor,
                     ignore_index: int = -1) -> torch.Tensor:
    """Teacher-forcing token accuracy in percent."""
    mask = ys != ignore_index
    correct = ((logits.argmax(-1) == ys) & mask).sum()
    return 100.0 * correct / mask.sum().clamp(min=1)


def kldiv_lsm_ctc(logits: torch.Tensor, elens: torch.Tensor) -> torch.Tensor:
    """KL(softmax(logits) || uniform) summed over the valid frames and
    divided by B, for CTC label smoothing. logits [B, T, V]."""
    logits = logits.float()
    log_probs = torch.log_softmax(logits, dim=-1)
    kl = (log_probs.exp() * (log_probs + math.log(logits.shape[-1]))).sum(-1)
    kl = torch.where(make_pad_mask(elens, logits.shape[1]), kl,
                     torch.zeros_like(kl))
    return kl.sum() / logits.shape[0]
