"""CTC loss and Viterbi forced alignment (counterpart of
``neural_sp_tpu/ops/ctc.py::ctc_loss`` and ``ctc_forced_align``).

The nll and its gradient are kernel K4 (``ops.kernels.ctc_loss``), with the
semantics of the JAX package's custom VJP ``_ctc_nll_fb``; this module
adds ``zero_infinity``, as there. The caller reduces. The forced alignment
is plain PyTorch (the JAX package computes it in plain JAX), its emission
table a gather where JAX contracts with a one-hot.
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


def _shift_right(x: torch.Tensor, n: int) -> torch.Tensor:
    """out[..., s] = x[..., s - n], NEG_INF in the first n."""
    return torch.nn.functional.pad(x, (n, 0), value=NEG_INF)[..., :x.shape[-1]]


@torch.no_grad()
def ctc_forced_align(log_probs: torch.Tensor, labels: torch.Tensor,
                     logit_lengths: torch.Tensor, label_lengths: torch.Tensor,
                     blank: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Viterbi forced alignment over the CTC lattice of log-probs [B, T,
    V] against labels [B, U] (any padding past label_lengths), blank 0.

    Returns (trigger_points [B, U] int32: the first frame whose state is
    label u's, 0 past label_lengths; best_paths [B, T] int32: the label id
    per frame, blank included). As JAX: the forward max-product keeps, per
    state, the first of (stay, from s-1, skip from s-2) that reaches the
    max (``argmax``'s tie rule); frames past a row's length keep the row's
    states; the backtrace starts at the better of the last two states."""
    lp = log_probs.float()
    dev = lp.device
    bs, tmax, v = lp.shape
    labels = labels.to(device=dev, dtype=torch.long)
    logit_lengths = logit_lengths.to(device=dev, dtype=torch.long)
    label_lengths = label_lengths.to(device=dev, dtype=torch.long)
    u = labels.shape[1]
    s = 2 * u + 1
    z = torch.full((bs, s), blank, dtype=torch.long, device=dev)
    z[:, 1::2] = labels
    z_m2 = torch.nn.functional.pad(z, (2, 0), value=-1)[:, :s]
    allow_skip = (z != blank) & (z != z_m2)
    # emit[b, t, s] = lp[b, t, z[b, s]]; an id outside the vocabulary (a
    # padding id) emits 0, as JAX's one-hot of it
    inside = (z >= 0) & (z < v)
    emit = lp.gather(2, torch.where(inside, z, 0)[:, None, :].expand(
        bs, tmax, s))
    emit = torch.where(inside[:, None, :], emit, torch.zeros_like(emit))
    alpha = torch.full((bs, s), NEG_INF, device=dev)
    alpha[:, :2] = emit[:, 0, :2]
    bps = torch.zeros((max(tmax - 1, 0), bs, s), dtype=torch.uint8,
                      device=dev)
    neg = torch.full_like(alpha, NEG_INF)
    for t in range(1, tmax):
        a0, a1 = alpha, _shift_right(alpha, 1)
        a2 = torch.where(allow_skip, _shift_right(alpha, 2), neg)
        best = torch.maximum(torch.maximum(a0, a1), a2)
        # the first maximum, as jnp.argmax over [a0, a1, a2]
        bp = torch.where(a0 == best, 0, torch.where(a1 == best, 1, 2))
        valid = (t < logit_lengths)[:, None]
        alpha = torch.where(valid, best + emit[:, t], alpha)
        bps[t - 1] = torch.where(valid, bp, 0).to(torch.uint8)
    end = 2 * label_lengths
    a_end = alpha.gather(1, end[:, None])[:, 0]
    end1 = (end - 1).clamp(min=0)
    a_end1 = alpha.gather(1, end1[:, None])[:, 0]
    s_cur = torch.where(a_end >= a_end1, end, end1)
    states = torch.empty((bs, tmax), dtype=torch.long, device=dev)
    states[:, tmax - 1] = s_cur
    for t in range(tmax - 2, -1, -1):
        off = bps[t].gather(1, s_cur[:, None])[:, 0].long()
        s_cur = torch.where(t + 1 < logit_lengths, s_cur - off, s_cur)
        states[:, t] = s_cur
    best_paths = z.gather(1, states)
    u_states = 2 * torch.arange(u, device=dev)[None, :, None] + 1
    frames = torch.arange(tmax, device=dev)
    trigger = torch.where(states[:, None, :] == u_states, frames,
                          torch.full_like(frames, tmax)).amin(2) \
        if u > 0 else torch.zeros((bs, 0), dtype=torch.long, device=dev)
    trigger = torch.where(torch.arange(u, device=dev)[None] <
                          label_lengths[:, None], trigger,
                          torch.zeros_like(trigger))
    return trigger.to(torch.int32), best_paths.to(torch.int32)
