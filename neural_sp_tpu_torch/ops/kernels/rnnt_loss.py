"""K5: the RNN transducer's lattice loss, forward and backward (CUDA C++,
``sm_90a``).

Replaces ``rnnt_alphas_from_pair`` of ``neural_sp_tpu/ops/rnnt.py`` (plain
JAX there: a ``lax.scan`` over T with an associative scan over U inside
each frame), which stands where upstream called the native CUDA kernels
``warp_rnnt`` / ``warp-transducer``. Its inputs are the pre-gathered
log-probabilities of the lattice's two moves, ``blank_lp [B, T, U+1]``
and ``emit_lp [B, T, U]`` (already -1e30 past each row's label length), so
the [B, T, U+1, V] log-softmax is never formed.

The lattice: alpha[0, 0] = 0,

    alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                            alpha[t, u-1] + emit[t, u-1]),

nll = -(alpha[T_b-1, U_b] + blank[T_b-1, U_b]), with T_b clipped to [1, T]
and U_b to [0, U], as JAX's gathers clip them (a row of length 0 reads
frame 0). The backward is the closed form: with beta the mirrored
recurrence (beta[T_b-1, U_b] = blank[T_b-1, U_b]),

    d nll / d blank[t, u] = -exp(alpha[t, u] + blank[t, u] + beta[t+1, u]
                                 + nll),
    d nll / d emit[t, u]  = -exp(alpha[t, u] + emit[t, u] + beta[t, u+1]
                                 + nll),

(beta[T_b, U_b] read as 0 at the final blank), zero past T_b and U_b.

On the card a block takes an utterance, a thread a label position u (U+1
<= 1024), and the lattice is swept by anti-diagonals t + u = d with one
barrier per diagonal; the backward produces both gradients where it
produces beta, in one pass. Precision: as K4's (C14), the values are
carried in float64 (a log alpha falls by about log V a frame and a label;
float32 rounds it at every cell, and the occupancies take the roundings of
both recurrences), only the exponential and the logarithm of the
difference to the maximum in float32. The plain versions beside it
compute in float64 by anti-diagonals, vectorized over each diagonal:
``rnnt_forward_alphas`` (the forward) and ``rnnt_loss_bwd_ref`` with
``rnnt_backward_betas`` (the backward, written out, not autograd). A
``dtype=torch.float32`` there gives the recurrence in JAX's precision, to
measure what float64 buys. ``RNNTNll`` is the ``autograd.Function``: CPU
tensors run the plain versions, CUDA tensors the kernels. Source:
``csrc/rnnt_loss.cu``.
"""
from __future__ import annotations

import torch

from ._checks import check, on_cpu, raise_on_error, stream_of
from .build import load_library
from .roofline import valid_lengths

NEG_INF = -1.0e30
# flops of one lattice cell of the alpha (or beta) recurrence: the two
# moves' adds, a log-add-exp (max, subtract, abs, exp, log1p, add) and
# the clamp
RECURRENCE_FLOPS = 9
# the backward's two occupancies per cell: two sums of three, two exps,
# two products by g
GAMMA_FLOPS = 10


def _clipped(logit_lengths, label_lengths, t, u, dev):
    tb = logit_lengths.to(dev).long().clamp(1, t)
    ub = label_lengths.to(dev).long().clamp(0, u)
    return tb, ub


def _diagonal(d, t_max, u1):
    """(t, u) index tensors of the cells with t + u = d."""
    u = torch.arange(max(0, d - t_max + 1), min(d, u1 - 1) + 1)
    return d - u, u


def rnnt_forward_alphas(blank_lp, emit_lp, logit_lengths, label_lengths,
                        dtype=torch.float64):
    """Plain version of the forward kernel (JAX's
    ``rnnt_alphas_from_pair``) by anti-diagonals. blank_lp [B, T, U+1],
    emit_lp [B, T, U] f32; lengths [B] int. Returns (nll [B] f32, alphas
    [B, T, U+1] in ``dtype``): every cell of the lattice, those past a
    row's lengths included, clamped at NEG_INF as JAX's."""
    bs, t_max, u1 = blank_lp.shape
    dev = blank_lp.device
    blank = blank_lp.to(dtype)
    emit = emit_lp.to(dtype)
    alpha = torch.full((bs, t_max, u1), NEG_INF, dtype=dtype, device=dev)
    alpha[:, 0, 0] = 0.0
    neg = torch.tensor(NEG_INF, dtype=dtype, device=dev)
    for d in range(1, t_max + u1 - 1):
        t, u = _diagonal(d, t_max, u1)
        t, u = t.to(dev), u.to(dev)
        tp, up = (t - 1).clamp(min=0), (u - 1).clamp(min=0)
        from_blank = torch.where(t >= 1, alpha[:, tp, u] + blank[:, tp, u],
                                 neg)
        from_emit = torch.where(u >= 1, alpha[:, t, up] + emit[:, t, up],
                                neg)
        alpha[:, t, u] = torch.logaddexp(from_blank, from_emit).clamp(
            min=NEG_INF)
    return _final_nll(alpha, blank, logit_lengths, label_lengths).float(), \
        alpha


def _final_nll(alpha, blank, logit_lengths, label_lengths):
    bs, t_max, u1 = alpha.shape
    tb, ub = _clipped(logit_lengths, label_lengths, t_max, u1 - 1,
                      alpha.device)
    rows = torch.arange(bs, device=alpha.device)
    return -(alpha[rows, tb - 1, ub] + blank[rows, tb - 1, ub])


def rnnt_backward_betas(blank_lp, emit_lp, logit_lengths, label_lengths,
                        dtype=torch.float64):
    """beta[b, t, u] = log P(the path completes after reaching (t, u)), by
    anti-diagonals from the last cell; NEG_INF past each row's lengths."""
    bs, t_max, u1 = blank_lp.shape
    dev = blank_lp.device
    blank = blank_lp.to(dtype)
    emit = emit_lp.to(dtype)
    tb, ub = _clipped(logit_lengths, label_lengths, t_max, u1 - 1, dev)
    beta = torch.full((bs, t_max, u1), NEG_INF, dtype=dtype, device=dev)
    neg = torch.tensor(NEG_INF, dtype=dtype, device=dev)
    for d in range(t_max + u1 - 2, -1, -1):
        t, u = _diagonal(d, t_max, u1)
        t, u = t.to(dev), u.to(dev)
        tn, un = (t + 1).clamp(max=t_max - 1), (u + 1).clamp(max=u1 - 1)
        below = torch.where(t + 1 < t_max, beta[:, tn, u], neg)
        right = torch.where(u + 1 < u1, beta[:, t, un], neg)
        em = emit[:, t, u.clamp(max=max(u1 - 2, 0))] if u1 > 1 else \
            torch.zeros_like(below)
        new = torch.logaddexp(below + blank[:, t, u], right + em).clamp(
            min=NEG_INF)
        final = (t[None] == tb[:, None] - 1) & (u[None] == ub[:, None])
        valid = (t[None] < tb[:, None]) & (u[None] <= ub[:, None])
        beta[:, t, u] = torch.where(final, blank[:, t, u],
                                    torch.where(valid, new, neg))
    return beta


def rnnt_loss_bwd_ref(blank_lp, emit_lp, logit_lengths, label_lengths,
                      alphas, g, dtype=torch.float64):
    """Plain version of the backward kernel, in float64 (or ``dtype``):
    (d(sum_b g[b] nll[b]) / d blank_lp [B, T, U+1], ... / d emit_lp [B, T,
    U]) f32, from the forward's alphas (the nll taken from them)."""
    bs, t_max, u1 = blank_lp.shape
    dev = blank_lp.device
    blank = blank_lp.to(dtype)
    emit = emit_lp.to(dtype)
    alphas = alphas.to(dtype)
    tb, ub = _clipped(logit_lengths, label_lengths, t_max, u1 - 1, dev)
    nll = _final_nll(alphas, blank, logit_lengths, label_lengths)
    beta = rnnt_backward_betas(blank_lp, emit_lp, logit_lengths,
                               label_lengths, dtype)
    t_idx = torch.arange(t_max, device=dev)[None, :, None]
    u_idx = torch.arange(u1, device=dev)[None, None, :]
    below = torch.cat([beta[:, 1:], torch.full_like(beta[:, :1], NEG_INF)],
                      1)
    final = (t_idx == tb[:, None, None] - 1) & (u_idx == ub[:, None, None])
    below = torch.where(final, torch.zeros_like(below), below)
    valid = (t_idx < tb[:, None, None]) & (u_idx <= ub[:, None, None])
    scale = -g.to(dtype)[:, None, None]
    occ = torch.exp((alphas + blank + below + nll[:, None, None]).clamp(
        max=0.0))
    grad_blank = torch.where(valid, scale * occ, torch.zeros_like(occ))
    u_e = u_idx[..., :-1]
    occ_e = torch.exp((alphas[..., :-1] + emit + beta[..., 1:]
                       + nll[:, None, None]).clamp(max=0.0))
    valid_e = (t_idx < tb[:, None, None]) & (u_e < ub[:, None, None])
    grad_emit = torch.where(valid_e, scale * occ_e, torch.zeros_like(occ_e))
    return grad_blank.float(), grad_emit.float()


def _cells(t, u, logit_lengths, label_lengths):
    """sum over utterances of the lattice's valid cells, T_b x (U_b + 1),
    with T_b clipped to [1, T]."""
    tl = [max(x, 1) for x in valid_lengths(logit_lengths, t)]
    ul = valid_lengths(label_lengths, u)
    return sum(x * (y + 1) for x, y in zip(tl, ul))


def rnnt_cost(b, t, u, logit_lengths, label_lengths):
    """(flops, bytes) of K5's forward: the alpha recurrence over each
    utterance's valid cells; reads their blank and emit log-probs and the
    lengths, writes their float64 alphas and the nll. Elementwise work:
    its peak is the SIMT rate."""
    cells = _cells(t, u, logit_lengths, label_lengths)
    return RECURRENCE_FLOPS * cells, (4 + 4 + 8) * cells + 4 * 3 * b


def rnnt_bwd_cost(b, t, u, logit_lengths, label_lengths):
    """(flops, bytes) of K5's backward: the beta recurrence and the two
    occupancies over the valid cells; reads their log-probs and float64
    alphas, the lengths and g; writes the two dense gradients [B, T, U+1]
    and [B, T, U] (the wrapper zeroes them, the kernel writes the valid
    cells)."""
    cells = _cells(t, u, logit_lengths, label_lengths)
    return (RECURRENCE_FLOPS + GAMMA_FLOPS) * cells, \
        (4 + 4 + 8) * cells + 4 * 3 * b + 4 * b * t * (2 * u + 1)


def _check_args(blank_lp, emit_lp, logit_lengths, label_lengths):
    b, t, u1 = blank_lp.shape
    check("blank_lp", blank_lp, (b, t, u1))
    check("emit_lp", emit_lp, (b, t, u1 - 1))
    check("logit_lengths", logit_lengths, (b,), torch.int32)
    check("label_lengths", label_lengths, (b,), torch.int32)
    lib = load_library()
    if u1 - 1 > lib.nsp_rnnt_max_labels():
        raise ValueError(f"rnnt_loss: {u1 - 1} labels, more than the "
                         f"{lib.nsp_rnnt_max_labels()} the kernels hold")
    return lib


def rnnt_loss_fwd(blank_lp, emit_lp, logit_lengths, label_lengths):
    """(nll [B], alphas [B, T, U+1] float64). CPU tensors take the plain
    version; CUDA tensors launch the kernel (f32 log-probs, int32 lengths,
    contiguous) or raise. Counts in ``rnnt_loss_fwd.launches``."""
    args = (blank_lp, emit_lp, logit_lengths, label_lengths)
    if on_cpu(*args):
        return rnnt_forward_alphas(*args)
    lib = _check_args(*args)
    b, t, u1 = blank_lp.shape
    # cells past a row's lengths are not written; nothing reads them
    alphas = torch.empty((b, t, u1), dtype=torch.float64,
                         device=blank_lp.device)
    nll = torch.empty((b,), dtype=torch.float32, device=blank_lp.device)
    err = lib.nsp_rnnt_alpha_f32(*(x.data_ptr() for x in (*args, alphas, nll)),
                                 b, t, u1 - 1, stream_of(blank_lp))
    raise_on_error("rnnt_loss", err)
    rnnt_loss_fwd.launches += 1
    return nll, alphas


def rnnt_loss_bwd(blank_lp, emit_lp, logit_lengths, label_lengths, alphas,
                  g):
    """(grad_blank [B, T, U+1], grad_emit [B, T, U]) from the forward's
    alphas; dispatch as ``rnnt_loss_fwd``. Counts in
    ``rnnt_loss_bwd.launches``."""
    args = (blank_lp, emit_lp, logit_lengths, label_lengths)
    if on_cpu(*args, alphas, g):
        return rnnt_loss_bwd_ref(*args, alphas, g)
    lib = _check_args(*args)
    b, t, u1 = blank_lp.shape
    check("alphas", alphas, (b, t, u1), torch.float64)
    g = g.contiguous()
    check("g", g, (b,))
    grad_blank = torch.zeros_like(blank_lp)
    grad_emit = torch.zeros_like(emit_lp)
    err = lib.nsp_rnnt_beta_grad_f32(
        *(x.data_ptr() for x in (*args, alphas, g, grad_blank, grad_emit)),
        b, t, u1 - 1, stream_of(blank_lp))
    raise_on_error("rnnt_loss_bwd", err)
    rnnt_loss_bwd.launches += 1
    return grad_blank, grad_emit


rnnt_loss_fwd.launches = 0
rnnt_loss_bwd.launches = 0


class RNNTNll(torch.autograd.Function):
    """Per-utterance transducer negative log-likelihood [B], differentiable
    in the two gathered log-probabilities."""

    @staticmethod
    def forward(ctx, blank_lp, emit_lp, logit_lengths, label_lengths):
        nll, alphas = rnnt_loss_fwd(blank_lp, emit_lp, logit_lengths,
                                    label_lengths)
        ctx.save_for_backward(blank_lp, emit_lp, logit_lengths,
                              label_lengths, alphas)
        return nll

    @staticmethod
    def backward(ctx, g):
        grad_blank, grad_emit = rnnt_loss_bwd(*ctx.saved_tensors, g)
        return grad_blank, grad_emit, None, None


def rnnt_nll(blank_lp, emit_lp, logit_lengths, label_lengths):
    return RNNTNll.apply(blank_lp, emit_lp, logit_lengths, label_lengths)
