"""K4: CTC loss, forward and backward (CUDA C++, ``sm_90a``).

Replaces the TPU kernels ``_kernel`` (reached through ``ctc_loss_pallas``)
and ``_kernel_fused`` (``ctc_loss_pallas_fused``) of
``neural_sp_tpu/ops/ctc_pallas.py`` (deleted in 63255ae; read it with
``git show 63255ae~1:neural_sp_tpu/ops/ctc_pallas.py``): the alpha
recurrence with the emission gathered in-kernel. The backward is the JAX
package's custom VJP ``_ctc_nll_bwd`` (``ops/ctc.py``): one beta pass from
the saved alphas, the state occupancies, and their scatter into a dense
gradient w.r.t. the log-probs.

On the card a block of 256 threads takes an utterance (``ctc_alpha_ahead``
and ``ctc_beta_grad_ahead``): a thread holds 1 to 16 states of the lattice
(at most 2047 labels), the frame's alphas (or beta + emission) sit in
shared memory with one barrier per frame, and the emissions (and saved
alphas, in the backward) of the next frames are loaded ahead into
registers, so that no frame waits for global memory. The backward is one
pass per frame, and sums the states that share a vocabulary id in a fixed
order, so that it gives the same bits in every run: the blanks'
occupancies by a shuffle tree inside each warp, one store a warp into the
frame's scratch row; a label seen once stores its own into the gradient;
a repeated label into the scratch row. After the last frame the warps'
sums are added in warp order and each repeated label's occurrences in
label order. It writes into a gradient that the wrapper zeroes: that
memset is the loss's byte bound.

Plain PyTorch versions beside it: ``ctc_forward_alphas`` (the forward) and
``ctc_loss_bwd_ref`` with ``ctc_backward_betas`` (the backward, written
out, not autograd). ``CTCNll`` is the ``autograd.Function``: CPU tensors run
the plain versions, CUDA tensors the kernels. Source: ``csrc/ctc_loss.cu``.
"""
from __future__ import annotations

import torch

from ._checks import check, on_cpu, raise_on_error, stream_of
from .build import load_library
from .roofline import valid_lengths

NEG_INF = -1.0e30
# flops of one state at one frame of the alpha (or beta) recurrence: a
# log-add-exp of three (2 max, 3 subtract, 3 exp, 2 add, 1 log, 1 add) and
# the emission's add
RECURRENCE_FLOPS = 13
# the backward's occupancy per state and frame: alpha + beta + nll, exp,
# times g
GAMMA_FLOPS = 4


def _extend(labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """labels [B, U] -> (z [B, 2U+1] blank-interleaved, allow_skip)."""
    bs, u = labels.shape
    z = torch.zeros((bs, 2 * u + 1), dtype=torch.long, device=labels.device)
    z[:, 1::2] = labels.long()
    z_m2 = torch.cat([torch.full((bs, 2), -1, dtype=torch.long,
                                 device=z.device), z[:, :-2]], 1)
    return z, (z != 0) & (z != z_m2)


def _logaddexp3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    ms = m.clamp(min=NEG_INF)
    out = ms + torch.log(torch.exp(a - ms) + torch.exp(b - ms)
                         + torch.exp(c - ms))
    return torch.where(m <= NEG_INF, torch.full_like(out, NEG_INF), out)


def _shift(x: torch.Tensor, n: int) -> torch.Tensor:
    """out[..., s] = x[..., s - n] (n > 0) or x[..., s + |n|] (n < 0),
    NEG_INF where that falls outside."""
    fill = torch.full_like(x[..., :abs(n)], NEG_INF)
    if n > 0:
        return torch.cat([fill, x[..., :-n]], -1)
    return torch.cat([x[..., -n:], fill], -1)


def _emit(log_probs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """emit[b, t, s] = log_probs[b, t, z[b, s]] ([B, T, S])."""
    t = log_probs.shape[1]
    return torch.gather(log_probs, 2, z[:, None, :].expand(-1, t, -1))


def ctc_forward_alphas(log_probs, labels, logit_lengths, label_lengths):
    """Plain version of the forward kernel (``ops/ctc.py::
    ctc_forward_alphas``). log_probs [B, T, V] f32; labels [B, U] int;
    lengths [B] int. Returns (nll [B], alphas [B, T, 2U+1])."""
    bs, tmax, _ = log_probs.shape
    z, skip = _extend(labels)
    emit = _emit(log_probs.float(), z)
    tl = logit_lengths.to(log_probs.device)
    alpha = torch.full_like(emit[:, 0], NEG_INF)
    alpha[:, 0] = emit[:, 0, 0]
    if z.shape[1] > 1:
        alpha[:, 1] = emit[:, 0, 1]
    hist = [alpha]
    neg = torch.full_like(alpha, NEG_INF)
    for t in range(1, tmax):
        a2 = torch.where(skip, _shift(alpha, 2), neg)
        new = (_logaddexp3(alpha, _shift(alpha, 1), a2)
               + emit[:, t]).clamp(min=NEG_INF)
        alpha = torch.where((t < tl)[:, None], new, alpha)
        hist.append(alpha)
    end = 2 * label_lengths.to(log_probs.device).long()
    a_end = alpha.gather(1, end[:, None])[:, 0]
    a_end1 = alpha.gather(1, (end - 1).clamp(min=0)[:, None])[:, 0]
    a_end1 = torch.where(end > 0, a_end1, torch.full_like(a_end1, NEG_INF))
    return -torch.logaddexp(a_end, a_end1), torch.stack(hist, 1)


def ctc_backward_betas(log_probs, labels, logit_lengths, label_lengths):
    """Beta recurrence (``ops/ctc.py::_ctc_backward_betas``): beta[b, t, s]
    = log P(the path completes after (t, s)); at and past each utterance's
    last frame it is the seed, 0 at its two final states."""
    bs, tmax, _ = log_probs.shape
    z, skip = _extend(labels)
    s = z.shape[1]
    skip_fwd = torch.cat([skip[:, 2:], torch.zeros_like(skip[:, :2])], 1)
    emit = _emit(log_probs.float(), z)
    tl = logit_lengths.to(log_probs.device)
    end = 2 * label_lengths.to(log_probs.device).long()
    s_idx = torch.arange(s, device=log_probs.device)[None]
    seed = torch.where((s_idx == end[:, None])
                       | (s_idx == (end - 1).clamp(min=0)[:, None]),
                       0.0, NEG_INF).to(emit.dtype)
    neg = torch.full_like(seed, NEG_INF)
    beta = seed
    hist = [beta]
    for t in range(tmax - 2, -1, -1):
        b0 = beta + emit[:, t + 1]
        new = _logaddexp3(b0, _shift(b0, -1),
                          torch.where(skip_fwd, _shift(b0, -2), neg))
        new = new.clamp(min=NEG_INF)
        beta = torch.where((t >= tl - 1)[:, None], seed, new)
        hist.append(beta)
    return torch.stack(hist[::-1], 1)


def ctc_loss_bwd_ref(log_probs, labels, logit_lengths, label_lengths, nll,
                     alphas, g):
    """Plain version of the backward kernel (``_ctc_nll_bwd``): d(sum_b
    g[b] nll[b]) / d log_probs, dense [B, T, V]."""
    bs, tmax, v = log_probs.shape
    z, _ = _extend(labels)
    betas = ctc_backward_betas(log_probs, labels, logit_lengths,
                               label_lengths)
    gamma = torch.exp((alphas + betas + nll[:, None, None]).clamp(max=0.0))
    dev = log_probs.device
    valid = ((torch.arange(tmax, device=dev)[None, :, None]
              < logit_lengths.to(dev)[:, None, None])
             & (torch.arange(z.shape[1], device=dev)[None, None]
                <= 2 * label_lengths.to(dev)[:, None, None]))
    gamma = torch.where(valid, gamma, torch.zeros_like(gamma))
    grad = torch.zeros((bs, tmax, v), dtype=gamma.dtype, device=dev)
    grad.scatter_add_(2, z[:, None, :].expand(-1, tmax, -1), gamma)
    return -grad * g[:, None, None]


def _states_frames(t, u, logit_lengths, label_lengths):
    """sum over utterances of (valid frames) x (2 U_b + 1 states), and of
    (valid frames) x (U_b + 1 emission columns: the labels and blank)."""
    tl = valid_lengths(logit_lengths, t)
    ul = valid_lengths(label_lengths, u)
    return (sum(x * (2 * y + 1) for x, y in zip(tl, ul)),
            sum(x * (y + 1) for x, y in zip(tl, ul)))


def ctc_loss_cost(b, t, u, v, logit_lengths, label_lengths):
    """(flops, bytes) of K4's forward: the alpha recurrence over each
    utterance's valid frames and states; reads the emissions it gathers
    (labels and blank, not the whole vocabulary), labels and lengths;
    writes alphas [B, T, 2U+1] and nll. Elementwise work: its peak is the
    SIMT rate."""
    sf, emit = _states_frames(t, u, logit_lengths, label_lengths)
    return RECURRENCE_FLOPS * sf, \
        4 * (emit + b * u + 2 * b + b * t * (2 * u + 1) + b)


def ctc_loss_bwd_cost(b, t, u, v, logit_lengths, label_lengths):
    """(flops, bytes) of K4's backward: the beta recurrence and the state
    occupancies over the valid frames and states; reads the gathered
    emissions, the valid alphas, labels, lengths, nll and g; writes the
    dense gradient [B, T, V]."""
    sf, emit = _states_frames(t, u, logit_lengths, label_lengths)
    return (RECURRENCE_FLOPS + GAMMA_FLOPS) * sf, \
        4 * (emit + sf + b * u + 2 * b + 2 * b + b * t * v)


def _check_args(log_probs, labels, logit_lengths, label_lengths):
    b, t, v = log_probs.shape
    check("log_probs", log_probs, (b, t, v))
    check("labels", labels, (b, labels.shape[1]), torch.int32)
    check("logit_lengths", logit_lengths, (b,), torch.int32)
    check("label_lengths", label_lengths, (b,), torch.int32)
    lib = load_library()
    if labels.shape[1] > lib.nsp_ctc_max_labels():
        raise ValueError(f"ctc_loss: {labels.shape[1]} labels, more than "
                         f"the {lib.nsp_ctc_max_labels()} the kernels hold")
    return lib


def ctc_loss_fwd(log_probs, labels, logit_lengths, label_lengths):
    """(nll [B], alphas [B, T, 2U+1]). CPU tensors take the plain version;
    CUDA tensors launch the kernel (f32 log-probs, int32 labels and
    lengths, contiguous) or raise. Counts in ``ctc_loss_fwd.launches``."""
    args = (log_probs, labels, logit_lengths, label_lengths)
    if on_cpu(*args):
        return ctc_forward_alphas(*args)
    lib = _check_args(*args)
    b, t, v = log_probs.shape
    u = labels.shape[1]
    alphas = torch.empty((b, t, 2 * u + 1), dtype=torch.float32,
                         device=log_probs.device)
    nll = torch.empty((b,), dtype=torch.float32, device=log_probs.device)
    err = lib.nsp_ctc_alpha_f32(*(x.data_ptr() for x in (*args, alphas, nll)),
                                b, t, v, u, stream_of(log_probs))
    raise_on_error("ctc_loss", err)
    ctc_loss_fwd.launches += 1
    return nll, alphas


def ctc_loss_bwd(log_probs, labels, logit_lengths, label_lengths, nll,
                 alphas, g):
    """Dense gradient [B, T, V]; dispatch as ``ctc_loss_fwd``. Counts in
    ``ctc_loss_bwd.launches``."""
    args = (log_probs, labels, logit_lengths, label_lengths)
    if on_cpu(*args, nll, alphas, g):
        return ctc_loss_bwd_ref(*args, nll, alphas, g)
    lib = _check_args(*args)
    b, t, v = log_probs.shape
    u = labels.shape[1]
    check("nll", nll, (b,))
    check("alphas", alphas, (b, t, 2 * u + 1))
    g = g.contiguous()
    check("g", g, (b,))
    grad = torch.zeros_like(log_probs)
    # per frame: each of the 8 warps' sum of the blanks' occupancies, and
    # the repeated labels' occupancies
    scratch = torch.empty((b, t, 8 + u), dtype=torch.float32,
                          device=log_probs.device)
    err = lib.nsp_ctc_beta_grad_f32(
        *(x.data_ptr() for x in (*args, alphas, nll, g, grad, scratch)),
        b, t, v, u, stream_of(log_probs))
    raise_on_error("ctc_loss_bwd", err)
    ctc_loss_bwd.launches += 1
    return grad


ctc_loss_fwd.launches = 0
ctc_loss_bwd.launches = 0


class CTCNll(torch.autograd.Function):
    """Per-utterance CTC negative log-likelihood [B], differentiable in the
    log-probs (``_ctc_nll_fb``)."""

    @staticmethod
    def forward(ctx, log_probs, labels, logit_lengths, label_lengths):
        nll, alphas = ctc_loss_fwd(log_probs, labels, logit_lengths,
                                   label_lengths)
        ctx.save_for_backward(log_probs, labels, logit_lengths,
                              label_lengths, nll, alphas)
        return nll

    @staticmethod
    def backward(ctx, g):
        grad = ctc_loss_bwd(*ctx.saved_tensors, g)
        return grad, None, None, None


def ctc_nll(log_probs, labels, logit_lengths, label_lengths):
    return CTCNll.apply(log_probs, labels, logit_lengths, label_lengths)
