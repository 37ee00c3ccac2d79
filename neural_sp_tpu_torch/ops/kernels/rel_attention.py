"""K1 / K1b: relative-position self-attention, forward and backward (CUDA
C++, ``sm_90a``).

Replaces the TPU kernel ``_fwd_kernel`` of
``neural_sp_tpu/ops/rel_attention_pallas.py`` (deleted in 583dfc4; read it
with ``git show 583dfc4~1:neural_sp_tpu/ops/rel_attention_pallas.py``),
reached there through ``_call`` / ``_rel_attention_fwd``. Signature and
semantics are kept: ``q`` and ``p`` come pre-scaled by ``1/sqrt(dk)``, and
``R = clamp_len + 1`` (an unclamped table is ``R = T``).

On the H100 the score tile is bound by arithmetic (O(T^2 dk) flops against
O(T dk) bytes per head). Both products run on the tensor cores at float32
accuracy (TF32 ``mma.sync`` with the 3xTF32 split), over 64-row query
tiles; k and v are split into TF32 (hi, lo) pairs once, in the wrapper's
scratch, and streamed in 32-key tiles by ``cp.async``. The scores stay in
registers with an online softmax, so no [B, H, T, T] tensor reaches device
memory, the rel-PE bias is formed in registers from the [T, R] table, and
key tiles past ``klens`` are skipped. Source: ``csrc/rel_attention.cu``.

The backward K1b replaces the TPU kernel ``_bwd_kernel`` of the same file
(reached through ``_call`` / ``_rel_attention_bwd``): two flash-style
passes from the forward's row statistics, query-major (D, dq, dp) then
key-major (dk, dv), deterministic, on the same tensor-core products; no
[T, T] block is stored. Source: ``csrc/rel_attention_bwd.cu``.
``RelAttention`` is the ``autograd.Function`` joining the two.
"""
from __future__ import annotations

import torch

from ..masks import apply_mask_logits
from ._checks import check, on_cpu, raise_on_error, stream_of
from .build import load_library
from .roofline import valid_lengths


def rel_attention_ref(q, k, v, p, klens):
    """Plain PyTorch twin of the kernel, the CPU path and the reference on
    the card. q, k, v: [B, H, T, dk]; p: [B, H, T, R]; klens: [B] int.
    Returns o [B, H, T, dk]."""
    return torch.matmul(torch.softmax(_scores(q, k, p, klens), dim=-1), v)


def rel_attention_stats_ref(q, k, p, klens):
    """Row statistics of the masked scores the forward saves for the
    backward: (m [B, H, T] row max, l [B, H, T] sum of exp(s - m))."""
    s = _scores(q, k, p, klens)
    m = s.amax(-1)
    return m, torch.exp(s - m[..., None]).sum(-1)


def _scores(q, k, p, klens):
    t, r = q.shape[2], p.shape[-1]
    s = torch.matmul(q, k.transpose(-1, -2))
    pos = torch.arange(t, device=q.device)
    idx = (pos[:, None] - pos[None, :]).abs().clamp(max=r - 1)
    s = s + torch.gather(p, -1, idx.expand(*p.shape[:2], t, t))
    return apply_mask_logits(s, _valid_keys(klens, t, q.device))


def _valid_keys(klens, t, device):
    pos = torch.arange(t, device=device)
    return (pos[None, :] < klens.to(device)[:, None])[:, None, None, :]


def rel_attention_bwd_ref(q, k, v, p, klens, o, m, l, do):
    """Plain PyTorch version of the backward kernel K1b, the adjoint written
    out (not autograd): P = exp(s - m) / l; D = sum(do * o); ds = P (do v^T
    - D) on valid keys, 0 on masked ones (the masked ``where`` passes no
    gradient); dq = ds k, dk = ds^T q, dv = P^T do, dp[i, r] = sum of ds[i,
    j] over min(|i-j|, R-1) = r. Returns (dq, dk, dv, dp)."""
    t, r = q.shape[2], p.shape[-1]
    s = _scores(q, k, p, klens)
    prob = torch.exp(s - m[..., None]) / l[..., None]
    delta = (do * o).sum(-1, keepdim=True)
    ds = prob * (torch.matmul(do, v.transpose(-1, -2)) - delta)
    ds = torch.where(_valid_keys(klens, t, q.device), ds,
                     torch.zeros_like(ds))
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    dv = torch.matmul(prob.transpose(-1, -2), do)
    pos = torch.arange(t, device=q.device)
    idx = (pos[:, None] - pos[None, :]).abs().clamp(max=r - 1)
    dp = torch.zeros_like(p).scatter_add_(
        -1, idx.expand(*p.shape[:2], t, t), ds)
    return dq, dk, dv, dp


def rel_attention_cost(b, h, t, dk, r, klens) -> tuple[int, int]:
    """(flops, bytes) the forward needs: the two products q k^T and P v
    (2 dk flops per query-key pair each) over the valid keys (with no valid
    key, P v alone over all T); q, p, o, m, l for every row; k and v for
    the keys read."""
    flops = kv_rows = 0
    for n in valid_lengths(klens, t):
        flops += (4 * n if n else 2 * t) * h * dk * t
        kv_rows += 2 * n if n else t
    return flops, 4 * (2 * b * h * t * dk + h * dk * kv_rows + b * h * t * r
                       + 2 * b * h * t + b)


def rel_attention_bwd_cost(b, h, t, dk, r, klens) -> tuple[int, int]:
    """(flops, bytes) the backward needs: five products over the valid
    keys (s = q k^T, dP = dO v^T, dv = P^T dO, dq = ds k, dk = ds^T q); with
    no valid key only dv = P^T dO over all T. Reads q, p, o, dO, m, l and
    the valid keys' k, v; writes dq, dk, dv, dp."""
    flops = kv_rows = 0
    for n in valid_lengths(klens, t):
        flops += (10 * n if n else 2 * t) * h * dk * t
        kv_rows += 2 * n
    return flops, 4 * (3 * b * h * t * dk + h * dk * kv_rows + b * h * t * r
                       + 2 * b * h * t + b + 3 * b * h * t * dk
                       + b * h * t * r)


def _check(q, k, v, p, klens):
    b, h, t, dk = q.shape
    r = p.shape[-1]
    for name, x in (("q", q), ("k", k), ("v", v)):
        check(name, x, (b, h, t, dk))
    check("p", p, (b, h, t, r))
    check("klens", klens, (b,), torch.int32)
    if dk not in (16, 32, 64):
        raise ValueError(f"rel_attention: head width {dk} not in (16, 32, 64)")


def _pair_scratch(x):
    """Scratch for two operands of x's shape split into TF32 (hi, lo) pairs:
    [2, .., dk, 2]."""
    return torch.empty((2, *x.shape, 2), dtype=torch.float32, device=x.device)


def _check_aligned(*tensors):
    """The kernels copy [.., dk] rows in 16-byte pieces (cp.async)."""
    if sum(x.data_ptr() % 16 for x in tensors):
        raise ValueError("rel_attention: the kernel takes 16-byte aligned "
                         "q, k, v, dO")


def rel_attention_fwd(q, k, v, p, klens):
    """(o, m, l): the output and the row statistics (see
    ``rel_attention_stats_ref``). CPU tensors take the plain versions; CUDA
    tensors launch K1 (float32, contiguous) or raise. Every launch adds one
    to ``rel_attention.launches``."""
    if on_cpu(q, k, v, p, klens):
        return (rel_attention_ref(q, k, v, p, klens),
                *rel_attention_stats_ref(q, k, p, klens))
    _check(q, k, v, p, klens)
    _check_aligned(q, k, v)
    b, h, t, dk = q.shape
    o = torch.empty_like(q)
    m = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    pairs = _pair_scratch(q)
    err = load_library().nsp_rel_attention_f32(
        *(x.data_ptr() for x in (q, k, v, p, klens, o, m, l, pairs)),
        b, h, t, p.shape[-1], dk, stream_of(q))
    raise_on_error("rel_attention", err)
    rel_attention.launches += 1
    return o, m, l


def rel_attention_bwd(q, k, v, p, klens, o, m, l, do):
    """(dq, dk, dv, dp). CPU tensors take ``rel_attention_bwd_ref``; CUDA
    tensors launch K1b or raise. Every launch adds one to
    ``rel_attention_bwd.launches``."""
    if on_cpu(q, k, v, p, klens, o, m, l, do):
        return rel_attention_bwd_ref(q, k, v, p, klens, o, m, l, do)
    _check(q, k, v, p, klens)
    b, h, t, dk = q.shape
    do = do.contiguous()
    check("o", o, q.shape)
    check("do", do, q.shape)
    check("m", m, (b, h, t))
    check("l", l, (b, h, t))
    _check_aligned(q, k, v, do)
    dq, dk_, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dp = torch.empty_like(p)
    delta = torch.empty_like(m)
    pairs = _pair_scratch(q)
    err = load_library().nsp_rel_attention_bwd_f32(
        *(x.data_ptr() for x in (q, k, v, p, klens, o, m, l, do, dq, dk_, dv,
                                 dp, delta, pairs)),
        b, h, t, p.shape[-1], dk, stream_of(q))
    raise_on_error("rel_attention_bwd", err)
    rel_attention_bwd.launches += 1
    return dq, dk_, dv, dp


class RelAttention(torch.autograd.Function):
    """K1 forward, K1b backward; gradients for q, k, v and p."""

    @staticmethod
    def forward(ctx, q, k, v, p, klens):
        o, m, l = rel_attention_fwd(q, k, v, p, klens)
        ctx.save_for_backward(q, k, v, p, klens, o, m, l)
        return o

    @staticmethod
    def backward(ctx, do):
        return (*rel_attention_bwd(*ctx.saved_tensors, do), None)


def rel_attention(q, k, v, p, klens):
    """o = softmax(q k^T + p[..., min(|i-j|, R-1)], keys >= klens masked) v,
    differentiable in q, k, v and p.

    CPU tensors take the plain versions (``rel_attention_ref`` forward,
    ``rel_attention_bwd_ref`` backward); CUDA tensors launch K1 / K1b
    (float32, contiguous) or raise. Launches are counted in
    ``rel_attention.launches`` and ``rel_attention_bwd.launches``."""
    return RelAttention.apply(q, k, v, p, klens)


rel_attention.launches = 0
rel_attention_bwd.launches = 0
