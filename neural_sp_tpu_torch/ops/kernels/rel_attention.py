"""K1: relative-position self-attention forward (CUDA C++, ``sm_90a``).

Replaces the TPU kernel ``_fwd_kernel`` of
``neural_sp_tpu/ops/rel_attention_pallas.py`` (deleted in 583dfc4; read it
with ``git show 583dfc4~1:neural_sp_tpu/ops/rel_attention_pallas.py``),
reached there through ``_call`` / ``_rel_attention_fwd``. Signature and
semantics are kept: ``q`` and ``p`` come pre-scaled by ``1/sqrt(dk)``, and
``R = clamp_len + 1`` (an unclamped table is ``R = T``).

On the H100 the score tile is bound by float32 arithmetic (O(T^2 dk)
multiply-adds against O(T dk) bytes per head). The kernel keeps scores in
registers and shared memory with an online softmax, so no [B, H, T, T]
tensor reaches device memory, builds the rel-PE bias in-kernel from the
[T, R] table, and skips key tiles past ``klens``. Source:
``csrc/rel_attention.cu``.
"""
from __future__ import annotations

import torch

from ..masks import apply_mask_logits
from ._checks import check, on_cpu, raise_on_error, stream_of
from .build import load_library


def rel_attention_ref(q, k, v, p, klens):
    """Plain PyTorch twin of the kernel, the CPU path and the reference on
    the card. q, k, v: [B, H, T, dk]; p: [B, H, T, R]; klens: [B] int.
    Returns o [B, H, T, dk]."""
    t, r = q.shape[2], p.shape[-1]
    s = torch.matmul(q, k.transpose(-1, -2))
    pos = torch.arange(t, device=q.device)
    idx = (pos[:, None] - pos[None, :]).abs().clamp(max=r - 1)
    s = s + torch.gather(p, -1, idx.expand(*p.shape[:2], t, t))
    valid = pos[None, :] < klens.to(pos.device)[:, None]            # [B, T]
    s = apply_mask_logits(s, valid[:, None, None, :])
    return torch.matmul(torch.softmax(s, dim=-1), v)


def rel_attention(q, k, v, p, klens):
    """o = softmax(q k^T + p[..., min(|i-j|, R-1)], keys >= klens masked) v.

    CPU tensors take the twin ``rel_attention_ref``; CUDA tensors launch
    the kernel (float32, contiguous) or raise. Every launch adds one to
    ``rel_attention.launches``."""
    if on_cpu(q, k, v, p, klens):
        return rel_attention_ref(q, k, v, p, klens)
    b, h, t, dk = q.shape
    r = p.shape[-1]
    for name, x in (("q", q), ("k", k), ("v", v)):
        check(name, x, (b, h, t, dk))
    check("p", p, (b, h, t, r))
    check("klens", klens, (b,), torch.int32)
    if dk not in (16, 32, 64):
        raise ValueError(f"rel_attention: head width {dk} not in (16, 32, 64)")
    o = torch.empty_like(q)
    err = load_library().nsp_rel_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        klens.data_ptr(), o.data_ptr(), b, h, t, r, dk, stream_of(q))
    raise_on_error("rel_attention", err)
    rel_attention.launches += 1
    return o


rel_attention.launches = 0
