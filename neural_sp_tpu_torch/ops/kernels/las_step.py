"""K2: one LAS decode step, LSTM layer 0 + location attention (CUDA C++,
``sm_90a``).

Replaces the TPU kernel ``_fwd_kernel`` of
``neural_sp_tpu/ops/las_scan_pallas.py`` (deleted in 63255ae; read it with
``git show 63255ae~1:neural_sp_tpu/ops/las_scan_pallas.py``), reached there
through ``_fwd``, in its one-step decode form: U = 1 and N rows = beam x
utterances, forward only. As there, the embedding half of the layer-0
gates (``eg = emb W_emb``) comes in precomputed; everything else of the
step happens in the kernel: ``ctx_prev W_ctx + h_prev W_h + b``, the LSTM
cell (gates i, f, g, o), the query ``h W_q``, the width-K SAME
cross-correlation of ``aw_prev`` (flax ``nn.Conv``; left pad ``(K-1)//2``),
``loc W_f``, ``e = v . tanh(kc + q + f)``, the masked float32 softmax and
``ctx = aw values``.

On the H100 a decode step is a batch-N GEMV, bound by bytes: the gate
weights ((D + H) x 4H floats) and each row's keys and values. The design
reads every gate weight once per step (split-K, all rows of a block held in
registers) and spreads the attention over blocks of (16 frames,
hypothesis) and (32 context columns, hypothesis), so that ten hypotheses
still keep the card's 132 SMs reading. Source: ``csrc/las_step.cu``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..masks import apply_mask_logits
from ._checks import check, on_cpu, raise_on_error, stream_of
from .build import load_library
from .roofline import valid_lengths

SMEM_LIMIT = 232448   # bytes of shared memory one block may use on sm_90
GATE_SPLIT = 128      # reduction rows per block of the gate GEMV (kGateK)


def location_features(aw_prev, conv_w):
    """Width-K SAME cross-correlation of aw_prev [N, T] with conv_w [C, K]
    (flax ``nn.Conv``: left pad (K-1)//2) -> [N, T, C]."""
    k = conv_w.shape[-1]
    left = (k - 1) // 2
    aw_pad = F.pad(aw_prev, (left, k - 1 - left))
    return F.conv1d(aw_pad[:, None], conv_w[:, None]).transpose(1, 2)


def attend_ref(query, aw_prev, w_q, conv_w, w_f, v, kc, values, klens):
    """Location attention of one step from the query [N, H]. Returns
    (q = query W_q^T [N, A], aw [N, T], ctx [N, D])."""
    q = query @ w_q.t()
    loc = location_features(aw_prev, conv_w)
    e = torch.tanh(kc + q[:, None] + loc @ w_f.t()) @ v          # [N, T]
    valid = (torch.arange(e.shape[1], device=e.device)[None]
             < klens.to(e.device)[:, None])
    aw = torch.softmax(apply_mask_logits(e, valid), dim=-1)
    return q, aw, torch.bmm(aw[:, None], values)[:, 0]


def las_step_ref(eg, ctx_prev, h_prev, c_prev, aw_prev, w_ctx, w_h, bias,
                 w_q, conv_w, w_f, v, kc, values, klens):
    """Plain PyTorch twin of the kernel. Shapes: eg [N, 4H], ctx_prev
    [N, D], h_prev / c_prev [N, H], aw_prev [N, T], w_ctx [D, 4H], w_h
    [H, 4H], bias [4H], w_q [A, H], conv_w [C, K], w_f [A, C], v [A], kc
    [N, T, A], values [N, T, D], klens [N] int. Returns (h, c, aw, ctx)."""
    y = eg + ctx_prev @ w_ctx + h_prev @ w_h + bias
    i, f, g, o = y.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    _, aw, ctx = attend_ref(h, aw_prev, w_q, conv_w, w_f, v, kc, values,
                            klens)
    return h, c, aw, ctx


def attend_flops(t_valid, hd, d, a, ch, k) -> int:
    """Flops of one step's attention over ``t_valid`` valid frames in all
    (the query h W_q^T is counted per row by the caller): the location
    conv, loc W_f^T, v . tanh(...) and aw values."""
    return 2 * t_valid * (ch * k + a * ch + a + d)


def las_step_cost(n, t, hd, d, a, ch, k, klens) -> tuple[int, int]:
    """(flops, bytes) of one decode step over N rows: the gate GEMV
    [ctx, h] (D + H) x 4H, the query H x A, and the attention over each
    row's valid frames. Reads the weights once, each row's state and its
    valid keys and values; writes h, c, aw, ctx."""
    tv = sum(valid_lengths(klens, t))
    flops = 2 * n * ((d + hd) * 4 * hd + hd * a) + \
        attend_flops(tv, hd, d, a, ch, k)
    weights = (d + hd) * 4 * hd + 4 * hd + a * hd + ch * k + a * ch + a
    rows = n * (4 * hd + d + 2 * hd + t + 1) + tv * (a + d)
    return flops, 4 * (weights + rows + n * (2 * hd + t + d))


def las_step(eg, ctx_prev, h_prev, c_prev, aw_prev, w_ctx, w_h, bias,
             w_q, conv_w, w_f, v, kc, values, klens):
    """One decode step; arguments as ``las_step_ref``. CPU tensors take
    the twin; CUDA tensors launch the kernel (float32, contiguous) or
    raise. Every launch adds one to ``las_step.launches``."""
    args = (eg, ctx_prev, h_prev, c_prev, aw_prev, w_ctx, w_h, bias, w_q,
            conv_w, w_f, v, kc, values, klens)
    if on_cpu(*args):
        return las_step_ref(*args)
    n, t = aw_prev.shape
    hdim, d = h_prev.shape[1], ctx_prev.shape[1]
    a, (c_ch, k) = w_q.shape[0], conv_w.shape
    shapes = {"eg": (n, 4 * hdim), "ctx_prev": (n, d), "h_prev": (n, hdim),
              "c_prev": (n, hdim), "aw_prev": (n, t), "w_ctx": (d, 4 * hdim),
              "w_h": (hdim, 4 * hdim), "bias": (4 * hdim,), "w_q": (a, hdim),
              "conv_w": (c_ch, k), "w_f": (a, c_ch), "v": (a,),
              "kc": (n, t, a), "values": (n, t, d)}
    for (name, shape), x in zip(shapes.items(), args):
        check(name, x, shape)
    check("klens", klens, (n,), torch.int32)
    lib = load_library()
    smem = lib.nsp_las_step_smem_bytes(t, hdim, a, c_ch, k)
    if smem > SMEM_LIMIT:
        raise ValueError(f"las_step: {t} frames need {smem} bytes of shared "
                         f"memory per block, more than {SMEM_LIMIT}")
    n_split = -(-(d + hdim) // GATE_SPLIT)
    partial = torch.empty((n_split, n, 4 * hdim), dtype=torch.float32,
                          device=eg.device)
    q = torch.empty((n, a), dtype=torch.float32, device=eg.device)
    e = torch.empty_like(aw_prev)
    h = torch.empty_like(h_prev)
    c = torch.empty_like(c_prev)
    aw = torch.empty_like(aw_prev)
    ctx = torch.empty_like(ctx_prev)
    err = lib.nsp_las_step_f32(
        *(x.data_ptr() for x in (*args, partial, q, e, h, c, aw, ctx)),
        n, t, hdim, d, a, c_ch, k, stream_of(eg))
    raise_on_error("las_step", err)
    las_step.launches += 1
    return h, c, aw, ctx


las_step.launches = 0
