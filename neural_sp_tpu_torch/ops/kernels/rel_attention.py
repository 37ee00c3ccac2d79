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
[T, T] block is stored. Source: ``csrc/rel_attention_bwd.cu`` (the bf16
entry ``csrc/rel_attention_bwd_bf16.cu``, each compiled apart).
``RelAttention`` is the ``autograd.Function`` joining the two.

Both kernels have a bfloat16 entry too (``nsp_rel_attention_bf16``,
``nsp_rel_attention_bwd_bf16``), which the wrappers take when q is bf16:
one ``mma.sync m16n8k16`` bf16 product per 16-deep slice, float32
accumulation, the scores and the softmax in float32, and the TPU kernel's
rounding points: P normalised, then rounded to bf16 before P v
(``aws.astype(q.dtype)``; the forward sweeps the keys three times: the
row max, the sum of the exponentials at that max, then P v), and P and ds
before the dv, dq and dk products
(``aws_lp`` / ``ds_lp``).
o, dq, dk, dv and dp come out in the inputs' type; the row statistics m
and l stay float32. The plain versions round at the same points when
given bf16, and run float32 throughout when given float32.

A window on the keys (the streaming encoders' masks, passed as three
integers, never as a [T, T] tensor): ``window = (n_l, n_c, n_r)`` lets
query i attend key j iff j < klens[b], j < (i // n_c + 1) n_c + n_r and,
when n_l >= 0, j >= (i // n_c) n_c - n_l (``ops.masks.window_mask``, the
plain versions' mask; ``make_chunkwise_san_mask``); ``masks.CAUSAL =
(-1, 1, 0)`` is ``causal_mask``. A row with no allowed key gets uniform
weights over all Tk keys, as the masked softmax of the JAX module (every
score finfo.min / 2). The forward also takes fewer queries
than keys (a streaming block against cached keys): query i then sits at
position i + Tk - Tq among the keys, its relative distance to key j is
|i + Tk - Tq - j|, and keys below ``key_start`` are masked (the cache's
empty slots). The backward takes fewer queries than keys too (the
Transformer-XL's segment against its memory), but no ``key_start``.

Dropout of the attention probabilities (the Transformer-XL's
``dropout_att``): ``dropout = (rate, (k0, k1))`` drops P[b, h, i, j] where
the counter hash of ``ops.dropout.fast_uniform`` at the row-major index
((b H + h) Tq + i) Tk + j under the key words (k0, k1) is not below 1 -
rate, and scales the kept ones by 1 / (1 - rate), before P v, as the JAX
module's ``Dropout`` on its attention weights (the same bits given the same
key words). The kernels hash each element where they need it, so no mask
reaches device memory; the row statistics m and l stay those of the
undropped P. With M the mask scaled by 1 / (1 - rate), the backward is
dP = (dO v^T) M, dv = (P M)^T dO and ds = P (dP - D), D = rowsum(dO o)
unchanged. The bf16 entries take it too, each in an instantiation of its
own: P normalised and rounded to bf16, then dropped (and rounded again as
P v's operand), as the plain bf16 version; dv = (P M)^T dO from the
rounded P, ds = P (dP - D) from the unrounded one.

Head widths: the kernels are instantiated at dk 16, 32 and 64. A narrower
head (the ``ci_test`` conformer's d_model 8 over 4 heads: dk 2) is
zero-padded to 16 along the head width before the launch and its
outputs and gradients sliced back: a zero column adds 0 to every q k^T
and gives a zero column of o, dq, dk and dv, so the kernel computes the
same function. Other widths raise.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..dropout import fast_uniform
from ..masks import apply_mask_logits, window_mask
from ._checks import check, on_cpu, raise_on_error, stream_of
from .build import load_library
from .roofline import valid_lengths


def rel_attention_ref(q, k, v, p, klens, window=None, key_start=0,
                      dropout=None):
    """Plain PyTorch twin of the kernel, the CPU path and the reference on
    the card. q: [B, H, Tq, dk]; k, v: [B, H, Tk, dk] (Tq <= Tk); p:
    [B, H, Tq, R]; klens: [B] int; ``window`` (n_l, n_c, n_r) or None,
    ``key_start`` and ``dropout`` (rate, key words) or None as the module
    docstring says. Returns o [B, H, Tq, dk] in q's type. Scores and
    softmax in float32 (or wider); for bf16 inputs P is rounded to bf16
    before P v (and again after its dropout), as the JAX module."""
    prob = torch.softmax(_scores(q, k, p, klens, window, key_start), dim=-1)
    prob = _rounded(prob, q)
    if dropout is not None:
        prob = _rounded(_dropped(prob, dropout), q)
    return torch.matmul(prob, _wide(v)).to(q.dtype)


def attention_keep(dropout, shape, device=None) -> torch.Tensor:
    """The keep mask (bool, ``shape`` = [B, H, Tq, Tk]) of ``dropout`` =
    (rate, (k0, k1)): the counter hash of ``ops.dropout.fast_uniform`` at
    each element's row-major index below 1 - rate, as the JAX ``Dropout``
    draws it (``fast_bernoulli``)."""
    rate, key = dropout
    return fast_uniform(key, shape, device) < 1.0 - rate


def _dropped(x, dropout):
    """where(keep, x / (1 - rate), 0) over [B, H, Tq, Tk] x."""
    keep = attention_keep(dropout, x.shape, x.device)
    return torch.where(keep, x / (1.0 - dropout[0]), torch.zeros_like(x))


def rel_attention_stats_ref(q, k, p, klens, window=None, key_start=0):
    """Row statistics of the masked scores the forward saves for the
    backward: (m [B, H, Tq] row max, l [B, H, Tq] sum of exp(s - m)), in
    float32 (or wider)."""
    s = _scores(q, k, p, klens, window, key_start)
    m = s.amax(-1)
    return m, torch.exp(s - m[..., None]).sum(-1)


def _wide(x):
    """x in at least float32 (bf16 widened; float32 and float64 as they
    are)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _rounded(x, like):
    """x rounded to like's type and widened back (a no-op when like is at
    least float32)."""
    return x.to(like.dtype).to(x.dtype)


def _scores(q, k, p, klens, window=None, key_start=0):
    """The masked scores in at least float32 (for bf16 inputs the products
    exact, as the tensor cores form them, summed in float32)."""
    tq, tk = q.shape[2], k.shape[2]
    s = torch.matmul(_wide(q), _wide(k).transpose(-1, -2))
    idx = _buckets(tq, tk, p.shape[-1], q.device)
    s = s + torch.gather(_wide(p), -1, idx.expand(*p.shape[:2], tq, tk))
    return apply_mask_logits(
        s, window_mask(klens, tq, tk, window, key_start, q.device)[:, None])


def _buckets(tq, tk, r, device):
    """[Tq, Tk] rows of p that (query i, key j) reads: min(|i + Tk - Tq -
    j|, R - 1)."""
    i = torch.arange(tq, device=device) + (tk - tq)
    j = torch.arange(tk, device=device)
    return (i[:, None] - j[None, :]).abs().clamp(max=r - 1)


def key_ranges(klens, tq, tk, window=None, key_start=0):
    """Per batch row, the [Tq] (lo, hi) bounds of each query's allowed
    keys as numpy int arrays (empty when lo >= hi): what the kernels
    compute per row."""
    i = np.arange(tq) + (tk - tq)
    out = []
    for n in klens:
        lo = np.full(tq, key_start)
        hi = np.full(tq, min(int(n), tk))
        if window is not None:
            n_l, n_c, n_r = window
            c = i // n_c
            hi = np.minimum(hi, (c + 1) * n_c + n_r)
            if n_l >= 0:
                lo = np.maximum(lo, c * n_c - n_l)
        out.append((lo, hi))
    return out


def rel_attention_bwd_ref(q, k, v, p, klens, o, m, l, do, window=None,
                          dropout=None):
    """Plain PyTorch version of the backward kernel K1b, the adjoint written
    out (not autograd): P = exp(s - m) / l; with ``dropout`` the scaled keep
    mask M (1 / (1 - rate) where kept, 0 where dropped; else M = 1); D =
    sum(do * o); dP = (do v^T) M; ds = P (dP - D) on allowed keys, 0 on
    masked ones (the masked ``where`` passes no gradient); dq = ds k, dk =
    ds^T q, dv = (P M)^T do, dp[i, r] = sum of ds[i, j] over min(|i + Tk -
    Tq - j|, R-1) = r. Tq <= Tk (query i at key position i + Tk - Tq, as
    the forward), no ``key_start``. Everything in at least float32; for
    bf16 inputs P and ds are rounded to bf16 before their products, as the
    kernel. Returns (dq, dk, dv, dp) in the inputs' type."""
    tq, tk = q.shape[2], k.shape[2]
    s = _scores(q, k, p, klens, window)
    prob = torch.exp(s - m[..., None]) / l[..., None]
    do_, k_, q_ = _wide(do), _wide(k), _wide(q)
    delta = (do_ * _wide(o)).sum(-1, keepdim=True)
    dpv = torch.matmul(do_, _wide(v).transpose(-1, -2))
    prob_v = _rounded(prob, q)
    if dropout is not None:
        dpv = _dropped(dpv, dropout)
        prob_v = _rounded(_dropped(prob_v, dropout), q)
    ds = prob * (dpv - delta)
    ds = torch.where(window_mask(klens, tq, tk, window, 0, q.device)[:, None],
                     ds, torch.zeros_like(ds))
    ds_lp = _rounded(ds, q)
    dq = torch.matmul(ds_lp, k_)
    dk = torch.matmul(ds_lp.transpose(-1, -2), q_)
    dv = torch.matmul(prob_v.transpose(-1, -2), do_)
    idx = _buckets(tq, tk, p.shape[-1], q.device)
    dp = torch.zeros(p.shape, dtype=ds.dtype, device=p.device).scatter_add_(
        -1, idx.expand(*p.shape[:2], tq, tk), ds)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), dp.to(p.dtype)


def _pairs(klens, tq, tk, window, key_start):
    """Summed over the batch: (query-key pairs of allowed keys, rows with
    no allowed key, keys some row allows, and the value rows the forward
    reads: those keys, or all Tk in a batch row where some query has
    none)."""
    pairs = empty = union = v_rows = 0
    for lo, hi in key_ranges(valid_lengths(klens, tk), tq, tk, window,
                             key_start):
        n = (hi - lo).clip(min=0)
        pairs += int(n.sum())
        empty += int((n == 0).sum())
        cover = np.zeros(tk + 1, np.int64)
        np.add.at(cover, lo[n > 0], 1)
        np.add.at(cover, hi[n > 0], -1)
        keys = int((np.cumsum(cover)[:tk] > 0).sum())
        union += keys
        v_rows += tk if (n == 0).any() else keys
    return pairs, empty, union, v_rows


def rel_attention_cost(b, h, t, dk, r, klens, elem: int = 4, window=None,
                       tk=None, key_start=0) -> tuple[int, int]:
    """(flops, bytes) the forward needs: the two products q k^T and P v
    (2 dk flops per query-key pair each) over each row's allowed keys (for
    a row with none, P v alone over all Tk keys); q, p, o for every row
    and k and v for the keys read, ``elem`` bytes each (4 float32, 2
    bf16); m and l float32 (4 bytes), klens int32. t is Tq; ``tk`` the keys
    (t when None)."""
    tk = t if tk is None else tk
    pairs, empty, union, v_rows = _pairs(klens, t, tk, window, key_start)
    flops = (4 * pairs + 2 * empty * tk) * h * dk
    return flops, elem * (2 * b * h * t * dk + h * dk * (union + v_rows)
                          + b * h * t * r) + 4 * (2 * b * h * t + b)


def rel_attention_bwd_cost(b, h, t, dk, r, klens, elem: int = 4,
                           window=None, tk=None) -> tuple[int, int]:
    """(flops, bytes) the backward needs: five products over each row's
    allowed keys (s = q k^T, dP = dO v^T, dv = P^T dO, dq = ds k, dk = ds^T
    q); for a row with none only dv = P^T dO over all Tk. Reads q, p, o,
    dO and the keys' k, v and writes dq, dp (Tq rows) and dk, dv (Tk rows),
    ``elem`` bytes each; reads m, l (float32) and klens. t
    is Tq; ``tk`` the keys (t when None). A dropout mask is hashed where it
    is used: it moves no byte, and its hash is not counted."""
    tk = t if tk is None else tk
    pairs, empty, union, _ = _pairs(klens, t, tk, window, 0)
    flops = (10 * pairs + 2 * empty * tk) * h * dk
    return flops, elem * (3 * b * h * t * dk + 2 * h * dk * union
                          + b * h * t * r + b * h * t * dk
                          + 2 * b * h * tk * dk + b * h * t * r) \
        + 4 * (2 * b * h * t + b)


# the kernels' element types: float32 (3xTF32 products) and bf16
_ENTRIES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check(q, k, v, p, klens) -> str:
    """Checks the arguments; returns the entry's suffix for q's type."""
    b, h, tq, dk = q.shape
    tk, r = k.shape[2], p.shape[-1]
    if q.dtype not in _ENTRIES:
        raise TypeError(f"rel_attention: dtype {q.dtype}, the kernels take "
                        f"{sorted(map(str, _ENTRIES))}")
    check("q", q, (b, h, tq, dk), q.dtype)
    for name, x in (("k", k), ("v", v)):
        check(name, x, (b, h, tk, dk), q.dtype)
    check("p", p, (b, h, tq, r), q.dtype)
    check("klens", klens, (b,), torch.int32)
    if dk not in (16, 32, 64):
        raise ValueError(f"rel_attention: head width {dk} not in (16, 32, 64)")
    if tq > tk:
        raise ValueError(f"rel_attention: {tq} queries past {tk} keys")
    return _ENTRIES[q.dtype]


def _window_args(window, key_start: int) -> tuple[int, int, int, int]:
    """(n_c, n_l, n_r, key_start) as the kernels take them; n_c = 0: no
    window."""
    if window is None:
        return 0, -1, 0, key_start
    n_l, n_c, n_r = (int(x) for x in window)
    if n_c < 1 or n_r < 0:
        raise ValueError(f"rel_attention: window {window}")
    return n_c, n_l, n_r, key_start


def _drop_args(dropout) -> tuple[float, int, int]:
    """(keep = 1 - rate, k0, k1) as the entries take them (keep is passed
    as a float32, the threshold JAX compares against); keep 1: no
    dropout."""
    if dropout is None:
        return 1.0, 0, 0
    rate, (k0, k1) = dropout
    if not 0.0 < rate < 1.0:
        raise ValueError(f"rel_attention: dropout rate {rate} outside (0, 1)")
    return 1.0 - float(rate), int(k0) & 0xFFFFFFFF, int(k1) & 0xFFFFFFFF


def _pair_scratch(x):
    """Scratch for two operands of x's shape split into TF32 (hi, lo) pairs:
    [2, .., dk, 2] (the float32 entries only)."""
    return torch.empty((2, *x.shape, 2), dtype=torch.float32, device=x.device)


def _check_aligned(*tensors):
    """The kernels copy [.., dk] rows in 16-byte pieces (cp.async)."""
    if sum(x.data_ptr() % 16 for x in tensors):
        raise ValueError("rel_attention: the kernel takes 16-byte aligned "
                         "q, k, v, dO")


# head widths below this are zero-padded to it before a launch
PAD_DK = 16


def _pad_heads(x):
    """x [.., dk] zero-padded to [.., PAD_DK]."""
    return F.pad(x, (0, PAD_DK - x.shape[-1])).contiguous()


def rel_attention_fwd(q, k, v, p, klens, window=None, key_start=0,
                      dropout=None):
    """(o, m, l): the output (q's type) and the float32 row statistics (see
    ``rel_attention_stats_ref``; with ``dropout`` those of the undropped
    P). CPU tensors take the plain versions; CUDA tensors launch K1's
    float32 or bf16 entry, by q's type (contiguous, every floating argument
    of that type), or raise. Every launch adds one to
    ``rel_attention.launches`` (float32) or ``.launches_bf16``, and a
    launch with a window also to ``rel_attention.launches_window``, one
    with dropout to ``.launches_dropout`` (float32) or
    ``.launches_bf16_dropout`` (each its own instantiation) and one with
    fewer queries than keys and no dropout to ``.launches_offset``.
    A head width below 16 is padded to 16 (the module docstring) and
    counted in ``.launches_padded`` too."""
    if on_cpu(q, k, v, p, klens):
        return (rel_attention_ref(q, k, v, p, klens, window, key_start,
                                  dropout),
                *rel_attention_stats_ref(q, k, p, klens, window, key_start))
    dk = q.shape[-1]
    if dk < PAD_DK:
        o, m, l = rel_attention_fwd(*map(_pad_heads, (q, k, v)), p, klens,
                                    window, key_start, dropout)
        rel_attention.launches_padded += 1
        return o[..., :dk].contiguous(), m, l
    entry = _check(q, k, v, p, klens)
    _check_aligned(q, k, v)
    b, h, tq, dk = q.shape
    tk = k.shape[2]
    win = _window_args(window, key_start)
    o = torch.empty_like(q)
    m = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    lib = load_library()
    if entry == "bf16":
        err = lib.nsp_rel_attention_bf16(
            *(x.data_ptr() for x in (q, k, v, p, klens, o, m, l)),
            b, h, tq, tk, p.shape[-1], dk, *win, *_drop_args(dropout),
            stream_of(q))
    else:
        err = lib.nsp_rel_attention_f32(
            *(x.data_ptr() for x in (q, k, v, p, klens, o, m, l,
                                     _pair_scratch(k))),
            b, h, tq, tk, p.shape[-1], dk, *win, *_drop_args(dropout),
            stream_of(q))
    raise_on_error(f"rel_attention ({entry})", err)
    _count(rel_attention, entry, window, dropout, tq < tk)
    return o, m, l


def rel_attention_bwd(q, k, v, p, klens, o, m, l, do, window=None,
                      dropout=None):
    """(dq, dk, dv, dp) in the inputs' type, for Tq <= Tk. CPU tensors take
    ``rel_attention_bwd_ref``; CUDA tensors launch K1b's float32 or bf16
    entry, by q's type, or raise. Every launch adds one to
    ``rel_attention_bwd.launches`` (float32) or ``.launches_bf16``, one
    with a window also to ``.launches_window``, one with dropout to
    ``.launches_dropout`` (float32) or ``.launches_bf16_dropout`` and one
    with fewer queries than keys and no dropout to ``.launches_offset``; a
    head width below 16 is padded, as the forward's, and counted in
    ``.launches_padded`` too."""
    if on_cpu(q, k, v, p, klens, o, m, l, do):
        return rel_attention_bwd_ref(q, k, v, p, klens, o, m, l, do, window,
                                     dropout)
    dk = q.shape[-1]
    if dk < PAD_DK:
        q, k, v, o, do = map(_pad_heads, (q, k, v, o, do))
        grads = rel_attention_bwd(q, k, v, p, klens, o, m, l, do, window,
                                  dropout)
        rel_attention_bwd.launches_padded += 1
        return (*(g[..., :dk].contiguous() for g in grads[:3]), grads[3])
    entry = _check(q, k, v, p, klens)
    b, h, tq, dk = q.shape
    tk = k.shape[2]
    r = p.shape[-1]
    do = do.contiguous()
    check("o", o, q.shape, q.dtype)
    check("do", do, q.shape, q.dtype)
    check("m", m, (b, h, tq))
    check("l", l, (b, h, tq))
    _check_aligned(q, k, v, do)
    win = _window_args(window, 0)[:3]
    dq, dk_, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dp = torch.empty_like(p)
    delta = torch.empty_like(m)
    lib = load_library()
    if entry == "bf16":
        # dp's bucket sums in float32: in shared memory when R <= 16, else
        # in this scratch
        dp32 = torch.empty((b, h, tq, r) if r > SMEM_R else (0,),
                           dtype=torch.float32, device=q.device)
        err = lib.nsp_rel_attention_bwd_bf16(
            *(x.data_ptr() for x in (q, k, v, p, klens, o, m, l, do, dq, dk_,
                                     dv, dp, dp32, delta)),
            b, h, tq, tk, r, dk, *win, *_drop_args(dropout), stream_of(q))
    else:
        # k, v split first, then q, dO, through one scratch: Tk >= Tq rows
        err = lib.nsp_rel_attention_bwd_f32(
            *(x.data_ptr() for x in (q, k, v, p, klens, o, m, l, do, dq, dk_,
                                     dv, dp, delta, _pair_scratch(k))),
            b, h, tq, tk, r, dk, *win, *_drop_args(dropout), stream_of(q))
    raise_on_error(f"rel_attention_bwd ({entry})", err)
    _count(rel_attention_bwd, entry, window, dropout, tq < tk)
    return dq, dk_, dv, dp


def _count(wrapper, entry: str, window, dropout, offset: bool) -> None:
    """One launch of ``wrapper``'s ``entry`` in its counters (see
    ``rel_attention_fwd``)."""
    bf16 = entry == "bf16"
    if bf16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1
    if window is not None:
        wrapper.launches_window += 1
    if dropout is not None:
        if bf16:
            wrapper.launches_bf16_dropout += 1
        else:
            wrapper.launches_dropout += 1
    elif offset:
        wrapper.launches_offset += 1


class RelAttention(torch.autograd.Function):
    """K1 forward, K1b backward; gradients for q, k, v and p."""

    @staticmethod
    def forward(ctx, q, k, v, p, klens, window, key_start, dropout):
        o, m, l = rel_attention_fwd(q, k, v, p, klens, window, key_start,
                                    dropout)
        ctx.save_for_backward(q, k, v, p, klens, o, m, l)
        ctx.window, ctx.key_start, ctx.dropout = window, key_start, dropout
        return o

    @staticmethod
    def backward(ctx, do):
        if ctx.key_start != 0:
            raise NotImplementedError(
                "rel_attention: no backward against cached keys with "
                "masked slots (key_start > 0: streaming inference only)")
        return (*rel_attention_bwd(*ctx.saved_tensors, do, ctx.window,
                                   ctx.dropout),
                None, None, None, None)


def rel_attention(q, k, v, p, klens, window=None, key_start=0,
                  dropout=None):
    """o = softmax(q k^T + p[..., min(|i + Tk - Tq - j|, R-1)], keys outside
    the window, at or past klens or below ``key_start`` masked), dropped by
    ``dropout`` = (rate, key words) when given, times v; differentiable in
    q, k, v and p (for ``key_start`` 0).

    CPU tensors take the plain versions (``rel_attention_ref`` forward,
    ``rel_attention_bwd_ref`` backward); CUDA tensors launch K1 / K1b
    (float32 or bf16 by q's type, contiguous) or raise. Launches are
    counted in ``rel_attention.launches`` and ``rel_attention_bwd.launches``
    (float32 entries) and in their ``launches_bf16``; those with a window
    in ``launches_window`` as well, those with dropout in
    ``launches_dropout`` (float32) or ``launches_bf16_dropout`` and those
    with fewer queries than keys and no dropout in ``launches_offset``."""
    return RelAttention.apply(q, k, v, p, klens, window, key_start, dropout)


# p rows a block keeps in shared memory (csrc/rel_attention_common.cuh's
# kSmemR)
SMEM_R = 16
rel_attention.launches = rel_attention.launches_bf16 = 0
rel_attention.launches_window = rel_attention.launches_offset = 0
rel_attention.launches_dropout = rel_attention.launches_padded = 0
rel_attention.launches_bf16_dropout = 0
rel_attention_bwd.launches = rel_attention_bwd.launches_bf16 = 0
rel_attention_bwd.launches_window = rel_attention_bwd.launches_offset = 0
rel_attention_bwd.launches_dropout = rel_attention_bwd.launches_padded = 0
rel_attention_bwd.launches_bf16_dropout = 0
