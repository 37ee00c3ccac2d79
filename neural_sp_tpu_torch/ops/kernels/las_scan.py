"""K3 / K3b: the teacher-forced LAS scan over U steps, LSTM layer 0 +
location attention, forward and backward (CUDA C++, ``sm_90a``).

Replaces the TPU kernels ``_fwd_kernel`` (its U-step form, reached through
``_fwd``) and ``_bwd_kernel`` (through ``_bwd``) of
``neural_sp_tpu/ops/las_scan_pallas.py`` (deleted in 63255ae; read it with
``git show 63255ae~1:neural_sp_tpu/ops/las_scan_pallas.py``). Per step t,
as in that file's docstring::

    y   = eg_t + ctx_{t-1} W_ctx + h_{t-1} W_h + b
    c_t, h_t = LSTM cell of y            (gate order i, f, g, o)
    hd  = h_t keep_t                     (dropout; the carry keeps h_t)
    loc = conv(aw_{t-1})                 (width K, SAME, cross-correlation)
    e   = v . tanh(kc + hd W_q^T + loc W_f^T);  aw = masked softmax(e)
    ctx = aw values

The forward K3 (``nsp_las_scan_f32`` in ``csrc/las_step.cu``) reuses K2's
device code from a host loop and keeps each step's gates, c, h, query,
weights and context. The backward K3b (``csrc/las_scan.cu``) walks the
steps in reverse, four kernels per step (``las_scan_bwd_chain``), and
streams dy, dq and each step's total context gradient out; the
step-invariant weight gradients (dW_h, dW_ctx, db, dW_q) and dvalues are
single products over all steps here (``las_scan_bwd_finish``), as the
Pallas ``_bwd`` reduced them outside its kernel.

K3, K3b and their plain PyTorch versions ``las_scan_ref`` and
``las_scan_bwd_ref`` (the adjoint written out, not autograd) work
time-major: every per-step tensor is [U, B, ...]. ``LASScan`` is the
``autograd.Function``: it takes and returns batch-major tensors, keeps
K3's time-major outputs for K3b as they are, and runs the plain versions
on CPU tensors, the kernels on CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._checks import check, on_cpu, raise_on_error, stream_of
from .build import load_library
from .las_step import (GATE_SPLIT, SMEM_LIMIT, attend_flops, attend_ref,
                       location_features)
from .roofline import valid_lengths

def las_scan_ref(eg, w_ctx, w_h, bias, w_q, conv_w, w_f, v, kc, values,
                 klens, keep):
    """Plain version of K3. eg [U, B, 4H] (the embedding half of the gates);
    weights as ``las_step_ref``; kc [B, T, A]; values [B, T, D]; klens [B];
    keep [U, B, H]. Returns (h, c, gates, q, aw, ctx), each [U, B, ...]:
    gates are the activations (i, f, g, o), q the queries hd W_q^T."""
    u, bs, g4 = eg.shape
    hdim, t = g4 // 4, kc.shape[1]
    h = eg.new_zeros((bs, hdim))
    c = eg.new_zeros((bs, hdim))
    aw = eg.new_zeros((bs, t))
    ctx = eg.new_zeros((bs, values.shape[-1]))
    outs = []
    for i in range(u):
        y = eg[i] + ctx @ w_ctx + h @ w_h + bias
        yi, yf, yg, yo = y.chunk(4, dim=-1)
        gates = torch.cat([torch.sigmoid(yi), torch.sigmoid(yf),
                           torch.tanh(yg), torch.sigmoid(yo)], -1)
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        c = gf * c + gi * gg
        h = go * torch.tanh(c)
        q, aw, ctx = attend_ref(h * keep[i], aw, w_q, conv_w, w_f, v, kc,
                                values, klens)
        outs.append((h, c, gates, q, aw, ctx))
    return tuple(torch.stack(x) for x in zip(*outs))


def _prev(x):
    """[U, B, ...] -> the same shifted one step later, zeros at step 0."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def _weight_grads(h, ctx, keep, dy, dq):
    """The step-invariant weight gradients from the streamed dy [U, B, 4H]
    and dq [U, B, A]: (dW_ctx, dW_h, db, dW_q)."""
    g4, a = dy.shape[-1], dq.shape[-1]
    dy2 = dy.reshape(-1, g4)
    d_w_h = _prev(h).reshape(-1, h.shape[-1]).t() @ dy2
    d_w_ctx = _prev(ctx).reshape(-1, ctx.shape[-1]).t() @ dy2
    d_w_q = dq.reshape(-1, a).t() @ (h * keep).reshape(-1, h.shape[-1])
    return d_w_ctx, d_w_h, dy2.sum(0), d_w_q


def las_scan_bwd_ref(w_ctx, w_h, w_q, conv_w, w_f, v, kc, values, klens,
                     keep, h, c, gates, q, aw, ctx, dh_out, dctx_out):
    """Plain version of K3b: the reverse-step adjoint written out. dh_out
    [U, B, H] and dctx_out [U, B, D] are the gradients w.r.t. K3's h (the
    undropped output) and ctx. Returns (d_eg [U, B, 4H], dW_ctx, dW_h, db,
    dW_q, dconv_w, dW_f, dv, dkc, dvalues)."""
    dy, dq, _, d_conv, d_w_f, d_v, dkc, dvalues = las_scan_bwd_steps_ref(
        w_ctx, w_h, w_q, conv_w, w_f, v, kc, values, klens, keep, h, c,
        gates, q, aw, ctx, dh_out, dctx_out)
    return (dy, *_weight_grads(h, ctx, keep, dy, dq), d_conv, d_w_f, d_v,
            dkc, dvalues)


def las_scan_bwd_steps_ref(w_ctx, w_h, w_q, conv_w, w_f, v, kc, values,
                           klens, keep, h, c, gates, q, aw, ctx, dh_out,
                           dctx_out):
    """The reverse-step loop of ``las_scan_bwd_ref``: the per-step dy [U, B,
    4H], dq [U, B, A] and total context gradient dctx [U, B, D], and the
    sums accumulated over the steps (dconv_w, dW_f, dv, dkc, dvalues)."""
    u, bs, hdim = h.shape
    t = kc.shape[1]
    ch, k = conv_w.shape
    left = (k - 1) // 2
    valid = torch.arange(t, device=kc.device)[None] < klens.to(kc.device)[:, None]
    dh_c = h.new_zeros((bs, hdim))
    dc_c = h.new_zeros((bs, hdim))
    dctx_c = h.new_zeros((bs, ctx.shape[-1]))
    daw_c = h.new_zeros((bs, t))
    dkc, dvalues = torch.zeros_like(kc), torch.zeros_like(values)
    d_v, d_w_f, d_conv = torch.zeros_like(v), torch.zeros_like(w_f), \
        torch.zeros_like(conv_w)
    dys, dqs, dctxs = [], [], []
    for i in range(u - 1, -1, -1):
        aw_t = aw[i]
        aw_prev = aw[i - 1] if i > 0 else torch.zeros_like(aw_t)
        # context and softmax
        dctx = dctx_out[i] + dctx_c
        daw = daw_c + torch.einsum("btd,bd->bt", values, dctx)
        dvalues += aw_t[:, :, None] * dctx[:, None, :]
        de = aw_t * (daw - (aw_t * daw).sum(-1, keepdim=True))
        de = torch.where(valid, de, torch.zeros_like(de))
        # energies: e = v . tanh(z), z = kc + q + loc W_f^T
        loc = location_features(aw_prev, conv_w)                 # [B, T, C]
        s = torch.tanh(kc + q[i][:, None] + loc @ w_f.t())
        d_v += torch.einsum("bt,bta->a", de, s)
        dz = de[:, :, None] * v * (1.0 - s * s)
        dkc += dz
        dq = dz.sum(1)                                           # [B, A]
        d_w_f += torch.einsum("bta,btc->ac", dz, loc)
        dloc = dz @ w_f                                          # [B, T, C]
        # location conv: loc[t, c] = sum_k aw_prev[t + k - left] conv[c, k]
        daw_pad = F.conv_transpose1d(dloc.transpose(1, 2),
                                     conv_w[:, None, :])[:, 0]   # [B, T+K-1]
        daw_c = daw_pad[:, left:left + t]
        aw_pad = F.pad(aw_prev, (left, k - 1 - left)).unfold(-1, k, 1)
        d_conv += torch.einsum("btc,btk->ck", dloc, aw_pad)
        # query from the dropped output, then the LSTM cell
        dh = dh_out[i] + (dq @ w_q) * keep[i] + dh_c
        gi, gf, gg, go = gates[i].chunk(4, dim=-1)
        tc = torch.tanh(c[i])
        dc = dc_c + dh * go * (1.0 - tc * tc)
        c_prev = c[i - 1] if i > 0 else torch.zeros_like(tc)
        dy = torch.cat([dc * gg * gi * (1 - gi), dc * c_prev * gf * (1 - gf),
                        dc * gi * (1 - gg * gg), dh * tc * go * (1 - go)], -1)
        dc_c = dc * gf
        dh_c = dy @ w_h.t()
        dctx_c = dy @ w_ctx.t()
        dys.append(dy)
        dqs.append(dq)
        dctxs.append(dctx)
    return (*(torch.stack(x[::-1]) for x in (dys, dqs, dctxs)), d_conv, d_w_f,
            d_v, dkc, dvalues)


def las_scan_cost(u, b, t, hd, d, a, ch, k, klens) -> tuple[int, int]:
    """(flops, bytes) of K3: U decode steps of B rows (``las_step_cost``'s
    products). Reads the weights, kc and values (valid frames) once and
    eg, keep per step; writes h, c, gates, q, aw, ctx per step."""
    tv = sum(valid_lengths(klens, t))
    flops = u * (2 * b * ((d + hd) * 4 * hd + hd * a)
                 + attend_flops(tv, hd, d, a, ch, k))
    weights = (d + hd) * 4 * hd + 4 * hd + a * hd + ch * k + a * ch + a
    ins = weights + tv * (a + d) + b + u * b * (4 * hd + hd)
    outs = u * b * (2 * hd + 4 * hd + a + t + d)
    return flops, 4 * (ins + outs)


def las_scan_bwd_cost(u, b, t, hd, d, a, ch, k, klens) -> tuple[int, int]:
    """(flops, bytes) of K3b with its weight-gradient matmuls. Per step:
    the recurrent adjoints dy W_h^T and dy W_ctx^T, dq W_q, the energy
    recomputed (location conv and loc W_f^T) and its adjoints (dW_f, dloc,
    the conv transpose, dconv, dv, dkc, daw, dvalues); over all steps
    dW_h, dW_ctx, dW_q. Reads the weights, kc and values (valid frames)
    once and K3's saved per-step tensors and the output gradients; writes
    every gradient."""
    tv = sum(valid_lengths(klens, t))
    per_step = 2 * b * (4 * hd * (hd + d) + a * hd) + \
        2 * tv * (3 * ch * k + 3 * a * ch + 2 * a + 2 * d)
    outside = 2 * u * b * (hd * 4 * hd + d * 4 * hd + a * hd)
    weights = (d + hd) * 4 * hd + a * hd + ch * k + a * ch + a
    ins = weights + tv * (a + d) + b + \
        u * b * (hd + 2 * hd + 4 * hd + a + t + d + hd + d)
    outs = u * b * 4 * hd + weights + 4 * hd + b * t * (a + d)
    return u * per_step + outside, 4 * (ins + outs)


def _check_shapes(b, u, hd, w_ctx, w_h, bias, w_q, conv_w, w_f, v, kc,
                  values, klens, keep):
    g4, t, a, d = 4 * hd, kc.shape[1], kc.shape[2], values.shape[2]
    ch, k = conv_w.shape
    want = {"w_ctx": (d, g4), "w_h": (hd, g4), "bias": (g4,),
            "w_q": (a, hd), "conv_w": (ch, k), "w_f": (a, ch), "v": (a,),
            "kc": (b, t, a), "values": (b, t, d), "keep": (u, b, hd)}
    for (name, shape), x in zip(want.items(), (w_ctx, w_h, bias, w_q, conv_w,
                                               w_f, v, kc, values, keep)):
        if x is not None:      # the backward takes no bias
            check(name, x, shape)
    check("klens", klens, (b,), torch.int32)
    lib = load_library()
    smem = max(lib.nsp_las_step_smem_bytes(t, hd, a, ch, k),
               lib.nsp_las_scan_bwd_smem_bytes(t, d, a, ch, k))
    if smem > SMEM_LIMIT:
        raise ValueError(f"las_scan: {t} frames need {smem} bytes of shared "
                         f"memory per block, more than {SMEM_LIMIT}")
    return lib, (u, b, t, hd, d, a, ch, k)


def las_scan(eg, w_ctx, w_h, bias, w_q, conv_w, w_f, v, kc, values, klens,
             keep):
    """K3: (h, c, gates, q, aw, ctx) as ``las_scan_ref``, time-major. CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (float32, contiguous, int32 klens) or raise. Counts in
    ``las_scan.launches``."""
    args = (eg, w_ctx, w_h, bias, w_q, conv_w, w_f, v, kc, values, klens,
            keep)
    if on_cpu(*args):
        return las_scan_ref(*args)
    u, b, g4 = eg.shape
    check("eg", eg, (u, b, g4))
    lib, dims = _check_shapes(b, u, g4 // 4, *args[1:])
    _, _, t, hd, d, a, _, _ = dims
    dev = eg.device

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    zeros = [torch.zeros(s, dtype=torch.float32, device=dev)
             for s in ((b, hd), (b, hd), (b, t), (b, d))]
    scratch = [out(-(-(d + hd) // GATE_SPLIT), b, 4 * hd), out(b, t)]
    outs = [out(u, b, hd), out(u, b, hd), out(u, b, 4 * hd), out(u, b, a),
            out(u, b, t), out(u, b, d)]
    err = lib.nsp_las_scan_f32(
        *(x.data_ptr() for x in (*args, *zeros, *scratch, *outs)), *dims,
        stream_of(eg))
    raise_on_error("las_scan", err)
    las_scan.launches += 1
    return tuple(outs)


def las_scan_bwd_finish(h, ctx, keep, aw, dy, dq, dctx, dkc, dconv_part,
                        dwf_part, dv_part):
    """K3b's work after its loop, plain tensor code: the step-invariant
    weight gradients from the streamed dy [U, B, 4H] and dq [U, B, A];
    dvalues = sum_t aw_t (x) dctx_t from each step's total context gradient
    dctx [U, B, D], one batched product (the loop's per-step ``dvalues +=``
    taken out of it); and the sums of the per-block partials [slots, ...]
    of dconv [C, K], dW_f (transposed: [C, A]) and dv [A]. Returns the
    gradients in ``las_scan_bwd_ref``'s order."""
    d_values = torch.einsum("ubt,ubd->btd", aw, dctx)
    return (dy, *_weight_grads(h, ctx, keep, dy, dq), dconv_part.sum(0),
            dwf_part.sum(0).t(), dv_part.sum(0), dkc, d_values)


def las_scan_bwd_chain(w_ctx, w_h, w_q, conv_w, w_f, v, kc, values, klens,
                       keep, h, c, gates, q, aw, ctx, dh_out, dctx_out):
    """K3b's kernel loop alone, on CUDA tensors: launches the per-step
    chain (or raises) and returns what ``las_scan_bwd_finish`` takes after
    (h, ctx, keep, aw). Counts in ``las_scan_bwd.launches``; the number of
    kernels it launched goes to ``las_scan_bwd.kernel_launches_per_call``."""
    u, b, hd = h.shape
    lib, dims = _check_shapes(b, u, hd, w_ctx, w_h, None, w_q, conv_w, w_f,
                              v, kc, values, klens, keep)
    _, _, t, _, d, a, ch, k = dims
    for name, x, shape in (("h", h, (u, b, hd)), ("c", c, (u, b, hd)),
                           ("gates", gates, (u, b, 4 * hd)),
                           ("q", q, (u, b, a)), ("aw", aw, (u, b, t)),
                           ("ctx", ctx, (u, b, d)),
                           ("dh_out", dh_out, (u, b, hd)),
                           ("dctx_out", dctx_out, (u, b, d))):
        check(name, x, shape)
    n_tb = -(-t // 16)
    dev = h.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    ins = (w_ctx, w_h, w_q, conv_w, w_f, v, kc, values, klens, keep, gates, c,
           q, aw, ctx, zeros(b, t), dh_out, dctx_out)
    carries = (zeros(b, hd), zeros(b, t))
    scratch = (empty(lib.nsp_las_scan_bwd_parts(hd), b, d + hd),
               empty(b, t, ch), empty(n_tb, b, a))
    dy, dq, dctx = empty(u, b, 4 * hd), empty(u, b, a), empty(u, b, d)
    dkc = zeros(b, t, a)
    dv_part, dwf_part = zeros(b * n_tb, a), zeros(b * n_tb, ch, a)
    dconv_part = zeros(b * n_tb, ch, k)
    launched = ctypes.c_int(0)
    err = lib.nsp_las_scan_bwd_f32(
        *(x.data_ptr() for x in (*ins, *carries, *scratch, dy, dq, dctx, dkc,
                                 dv_part, dwf_part, dconv_part)),
        ctypes.addressof(launched), *dims, stream_of(h))
    raise_on_error("las_scan_bwd", err)
    las_scan_bwd.launches += 1
    las_scan_bwd.kernel_launches_per_call = launched.value
    return dy, dq, dctx, dkc, dconv_part, dwf_part, dv_part


def las_scan_bwd(w_ctx, w_h, w_q, conv_w, w_f, v, kc, values, klens, keep,
                 h, c, gates, q, aw, ctx, dh_out, dctx_out):
    """K3b: gradients as ``las_scan_bwd_ref``; dispatch as ``las_scan``:
    the kernel loop (``las_scan_bwd_chain``, which counts the launch),
    then ``las_scan_bwd_finish``."""
    args = (w_ctx, w_h, w_q, conv_w, w_f, v, kc, values, klens, keep, h, c,
            gates, q, aw, ctx, dh_out, dctx_out)
    if on_cpu(*args):
        return las_scan_bwd_ref(*args)
    return las_scan_bwd_finish(h, ctx, keep, aw, *las_scan_bwd_chain(*args))


las_scan.launches = 0
las_scan_bwd.launches = 0
# kernels the last call of K3b launched (its per-step chain, U steps)
las_scan_bwd.kernel_launches_per_call = 0


def _tm(x):
    """[B, U, ...] <-> [U, B, ...], contiguous."""
    return x.transpose(0, 1).contiguous()


class LASScan(torch.autograd.Function):
    """K3 forward, K3b backward, batch-major at its boundary: eg [B, U, 4H]
    and keep [B, U, H] in; (h [B, U, H], ctx [B, U, D], aw [B, U, T]) out,
    views of K3's time-major outputs, which are saved for K3b as they
    are. aw is not differentiable (the location-attention loss does not
    read it). Gradients for eg and the seven weights, kc and values."""

    @staticmethod
    def forward(ctx_, eg, w_ctx, w_h, bias, w_q, conv_w, w_f, v, kc, values,
                klens, keep):
        keep = _tm(keep)
        h, c, gates, q, aw, ctx = las_scan(_tm(eg), w_ctx, w_h, bias, w_q,
                                           conv_w, w_f, v, kc, values, klens,
                                           keep)
        ctx_.save_for_backward(w_ctx, w_h, w_q, conv_w, w_f, v, kc, values,
                               klens, keep, h, c, gates, q, aw, ctx)
        aw = aw.transpose(0, 1)
        ctx_.mark_non_differentiable(aw)
        return h.transpose(0, 1), ctx.transpose(0, 1), aw

    @staticmethod
    def backward(ctx_, dh, dctx, _daw):
        (d_eg, d_w_ctx, d_w_h, d_b, d_w_q, d_conv, d_w_f, d_v, d_kc,
         d_values) = las_scan_bwd(*ctx_.saved_tensors, _tm(dh), _tm(dctx))
        return (d_eg.transpose(0, 1), d_w_ctx, d_w_h, d_b, d_w_q, d_conv, d_w_f, d_v, d_kc,
                d_values, None, None)
