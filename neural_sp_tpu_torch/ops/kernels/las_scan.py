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
    loc = conv(aw_{t-1} m_{t-1})         (width K, SAME, cross-correlation)
    e   = v . tanh(kc + hd W_q^T + loc W_f^T);  aw = masked softmax(e)
    ctx = (aw m_t) values

m_t [B, T] is step t's attention dropout scale (``att_keep``, the keep
mask over 1 - rate; 1 without dropout): the context and the next step's
location conv read the dropped weights aw m_t, as JAX's decoder carries
its dropped weights on (``aw_new = aw``). K3 keeps the raw aw, which the
softmax's adjoint needs, and drops them where they are read; the adjoint
multiplies the gradient that reaches the dropped weights by m_t before
the softmax's adjoint.

With the decoder's projection (``proj`` = (W_p [P, H], b_p [P]), JAX's
``projs_0``), the query and the readout read p_t = relu(hd W_p^T + b_p)
in place of hd: K3 keeps p [U, B, P] as a seventh output and K3b takes
its gradient dp_out, and per step dpre = (dq W_q + dp_out) [p > 0] and
dhd = dpre W_p (one more kernel per step); dW_p and b_p are products over
all steps after the loop, with dW_q then dq^T p.

The forward K3 (``nsp_las_scan_f32`` in ``csrc/las_step.cu``) runs K2's
five kernels per step from a host loop (``las_step.py`` describes them:
the split-K gate product that reads [W_ctx; W_h] once per step, the cell,
the query, the attention per block of 16 valid frames, and the row's
softmax combined once), as programmatic dependent launches: each kernel
loads what no step writes (its weights, kc, values) while the kernel
before it still runs. It keeps each step's gates, c, h, query, weights and
context. A row with klen 0 gets uniform weights over all T frames, as the
masked softmax of ``attend_ref`` gives. The backward K3b
(``csrc/las_scan.cu``) walks the steps in reverse, four kernels per step
(``las_scan_bwd_chain``), and streams dy, dq and each step's total
context gradient out; the step-invariant weight gradients (dW_h, dW_ctx,
db, dW_q) and dvalues are single products over all steps here
(``las_scan_bwd_finish``), as the Pallas ``_bwd`` reduced them outside
its kernel.

The additive energy (``conv_w`` and ``w_f`` None; the decoder's ``add``
and triggered attention) is ``e = v . tanh(kc + hd W_q^T)``: K3 and K3b
run instantiations of their own with no location conv and no loc W_f^T,
and its adjoint has no dconv, dW_f or daw carry (their gradients are
None). Triggered attention's window is a length per step: klens [U, B]
(time-major), step t's row read at t, ``min(klens, trigger + 1)``.

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
from .las_step import (SMEM_LIMIT, _ptr, attend_flops, attend_ref,
                       energy_features, given, location_dims,
                       location_features, project, query_weights,
                       step_scratch)
from .roofline import valid_lengths


def step_lengths(klens, u: int):
    """klens [B] or [U, B] (a length per step) -> [U, B]."""
    return klens.expand(u, -1) if klens.dim() == 1 else klens


def valid_frames(klens, t: int, u: int) -> tuple[int, int, int]:
    """(the valid frames summed over the steps and rows, the frames of kc
    and values a run reads: each row's longest step, the lengths' count)
    of klens [B] or [U, B] (a tensor or nested lists)."""
    lens = torch.as_tensor(klens).cpu()
    count = lens.numel()
    lens = step_lengths(lens, u)
    per_step = sum(sum(valid_lengths(row, t)) for row in lens)
    read = sum(valid_lengths(lens.max(0).values, t))
    return per_step, read, count


def las_scan_ref(eg, w_ctx, w_h, bias, w_q, conv_w, w_f, v, kc, values,
                 klens, keep, att_keep=None, proj=None):
    """Plain version of K3. eg [U, B, 4H] (the embedding half of the gates);
    weights as ``las_step_ref`` (conv_w and w_f None: the additive
    energy); kc [B, T, A]; values [B, T, D]; klens [B], or [U, B] a length
    per step; keep [U, B, H]; att_keep [U, B, T] or None (no attention
    dropout); proj (W_p, b_p) or None (no projection). Returns (h, c,
    gates, q, aw, ctx), each [U, B, ...], and with proj p [U, B, P] after
    them: gates are the activations (i, f, g, o), q the queries, aw the
    raw weights (undropped), ctx from the dropped ones."""
    u, bs, g4 = eg.shape
    hdim, t = g4 // 4, kc.shape[1]
    h = eg.new_zeros((bs, hdim))
    c = eg.new_zeros((bs, hdim))
    aw = eg.new_zeros((bs, t))
    ctx = eg.new_zeros((bs, values.shape[-1]))
    lens = step_lengths(klens, u)
    outs = []
    for i in range(u):
        y = eg[i] + ctx @ w_ctx + h @ w_h + bias
        yi, yf, yg, yo = y.chunk(4, dim=-1)
        gates = torch.cat([torch.sigmoid(yi), torch.sigmoid(yf),
                           torch.tanh(yg), torch.sigmoid(yo)], -1)
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        c = gf * c + gi * gg
        h = go * torch.tanh(c)
        aw_prev = aw if att_keep is None or i == 0 else aw * att_keep[i - 1]
        p = project(h * keep[i], proj)
        q, aw, ctx = attend_ref(p, aw_prev, w_q, conv_w, w_f, v, kc, values,
                                lens[i],
                                None if att_keep is None else att_keep[i])
        outs.append((h, c, gates, q, aw, ctx) + (() if proj is None
                                                  else (p,)))
    return tuple(torch.stack(x) for x in zip(*outs))


def _prev(x):
    """[U, B, ...] -> the same shifted one step later, zeros at step 0."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def _weight_grads(h, ctx, keep, dy, dq, p=None, dpre=None):
    """The step-invariant weight gradients from the streamed dy [U, B, 4H]
    and dq [U, B, A]: (dW_ctx, dW_h, db, dW_q), and with the projection
    (K3's p and the streamed dpre [U, B, P]) (dW_p, db_p) after them."""
    g4, a = dy.shape[-1], dq.shape[-1]
    dy2 = dy.reshape(-1, g4)
    hd = (h * keep).reshape(-1, h.shape[-1])
    d_w_h = _prev(h).reshape(-1, h.shape[-1]).t() @ dy2
    d_w_ctx = _prev(ctx).reshape(-1, ctx.shape[-1]).t() @ dy2
    query = hd if p is None else p.reshape(-1, p.shape[-1])
    d_w_q = dq.reshape(-1, a).t() @ query
    grads = (d_w_ctx, d_w_h, dy2.sum(0), d_w_q)
    if p is None:
        return grads
    dpre = dpre.reshape(-1, dpre.shape[-1])
    return (*grads, dpre.t() @ hd, dpre.sum(0))


def las_scan_bwd_ref(w_ctx, w_h, w_q, conv_w, w_f, v, kc, values, klens,
                     keep, h, c, gates, q, aw, ctx, dh_out, dctx_out,
                     att_keep=None, w_p=None, p=None, dp_out=None):
    """Plain version of K3b: the reverse-step adjoint written out. dh_out
    [U, B, H] and dctx_out [U, B, D] are the gradients w.r.t. K3's h (the
    undropped output) and ctx; aw K3's raw weights, att_keep as K3 took
    it; with the projection W_p, K3's p and its gradient dp_out [U, B, P]
    (None without). Returns (d_eg [U, B, 4H], dW_ctx, dW_h, db, dW_q,
    dconv_w, dW_f, dv, dkc, dvalues), and with the projection (dW_p, db_p)
    after them; dconv_w and dW_f are None for the additive energy."""
    (dy, dq, _, d_conv, d_w_f, d_v, dkc, dvalues,
     *dpre) = las_scan_bwd_steps_ref(
        w_ctx, w_h, w_q, conv_w, w_f, v, kc, values, klens, keep, h, c,
        gates, q, aw, ctx, dh_out, dctx_out, att_keep, w_p, p, dp_out)
    grads = _weight_grads(h, ctx, keep, dy, dq, p, *dpre)
    return (dy, *grads[:4], d_conv, d_w_f, d_v, dkc, dvalues, *grads[4:])


def las_scan_bwd_steps_ref(w_ctx, w_h, w_q, conv_w, w_f, v, kc, values,
                           klens, keep, h, c, gates, q, aw, ctx, dh_out,
                           dctx_out, att_keep=None, w_p=None, p=None,
                           dp_out=None):
    """The reverse-step loop of ``las_scan_bwd_ref``: the per-step dy [U, B,
    4H], dq [U, B, A] and total context gradient dctx [U, B, D], the sums
    accumulated over the steps (dconv_w, dW_f, dv, dkc, dvalues), and with
    the projection its per-step dpre [U, B, P] after them."""
    u, bs, hdim = h.shape
    t = kc.shape[1]
    loc_on = conv_w is not None
    k = conv_w.shape[1] if loc_on else 0
    left = (k - 1) // 2
    valid = torch.arange(t, device=kc.device)[None, None] < \
        step_lengths(klens.to(kc.device), u)[..., None]          # [U, B, T]
    dh_c = h.new_zeros((bs, hdim))
    dc_c = h.new_zeros((bs, hdim))
    dctx_c = h.new_zeros((bs, ctx.shape[-1]))
    daw_c = h.new_zeros((bs, t))
    dkc, dvalues = torch.zeros_like(kc), torch.zeros_like(values)
    d_v = torch.zeros_like(v)
    d_w_f, d_conv = (torch.zeros_like(w_f), torch.zeros_like(conv_w)) \
        if loc_on else (None, None)
    dys, dqs, dctxs, dpres = [], [], [], []
    # the dropped weights: what the context and the next step's conv read
    aw_d = aw if att_keep is None else aw * att_keep
    for i in range(u - 1, -1, -1):
        aw_t = aw[i]
        aw_prev = aw_d[i - 1] if i > 0 else torch.zeros_like(aw_t)
        # context and softmax: daw reaches the dropped weights, then m_t
        dctx = dctx_out[i] + dctx_c
        daw = daw_c + torch.einsum("btd,bd->bt", values, dctx)
        dvalues += aw_d[i][:, :, None] * dctx[:, None, :]
        if att_keep is not None:
            daw = daw * att_keep[i]
        de = aw_t * (daw - (aw_t * daw).sum(-1, keepdim=True))
        de = torch.where(valid[i], de, torch.zeros_like(de))
        # energies: e = v . tanh(z), z = kc + q (+ loc W_f^T)
        s = torch.tanh(energy_features(kc, q[i], aw_prev, conv_w, w_f))
        d_v += torch.einsum("bt,bta->a", de, s)
        dz = de[:, :, None] * v * (1.0 - s * s)
        dkc += dz
        dq = dz.sum(1)                                           # [B, A]
        if loc_on:
            loc = location_features(aw_prev, conv_w)             # [B, T, C]
            d_w_f += torch.einsum("bta,btc->ac", dz, loc)
            dloc = dz @ w_f                                      # [B, T, C]
            # location conv: loc[t, c] = sum_k aw_prev[t + k - left]
            # conv[c, k]
            daw_pad = F.conv_transpose1d(dloc.transpose(1, 2),
                                         conv_w[:, None, :])[:, 0]
            daw_c = daw_pad[:, left:left + t]                    # [B, T]
            aw_pad = F.pad(aw_prev, (left, k - 1 - left)).unfold(-1, k, 1)
            d_conv += torch.einsum("btc,btk->ck", dloc, aw_pad)
        # query from the dropped output (or its projection), then the cell
        dquery = dq @ w_q
        if w_p is not None:
            dpre = torch.where(p[i] > 0, dquery + dp_out[i],
                               torch.zeros_like(dquery))
            dpres.append(dpre)
            dquery = dpre @ w_p
        dh = dh_out[i] + dquery * keep[i] + dh_c
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
            d_v, dkc, dvalues, *((torch.stack(dpres[::-1]),) if dpres else ()))


def las_scan_cost(u, b, t, hd, d, a, ch, k, klens, att_drop: bool = False,
                  n_p: int = 0) -> tuple[int, int]:
    """(flops, bytes) of K3: U decode steps of B rows (``las_step_cost``'s
    products, the projection's of width ``n_p`` with them). Reads the
    weights, kc and values (valid frames) once and eg, keep (with
    ``att_drop`` the attention dropout scale [B, T] too) per step; writes
    h, c, gates, q, aw, ctx (and p) per step. klens [B] or [U, B] (a
    window per step: each step's valid frames count; ch = k = 0 for the
    additive energy)."""
    tv_steps, tv, n_lens = valid_frames(klens, t, u)
    qw = query_weights(hd, a, n_p)
    flops = u * 2 * b * ((d + hd) * 4 * hd + qw) + \
        attend_flops(tv_steps, hd, d, a, ch, k)
    weights = (d + hd) * 4 * hd + 4 * hd + qw + ch * k + a * ch + a
    ins = weights + tv * (a + d) + n_lens + u * b * (4 * hd + hd)
    if att_drop:
        ins += u * b * t
    outs = u * b * (2 * hd + 4 * hd + a + t + d + n_p)
    return flops, 4 * (ins + outs)


def las_scan_bwd_cost(u, b, t, hd, d, a, ch, k, klens,
                      att_drop: bool = False,
                      n_p: int = 0) -> tuple[int, int]:
    """(flops, bytes) of K3b with its weight-gradient matmuls. Per step:
    the recurrent adjoints dy W_h^T and dy W_ctx^T, dq W_q, the energy
    recomputed (location conv and loc W_f^T) and its adjoints (dW_f, dloc,
    the conv transpose, dconv, dv, dkc, daw, dvalues); over all steps
    dW_h, dW_ctx, dW_q. Reads the weights, kc and values (valid frames)
    once and K3's saved per-step tensors and the output gradients (with
    ``att_drop`` the attention dropout scale [U, B, T]; with the
    projection of width ``n_p`` its p and dp per step); writes every
    gradient. klens as ``las_scan_cost``."""
    tv_steps, tv, n_lens = valid_frames(klens, t, u)
    qw = query_weights(hd, a, n_p)
    per_step = 2 * b * (4 * hd * (hd + d) + qw)
    frames = 2 * tv_steps * (3 * ch * k + 3 * a * ch + 2 * a + 2 * d)
    outside = 2 * u * b * (hd * 4 * hd + d * 4 * hd + qw)
    weights = (d + hd) * 4 * hd + qw + ch * k + a * ch + a
    ins = weights + tv * (a + d) + n_lens + \
        u * b * (hd + 2 * hd + 4 * hd + a + t + d + hd + d + 2 * n_p)
    if att_drop:
        ins += u * b * t
    outs = u * b * 4 * hd + weights + 4 * hd + b * t * (a + d)
    return u * per_step + frames + outside, 4 * (ins + outs)


def _check_shapes(b, u, hd, w_ctx, w_h, bias, w_q, conv_w, w_f, v, kc,
                  values, klens, keep, att_keep=None, w_p=None, b_p=None):
    """Checks K3's / K3b's operands and the shared memory their blocks ask
    for. Returns (library, (U, B, T, H, D, A, C, K), P): P the projection's
    width (0 without), C = K = 0 for the additive energy."""
    g4, t, a, d = 4 * hd, kc.shape[1], kc.shape[2], values.shape[2]
    ch, k = location_dims(conv_w, w_f)
    n_p = 0 if w_p is None else w_p.shape[0]
    want = {"w_ctx": (d, g4), "w_h": (hd, g4), "bias": (g4,),
            "w_q": (a, n_p or hd), "conv_w": (ch, k), "w_f": (a, ch),
            "v": (a,), "kc": (b, t, a), "values": (b, t, d),
            "keep": (u, b, hd), "att_keep": (u, b, t), "w_p": (n_p, hd),
            "b_p": (n_p,)}
    for (name, shape), x in zip(want.items(), (w_ctx, w_h, bias, w_q, conv_w,
                                               w_f, v, kc, values, keep,
                                               att_keep, w_p, b_p)):
        if x is not None:      # the backward takes no bias
            check(name, x, shape)
    check("klens", klens, (b,) if klens.dim() == 1 else (u, b), torch.int32)
    lib = load_library()
    smem = max(lib.nsp_las_step_smem_bytes(t, max(hd, n_p), d, a, ch, k),
               lib.nsp_las_scan_bwd_smem_bytes(t, d, max(a, n_p), ch, k))
    if smem > SMEM_LIMIT:
        raise ValueError(f"las_scan: {t} frames need {smem} bytes of shared "
                         f"memory per block, more than {SMEM_LIMIT}")
    return lib, (u, b, t, hd, d, a, ch, k), n_p


def las_scan(eg, w_ctx, w_h, bias, w_q, conv_w, w_f, v, kc, values, klens,
             keep, att_keep=None, proj=None):
    """K3: (h, c, gates, q, aw, ctx), and with ``proj`` p after them, as
    ``las_scan_ref``, time-major. CPU tensors take the plain version; CUDA
    tensors launch the kernel (float32, contiguous, int32 klens) or raise.
    Counts in ``las_scan.launches`` (and one with attention dropout also
    in ``las_scan.launches_dropout``, one with the projection in
    ``las_scan.launches_proj``, one with the additive energy in
    ``las_scan.launches_add``, one with a length per step in
    ``las_scan.launches_window``); the number of kernels it launched
    goes to ``las_scan.kernel_launches_per_call``."""
    args = (eg, w_ctx, w_h, bias, w_q, conv_w, w_f, v, kc, values, klens,
            keep)
    if on_cpu(*given(*args, att_keep, *(proj or ()))):
        return las_scan_ref(*args, att_keep, proj)
    u, b, g4 = eg.shape
    check("eg", eg, (u, b, g4))
    w_p, b_p = proj or (None, None)
    lib, dims, n_p = _check_shapes(b, u, g4 // 4, *args[1:], att_keep, w_p,
                                   b_p)
    _, _, t, hd, d, a, _, _ = dims
    dev = eg.device

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    zeros = [torch.zeros(s, dtype=torch.float32, device=dev)
             for s in ((b, hd), (b, hd), (b, t), (b, d))]
    scratch = step_scratch(lib, b, t, hd, d, a, dev)
    outs = [out(u, b, hd), out(u, b, hd), out(u, b, 4 * hd), out(u, b, a),
            out(u, b, t), out(u, b, d)]
    p = out(u, b, n_p) if n_p else None
    # step 0's location conv reads the zero carry undropped
    aw0_keep = None if att_keep is None else torch.ones(
        (b, t), dtype=torch.float32, device=dev)
    launched = ctypes.c_int(0)
    err = lib.nsp_las_scan_f32(
        *(_ptr(x) for x in args),
        *(_ptr(x) for x in (att_keep, aw0_keep, w_p, b_p, p)),
        *(x.data_ptr() for x in (*zeros, scratch, *outs)),
        ctypes.addressof(launched), *dims, n_p, int(klens.dim() == 2),
        stream_of(eg))
    raise_on_error("las_scan", err)
    las_scan.launches += 1
    las_scan.launches_dropout += att_keep is not None
    las_scan.launches_proj += proj is not None
    las_scan.launches_add += conv_w is None
    las_scan.launches_window += klens.dim() == 2
    las_scan.kernel_launches_per_call = launched.value
    return tuple(outs) if p is None else (*outs, p)


def las_scan_bwd_finish(h, ctx, keep, aw, dy, dq, dctx, dkc, dconv_part,
                        dwf_part, dv_part, att_keep=None, p=None, dpre=None):
    """K3b's work after its loop, plain tensor code: the step-invariant
    weight gradients from the streamed dy [U, B, 4H] and dq [U, B, A] (and
    with the projection, K3's p and the streamed dpre [U, B, P]);
    dvalues = sum_t aw_t m_t (x) dctx_t (the dropped weights: aw times
    att_keep when given) from each step's total context gradient dctx [U,
    B, D], one batched product (the loop's per-step ``dvalues +=`` taken
    out of it); and the sums of the per-block partials [slots, ...] of
    dconv [C, K], dW_f (transposed: [C, A]) and dv [A]. Returns the
    gradients in ``las_scan_bwd_ref``'s order."""
    d_values = torch.einsum("ubt,ubd->btd",
                            aw if att_keep is None else aw * att_keep, dctx)
    grads = _weight_grads(h, ctx, keep, dy, dq, p, dpre)
    d_loc = (None, None) if dconv_part is None else \
        (dconv_part.sum(0), dwf_part.sum(0).t())
    return (dy, *grads[:4], *d_loc, dv_part.sum(0), dkc, d_values,
            *grads[4:])


def las_scan_bwd_chain(w_ctx, w_h, w_q, conv_w, w_f, v, kc, values, klens,
                       keep, h, c, gates, q, aw, ctx, dh_out, dctx_out,
                       att_keep=None, w_p=None, p=None, dp_out=None):
    """K3b's kernel loop alone, on CUDA tensors: launches the per-step
    chain (or raises) and returns what ``las_scan_bwd_finish`` takes after
    (h, ctx, keep, aw), and with the projection dpre after them. Counts in
    ``las_scan_bwd.launches`` (with attention dropout also in
    ``las_scan_bwd.launches_dropout``, with the projection in
    ``las_scan_bwd.launches_proj``); the number of kernels it launched
    goes to ``las_scan_bwd.kernel_launches_per_call``. With the additive
    energy dconv_part and dwf_part come back None (and count in
    ``las_scan_bwd.launches_add``), with a length per step it counts in
    ``las_scan_bwd.launches_window``."""
    u, b, hd = h.shape
    lib, dims, n_p = _check_shapes(b, u, hd, w_ctx, w_h, None, w_q, conv_w,
                                   w_f, v, kc, values, klens, keep, att_keep,
                                   w_p)
    _, _, t, _, d, a, ch, k = dims
    for name, x, shape in (("h", h, (u, b, hd)), ("c", c, (u, b, hd)),
                           ("gates", gates, (u, b, 4 * hd)),
                           ("q", q, (u, b, a)), ("aw", aw, (u, b, t)),
                           ("ctx", ctx, (u, b, d)),
                           ("dh_out", dh_out, (u, b, hd)),
                           ("dctx_out", dctx_out, (u, b, d)),
                           ("p", p, (u, b, n_p)),
                           ("dp_out", dp_out, (u, b, n_p))):
        if x is not None or name not in ("p", "dp_out") or n_p:
            check(name, x, shape)
    n_tb = -(-t // 16)
    dev = h.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    ins = (w_ctx, w_h, w_q, conv_w, w_f, v, kc, values, klens, keep)
    dpre = empty(u, b, n_p) if n_p else None
    saved = (gates, c, q, aw, ctx, zeros(b, t), dh_out, dctx_out)
    carries = (zeros(b, hd), zeros(b, t))
    scratch = (empty(lib.nsp_las_scan_bwd_parts(hd), b, d + hd),
               empty(b, t, ch), empty(n_tb, b, a))
    dy, dq, dctx = empty(u, b, 4 * hd), empty(u, b, a), empty(u, b, d)
    dkc = zeros(b, t, a)
    dv_part = zeros(b * n_tb, a)
    dwf_part, dconv_part = (zeros(b * n_tb, ch, a), zeros(b * n_tb, ch, k)) \
        if ch else (None, None)
    launched = ctypes.c_int(0)
    err = lib.nsp_las_scan_bwd_f32(
        *(_ptr(x) for x in ins),
        *(_ptr(x) for x in (att_keep, w_p, p, dp_out, dpre)),
        *(_ptr(x) for x in (*saved, *carries, *scratch, dy, dq, dctx,
                            dkc, dv_part, dwf_part, dconv_part)),
        ctypes.addressof(launched), *dims, n_p, int(klens.dim() == 2),
        stream_of(h))
    raise_on_error("las_scan_bwd", err)
    las_scan_bwd.launches += 1
    las_scan_bwd.launches_dropout += att_keep is not None
    las_scan_bwd.launches_proj += w_p is not None
    las_scan_bwd.launches_add += conv_w is None
    las_scan_bwd.launches_window += klens.dim() == 2
    las_scan_bwd.kernel_launches_per_call = launched.value
    loop = (dy, dq, dctx, dkc, dconv_part, dwf_part, dv_part)
    return loop if dpre is None else (*loop, dpre)


def las_scan_bwd(w_ctx, w_h, w_q, conv_w, w_f, v, kc, values, klens, keep,
                 h, c, gates, q, aw, ctx, dh_out, dctx_out, att_keep=None,
                 w_p=None, p=None, dp_out=None):
    """K3b: gradients as ``las_scan_bwd_ref``; dispatch as ``las_scan``:
    the kernel loop (``las_scan_bwd_chain``, which counts the launch),
    then ``las_scan_bwd_finish``."""
    args = (w_ctx, w_h, w_q, conv_w, w_f, v, kc, values, klens, keep, h, c,
            gates, q, aw, ctx, dh_out, dctx_out)
    opt = (att_keep, w_p, p, dp_out)
    if on_cpu(*given(*args, *opt)):
        return las_scan_bwd_ref(*args, *opt)
    loop = las_scan_bwd_chain(*args, *opt)
    dpre = loop[7] if len(loop) > 7 else None
    return las_scan_bwd_finish(h, ctx, keep, aw, *loop[:7], att_keep, p,
                               dpre)


las_scan.launches = las_scan.launches_dropout = las_scan.launches_proj = 0
las_scan.launches_add = las_scan.launches_window = 0
las_scan_bwd.launches = las_scan_bwd.launches_dropout = 0
las_scan_bwd.launches_proj = las_scan_bwd.launches_add = 0
las_scan_bwd.launches_window = 0
# kernels the last call of K3 / K3b launched (the per-step chain, U steps)
las_scan.kernel_launches_per_call = 0
las_scan_bwd.kernel_launches_per_call = 0


def _tm(x):
    """[B, U, ...] <-> [U, B, ...], contiguous."""
    return x.transpose(0, 1).contiguous()


class LASScan(torch.autograd.Function):
    """K3 forward, K3b backward, batch-major at its boundary: eg [B, U, 4H],
    keep [B, U, H], att_keep [B, U, T] (the attention dropout scale) or
    None, and the projection's w_p [P, H] and b_p [P] or None in (conv_w
    and w_f None: the additive energy; klens [B], or [U, B] time-major, a
    length per step, as K3 reads it); (h
    [B, U, H], ctx [B, U, D], aw [B, U, T]) out, and with the projection p
    [B, U, P] after them: views of K3's time-major outputs, which are saved
    for K3b as they are (aw the raw weights). aw is not differentiable
    (the location-attention loss does not read it). Gradients for eg, the
    seven weights (and w_p, b_p), kc and values.

    K3 and K3b are float32 kernels. Given bf16 (a bf16 compute_dtype), this
    casts at their boundary, as the TPU kernel kept its state in float32:
    the inputs go to float32, h, ctx, aw and p come back in the promoted
    type of eg and values (bf16 over a conformer; float32 over an RNN
    encoder's float32 outputs, as JAX's decoder promotes), and each
    gradient in its input's type. Float32 inputs pass uncopied."""

    @staticmethod
    def forward(ctx_, eg, w_ctx, w_h, bias, w_q, conv_w, w_f, v, kc, values,
                klens, keep, att_keep=None, w_p=None, b_p=None):
        floats = (eg, w_ctx, w_h, bias, w_q, conv_w, w_f, v, kc, values) + \
            (() if w_p is None else (w_p, b_p))
        ctx_.dtypes = [None if x is None else x.dtype for x in floats]
        floats = [None if x is None else x.float() for x in floats]
        (eg, w_ctx, w_h, bias, w_q, conv_w, w_f, v, kc, values) = floats[:10]
        proj = None if w_p is None else tuple(floats[10:])
        keep = _tm(keep.float())
        if att_keep is not None:
            att_keep = _tm(att_keep.float())
        h, c, gates, q, aw, ctx, *p = las_scan(
            _tm(eg), w_ctx, w_h, bias, w_q, conv_w, w_f, v, kc, values,
            klens, keep, att_keep, proj)
        p = p[0] if p else None
        ctx_.save_for_backward(w_ctx, w_h, w_q, conv_w, w_f, v, kc, values,
                               klens, keep, h, c, gates, q, aw, ctx,
                               att_keep, None if proj is None else proj[0],
                               p)
        # JAX's decoder state takes the embedding gates' and the encoder
        # outputs' promoted type (float32 over an RNN encoder at bf16)
        out_dt = torch.promote_types(ctx_.dtypes[0], ctx_.dtypes[9])
        outs = [x.transpose(0, 1).to(out_dt)
                for x in (h, ctx, aw) + (() if p is None else (p,))]
        ctx_.mark_non_differentiable(outs[2])
        return tuple(outs)

    @staticmethod
    def backward(ctx_, dh, dctx, _daw, dp=None):
        *saved, att_keep, w_p, p = ctx_.saved_tensors
        dp_out = None if p is None else _tm(dp.float())
        grads = las_scan_bwd(*saved, _tm(dh.float()), _tm(dctx.float()),
                             att_keep, w_p, p, dp_out)
        d_eg, *rest = (None if g is None else g.to(dt)
                       for g, dt in zip(grads, ctx_.dtypes))
        proj = rest[9:] if p is not None else [None, None]
        return (d_eg.transpose(0, 1), *rest[:9], None, None, None, *proj)
