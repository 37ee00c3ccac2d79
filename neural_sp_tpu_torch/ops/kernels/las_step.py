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
``ctx = aw values``. With attention dropout (``att_keep`` [N, T], the keep
mask over 1 - rate, as the JAX module's ``Dropout`` on the weights) the
context is ``(aw att_keep) values`` and the carried weights are ``aw
att_keep``: the next step's location conv reads the dropped weights, as
JAX's ``aw_new = aw`` after its dropout. With the decoder's projection
(``proj`` = (w_p [P, H], b_p [P]), JAX's ``projs_0``) the query is
``p W_q^T`` of ``p = relu(h keep W_p^T + b_p)``, one more launch of the
query kernel before the query's; p is returned for the readout.
With ``conv_w`` and ``w_f`` None the energy is the additive one, ``e = v .
tanh(kc + q)`` (the decoder's ``add`` and triggered attention): the kernels
run instantiations of their own that read no location weights and do no
conv work, and ``aw_prev`` is not read. Triggered attention's window
(frames ``t <= trigger``) is a length: the caller passes ``min(klens,
trigger + 1)`` as klens.

On the H100 a step over N rows is small: by bytes it needs the gate
weights ((D + H) x 4H floats) and each row's keys and values over its valid
frames once, but each of its kernels is short, so latency sets its time.
The step is four kernels on one stream, as programmatic dependent launches
(source: ``csrc/las_step.cu``):

1. ``las_gates_rows``: the split-K product [ctx_prev, h_prev] [W_ctx; W_h]
   for up to 16 rows, shaped as a matrix-vector product: the weights go
   from global memory straight to registers, x sits in shared memory and is
   read by broadcast, and 10 rows cost 12 rows' arithmetic (more than 16
   rows take K3's ``las_gates``, 32 rows at a time);
2. ``las_cell``: sums the partials and applies the LSTM cell;
3. ``las_query``: q = h W_q^T, a warp per output for 8 rows;
4. ``las_attend``: a block per (16 frames, row), only over the row's valid
   frames: location features, energies, then the block's own max,
   exponentials, their sum and the unnormalised partial context
   (``attend_parts_ref`` is its plain version from the energies on); the
   block of a row that finishes last does the row's softmax, once, from the
   blocks' (max, sum) pairs, and the context from their partial contexts
   (``attend_combine_ref``). K3 runs these two halves as two kernels.

``parent`` [N] makes row n read row ``parent[n]`` of the carry, so a beam
search reorders its hypotheses inside the step and copies nothing. A decode
loop steps through a ``LasStepWorkspace``: scratch, the ``eg`` and
``parent`` buffers and two carry sets written in turns, allocated and
checked once, so a step costs the host one ctypes call; ``las_step`` is the
checked, allocating call with the same result bit for bit.

The masked value is finfo(f32).min / 2 (``apply_mask_logits``), so a row
with klen 0 gets uniform weights 1 / T over all T frames and the mean of
its T value rows as context; the kernel treats such a row as T frames of
equal energy, and reads no frame past klen for any other row. K3
(``las_scan.py``) runs five kernels of the same family per teacher-forced
step.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..masks import apply_mask_logits
from ._checks import check, on_cpu, raise_on_error, stream_of
from .build import load_library
from .roofline import valid_lengths

SMEM_LIMIT = 232448   # bytes of shared memory one block may use on sm_90


def location_features(aw_prev, conv_w):
    """Width-K SAME cross-correlation of aw_prev [N, T] with conv_w [C, K]
    (flax ``nn.Conv``: left pad (K-1)//2) -> [N, T, C]."""
    k = conv_w.shape[-1]
    left = (k - 1) // 2
    aw_pad = F.pad(aw_prev, (left, k - 1 - left))
    return F.conv1d(aw_pad[:, None], conv_w[:, None]).transpose(1, 2)


def energy_features(kc, q, aw_prev, conv_w, w_f):
    """z = kc + q + loc W_f^T [N, T, A] of location attention (loc the
    location features of aw_prev), or the additive energy's kc + q when
    conv_w is None."""
    z = kc + q[:, None]
    if conv_w is None:
        return z
    return z + location_features(aw_prev, conv_w) @ w_f.t()


def attend_ref(query, aw_prev, w_q, conv_w, w_f, v, kc, values, klens,
               att_keep=None):
    """Location attention of one step from the query [N, H] (the additive
    energy when conv_w and w_f are None). Returns (q = query W_q^T [N, A],
    aw [N, T], ctx [N, D]): aw the raw masked softmax, ctx = (aw att_keep)
    values (att_keep [N, T], the attention dropout scale, or None:
    none)."""
    q = query @ w_q.t()
    e = torch.tanh(energy_features(kc, q, aw_prev, conv_w, w_f)) @ v  # [N, T]
    valid = (torch.arange(e.shape[1], device=e.device)[None]
             < klens.to(e.device)[:, None])
    aw = torch.softmax(apply_mask_logits(e, valid), dim=-1)
    aw_d = aw if att_keep is None else aw * att_keep
    return q, aw, torch.bmm(aw_d[:, None], values)[:, 0]


ATTEND_FRAMES = 16    # frames per block of the kernel's attention (kFrames)


def attend_frames(klens, t):
    """The frames each row's softmax runs over in the kernel: its klen, or
    all t frames for a row with none (uniform weights, as the masked
    softmax gives)."""
    klens = klens.clamp(0, t)
    return torch.where(klens == 0, torch.full_like(klens, t), klens)


def attend_parts_ref(e, values, klens, frames=ATTEND_FRAMES, att_keep=None):
    """Plain version of the first half of the kernel's softmax and context
    (``las_attend_part``): per block of ``frames`` frames of each row, over
    the row's ``attend_frames`` only, the block's max m, p = exp(e - m)
    (0 past the row's frames), the sum s of p and the unnormalised partial
    context p values (p att_keep values with attention dropout, att_keep
    [N, T]). e [N, T] energies (a row with klen 0 takes the masked value
    everywhere), values [N, T, D]. Returns p [N, T], ms [N, n_b, 2],
    part_ctx [N, n_b, D]; a block with no frame holds (-inf, 0, 0)."""
    n, t = e.shape
    n_b = -(-t // frames)
    pad = n_b * frames - t
    lens = attend_frames(klens.to(e.device), t)
    live = torch.arange(t, device=e.device)[None] < lens[:, None]
    masked = torch.finfo(e.dtype).min / 2
    e = torch.where((klens.to(e.device) <= 0)[:, None],
                    torch.full_like(e, masked), e)
    e = torch.where(live, e, torch.full_like(e, -torch.inf))
    eb = F.pad(e, (0, pad), value=-torch.inf).view(n, n_b, frames)
    m = eb.max(-1).values
    p = torch.where(torch.isfinite(eb), torch.exp(eb - m[..., None]),
                    torch.zeros_like(eb))
    vb = F.pad(values, (0, 0, 0, pad)).view(n, n_b, frames, -1)
    pk = p if att_keep is None else \
        p * F.pad(att_keep, (0, pad)).view(n, n_b, frames)
    part_ctx = torch.einsum("nbf,nbfd->nbd", pk, vb)
    return (p.view(n, -1)[:, :t], torch.stack([m, p.sum(-1)], -1), part_ctx)


def attend_combine_ref(p, ms, part_ctx, klens, frames=ATTEND_FRAMES,
                       aw_keep=None):
    """Plain version of ``las_attend_combine``: the row's softmax from the
    blocks' (m_b, s_b): M = max m_b, S = sum s_b exp(m_b - M); aw = p
    exp(m_b - M) / S (times aw_keep [N, T] when given: K2's dropped carry)
    and ctx = sum_b part_ctx_b exp(m_b - M) / S. Returns (aw [N, T], ctx
    [N, D])."""
    t = p.shape[1]
    m, s = ms[..., 0], ms[..., 1]
    scale = torch.exp(m - m.max(-1, keepdim=True).values)
    scale = scale / (s * scale).sum(-1, keepdim=True)
    aw = p * scale.repeat_interleave(frames, dim=1)[:, :t]
    if aw_keep is not None:
        aw = aw * aw_keep
    return aw, torch.einsum("nb,nbd->nd", scale, part_ctx)


def project(hd, proj):
    """The decoder's projection relu(hd W_p^T + b_p) of proj = (W_p, b_p),
    or hd itself when proj is None."""
    if proj is None:
        return hd
    w_p, b_p = proj
    return torch.relu(hd @ w_p.t() + b_p)


def las_step_ref(eg, ctx_prev, h_prev, c_prev, aw_prev, w_ctx, w_h, bias,
                 w_q, conv_w, w_f, v, kc, values, klens, parent=None,
                 keep=None, att_keep=None, proj=None):
    """Plain PyTorch twin of the kernel. Shapes: eg [N, 4H], ctx_prev
    [N, D], h_prev / c_prev [N, H], aw_prev [N, T], w_ctx [D, 4H], w_h
    [H, 4H], bias [4H], w_q [A, H], conv_w [C, K], w_f [A, C], v [A], kc
    [N, T, A], values [N, T, D], klens [N] int; parent [N] int or None:
    row n takes row parent[n] of ctx_prev, h_prev, c_prev and aw_prev (a
    beam's reorder); keep [N, H] or None: the dropout scale of the step's
    output, which the query reads as h keep (the returned h, the carry, is
    undropped: K3's step with dropout); att_keep [N, T] or None: the
    attention dropout scale (ctx and the returned aw, the next step's
    aw_prev, are formed from aw att_keep); proj (W_p [P, H], b_p [P]) or
    None: the query is p W_q^T (w_q [A, P]) of p = relu(h keep W_p^T +
    b_p). Returns (h, c, aw, ctx), and p [N, P] after them with proj."""
    if parent is not None:
        rows = parent.long()
        ctx_prev, h_prev, c_prev, aw_prev = (
            x[rows] for x in (ctx_prev, h_prev, c_prev, aw_prev))
    y = eg + ctx_prev @ w_ctx + h_prev @ w_h + bias
    i, f, g, o = y.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    p = project(h if keep is None else h * keep, proj)
    _, aw, ctx = attend_ref(p, aw_prev, w_q, conv_w, w_f, v, kc, values,
                            klens, att_keep)
    out = (h, c, aw if att_keep is None else aw * att_keep, ctx)
    return out if proj is None else (*out, p)


def attend_flops(t_valid, hd, d, a, ch, k) -> int:
    """Flops of one step's attention over ``t_valid`` valid frames in all
    (the query h W_q^T is counted per row by the caller): the location
    conv, loc W_f^T (none for the additive energy: ch = k = 0), v .
    tanh(...) and aw values."""
    return 2 * t_valid * (ch * k + a * ch + a + d)


def query_weights(hd, a, n_p=0) -> int:
    """The floats of the query's weights: W_q [A, H], or with the
    projection of width P, W_p [P, H], b_p [P] and W_q [A, P]."""
    return a * hd if not n_p else n_p * hd + n_p + a * n_p


def las_step_cost(n, t, hd, d, a, ch, k, klens, att_drop: bool = False,
                  n_p: int = 0) -> tuple[int, int]:
    """(flops, bytes) of one decode step over N rows: the gate GEMV
    [ctx, h] (D + H) x 4H, the query H x A (with the projection of width
    ``n_p``, H x P then P x A), and the attention over each row's valid
    frames. Reads the weights once, each row's state and its valid keys
    and values (and with ``att_drop`` its [T] attention dropout scale);
    writes h, c, aw, ctx (and p)."""
    tv = sum(valid_lengths(klens, t))
    flops = 2 * n * ((d + hd) * 4 * hd + query_weights(hd, a, n_p)) + \
        attend_flops(tv, hd, d, a, ch, k)
    weights = (d + hd) * 4 * hd + 4 * hd + query_weights(hd, a, n_p) + \
        ch * k + a * ch + a
    rows = n * (4 * hd + d + 2 * hd + t + 1) + tv * (a + d)
    if att_drop:
        rows += n * t
    return flops, 4 * (weights + rows + n * (2 * hd + t + d + n_p))


def location_dims(conv_w, w_f) -> tuple[int, int]:
    """(C, K) of the location conv, (0, 0) for the additive energy (conv_w
    and w_f None)."""
    if (conv_w is None) != (w_f is None):
        raise ValueError("conv_w and w_f: both or neither (additive)")
    return (0, 0) if conv_w is None else tuple(conv_w.shape)


def given(*xs):
    """The arguments that are given (not None)."""
    return tuple(x for x in xs if x is not None)


def _ptr(x):
    """x's device pointer, or None."""
    return None if x is None else x.data_ptr()


def _checked(eg, ctx_prev, h_prev, c_prev, aw_prev, w_ctx, w_h, bias, w_q,
             conv_w, w_f, v, kc, values, klens, parent, keep=None,
             att_keep=None, proj=None):
    """Checks a step's CUDA operands (dtype, shape, contiguity, the shared
    memory its blocks ask for). Returns (library, (N, T, H, D, A, C, K),
    P): P the projection's width (0 without); C = K = 0 for the additive
    energy."""
    n, t = aw_prev.shape
    hdim, d = h_prev.shape[1], ctx_prev.shape[1]
    a, (c_ch, k) = w_q.shape[0], location_dims(conv_w, w_f)
    n_p = 0 if proj is None else proj[0].shape[0]
    if proj is not None:
        check("w_p", proj[0], (n_p, hdim))
        check("b_p", proj[1], (n_p,))
    shapes = {"eg": (n, 4 * hdim), "ctx_prev": (n, d), "h_prev": (n, hdim),
              "c_prev": (n, hdim), "aw_prev": (n, t), "w_ctx": (d, 4 * hdim),
              "w_h": (hdim, 4 * hdim), "bias": (4 * hdim,),
              "w_q": (a, n_p or hdim),
              "conv_w": (c_ch, k), "w_f": (a, c_ch), "v": (a,),
              "kc": (n, t, a), "values": (n, t, d)}
    for (name, shape), x in zip(shapes.items(), (
            eg, ctx_prev, h_prev, c_prev, aw_prev, w_ctx, w_h, bias, w_q,
            conv_w, w_f, v, kc, values)):
        if x is not None or name not in ("conv_w", "w_f"):
            check(name, x, shape)
    check("klens", klens, (n,), torch.int32)
    if parent is not None:
        check("parent", parent, (n,), torch.int32)
    if keep is not None:
        check("keep", keep, (n, hdim))
    if att_keep is not None:
        check("att_keep", att_keep, (n, t))
    lib = load_library()
    smem = lib.nsp_las_step_smem_bytes(t, max(hdim, n_p), d, a, c_ch, k)
    if smem > SMEM_LIMIT:
        raise ValueError(f"las_step: {t} frames need {smem} bytes of shared "
                         f"memory per block, more than {SMEM_LIMIT}")
    return lib, (n, t, hdim, d, a, c_ch, k), n_p


def las_step(eg, ctx_prev, h_prev, c_prev, aw_prev, w_ctx, w_h, bias,
             w_q, conv_w, w_f, v, kc, values, klens, parent=None, keep=None,
             att_keep=None, proj=None):
    """One decode step; arguments and results as ``las_step_ref``. CPU
    tensors take the twin; CUDA tensors launch the kernel (float32,
    contiguous; klens and parent int32; keep float32 [N, H], att_keep
    [N, T], proj's w_p [P, H] and b_p [P]) or raise.
    Checks its arguments
    and allocates its
    scratch and outputs on every call: a decode loop takes a
    ``LasStepWorkspace`` instead, which gives the same result bit for bit.
    Every call adds one to ``las_step.launches`` (and one with att_keep
    to ``las_step.launches_dropout``, one with proj to
    ``las_step.launches_proj``, one with the additive energy to
    ``las_step.launches_add``); the kernels it launched go to
    ``las_step.kernels_per_step``."""
    args = (eg, ctx_prev, h_prev, c_prev, aw_prev, w_ctx, w_h, bias, w_q,
            conv_w, w_f, v, kc, values, klens)
    opt = (parent, keep, att_keep)
    if on_cpu(*given(*args, *opt, *(proj or ()))):
        return las_step_ref(*args, parent=parent, keep=keep,
                            att_keep=att_keep, proj=proj)
    lib, dims, n_p = _checked(*args, *opt, proj)
    n, t, hdim, d, a = dims[:5]
    scratch = step_scratch(lib, n, t, hdim, d, a, eg.device)
    h = torch.empty_like(h_prev)
    c = torch.empty_like(c_prev)
    aw = torch.empty_like(aw_prev)
    ctx = torch.empty_like(ctx_prev)
    p = None if proj is None else torch.empty((n, n_p), dtype=torch.float32,
                                              device=eg.device)
    launched = ctypes.c_int(0)
    err = lib.nsp_las_step_f32(
        *(_ptr(x) for x in args),
        *(_ptr(x) for x in (*opt, *(proj or (None, None)), p)),
        *(x.data_ptr() for x in (scratch, h, c, aw, ctx)),
        ctypes.addressof(launched), *dims, n_p, stream_of(eg))
    raise_on_error("las_step", err)
    las_step.launches += 1
    las_step.launches_dropout += att_keep is not None
    las_step.launches_proj += proj is not None
    las_step.launches_add += conv_w is None
    las_step.kernels_per_step = launched.value
    return (h, c, aw, ctx) if p is None else (h, c, aw, ctx, p)


def step_scratch(lib, n, t, hdim, d, a, device):
    """The scratch buffer one step over n rows takes (K2 and K3 alike)."""
    return torch.empty(lib.nsp_las_step_scratch_floats(n, t, hdim, d, a),
                       dtype=torch.float32, device=device)


las_step.launches = las_step.launches_dropout = las_step.launches_proj = 0
las_step.launches_add = 0
las_step.kernels_per_step = 0


class _Plan(ctypes.Structure):
    """``NspLasStepPlan`` of ``csrc/las_step.cu``, field for field."""
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "eg", "w_ctx", "w_h", "bias", "w_q", "conv_w", "w_f", "v", "kc",
            "values", "klens", "parent", "scratch")]
        + [(name, ctypes.c_void_p * 2) for name in ("h", "c", "aw", "ctx")]
        + [(name, ctypes.c_int) for name in "NTHDACK"]
        + [(name, ctypes.c_void_p) for name in ("w_p", "b_p", "p")]
        + [("P", ctypes.c_int)])


class LasStepWorkspace:
    """What one decode loop fixes for all its K2 steps over N rows and T
    frames: the weights, keys, values and lengths (held, not copied), the
    kernel's scratch, the buffers ``eg`` [N, 4H] and ``parent`` [N] int32
    that the caller refills before a step, and two sets of the carry (h, c,
    aw, ctx) that the steps write in turns, so a step never writes what it
    reads and a beam's reorder (``parent``) needs no copy. Everything is
    allocated and checked here, once; a step on the card is one ctypes call
    with pointers taken here, and adds one to ``las_step.launches``. The
    carry starts as zeros (``RNNDecoder.init_carry``). On CPU tensors a
    step is ``las_step_ref`` copied into the other set. Not for autograd.
    With the decoder's projection (``proj`` = (w_p, b_p)) each step also
    writes p = relu(h W_p^T + b_p) into ``self.p`` [N, P] (the readout's
    input), overwritten by the next step. conv_w and w_f None: the
    additive energy (``las_step``). klens is held, not copied: a caller
    may rewrite it between steps (a window per step)."""

    def __init__(self, w_ctx, w_h, bias, w_q, conv_w, w_f, v, kc, values,
                 klens, proj=None):
        n, t, _ = kc.shape
        d, hdim = values.shape[2], w_h.shape[0]
        dev = kc.device

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.fixed = (w_ctx, w_h, bias, w_q, conv_w, w_f, v, kc, values,
                      klens)
        self.proj = proj
        self.p = None if proj is None else zeros(n, proj[0].shape[0])
        self.eg = zeros(n, 4 * hdim)
        self.parent = torch.arange(n, dtype=torch.int32, device=dev)
        self.sets = tuple((zeros(n, hdim), zeros(n, hdim), zeros(n, t),
                           zeros(n, d)) for _ in range(2))
        self.cur = 0          # the set that holds the carry
        self._lib = None
        h, c, aw, ctx = self.sets[0]
        if on_cpu(*given(*self.fixed)):
            return
        self._lib, dims, n_p = _checked(self.eg, ctx, h, c, aw, *self.fixed,
                                        self.parent, proj=proj)
        self._scratch = step_scratch(self._lib, n, t, hdim, d,
                                     w_q.shape[0], dev)
        self._plan = _Plan(
            self.eg.data_ptr(), *(_ptr(x) for x in self.fixed),
            self.parent.data_ptr(), self._scratch.data_ptr(),
            *((ctypes.c_void_p * 2)(self.sets[0][i].data_ptr(),
                                    self.sets[1][i].data_ptr())
              for i in range(4)), *dims,
            *(None if x is None else x.data_ptr()
              for x in (*(proj or (None, None)), self.p)), n_p)
        self._launched = ctypes.c_int(0)
        self._call = (self._lib.nsp_las_step_plan_f32,
                      ctypes.addressof(self._plan),
                      ctypes.addressof(self._launched), dev.index)

    @property
    def carry(self):
        """(h, c, aw, ctx) of the last step (zeros before the first)."""
        return self.sets[self.cur]

    def load_carry(self, ctx, h, c, aw):
        """Copies a carry into the workspace (the next step reads it)."""
        for dst, src in zip(self.carry, (h, c, aw, ctx)):
            dst.copy_(src)

    def step(self, use_parent: bool = False, keep=None, att_keep=None):
        """One step from ``eg`` and the carry (row n reads row
        ``parent[n]`` of it when use_parent); ``keep`` [N, H] and
        ``att_keep`` [N, T] (float32, contiguous) or None: the step's
        dropout scales, as ``las_step``. Returns the new carry (h, c, aw,
        ctx): the workspace's own tensors, overwritten by the step after
        the next."""
        if self._lib is None:
            ctx, h, c, aw = (self.carry[i] for i in (3, 0, 1, 2))
            outs = las_step_ref(
                self.eg, ctx, h, c, aw, *self.fixed,
                parent=self.parent if use_parent else None, keep=keep,
                att_keep=att_keep, proj=self.proj)
            for dst, src in zip(self.sets[self.cur ^ 1], outs):
                dst.copy_(src)
            if self.proj is not None:
                self.p.copy_(outs[4])
        else:
            for name, x, like in (("keep", keep, self.carry[0]),
                                  ("att_keep", att_keep, self.carry[2])):
                if x is None:
                    continue
                if x.device != self.eg.device:
                    raise ValueError(f"{name} on {x.device}, the "
                                     f"workspace on {self.eg.device}")
                check(name, x, like.shape)
            run, plan, launched, index = self._call
            err = run(plan, self.cur, 1 if use_parent else 0,
                      None if keep is None else keep.data_ptr(),
                      None if att_keep is None else att_keep.data_ptr(),
                      launched, torch._C._cuda_getCurrentRawStream(index))
            raise_on_error("las_step", err)
            las_step.launches += 1
            las_step.launches_dropout += att_keep is not None
            las_step.launches_proj += self.proj is not None
            las_step.launches_add += self.fixed[4] is None
            las_step.kernels_per_step = self._launched.value
        self.cur ^= 1
        return self.sets[self.cur]
