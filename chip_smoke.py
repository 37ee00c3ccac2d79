#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port (``neural_sp_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build the CUDA kernels from ``neural_sp_tpu_torch/ops/kernels/csrc``
     with nvcc (sm_90a, one nvcc per source, all at once) and time the
     build;
  2. hold each kernel against its plain PyTorch twin at the serving path's
     shapes (K1 rel_attention: B=4, H=8, dk=64, R=11, T in 800/400/200 with
     ragged lengths; K2 las_step: N=10, 4 and 40 rows at T=200, as the three
     served sessions give it, and N=10 at T=400, the checked call and the
     workspace form a decode loop uses, each with and without a beam's
     reorder ``parent``, the two forms equal bit for bit),
     TF32 off, and time kernel and twin with CUDA events; K1 also against
     its library yardstick, ``F.scaled_dot_product_attention`` with the
     rel-PE bias as an additive mask (efficient backend), timed in turns
     with the kernel;
     each kernel's bound (``ops/kernels/roofline.py`` from its ``*_cost``)
     is printed beside its time;
  3. build the flagship Conformer-LAS (``configs.flagship_args(faithful=
     True)``, full widths, seeded random weights) on the card and serve a
     batch of 4 fbank-shaped utterances (700/1000/1300/1600 frames x 80)
     through ``Speech2TextSession.decode`` with beam 10 + CTC weight 0.3,
     with the on-device batched beam 10 (no CTC) and with greedy
     decoding (wall per decode step beside each RTF); launch counters are
     zeroed just before and read just after, and both kernels must have run;
     then time the encoder alone and profile one beam request (device
     busy time against wall time, the kernels taking the most time);
  4. run the encoder with the twins in place of the kernels and compare
     the encoder outputs, then replay the best beam hypothesis through the
     twin decode step and compare the logits at every step; then step the
     serving loops' ``DecodeLoop`` (the carry in K2's workspace) at N=40, 10
     and 4 rows for 8 steps with random tokens and random ``parent`` rows,
     against the chain of plain steps, logits and attention weights at
     every step;
  2b. (after 4, so the serving phases keep their order) hold the training
     kernels against their plain versions at the training path's shapes:
     K1b rel_attention_bwd (B=32, H=8, dk=64, R=11, T in 750/375/188,
     ragged lengths; and K1 there at full lengths), K3 las_scan and K3b
     las_scan_bwd (B=32, U+1=101, T=188, H=1024, D=A=512, C=10, K=201,
     dropout keep-masks; K3's kernel launches per call; the time of K3b's
     wrapper's work after its kernel loop), K4 ctc_loss forward and backward
     (B=32, T=188, U=100, V=10000, ragged lengths, a repeated label);
     errors are normalised by the reference's largest magnitude; K1b
     against the autograd backward of K1's yardstick, K4 against
     ``F.ctc_loss``; each with its bound;
     Then K1's and K1b's bf16 entries at the same shapes, ragged and full
     lengths, each against its plain bf16 version (1e-2 of the
     reference's max) and against the plain float32 version on the same
     bf16-rounded inputs (its error at most 1.5x the plain bf16
     version's), timed in turns with efficient SDPA in bf16 (and its
     backward), with the bound at the bf16 tensor-core peak; and the time
     of LASScan's casts at K3's and K3b's boundary under bf16 compute;
  5. train the flagship (same model, ``train()`` mode: SpecAugment and
     dropout on, f32, TF32 off) with noam Adam, clip 5 and 4-step
     accumulation on B=32 utterances of 1500 frames x 80 with U=100 labels:
     one warm-up optimizer step, then 2 timed ones (counts zeroed just
     before all 12 microsteps and read just after; K1, K1b, K3, K3b and K4
     must have run; K3's and K3b's kernel launches per call read there
     too), and profile one microstep; then the same at bf16 compute over
     float32 master weights (``train_dtype`` "bfloat16", as ``bench.py``
     times the JAX step): K1's and K1b's bf16 entries, K3, K3b and K4 must
     have run, and no float32 K1 / K1b;
  6. one microstep's loss and every gradient in ``eval()`` mode with the
     kernels against the plain versions patched in;
  6b. the same at bf16 compute: the kernels' loss and each gradient leaf
     no farther from the plain f32 microstep than twice the plain bf16
     microstep, plus phase 6's tolerance, in the L2 norm; then
     5 Adam steps (lr 1e-4) on a fixed batch of 8 utterances in
     ``train()`` mode, in float32 and at bf16, whose loss must fall.

Launches per step (per encode for K1, per decode step for K2, per training
microstep for the rest; K1 / K1b bf16 in phase 5's bf16 run) are counted
in phases 3b, 4 and 5. Prints the
details as JSON (also written to ``chiprun_out/chip_smoke.json``), then one
JSON line of per-kernel results (launches, launches_per_step, ms,
plain_ms, bound_ms, bound_by, library_ms, errors), the card's ``name,
power.limit`` (nvidia-smi), and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the package beside this script, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "neural_sp_tpu_torch"
SEED = 0
UTT_FRAMES = (700, 1000, 1300, 1600)   # 10 ms frames
FRAME_SEC = 0.01
# Kernel vs twin, float32 on both sides: the sums run in other orders
# (online softmax, split-K GEMV), so agreement is to float32 rounding
# amplified by the reduction length.
KERNEL_ATOL = 1e-4
# A library yardstick's output against the plain version, max |err| / max
# |reference|: it must compute the same function.
YARDSTICK_RTOL = 1e-3
# Whole encoder (12 layers) and a replayed decoder chain: the per-kernel
# rounding differences above, carried through every layer / step.
PATH_ATOL = 2e-3
# Training kernels vs plain versions, max |err| / max |reference|: sums in
# other orders (K1b over T keys, K4 over T frames); K3 / K3b carry them
# through a 101-step recurrence.
TRAIN_KERNEL_TOL = {"rel_attention_bwd": 1e-4, "ctc_loss": 1e-4,
                    "las_scan": 1e-3, "las_scan_bwd": 1e-3}
# Train-step parity (phase 6), kernels vs plain versions through the whole
# model: loss to 1e-4 relative; each gradient leaf to 2e-3 of its own
# largest magnitude. The self-attention key biases are the exception: the
# softmax's shift invariance makes their gradient zero in exact arithmetic,
# so both sides hold rounding only, and they are held to 1e-5 of the
# largest gradient of all leaves instead.
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_FLOOR = 2e-3, 1e-5
ZERO_GRAD_LEAF = ".mha.w_key.bias"
TRAIN_B, TRAIN_FRAMES, TRAIN_U, ACCUM = 32, 1500, 100, 4
# K1 / K1b's bf16 entries vs their plain bf16 versions, max |err| / max
# |reference|: bf16 carries 8 significant bits; the two round P and ds at
# the same points but sum in other orders.
BF16_KERNEL_TOL = 1e-2
# ... and against the plain float32 version on the same bf16-rounded
# inputs: the kernel's error at most this multiple of the plain bf16
# version's, so the kernel is no less exact than the plain path.
BF16_VS_F32_RATIO = 1.5
# Phase 6b, the bf16 microstep with the kernels against the same microstep
# with the plain versions: the loss and each gradient leaf of the kernels'
# microstep may lie no farther from the plain float32 microstep's than
# twice the plain bf16 microstep does (the kernels no less exact than the
# plain path), in the L2 norm (as the CPU tests' rule), plus phase 6's
# float32 tolerance carried to the L2 norm (LOSS_RTOL; per element
# GRAD_RTOL of the leaf's max, GRAD_FLOOR of the largest gradient for the
# key biases, times the root of the leaf's size): the kernels no less
# exact than the plain path, as phase 2b holds each kernel. Not |kernels -
# plain bf16|: in the attention query / key projections' gradients
# (zero-sum in exact arithmetic, so rounding is most of what bf16 leaves
# there) the two paths' bf16 errors are of one size and point apart, so
# their difference reaches twice either (0.996 of that tolerance on the
# H100 with K1 rounding P where the plain version does; 1.1 when K1
# rounded it before the 1 / l, its error then up to 3x the plain one's).
BF16_PATH_FACTOR = 2.0


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_pair(fn, library, iters: int = 20) -> tuple[float, float]:
    """CUDA-event ms of a kernel and of its library yardstick, timed in
    turns (kernel, library, library, kernel), each the mean of its two."""
    k1, l1 = cuda_ms(fn, iters), cuda_ms(library, iters)
    l2, k2 = cuda_ms(library, iters), cuda_ms(fn, iters)
    return (k1 + k2) / 2, (l1 + l2) / 2


def roofline(cost: tuple[int, int], simt: bool = False,
             bf16: bool = False) -> dict:
    """The least time the card could take for (flops, bytes): bound_ms and
    bound_by, at the peak of the kernel's products (``peak_flops``: float32
    on the tensor cores by the 3xTF32 split, bf16 on the tensor cores for
    the bf16 entries, or the SIMT pipes); for matrix products also the
    bound on the SIMT pipes alone (what the f32 kernels without tensor
    cores can reach at best)."""
    from neural_sp_tpu_torch.ops.kernels.roofline import (
        BF16_TENSOR_FLOPS, F32_SIMT_FLOPS, F32_TENSOR_FLOPS, bound_ms)
    flops, nbytes = cost
    peak = F32_SIMT_FLOPS if simt else BF16_TENSOR_FLOPS if bf16 \
        else F32_TENSOR_FLOPS
    ms, by = bound_ms(flops, nbytes, peak)
    out = {"flops": flops, "bytes": nbytes, "bound_ms": ms, "bound_by": by,
           "peak_flops": peak}
    if not simt:
        out["simt_bound_ms"] = bound_ms(flops, nbytes, F32_SIMT_FLOPS)[0]
    return out


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def rel_bias(torch, p, klens):
    """K1's rel-PE bias and key mask as one additive [B, H, T, T] mask, in
    p's type, for the library yardstick: p[b, h, i, min(|i-j|, R-1)] on
    valid keys, finfo(f32).min / 2 on masked ones. A view into rows padded
    to a multiple of 16 elements, the alignment the efficient kernel
    takes."""
    b, h, t, r = p.shape
    pos = torch.arange(t, device=p.device)
    idx = (pos[:, None] - pos[None, :]).abs().clamp(max=r - 1)
    bias = torch.empty((b, h, t, -(-t // 16) * 16), device=p.device,
                       dtype=p.dtype)[..., :t]
    bias.copy_(torch.gather(p, -1, idx.expand(b, h, t, t)))
    masked = pos[None, :] >= klens[:, None].long()
    return bias.masked_fill_(masked[:, None, None, :],
                             torch.finfo(torch.float32).min / 2)


def bias_grad_to_buckets(torch, dbias, r):
    """dbias [B, H, T, T] summed into the R distance buckets of dp (in
    float32, returned in dbias's type)."""
    b, h, t, _ = dbias.shape
    pos = torch.arange(t, device=dbias.device)
    idx = (pos[:, None] - pos[None, :]).abs().clamp(max=r - 1)
    return torch.zeros((b, h, t, r), device=dbias.device).scatter_add_(
        -1, idx.expand(b, h, t, t), dbias.float()).to(dbias.dtype)


def efficient_sdpa():
    """The efficient-attention backend only: float32 on the tensor cores
    with the 3xTF32 split (bf16 inputs: bf16 products), taking an additive
    mask of the inputs' type."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    return sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION)


def rel_attention_yardstick(torch, args, kernel, what: str,
                            phase: str = "2",
                            tol: float = YARDSTICK_RTOL) -> dict:
    """K1 against F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
    scale=1.0), the efficient backend, on the same inputs (float32 or
    bf16). The bias is built once, outside the timed region, and its time
    is logged apart. The library's output is held to the plain version
    (within ``tol`` of its max): a yardstick that computes something else
    is none."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from neural_sp_tpu_torch.ops.kernels import rel_attention_ref
    q, k, v, p, klens = args
    bias_ms = cuda_ms(lambda: rel_bias(torch, p, klens), iters=3, warmup=1)
    bias = rel_bias(torch, p, klens)
    with efficient_sdpa():
        err = rel_err(sdpa(q, k, v, attn_mask=bias, scale=1.0),
                      rel_attention_ref(*args))
        ms, lib_ms = timed_pair(lambda: kernel(*args), lambda: sdpa(
            q, k, v, attn_mask=bias, scale=1.0))
    log(f"[{phase}] K1 {what}: kernel {ms:.4f} ms  library (SDPA, efficient) "
        f"{lib_ms:.4f} ms, its error {err:.3e} of the plain max; bias "
        f"built in {bias_ms:.4f} ms")
    expect(err <= tol, f"K1 yardstick {what}: error {err}")
    return {"kernel_ms": ms, "library_ms": lib_ms, "library_err": err,
            "bias_ms": bias_ms}


def expect(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_build():
    from neural_sp_tpu_torch.ops.kernels.build import build_library, \
        load_library
    t0 = time.perf_counter()
    path, nvcc_out = build_library()
    load_library()
    sec = time.perf_counter() - t0
    log(f"[1] built {path.name} in {sec:.2f} s")
    for line in nvcc_out.splitlines():
        if "registers" in line or "Compiling entry" in line or \
                "spill" in line:
            log(f"    {line.strip()}")
    return sec


def phase_kernels(torch, rng):
    from neural_sp_tpu_torch.ops.kernels import (
        las_step, las_step_ref, rel_attention, rel_attention_ref)
    from neural_sp_tpu_torch.ops.kernels.las_step import (LasStepWorkspace,
                                                          las_step_cost)
    from neural_sp_tpu_torch.ops.kernels.rel_attention import \
        rel_attention_cost
    dev = torch.device("cuda")

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype("float32")).to(dev)

    res = {"rel_attention": {"max_abs_err": 0.0, "shapes": []},
           "las_step": {"max_abs_err": 0.0}}
    b, h, dk, r = 4, 8, 64, 11
    for tt in (800, 400, 200):
        q, k, v = t(b, h, tt, dk, scale=dk ** -0.5), t(b, h, tt, dk), \
            t(b, h, tt, dk)
        p = t(b, h, tt, r, scale=dk ** -0.5)
        kl = [tt, tt - tt // 4, tt // 2, tt // 3 + 1]
        klens = torch.tensor(kl, dtype=torch.int32, device=dev)
        args = (q, k, v, p, klens)
        err = max_err(rel_attention(*args), rel_attention_ref(*args))
        ref_ms = cuda_ms(lambda: rel_attention_ref(*args))
        what = f"B={b} H={h} T={tt} dk={dk} R={r} klens={kl}"
        yard = rel_attention_yardstick(torch, args, rel_attention, what)
        bound = roofline(rel_attention_cost(b, h, tt, dk, r, kl))
        ms = yard["kernel_ms"]
        log(f"[2] K1 rel_attention {what}: max_abs_err {err:.3e}  kernel "
            f"{ms:.4f} ms  twin {ref_ms:.4f} ms  bound {bound['bound_ms']:.4f}"
            f" ms ({bound['bound_by']}; SIMT f32 alone "
            f"{bound['simt_bound_ms']:.4f} ms)")
        expect(err <= KERNEL_ATOL, f"K1 T={tt}: error {err} > {KERNEL_ATOL}")
        row = res["rel_attention"]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        shape = {"shape": what, "ms": ms, "plain_ms": ref_ms, **yard, **bound}
        row["shapes"].append(shape)
        if tt == 800:
            row.update(ms=ms, plain_ms=ref_ms, library_ms=yard["library_ms"],
                       library_err=yard["library_err"], **bound)

    hd, d, a, c, kw = 1024, 512, 512, 10, 201
    # the rows the served sessions give it: 10 (beam 10 of one utterance),
    # 4 (greedy, the batch) and 40 (the on-device beam over the batch)
    for n, tt in ((10, 200), (4, 200), (40, 200), (10, 400)):
        aw_prev = torch.softmax(t(n, tt, scale=3.0), -1)
        args = (t(n, 4 * hd, scale=0.5), t(n, d), t(n, hd, scale=0.5),
                t(n, hd), aw_prev, t(d, 4 * hd, scale=(d + hd) ** -0.5),
                t(hd, 4 * hd, scale=(d + hd) ** -0.5), t(4 * hd, scale=0.1),
                t(a, hd, scale=hd ** -0.5), t(c, kw, scale=kw ** -0.5),
                t(a, c, scale=c ** -0.5), t(a, scale=a ** -0.5),
                t(n, tt, a), t(n, tt, d),
                torch.tensor([tt - 3 * i for i in range(n)],
                             dtype=torch.int32, device=dev))
        # both forms of the wrapper (the checked, allocating call and the
        # workspace a decode loop steps through), without and with a
        # beam's reorder, against the plain version; the forms must agree
        # bit for bit
        ws = LasStepWorkspace(*args[5:])
        parent = torch.from_numpy(
            rng.integers(0, n, n).astype("int32")).to(dev)
        err = 0.0
        for par in (None, parent):
            refs = las_step_ref(*args, parent=par)
            outs = las_step(*args, parent=par)
            ws.load_carry(*args[1:5])
            ws.eg.copy_(args[0])
            if par is not None:
                ws.parent.copy_(par)
            stepped = ws.step(use_parent=par is not None)
            err = max(err, *(max_err(x, y) for x, y in zip(outs, refs)))
            expect(all(torch.equal(x, y) for x, y in zip(stepped, outs)),
                   f"K2 N={n} T={tt}: the workspace form differs from the "
                   f"call")
        per_step = las_step.kernels_per_step
        ms = cuda_ms(lambda: ws.step(use_parent=True), iters=200)
        call_ms = cuda_ms(lambda: las_step(*args, parent=parent), iters=200)
        ref_ms = cuda_ms(lambda: las_step_ref(*args, parent=parent))
        bound = roofline(las_step_cost(n, tt, hd, d, a, c, kw,
                                       args[-1].tolist()))
        log(f"[2] K2 las_step N={n} T={tt} H={hd} D={d} A={a} C={c} K={kw}: "
            f"max_abs_err {err:.3e}  kernel {ms:.4f} ms through its "
            f"workspace, {call_ms:.4f} ms as a checked call, {per_step} "
            f"kernels per step  twin {ref_ms:.4f} ms  bound "
            f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        expect(err <= KERNEL_ATOL,
               f"K2 N={n} T={tt}: error {err} > {KERNEL_ATOL}")
        row = res["las_step"]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        shape = {"shape": f"N={n} T={tt}", "max_abs_err": err, "ms": ms,
                 "checked_call_ms": call_ms, "kernels_per_step": per_step,
                 "plain_ms": ref_ms, **bound}
        row.setdefault("shapes", []).append(shape)
        if (n, tt) == (10, 200):
            # no single PyTorch call computes an LSTM cell with location
            # attention fed back: no library yardstick
            row.update(ms=ms, checked_call_ms=call_ms,
                       kernels_per_step=per_step, plain_ms=ref_ms,
                       library_ms=None, **bound)
    return res


def flagship_model(torch):
    from neural_sp_tpu_torch.configs import flagship_args
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.utils.init_params import init_params
    model = build_speech2text(flagship_args(faithful=True))   # on the card
    init_params(model, SEED)
    return model.eval()


def utterances(rng):
    import numpy as np
    xs = np.zeros((len(UTT_FRAMES), max(UTT_FRAMES), 80), np.float32)
    for i, t in enumerate(UTT_FRAMES):
        xs[i, :t] = rng.standard_normal((t, 80))
    return xs, np.asarray(UTT_FRAMES, np.int64)


def phase_serve(torch, model, xs, xlens):
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
    from neural_sp_tpu_torch.models.decoders.las import DecodeLoop
    from neural_sp_tpu_torch.ops.kernels import (
        las_step, rel_attention, reset_launches)
    beam = Speech2TextSession(model, DecodeConfig(beam_width=10,
                                                  ctc_weight=0.3))
    device_beam = Speech2TextSession(model, DecodeConfig(beam_width=10,
                                                         device_beam=True))
    greedy = Speech2TextSession(model, DecodeConfig(beam_width=1))
    sessions = (("beam10_ctc0.3", beam), ("beam10_device", device_beam),
                ("greedy", greedy))
    for _, sess in sessions:   # warm-up, not counted
        sess.decode(xs[:1, :200], xlens[:1] * 0 + 200)
    torch.cuda.synchronize()
    audio_sec = float(xlens.sum()) * FRAME_SEC
    out = {}
    reset_launches()
    for name, sess in sessions:
        torch.cuda.reset_peak_memory_stats()
        steps_before = DecodeLoop.steps
        t0 = time.perf_counter()
        hyps = sess.decode(xs, xlens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = DecodeLoop.steps - steps_before
        expect(len(hyps) == len(UTT_FRAMES) and all(
            all(isinstance(y, int) and 0 <= y < model.dec_fwd.vocab
                for y in hyp) for hyp in hyps), f"{name}: malformed {hyps}")
        out[name] = {"hyp_lens": [len(h) for h in hyps], "wall_s": wall,
                     "wall_s_per_utt": wall / len(hyps),
                     "rtf": wall / audio_sec, "decode_steps": steps,
                     "wall_ms_per_decode_step": wall * 1e3 / max(steps, 1),
                     "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        if name == "beam10_ctc0.3":
            out["best_hyp0"] = hyps[0]
        log(f"[3] {name}: hyp lens {out[name]['hyp_lens']}  wall "
            f"{wall:.3f} s ({wall / len(hyps):.3f} s/utt)  RTF "
            f"{wall / audio_sec:.4f}  {steps} decode steps, "
            f"{out[name]['wall_ms_per_decode_step']:.4f} ms of wall each  "
            f"peak mem "
            f"{out[name]['peak_mem_bytes']} B")
    launches = {"rel_attention": rel_attention.launches,
                "las_step": las_step.launches}
    log(f"[3] launches during the served requests: {launches}")
    expect(all(v > 0 for v in launches.values()),
           f"a kernel of the path never launched: {launches}")
    return out, launches


def profiled(torch, what: str, fn) -> dict:
    """Run fn once under torch.profiler: wall time, device busy time (the
    union of the device events' intervals), idle share, and the kernels
    that take the most device time."""
    from collections import defaultdict
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], defaultdict(float)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            start, end = evt.time_range.start, evt.time_range.end
            spans.append((start, end))
            by_name[evt.name[:110]] += (end - start) / 1e3
    busy_us, last = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > last:
            busy_us += end - max(start, last)
            last = end
    out = {"wall_s": wall}
    if not spans:
        log(f"[3b] {what}: wall {wall:.3f} s; device time not measured "
            f"(the profiler saw no device events)")
        return out
    out.update(device_busy_s=busy_us / 1e6,
               device_idle_share=1.0 - busy_us / 1e6 / wall,
               top_device_ms=dict(sorted(by_name.items(),
                                         key=lambda kv: -kv[1])[:12]))
    log(f"[3b] {what}: wall {wall:.3f} s, device busy "
        f"{busy_us / 1e6:.4f} s, idle share {out['device_idle_share']:.4f}")
    for name, ms in out["top_device_ms"].items():
        log(f"      {ms:9.3f} ms  {name}")
    return out


def phase_breakdown(torch, model, xs, xlens):
    """Where a request's time goes: the encoder alone, one beam-10 + CTC
    request on the shortest utterance, and the on-device beam over the
    whole batch, each profiled."""
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
    beam = Speech2TextSession(model, DecodeConfig(beam_width=10,
                                                  ctc_weight=0.3))
    device_beam = Speech2TextSession(model, DecodeConfig(beam_width=10,
                                                         device_beam=True))
    from neural_sp_tpu_torch.ops.kernels import rel_attention, reset_launches
    reset_launches()
    t0 = time.perf_counter()
    beam.encode(xs, xlens)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    per_encode = rel_attention.launches
    log(f"[3b] encoder, batch of {len(UTT_FRAMES)}: {enc_s:.4f} s; K1 "
        f"launches per encode {per_encode}")
    n = UTT_FRAMES[0]
    return {"encode_batch_s": enc_s, "k1_launches_per_encode": per_encode,
            "beam10_ctc0.3_one_utt": profiled(
                torch, f"beam 10 + CTC 0.3, the {n}-frame utterance",
                lambda: beam.decode(xs[:1, :n], xlens[:1])),
            "beam10_device_batch": profiled(
                torch, f"on-device beam 10, batch of {len(UTT_FRAMES)}",
                lambda: device_beam.decode(xs, xlens))}


def phase_twins(torch, model, xs, xlens, best_hyp):
    """Encoder and decoder chain with the kernels against the twins."""
    from neural_sp_tpu_torch import EOS
    from neural_sp_tpu_torch.models.decoders import las
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
    from neural_sp_tpu_torch.models.modules import \
        relative_multihead_attention as rma
    from neural_sp_tpu_torch.ops.kernels import las_step, las_step_ref, \
        rel_attention_ref
    sess = Speech2TextSession(model, DecodeConfig(beam_width=10,
                                                  ctc_weight=0.3))
    eouts = sess.encode(xs, xlens)
    with mock.patch.object(rma, "rel_attention", rel_attention_ref):
        eouts_ref = sess.encode(xs, xlens)
    e, el = eouts["ys"]["xs"], eouts["ys"]["xlens"]
    expect(bool(torch.isfinite(e).all()), "encoder output not finite")
    expect(bool((el == eouts_ref["ys"]["xlens"]).all()), "encoder lengths")
    enc_err = max_err(e, eouts_ref["ys"]["xs"])
    log(f"[4] encoder {tuple(e.shape)}, lens {el.tolist()}: kernels vs "
        f"twins max_abs_err {enc_err:.3e}")
    expect(enc_err <= PATH_ATOL, f"encoder error {enc_err} > {PATH_ATOL}")

    dec = model.dec_fwd
    e0, el0 = e[:1], el[:1]
    klens = el0.to(torch.int32)
    tokens = [EOS] + best_hyp
    step_err = 0.0
    before = las_step.launches
    with torch.inference_mode():
        kc = dec.precompute_keys(e0)
        carry = carry_ref = dec.init_carry(1, e0.shape[1], e0.device)
        for y in tokens:
            y_t = torch.tensor([y], device=e0.device)
            carry, logits, _ = dec.decode_step(carry, y_t, kc, e0, klens)
            with mock.patch.object(las, "las_step", las_step_ref):
                carry_ref, logits_ref, _ = dec.decode_step(
                    carry_ref, y_t, kc, e0, klens)
            expect(bool(torch.isfinite(logits).all()), "logits not finite")
            step_err = max(step_err, max_err(logits, logits_ref))
    per_step = (las_step.launches - before) / len(tokens)
    log(f"[4] best hypothesis replay, {len(tokens)} steps: kernels vs twins "
        f"logits max_abs_err {step_err:.3e}; K2 launches per decode step "
        f"{per_step}")
    expect(step_err <= PATH_ATOL, f"decoder error {step_err} > {PATH_ATOL}")
    # the loops as the sessions step them: beam 10 of one utterance, the
    # on-device beam over the batch, greedy over the batch
    k = 10
    loop_err = max(
        loop_against_plain(torch, dec, e0.repeat_interleave(k, 0),
                           el0.repeat_interleave(k), reorder=True),
        loop_against_plain(torch, dec, e.repeat_interleave(k, 0),
                           el.repeat_interleave(k), reorder=True),
        loop_against_plain(torch, dec, e, el, reorder=True),
        loop_against_plain(torch, dec, e, el, reorder=False))
    return enc_err, max(step_err, loop_err), per_step


def loop_against_plain(torch, dec, e, el, reorder: bool, n_steps: int = 8):
    """Steps a ``DecodeLoop`` over the encoder outputs e [N, T, D] with
    seeded random tokens and, with ``reorder``, random parent rows, against
    the chain of plain decode steps on the same tokens and parents. Returns
    the largest error of the logits and the attention weights over the
    steps."""
    from neural_sp_tpu_torch.models.decoders import las
    from neural_sp_tpu_torch.ops.kernels import las_step, las_step_ref
    n, dev = e.shape[0], e.device
    gen = torch.Generator().manual_seed(SEED + n)
    klens = el.to(torch.int32)
    err = 0.0
    with torch.inference_mode():
        kc = dec.precompute_keys(e)
        before = las_step.launches
        loop = dec.decode_loop(kc, e, klens)
        carry = dec.init_carry(n, e.shape[1], dev)
        par = None
        for i in range(n_steps):
            y = torch.randint(4, dec.vocab, (n,), generator=gen).to(dev)
            if reorder and i > 0:
                par = torch.randint(0, n, (n,), generator=gen).to(
                    device=dev, dtype=torch.int32)
            logits, aw = loop.step(y, par)
            with mock.patch.object(las, "las_step", las_step_ref):
                carry, logits_ref, aw_ref = dec.decode_step(
                    carry, y, kc, e, klens, parent=par)
            expect(bool(torch.isfinite(logits).all()), "logits not finite")
            err = max(err, max_err(logits, logits_ref), max_err(aw, aw_ref))
        launched = las_step.launches - before
    log(f"[4] DecodeLoop N={n} reorder={reorder}, {n_steps} steps: logits "
        f"and attention weights vs the plain chain max_abs_err {err:.3e}; "
        f"K2 launches {launched}")
    expect(launched == n_steps, f"{launched} K2 launches in {n_steps} steps")
    expect(err <= PATH_ATOL, f"DecodeLoop N={n}: error {err} > {PATH_ATOL}")
    return err


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in float32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def rel_attention_bwd_yardstick(torch, args, kernel, what: str,
                                tol: float = YARDSTICK_RTOL) -> dict:
    """K1b against the autograd backward of K1's yardstick call
    (torch.autograd.grad of the efficient SDPA output w.r.t. q, k, v and
    the bias, on the same do), timed alone; the scatter of dbias into the R
    buckets of dp is timed apart. The library's dq, dk, dv, dp are held to
    the plain version (within ``tol`` of each one's max) taken with the
    library's own output as o: its D is sum dO out, so at bf16 its
    gradients follow where its forward rounded P."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from neural_sp_tpu_torch.ops.kernels.rel_attention import \
        rel_attention_bwd_ref
    q, k, v, p, klens, _, m, l, do = args
    bias = rel_bias(torch, p, klens).requires_grad_()
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    with efficient_sdpa():
        out = sdpa(*leaves, attn_mask=bias, scale=1.0)

        def grads():
            return torch.autograd.grad(out, (*leaves, bias), do,
                                       retain_graph=True)

        *dqkv, dbias = grads()
        ms, lib_ms = timed_pair(lambda: kernel(*args), grads, iters=10)
    r = p.shape[-1]
    scatter_ms = cuda_ms(lambda: bias_grad_to_buckets(torch, dbias, r),
                         iters=5, warmup=1)
    got = (*dqkv, bias_grad_to_buckets(torch, dbias, r))
    want = rel_attention_bwd_ref(q, k, v, p, klens, out.detach(), m, l, do)
    err = max(rel_err(x, y) for x, y in zip(got, want))
    log(f"[2b] K1b {what}: kernel {ms:.4f} ms  library (SDPA backward, "
        f"efficient) {lib_ms:.4f} ms + dbias into buckets {scatter_ms:.4f} "
        f"ms; library error {err:.3e} of the plain max")
    expect(err <= tol, f"K1b yardstick {what}: error {err}")
    return {"kernel_ms": ms, "library_ms": lib_ms, "library_err": err,
            "bucket_scatter_ms": scatter_ms}


def ctc_yardstick(torch, cargs, nll_r, alphas_r, g) -> dict:
    """K4 against F.ctc_loss(lp.transpose(0, 1), labels, lengths, blank=0,
    reduction="none"): forward against K4's forward; F.ctc_loss's backward
    gives the gradient w.r.t. the logits, so it is set against K4's
    backward followed by the log-softmax backward. Each output is held to
    the plain version."""
    from torch.nn.functional import ctc_loss
    from neural_sp_tpu_torch.ops.kernels.ctc_loss import (
        ctc_loss_bwd, ctc_loss_bwd_ref, ctc_loss_fwd)
    lp, labels, tl, ul = cargs

    def lib_fwd(x=lp):
        return ctc_loss(x.transpose(0, 1), labels, tl, ul, blank=0,
                        reduction="none")

    def lsm_bwd(grad):
        return torch._log_softmax_backward_data(grad, lp, -1, lp.dtype)

    leaf = lp.detach().requires_grad_()
    loss = lib_fwd(leaf)

    def lib_bwd():
        return torch.autograd.grad(loss, leaf, g, retain_graph=True)[0]

    err = max(rel_err(lib_fwd(), nll_r), rel_err(lib_bwd(), lsm_bwd(
        ctc_loss_bwd_ref(*cargs, nll_r, alphas_r, g))))
    fwd_ms, fwd_lib = timed_pair(lambda: ctc_loss_fwd(*cargs), lib_fwd)
    bwd_lsm_ms, bwd_lib = timed_pair(
        lambda: lsm_bwd(ctc_loss_bwd(*cargs, nll_r, alphas_r, g)), lib_bwd)
    log(f"[2b] K4 forward {fwd_ms:.4f} ms, F.ctc_loss forward {fwd_lib:.4f}"
        f" ms; K4 backward + log-softmax backward {bwd_lsm_ms:.4f} ms, "
        f"F.ctc_loss backward {bwd_lib:.4f} ms; library error {err:.3e} of "
        f"the plain max")
    expect(err <= YARDSTICK_RTOL, f"K4 yardstick: error {err}")
    return {"fwd_kernel_ms": fwd_ms, "fwd_library_ms": fwd_lib,
            "bwd_with_log_softmax_ms": bwd_lsm_ms, "bwd_library_ms": bwd_lib,
            "library_ms": fwd_lib + bwd_lib, "library_err": err}


def phase_train_kernels(torch, rng):
    """2b: the training kernels against their plain versions, at the
    training path's shapes, with CUDA-event times of each, their bounds
    and their library yardsticks; K1 at the training shapes too."""
    import numpy as np
    from neural_sp_tpu_torch.ops.kernels import rel_attention
    from neural_sp_tpu_torch.ops.kernels.ctc_loss import (
        ctc_forward_alphas, ctc_loss_bwd, ctc_loss_bwd_cost,
        ctc_loss_bwd_ref, ctc_loss_cost, ctc_loss_fwd)
    from neural_sp_tpu_torch.ops.kernels.las_scan import (
        las_scan, las_scan_bwd, las_scan_bwd_chain, las_scan_bwd_cost,
        las_scan_bwd_finish, las_scan_bwd_ref, las_scan_cost, las_scan_ref)
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_bwd, rel_attention_bwd_cost, rel_attention_bwd_ref,
        rel_attention_cost, rel_attention_fwd, rel_attention_ref)
    dev = torch.device("cuda")

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype("float32")).to(dev)

    res = {"rel_attention_train_shapes": []}

    def record(name, err, ms, ref_ms, what, **extra):
        log(f"[2b] {name} {what}: error {err:.3e} (of the reference's max)"
            f"  kernel {ms:.4f} ms  plain {ref_ms:.4f} ms"
            + (f"  bound {extra['bound_ms']:.4f} ms ({extra['bound_by']})"
               if "bound_ms" in extra else ""))
        tol = TRAIN_KERNEL_TOL[name]
        expect(err <= tol, f"{name} {what}: error {err} > {tol}")
        r = res.setdefault(name, {"max_abs_err": 0.0, "shapes": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["shapes"].append({"shape": what, "ms": ms, "plain_ms": ref_ms,
                            **extra})
        if "ms" not in r:
            r.update(ms=ms, plain_ms=ref_ms, **extra)

    b, h, dk, r = TRAIN_B, 8, 64, 11
    for tt in (750, 375, 188):
        q, k, v = t(b, h, tt, dk, scale=dk ** -0.5), t(b, h, tt, dk), \
            t(b, h, tt, dk)
        p = t(b, h, tt, r, scale=dk ** -0.5)
        kl = np.maximum(tt - (np.arange(b) * tt) // (2 * b), 1).tolist()
        klens = torch.tensor(kl, dtype=torch.int32, device=dev)
        o, m, l = rel_attention_fwd(q, k, v, p, klens)
        do = t(b, h, tt, dk)
        args = (q, k, v, p, klens, o, m, l, do)
        got, want = rel_attention_bwd(*args), rel_attention_bwd_ref(*args)
        err = max(rel_err(x, y) for x, y in zip(got, want))
        what = f"B={b} H={h} T={tt} dk={dk} R={r}"
        yard = rel_attention_bwd_yardstick(
            torch, args, rel_attention_bwd, what + " ragged klens")
        record("rel_attention_bwd", err, yard["kernel_ms"],
               cuda_ms(lambda: rel_attention_bwd_ref(*args), iters=5),
               what, **yard,
               **roofline(rel_attention_bwd_cost(b, h, tt, dk, r, kl)))
        # K1 at the training shapes, full lengths as phase 5 runs it
        full = torch.full((b,), tt, dtype=torch.int32, device=dev)
        fargs = (q, k, v, p, full)
        err = max_err(rel_attention(*fargs), rel_attention_ref(*fargs))
        expect(err <= KERNEL_ATOL, f"K1 {what}: error {err} > {KERNEL_ATOL}")
        yard = rel_attention_yardstick(torch, fargs, rel_attention,
                                       what + " full lengths", phase="2b")
        bound = roofline(rel_attention_cost(b, h, tt, dk, r, [tt] * b))
        res["rel_attention_train_shapes"].append(
            {"shape": what + " full lengths", "ms": yard["kernel_ms"],
             "plain_ms": cuda_ms(lambda: rel_attention_ref(*fargs), iters=5),
             "max_abs_err": err, **yard, **bound})
        log(f"[2b] K1 {what} full lengths: max_abs_err {err:.3e}  bound "
            f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        del got, want, args, fargs, o, m, l, do

    u, tt, hd, d, a, c, kw = 101, 188, 1024, 512, 512, 10, 201
    rate = 0.1
    keep = (torch.from_numpy((rng.random((u, b, hd)) >= rate).astype(
        "float32")) / (1 - rate)).to(dev)
    kl = [tt - 3 * i for i in range(b)]
    args = (t(u, b, 4 * hd, scale=0.5), t(d, 4 * hd, scale=(d + hd) ** -0.5),
            t(hd, 4 * hd, scale=(d + hd) ** -0.5), t(4 * hd, scale=0.1),
            t(a, hd, scale=hd ** -0.5), t(c, kw, scale=kw ** -0.5),
            t(a, c, scale=c ** -0.5), t(a, scale=a ** -0.5), t(b, tt, a),
            t(b, tt, d), torch.tensor(kl, dtype=torch.int32, device=dev),
            keep)
    outs, refs = las_scan(*args), las_scan_ref(*args)
    what = f"B={b} U={u} T={tt} H={hd} D={d} A={a} C={c} K={kw}"
    log(f"[2b] las_scan: {las_scan.kernel_launches_per_call} kernel launches "
        f"per call")
    # no single PyTorch call computes the scan (cuDNN's LSTM has no
    # attention fed back into its input): no library yardstick
    record("las_scan", max(rel_err(x, y) for x, y in zip(outs, refs)),
           cuda_ms(lambda: las_scan(*args), iters=5, warmup=1),
           cuda_ms(lambda: las_scan_ref(*args), iters=5, warmup=1), what,
           library_ms=None,
           **roofline(las_scan_cost(u, b, tt, hd, d, a, c, kw, kl)))
    w_ctx, w_h, _, w_q, conv_w, w_f, v, kc, values, klt, keep = args[1:]
    bargs = (w_ctx, w_h, w_q, conv_w, w_f, v, kc, values, klt, keep, *refs,
             t(u, b, hd), t(u, b, d))
    got, want = las_scan_bwd(*bargs), las_scan_bwd_ref(*bargs)
    # the wrapper's work after the kernel loop (weight-gradient and
    # dvalues products, partial sums), timed alone on the loop's outputs
    h, _, _, _, aw, ctx = refs
    raw = las_scan_bwd_chain(*bargs)
    outside_ms = cuda_ms(lambda: las_scan_bwd_finish(h, ctx, keep, aw, *raw),
                         iters=5, warmup=1)
    log(f"[2b] las_scan_bwd: {las_scan_bwd.kernel_launches_per_call} kernel "
        f"launches per call; the work after the loop {outside_ms:.4f} ms")
    record("las_scan_bwd", max(rel_err(x, y) for x, y in zip(got, want)),
           cuda_ms(lambda: las_scan_bwd(*bargs), iters=5, warmup=1),
           cuda_ms(lambda: las_scan_bwd_ref(*bargs), iters=5, warmup=1),
           what, library_ms=None, outside_ms=outside_ms,
           **roofline(las_scan_bwd_cost(u, b, tt, hd, d, a, c, kw, kl)))
    # at bf16 compute K3 and K3b stay float32 and LASScan casts at their
    # boundary: the inputs (and keep) to float32 and h, ctx, aw back to
    # bf16 around K3; the output gradients to float32 and the ten input
    # gradients back to bf16 around K3b. The casts alone, on these shapes:
    bf = torch.bfloat16
    ins16 = [x.to(bf) for x in args if x.is_floating_point()]
    outs32 = (refs[0], refs[5], refs[4])
    douts16 = [x.to(bf) for x in bargs[-2:]]
    cast_fwd = cuda_ms(lambda: ([x.float() for x in ins16],
                                [y.to(bf) for y in outs32]), iters=5)
    cast_bwd = cuda_ms(lambda: ([x.float() for x in douts16],
                                [g.to(bf) for g in got]), iters=5)
    res["las_scan"]["bf16_boundary_cast_ms"] = cast_fwd
    res["las_scan_bwd"]["bf16_boundary_cast_ms"] = cast_bwd
    log(f"[2b] bf16 compute: LASScan's casts at K3's boundary {cast_fwd:.4f}"
        f" ms, at K3b's {cast_bwd:.4f} ms (the kernels stay float32)")
    del got, want, raw

    tt, uu, vv = 188, TRAIN_U, 10000
    lp = torch.log_softmax(t(b, tt, vv, scale=2.0), -1)
    labels = rng.integers(4, vv, (b, uu))
    labels[:, 1] = labels[:, 0]                       # a repeated label
    tl, ul = [tt - 2 * i for i in range(b)], [uu - (i % 9) for i in range(b)]
    cargs = (lp, torch.from_numpy(labels.astype("int32")).to(dev),
             torch.tensor(tl, dtype=torch.int32, device=dev),
             torch.tensor(ul, dtype=torch.int32, device=dev))
    (nll, alphas), (nll_r, alphas_r) = ctc_loss_fwd(*cargs), \
        ctc_forward_alphas(*cargs)
    g = torch.linspace(0.5, 1.5, b, device=dev)
    grad = ctc_loss_bwd(*cargs, nll_r, alphas_r, g)
    grad_r = ctc_loss_bwd_ref(*cargs, nll_r, alphas_r, g)
    err = max(rel_err(nll, nll_r), rel_err(alphas, alphas_r),
              rel_err(grad, grad_r))
    yard = ctc_yardstick(torch, cargs, nll_r, alphas_r, g)
    fwd_ms = yard["fwd_kernel_ms"]
    fwd_ref = cuda_ms(lambda: ctc_forward_alphas(*cargs), iters=5, warmup=1)
    bwd_ms = cuda_ms(lambda: ctc_loss_bwd(*cargs, nll_r, alphas_r, g))
    bwd_ref = cuda_ms(lambda: ctc_loss_bwd_ref(*cargs, nll_r, alphas_r, g),
                      iters=5, warmup=1)
    fwd_cost = ctc_loss_cost(b, tt, uu, vv, tl, ul)
    bwd_cost = ctc_loss_bwd_cost(b, tt, uu, vv, tl, ul)
    log(f"[2b] ctc_loss forward kernel {fwd_ms:.4f} ms plain {fwd_ref:.4f} "
        f"ms; backward kernel {bwd_ms:.4f} ms plain {bwd_ref:.4f} ms")
    record("ctc_loss", err, fwd_ms + bwd_ms, fwd_ref + bwd_ref,
           f"forward + backward B={b} T={tt} U={uu} V={vv}", **yard,
           **roofline((fwd_cost[0] + bwd_cost[0], fwd_cost[1] + bwd_cost[1]),
                      simt=True),
           fwd_bound_ms=roofline(fwd_cost, simt=True)["bound_ms"],
           bwd_bound_ms=roofline(bwd_cost, simt=True)["bound_ms"])
    res["ctc_loss"].update(fwd_ms=fwd_ms, fwd_plain_ms=fwd_ref,
                           bwd_ms=bwd_ms, bwd_plain_ms=bwd_ref)
    return res


def phase_train_kernels_bf16(torch, rng):
    """2b at bf16: K1's and K1b's bf16 entries at the training shapes, with
    ragged and full lengths. Each is held against its plain bf16 version
    (within BF16_KERNEL_TOL of the reference's max) and against the plain
    float32 version on the same bf16-rounded inputs (its error at most
    BF16_VS_F32_RATIO times the plain bf16 version's error there), and
    timed in turns with its library yardstick (efficient SDPA in bf16 with
    the rel-PE bias as a bf16 mask; its autograd backward for K1b), with
    its bound at the bf16 tensor-core peak."""
    import numpy as np
    from neural_sp_tpu_torch.ops.kernels import rel_attention
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_bwd, rel_attention_bwd_cost, rel_attention_bwd_ref,
        rel_attention_cost, rel_attention_fwd, rel_attention_ref)
    dev, bf = torch.device("cuda"), torch.bfloat16

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            "float32")).to(dev).to(bf)

    def vs_f32(got, plain, f32):
        """(kernel's max |err| against the float32 plain version) / (the
        plain bf16 version's)."""
        return max_err(got.float(), f32) / max(max_err(plain.float(), f32),
                                               1e-30)

    res = {"rel_attention_bf16": {"max_abs_err": 0.0, "shapes": []},
           "rel_attention_bwd_bf16": {"max_abs_err": 0.0, "shapes": []}}

    def record(name, what, err, ratio, full_750, **extra):
        log(f"[2b] {name} {what}: error {err:.3e} of the plain bf16 max; "
            f"against plain f32 {ratio:.3f}x the plain bf16 version's  "
            f"kernel {extra['ms']:.4f} ms  plain {extra['plain_ms']:.4f} ms "
            f" library {extra['library_ms']:.4f} ms  bound "
            f"{extra['bound_ms']:.4f} ms ({extra['bound_by']}, bf16 peak)")
        expect(err <= BF16_KERNEL_TOL, f"{name} {what}: error {err}")
        expect(ratio <= BF16_VS_F32_RATIO,
               f"{name} {what}: {ratio:.3f}x the plain bf16 error vs f32")
        r = res[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        row = {"shape": what, "max_abs_err": err, "vs_f32_ratio": ratio,
               **extra}
        r["shapes"].append(row)
        if full_750:           # the main path's shape: phase 5's batch
            r.update({k: v for k, v in row.items()
                      if k not in ("shape", "max_abs_err")})

    b, h, dk, r = TRAIN_B, 8, 64, 11
    for tt in (750, 375, 188):
        ragged = np.maximum(tt - (np.arange(b) * tt) // (2 * b), 1).tolist()
        for lens, kl in (("ragged", ragged), ("full", [tt] * b)):
            q, k, v = t(b, h, tt, dk, scale=dk ** -0.5), t(b, h, tt, dk), \
                t(b, h, tt, dk)
            p = t(b, h, tt, r, scale=dk ** -0.5)
            klens = torch.tensor(kl, dtype=torch.int32, device=dev)
            fwd = (q, k, v, p, klens)
            fwd32 = (*(x.float() for x in (q, k, v, p)), klens)
            what = f"B={b} H={h} T={tt} dk={dk} R={r} {lens} lengths"
            full_750 = lens == "full" and tt == 750

            o, m, l = rel_attention_fwd(*fwd)
            o16, o32 = rel_attention_ref(*fwd), rel_attention_ref(*fwd32)
            err, ratio = rel_err(o, o16), vs_f32(o, o16, o32)
            del o16, o32
            yard = rel_attention_yardstick(torch, fwd, rel_attention,
                                           what + " bf16", phase="2b",
                                           tol=BF16_KERNEL_TOL)
            record("rel_attention_bf16", what, err, ratio, full_750,
                   ms=yard["kernel_ms"],
                   plain_ms=cuda_ms(lambda: rel_attention_ref(*fwd),
                                    iters=5),
                   **yard, **roofline(rel_attention_cost(
                       b, h, tt, dk, r, kl, elem=2), bf16=True))

            args = (*fwd, o, m, l, t(b, h, tt, dk))
            got = rel_attention_bwd(*args)
            want16 = rel_attention_bwd_ref(*args)
            want32 = rel_attention_bwd_ref(*fwd32, o.float(), m, l,
                                           args[-1].float())
            err = max(rel_err(x, y) for x, y in zip(got, want16))
            ratio = max(vs_f32(*xyz) for xyz in zip(got, want16, want32))
            del got, want16, want32
            yard = rel_attention_bwd_yardstick(
                torch, args, rel_attention_bwd, what + " bf16",
                tol=BF16_KERNEL_TOL)
            record("rel_attention_bwd_bf16", what, err, ratio, full_750,
                   ms=yard["kernel_ms"],
                   plain_ms=cuda_ms(lambda: rel_attention_bwd_ref(*args),
                                    iters=3),
                   **yard, **roofline(rel_attention_bwd_cost(
                       b, h, tt, dk, r, kl, elem=2), bf16=True))
            del args, fwd, fwd32, o, m, l
    return res


def train_batch(torch, rng, bs=TRAIN_B):
    """bench.py's per-utterance shape: 1500 frames x 80, U=100 labels in
    [4, vocab), every utterance full length."""
    dev = torch.device("cuda")
    xs = rng.standard_normal((bs, TRAIN_FRAMES, 80)).astype("float32")
    ys = rng.integers(4, 10000, (bs, TRAIN_U)).astype("int32")
    return (torch.from_numpy(xs).to(dev),
            torch.full((bs,), TRAIN_FRAMES, dtype=torch.int32, device=dev),
            torch.from_numpy(ys).to(dev),
            torch.full((bs,), TRAIN_U, dtype=torch.int32, device=dev))


# the kernels each training run must launch, by compute dtype; the bf16 run
# must launch no float32 K1 / K1b (no cast to float32 around them)
TRAIN_KERNELS = {"float32": ("rel_attention", "rel_attention_bwd"),
                 "bfloat16": ("rel_attention_bf16", "rel_attention_bwd_bf16")}
TRAIN_KERNELS_BOTH = ("las_scan", "las_scan_bwd", "ctc_loss", "ctc_loss_bwd")


def phase_train(torch, model, batch, train_dtype: str = "float32"):
    """5: optimizer steps of the full flagship in ``train_dtype`` (float32,
    or bf16 compute over float32 masters), timed, with the kernels'
    launches counted over the run."""
    import numpy as np
    from neural_sp_tpu_torch.configs import compute_dtype, flagship_args
    from neural_sp_tpu_torch.ops.kernels import (las_scan, las_scan_bwd,
                                                 launches, reset_launches)
    from neural_sp_tpu_torch.parallel.mesh import make_train_step
    from neural_sp_tpu_torch.trainers.lr_scheduler import noam_schedule
    from neural_sp_tpu_torch.trainers.optimizer import build_optimizer
    args = flagship_args(faithful=True)
    args.train_dtype = train_dtype
    tag = "5" if train_dtype == "float32" else "5 bf16"
    model.train()
    model.zero_grad(set_to_none=True)
    step = make_train_step(model, build_optimizer(
        "noam", schedule=noam_schedule(512, 25000, factor=5.0),
        clip_grad_norm=5.0, accum_grad_n_steps=ACCUM),
        compute_dtype=compute_dtype(args))
    gen = torch.Generator().manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    walls, metrics = [], []
    for n in range(3):                       # step 0 warms up, untimed
        t0 = time.perf_counter()
        for _ in range(ACCUM):
            metrics.append(step(*batch, gen=gen))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = launches()
    # the kernels K3's and K3b's last calls in the run launched (their
    # per-step chains)
    k3_kernels = las_scan.kernel_launches_per_call
    k3b_kernels = las_scan_bwd.kernel_launches_per_call
    peak = torch.cuda.max_memory_allocated()
    expect(all(m["emitted"] == ((i + 1) % ACCUM == 0)
               for i, m in enumerate(metrics)), "accumulation cycle")
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    expect(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
           f"non-finite loss or grad norm: {losses} {gnorms}")
    expect(all(k in metrics[-1] for k in ("loss_ctc", "loss_att", "acc_att")),
           f"missing observations: {sorted(metrics[-1])}")
    log(f"[{tag}] launches over 3 optimizer steps (12 microsteps): {counts}")
    for name in TRAIN_KERNELS[train_dtype] + TRAIN_KERNELS_BOTH:
        expect(counts[name] > 0, f"{name} never launched in training")
    for other, names in TRAIN_KERNELS.items():
        if other != train_dtype:
            expect(all(counts[name] == 0 for name in names),
                   f"{train_dtype} training launched {other} K1 / K1b")
    expect(k3_kernels > 0, "las_scan launched no kernel in training")
    expect(k3b_kernels > 0, "las_scan_bwd launched no kernel in training")
    log(f"[{tag}] las_scan: {k3_kernels} kernel launches per call; "
        f"las_scan_bwd: {k3b_kernels}")
    step_s = sum(walls[1:]) / len(walls[1:])
    frames = float(batch[1].sum()) * ACCUM
    out = {"train_dtype": train_dtype, "step_s": walls,
           "ms_per_step": step_s * 1e3,
           "frames_per_s": frames / step_s,
           "utts_per_s": TRAIN_B * ACCUM / step_s, "peak_mem_bytes": peak,
           "losses": losses, "grad_norms": gnorms, "launches": counts,
           "las_scan_kernel_launches_per_call": k3_kernels,
           "las_scan_bwd_kernel_launches_per_call": k3b_kernels,
           "last_obs": {k: float(v) for k, v in metrics[-1].items()}}
    log(f"[{tag}] optimizer step (4 x B={TRAIN_B} x {TRAIN_FRAMES} frames, "
        f"{train_dtype}): {step_s * 1e3:.1f} ms (warm-up step "
        f"{walls[0] * 1e3:.1f} ms); {out['frames_per_s']:.0f} frames/s, "
        f"{out['utts_per_s']:.2f} utts/s; peak mem {peak} B")
    log(f"[{tag}] losses {['%.3f' % x for x in losses]}")
    log(f"[{tag}] grad norms {['%.3f' % x for x in gnorms]}")
    out["profile"] = profiled(torch, f"train microstep, {train_dtype}",
                              lambda: step(*batch, gen=gen))
    model.zero_grad(set_to_none=True)
    return out, counts


class PlainLASScan:
    """``LASScan`` with the plain forward, differentiated by autograd; as
    ``LASScan``, in float32 at every compute dtype, cast at its boundary."""

    @staticmethod
    def apply(eg, *args):
        from neural_sp_tpu_torch.ops.kernels.las_scan import las_scan_ref
        *args, klens, keep = args
        h, _, _, _, aw, ctx = las_scan_ref(
            eg.float().transpose(0, 1), *(x.float() for x in args), klens,
            keep.float().transpose(0, 1))
        return tuple(x.transpose(0, 1).to(eg.dtype) for x in (h, ctx, aw))


def plain_rel_attention(torch):
    """``rel_attention`` with its plain versions on the card:
    ``rel_attention_ref`` forward, ``rel_attention_bwd_ref`` (the adjoint
    written out, rounding where the kernels do at bf16) backward."""
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_bwd_ref, rel_attention_ref, rel_attention_stats_ref)

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, p, klens):
            o = rel_attention_ref(q, k, v, p, klens)
            ctx.save_for_backward(q, k, v, p, klens, o,
                                  *rel_attention_stats_ref(q, k, p, klens))
            return o

        @staticmethod
        def backward(ctx, do):
            return (*rel_attention_bwd_ref(*ctx.saved_tensors, do), None)

    return Plain.apply


def eval_microstep(torch, model, batch, compute_dtype=None, plain=False):
    """One ``eval()`` microstep under ``compute_dtype`` (None: float32):
    (loss, {leaf: gradient}), through the kernels or, with ``plain``, the
    plain versions patched in (K1 / K1b: ``plain_rel_attention``; K3 / K3b:
    ``PlainLASScan``; K4: autograd through its plain forward)."""
    from contextlib import ExitStack
    from neural_sp_tpu_torch.models.decoders import las
    from neural_sp_tpu_torch.models.modules import \
        relative_multihead_attention as rma
    from neural_sp_tpu_torch.ops import ctc
    from neural_sp_tpu_torch.ops.kernels.ctc_loss import ctc_forward_alphas
    from neural_sp_tpu_torch.parallel.mesh import compute_loss
    model.eval()
    model.zero_grad(set_to_none=True)
    with ExitStack() as stack:
        if plain:
            for target, name, value in (
                    (rma, "rel_attention", plain_rel_attention(torch)),
                    (las, "LASScan", PlainLASScan),
                    (ctc, "ctc_nll", lambda *a: ctc_forward_alphas(*a)[0])):
                stack.enter_context(mock.patch.object(target, name, value))
        loss, _ = compute_loss(model, compute_dtype, *batch)
        loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def phase_train_parity(torch, model, batch):
    """6: one eval() microstep's loss and gradients, kernels vs plain
    versions, float32. Returns the result and the plain microstep's (loss,
    gradients), phase 6b's float32 reference."""
    loss, grads = eval_microstep(torch, model, batch)
    loss_ref, grads_ref = eval_microstep(torch, model, batch, plain=True)
    loss_err = abs(loss - loss_ref) / abs(loss_ref)
    g_max = max(float(g.abs().max()) for g in grads_ref.values())
    # per leaf: (share of its tolerance used, max |plain grad| / g_max,
    # max |kernel - plain| / g_max)
    leaves = {}
    for name, g in grads.items():
        ref = grads_ref[name]
        scale, err = float(ref.abs().max()), float((g - ref).abs().max())
        tol = GRAD_FLOOR * g_max if name.endswith(ZERO_GRAD_LEAF) else \
            GRAD_RTOL * scale
        leaves[name] = (err / tol if err else 0.0, scale / g_max,
                        err / g_max)
    ranked = sorted(leaves.items(), key=lambda kv: -kv[1][0])
    zero = [kv for kv in ranked if kv[0].endswith(ZERO_GRAD_LEAF)]
    log(f"[6] eval loss kernels {loss:.6f} plain {loss_ref:.6f} (rel "
        f"{loss_err:.2e}); largest gradient {g_max:.4e}")
    log(f"[6] {len(leaves) - len(zero)} leaves held to {GRAD_RTOL} of their "
        f"own max (no absolute floor), {len(zero)} key-bias leaves to "
        f"{GRAD_FLOOR} of the largest gradient")
    for name, (share, scale, err) in ranked[:6]:
        log(f"[6]   {name}: {share:.3f} of its tolerance (own max "
            f"{scale:.3e}, error {err:.3e} of the largest gradient)")
    for name, (share, scale, err) in zero[:2]:
        log(f"[6]   key bias {name}: {share:.3f} of its tolerance (plain "
            f"max {scale:.3e}, error {err:.3e} of the largest gradient)")
    worst_name, (worst, _, _) = ranked[0]
    expect(loss_err <= LOSS_RTOL, f"loss {loss} vs plain {loss_ref}")
    expect(worst <= 1.0, f"gradient {worst_name} outside tolerance")
    return {"loss_rel_err": loss_err, "worst_grad": worst,
            "worst_grad_leaf": worst_name, "worst_leaves": dict(ranked[:6]),
            "key_bias_leaves": dict(zero)}, (loss_ref, grads_ref)


def phase_train_parity_bf16(torch, model, batch, plain32):
    """6b: one eval() microstep at bf16 compute through the kernels against
    the same microstep with the plain versions patched in (both bf16): each
    quantity's distance from phase 6's plain float32 microstep
    (``plain32``) held to BF16_PATH_FACTOR times the plain bf16
    microstep's, in the L2 norm, plus phase 6's float32 tolerance in that
    norm."""
    bf = torch.bfloat16
    loss, grads = eval_microstep(torch, model, batch, bf)
    loss16, grads16 = eval_microstep(torch, model, batch, bf, plain=True)
    loss32, grads32 = plain32
    g_max = max(float(g.abs().max()) for g in grads32.values())
    loss_tol = BF16_PATH_FACTOR * abs(loss16 - loss32) + \
        LOSS_RTOL * abs(loss32)
    norm = torch.linalg.vector_norm
    leaves = {}
    for name, g in grads.items():
        ref, ref32 = grads16[name], grads32[name]
        per_element = GRAD_FLOOR * g_max if name.endswith(ZERO_GRAD_LEAF) \
            else GRAD_RTOL * float(ref32.abs().max())
        floor = per_element * ref32.numel() ** 0.5
        plain_cost = float(norm(ref - ref32))
        tol = BF16_PATH_FACTOR * plain_cost + floor
        err = float(norm(g - ref32))
        leaves[name] = (err / tol if err else 0.0, err, plain_cost,
                        float(norm(g - ref)))
    ranked = sorted(leaves.items(), key=lambda kv: -kv[1][0])
    log(f"[6b] bf16 eval loss kernels {loss:.6f} plain bf16 {loss16:.6f} "
        f"plain f32 {loss32:.6f}: |kernels - f32| {abs(loss - loss32):.3e} "
        f"against a tolerance of {loss_tol:.3e}")
    for name, (share, err, cost, between) in ranked[:6]:
        log(f"[6b]   {name}: {share:.3f} of its tolerance (|kernels - f32| "
            f"{err:.3e}, |plain bf16 - f32| {cost:.3e}, |kernels - plain "
            f"bf16| {between:.3e}, L2)")
    worst_name, (worst, _, _, _) = ranked[0]
    expect(abs(loss - loss32) <= loss_tol,
           f"bf16 loss {loss} vs plain f32 {loss32} (plain bf16 {loss16})")
    expect(worst <= 1.0, f"bf16 gradient {worst_name} outside tolerance")
    return {"loss": loss, "loss_plain_bf16": loss16, "loss_plain_f32": loss32,
            "worst_grad": worst, "worst_grad_leaf": worst_name,
            "worst_leaves": dict(ranked[:6])}


def phase_fit(torch, model, batch, compute_dtype=None, tag="6"):
    """5 Adam steps (lr 1e-4) on a fixed batch of 8 utterances in train()
    mode, under ``compute_dtype``; the loss must fall."""
    from neural_sp_tpu_torch.parallel.mesh import make_train_step
    from neural_sp_tpu_torch.trainers.optimizer import build_optimizer
    model.train()
    small = tuple(x[:8] for x in batch)
    step = make_train_step(model, build_optimizer("adam", lr=1e-4),
                           compute_dtype=compute_dtype)
    gen = torch.Generator().manual_seed(SEED)
    losses = [float(step(*small, gen=gen)["loss"]) for _ in range(5)]
    model.zero_grad(set_to_none=True)
    log(f"[{tag}] fixed batch of 8, Adam 1e-4: losses "
        f"{['%.4f' % x for x in losses]}")
    expect(losses[-1] < losses[0], f"loss did not fall: {losses}")
    return losses


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (PACKAGE / "ops" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {PACKAGE} not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    build_sec = phase_build()
    rng = np.random.default_rng(SEED)
    kernels = phase_kernels(torch, rng)
    model = flagship_model(torch)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[3] flagship faithful model: {n_params} parameters on the card")
    xs, xlens = utterances(rng)
    served, launches = phase_serve(torch, model, xs, xlens)
    breakdown = phase_breakdown(torch, model, xs, xlens)
    enc_err, dec_err, k2_per_step = phase_twins(torch, model, xs, xlens,
                                                served["best_hyp0"])
    train_kernels = phase_train_kernels(torch, rng)
    kernels["rel_attention"]["shapes"] += train_kernels.pop(
        "rel_attention_train_shapes")
    kernels.update(train_kernels)
    kernels.update(phase_train_kernels_bf16(torch, rng))
    batch = train_batch(torch, rng)
    trained, train_launches = phase_train(torch, model, batch)
    trained_bf16, bf16_launches = phase_train(torch, model, batch,
                                              "bfloat16")
    parity, plain32 = phase_train_parity(torch, model, batch)
    parity_bf16 = phase_train_parity_bf16(torch, model, batch, plain32)
    del plain32
    parity["fixed_batch_losses"] = phase_fit(torch, model, batch)
    parity_bf16["fixed_batch_losses"] = phase_fit(
        torch, model, batch, torch.bfloat16, tag="6b")
    # each kernel's launches from the main path it belongs to: the served
    # requests (K1, K2), the float32 training run (K1b, K3, K3b, K4) or
    # the bf16 training run (K1's and K1b's bf16 entries)
    bf16_names = TRAIN_KERNELS["bfloat16"]
    launches = {**train_launches, **launches,
                **{name: bf16_launches[name] for name in bf16_names}}
    # per encode (K1), per decode step (K2), per training microstep (the
    # rest)
    microsteps = 3 * ACCUM
    per_step = {name: n / microsteps for name, n in train_launches.items()}
    per_step.update({name: bf16_launches[name] / microsteps
                     for name in bf16_names},
                    rel_attention=breakdown["k1_launches_per_encode"],
                    las_step=k2_per_step)

    csrc = "neural_sp_tpu_torch/ops/kernels/csrc/"
    srcs = {"rel_attention": (
        csrc + "rel_attention.cu",
        "neural_sp_tpu/ops/rel_attention_pallas.py:61 (583dfc4~1)"),
        "rel_attention_bwd": (
        csrc + "rel_attention_bwd.cu",
        "neural_sp_tpu/ops/rel_attention_pallas.py:82 (583dfc4~1)"),
        "rel_attention_bf16": (
        csrc + "rel_attention.cu",
        "neural_sp_tpu/ops/rel_attention_pallas.py:61 (583dfc4~1)"),
        "rel_attention_bwd_bf16": (
        csrc + "rel_attention_bwd.cu",
        "neural_sp_tpu/ops/rel_attention_pallas.py:82 (583dfc4~1)"),
        "las_step": (
        csrc + "las_step.cu",
        "neural_sp_tpu/ops/las_scan_pallas.py:74 (63255ae~1)"),
        "las_scan": (
        csrc + "las_step.cu",
        "neural_sp_tpu/ops/las_scan_pallas.py:74 (63255ae~1)"),
        "las_scan_bwd": (
        csrc + "las_scan.cu",
        "neural_sp_tpu/ops/las_scan_pallas.py:154 (63255ae~1)"),
        "ctc_loss": (
        csrc + "ctc_loss.cu",
        "neural_sp_tpu/ops/ctc_pallas.py:39 and :120 (63255ae~1)")}
    details = {"card": card, "build_s": build_sec,
               "encoder_max_abs_err": enc_err,
               "decoder_max_abs_err": dec_err,
               "serve": {k: v for k, v in served.items() if k != "best_hyp0"},
               "breakdown": breakdown, "train": trained,
               "train_bf16": {**trained_bf16, "launches": bf16_launches},
               "train_parity": parity, "train_parity_bf16": parity_bf16,
               "kernels": kernels}
    log(json.dumps(details))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "simt_bound_ms", "library_err", "peak_flops")
    entries = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "launches_per_step": per_step[name],
         **{key: kernels[name].get(key) for key in keys}}
        for name, (src, rep) in srcs.items()]
    # K2: its time is the workspace form's (the decode loops'); beside it
    # the checked call's and the kernels one step launches
    next(e for e in entries if e["name"] == "las_step").update(
        checked_call_ms=kernels["las_step"]["checked_call_ms"],
        kernels_per_step=kernels["las_step"]["kernels_per_step"])
    # K4's ms are forward + backward; its backward entry point counts apart
    next(e for e in entries if e["name"] == "ctc_loss")["bwd_launches"] = \
        launches["ctc_loss_bwd"]
    # K3, K3b: the kernels the per-step chain launched per call in the
    # training run; K3b: the wrapper's work after the loop (phase 2b)
    next(e for e in entries if e["name"] == "las_scan").update(
        kernel_launches_per_call=trained[
            "las_scan_kernel_launches_per_call"])
    next(e for e in entries if e["name"] == "las_scan_bwd").update(
        kernel_launches_per_call=trained[
            "las_scan_bwd_kernel_launches_per_call"],
        outside_ms=kernels["las_scan_bwd"]["outside_ms"])
    # K3, K3b at bf16 compute: the casts at their boundary
    for name in ("las_scan", "las_scan_bwd"):
        next(e for e in entries if e["name"] == name)[
            "bf16_boundary_cast_ms"] = kernels[name]["bf16_boundary_cast_ms"]
    # K1 / K1b bf16: their error against the plain float32 version, as a
    # multiple of the plain bf16 version's
    for name in bf16_names:
        next(e for e in entries if e["name"] == name)["vs_f32_ratio"] = max(
            row["vs_f32_ratio"] for row in kernels[name]["shapes"])
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
