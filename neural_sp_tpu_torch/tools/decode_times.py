#!/usr/bin/env python3
"""Time the decode path of one checkout of the port on the card: K2
(las_step) alone, one whole ``RNNDecoder.decode_step``, the greedy and the
on-device beam loops on one utterance, and K4 (ctc_loss) forward and
backward, in one process.

    python3 neural_sp_tpu_torch/tools/decode_times.py \
        [--root DIR] [--label NAME] [--iters N] [--tokens] [--only-k2]
        [--only-k4]

``--root`` is the directory holding the ``neural_sp_tpu_torch`` package to
time (default: this checkout), so that two commits unpacked side by side
can be timed in turns on one card, each in its own process. A checkout
without the step workspace (``LasStepWorkspace``) is timed through the
plain call alone. What is measured, float32, TF32 off:

- K2 at N = 10 rows, T = 200 frames, flagship widths: the plain call and
  the workspace form, eager (CUDA events around many calls: the host's work
  included) and as a CUDA-graph replay (the device's time alone), the
  device time of each of its kernels (torch.profiler), the kernels per
  step, and the error against ``las_step_ref`` with and without ``parent``;
- one ``decode_step`` of the flagship's decoder at N = 10, T = 200, eager:
  the host's wall per step (a synchronise after the last step only), the
  device's busy time per step, and the device time of K2's kernels inside
  the step, where the vocabulary projection's weights pass through the L2
  between two steps;
- ``greedy_scan`` and ``decode_attention_beam_device`` (beam 10) on one
  1600-frame utterance (T = 200) through the full flagship with seeded
  random weights, the encoder's output computed once outside the timed
  region: decode steps (K2 launches), wall per step, device busy time and
  idle share (torch.profiler over a second run); then the same loops and
  the host's beam 10 without CTC cut to 10, 30 and 60 steps
  (``max_len_ratio``), the wall of each whole loop with what it builds at
  its start (the workspace) included, five readings each;
- K4 at B = 32, T = 188 and 500, U = 100, V = 10000: forward and backward
  wrappers
  eager, the device time of the backward's memset and of its kernel apart
  (torch.profiler), and ``F.ctc_loss`` forward and backward beside them;
- with ``--tokens``: the hypotheses of the three served sessions of
  ``chip_smoke.py`` (beam 10 + CTC 0.3, on-device beam 10, greedy) on its
  four utterances, and of the on-device beam with a least length (random
  weights let it end at once otherwise), to hold two checkouts' tokens
  against each other.

``--only-k2`` stops after K2 alone, ``--only-k4`` times K4 alone (a
quick look at a kernel change).
Prints one JSON line, the card's name and power limit included.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
N, T, H, D, A, C, K = 10, 200, 1024, 512, 512, 10, 201
UTT_FRAMES = (700, 1000, 1300, 1600)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--tokens", action="store_true")
    ap.add_argument("--only-k2", action="store_true")
    ap.add_argument("--only-k4", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, str(opts.root.resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("decode_times: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    s = importlib.import_module("neural_sp_tpu_torch.ops.kernels.las_step")
    ctc = importlib.import_module("neural_sp_tpu_torch.ops.kernels.ctc_loss")
    from neural_sp_tpu_torch.configs import flagship_args
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.ops.kernels.roofline import (
        F32_SIMT_FLOPS, F32_TENSOR_FLOPS, bound_ms)
    from neural_sp_tpu_torch.utils.init_params import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    has_ws = hasattr(s, "LasStepWorkspace")
    las = importlib.import_module("neural_sp_tpu_torch.models.decoders.las")

    def decode_steps():
        """Decode steps taken so far (a checkout without ``DecodeLoop``
        launches K2 once per step and nowhere else)."""
        loop = getattr(las, "DecodeLoop", None)
        return s.las_step.launches if loop is None else loop.steps

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            "float32")).to(dev)

    def cuda_ms(fn, iters):
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def graph_ms(fn, calls=20):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        ms = cuda_ms(graph.replay, 20) / calls
        del graph
        return ms

    def device_profile(fn, per=1):
        """Run fn under torch.profiler: wall seconds, device busy seconds
        (the union of the device events' intervals), idle share, and the
        device time (ms / ``per``) and count (/ ``per``) by kernel name."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans, by_name = [], {}
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                start, end = evt.time_range.start, evt.time_range.end
                spans.append((start, end))
                row = by_name.setdefault(evt.name[:70], [0.0, 0])
                row[0] += (end - start) / 1e3
                row[1] += 1
        busy, last = 0.0, float("-inf")
        for start, end in sorted(spans):
            if end > last:
                busy += end - max(start, last)
                last = end
        kernels = {k: {"ms": v[0] / per, "launches": v[1] / per}
                   for k, v in sorted(by_name.items(),
                                      key=lambda kv: -kv[1][0])}
        return {"wall_s": wall, "device_busy_s": busy / 1e6,
                "idle_share": 1.0 - busy / 1e6 / wall if spans else None,
                "kernels": kernels}

    def las_kernels(kernels):
        return {k: v for k, v in kernels.items() if "las_" in k}

    def rel_err(got, want):
        return max(float((x - y).abs().max() / y.abs().max().clamp(min=1e-30))
                   for x, y in zip(got, want))

    out = {"label": opts.label, "root": str(opts.root),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip().splitlines()[0]}

    # ---- K4 --------------------------------------------------------------
    def k4_times(tt: int) -> dict:
        """K4 forward and backward at B = 32, T = tt, U = 100, V = 10000."""
        b, uu, vv = 32, 100, 10000
        lp = torch.log_softmax(randn(b, tt, vv, scale=2.0), -1)
        labels = rng.integers(4, vv, (b, uu))
        labels[:, 1] = labels[:, 0]
        tl, ul = [tt - 2 * i for i in range(b)], [uu - (i % 9) for i in range(b)]
        cargs = (lp, torch.from_numpy(labels.astype("int32")).to(dev),
                 torch.tensor(tl, dtype=torch.int32, device=dev),
                 torch.tensor(ul, dtype=torch.int32, device=dev))
        g = torch.linspace(0.5, 1.5, b, device=dev)
        nll_r, alphas_r = ctc.ctc_forward_alphas(*cargs)
        nll, alphas = ctc.ctc_loss_fwd(*cargs)
        grad = ctc.ctc_loss_bwd(*cargs, alphas_r, g)
        grad_r = ctc.ctc_loss_bwd_ref(*cargs, alphas_r, g)
        leaf = lp.detach().requires_grad_()
        lib_loss = torch.nn.functional.ctc_loss(
            leaf.transpose(0, 1), cargs[1], cargs[2], cargs[3], blank=0,
            reduction="none")
        iters = max(20, opts.iters // 4)
        fwd_prof = device_profile(
            lambda: [ctc.ctc_loss_fwd(*cargs) for _ in range(10)], per=10)
        bwd_prof = device_profile(
            lambda: [ctc.ctc_loss_bwd(*cargs, alphas_r, g)
                     for _ in range(10)], per=10)
        fwd_cost = ctc.ctc_loss_cost(b, tt, uu, vv, tl, ul)
        bwd_cost = ctc.ctc_loss_bwd_cost(b, tt, uu, vv, tl, ul)
        return {
            "shape": f"B{b} T{tt} U{uu} V{vv}",
            "rel_err": {"nll": rel_err([nll], [nll_r]),
                        "alphas": rel_err([alphas.clamp(min=-1e4)],
                                          [alphas_r.clamp(min=-1e4)]),
                        "grad": rel_err([grad], [grad_r])},
            "fwd_ms": cuda_ms(lambda: ctc.ctc_loss_fwd(*cargs), iters),
            "bwd_ms": cuda_ms(
                lambda: ctc.ctc_loss_bwd(*cargs, alphas_r, g), iters),
            "memset_ms": cuda_ms(lambda: torch.zeros_like(lp), iters),
            "fwd_kernels": fwd_prof["kernels"],
            "bwd_kernels": bwd_prof["kernels"],
            "library_fwd_ms": cuda_ms(
                lambda: torch.nn.functional.ctc_loss(
                    lp.transpose(0, 1), cargs[1], cargs[2], cargs[3], blank=0,
                    reduction="none"), iters),
            "library_bwd_ms": cuda_ms(
                lambda: torch.autograd.grad(lib_loss, leaf, g,
                                            retain_graph=True), iters),
            "fwd_bound_ms": bound_ms(*fwd_cost, F32_SIMT_FLOPS)[0],
            "bwd_bound_ms": bound_ms(*bwd_cost, F32_SIMT_FLOPS)[0]}

    if opts.only_k4:
        out["K4 ctc_loss"] = [k4_times(tt) for tt in (188, 500)]
        print(json.dumps(out))
        return 0

    # ---- K2 alone ------------------------------------------------------
    kl = [T - 3 * i for i in range(N)]
    klens = torch.tensor(kl, dtype=torch.int32, device=dev)
    weights = (randn(D, 4 * H, scale=(D + H) ** -0.5),
               randn(H, 4 * H, scale=(D + H) ** -0.5), randn(4 * H, scale=0.1),
               randn(A, H, scale=H ** -0.5), randn(C, K, scale=K ** -0.5),
               randn(A, C, scale=C ** -0.5), randn(A, scale=A ** -0.5))
    state = (randn(N, 4 * H, scale=0.5), randn(N, D), randn(N, H, scale=0.5),
             randn(N, H), torch.softmax(randn(N, T, scale=3.0), -1))
    kc, values = randn(N, T, A), randn(N, T, D)
    step = (*state, *weights, kc, values, klens)
    with torch.no_grad():
        k2 = {"shape": f"N{N} T{T} H{H} D{D} A{A} C{C} K{K}",
              "rel_err": rel_err(s.las_step(*step), s.las_step_ref(*step)),
              "ms": cuda_ms(lambda: s.las_step(*step), opts.iters),
              "device_ms": graph_ms(lambda: s.las_step(*step))}
        prof = device_profile(lambda: [s.las_step(*step) for _ in range(10)],
                              per=10)
        k2["kernels"] = las_kernels(prof["kernels"])
        k2["kernels_per_step"] = sum(
            v["launches"] for v in k2["kernels"].values())
        bound, by = bound_ms(*s.las_step_cost(N, T, H, D, A, C, K, kl),
                             F32_TENSOR_FLOPS)
        k2.update(bound_ms=bound, bound_by=by)
        if has_ws:
            parent = torch.tensor([3, 3, 0, 9, 1, 1, 7, 2, 5, 0],
                                  dtype=torch.int32, device=dev)
            k2["rel_err_parent"] = rel_err(
                s.las_step(*step, parent=parent),
                s.las_step_ref(*step, parent=parent))
            ws = s.LasStepWorkspace(*weights, kc, values, klens)
            ws.load_carry(*state[1:])
            ws.eg.copy_(state[0])
            ws.parent.copy_(parent)
            got = [x.clone() for x in ws.step(use_parent=True)]
            k2["ws_equals_plain"] = all(
                torch.equal(x, y) for x, y in zip(
                    got, s.las_step(*step, parent=parent)))
            k2["ws_ms"] = cuda_ms(lambda: ws.step(use_parent=True),
                                  opts.iters)
            k2["ws_device_ms"] = graph_ms(lambda: (ws.step(use_parent=True),
                                                   ws.step(use_parent=True)),
                                          calls=10) / 2
            k2["ws_kernels"] = las_kernels(device_profile(
                lambda: [ws.step(use_parent=True) for _ in range(10)],
                per=10)["kernels"])
    out["K2 las_step"] = k2
    if opts.only_k2:
        print(json.dumps(out))
        return 0

    # ---- one decode_step, then the loops, through the flagship ----------
    model = build_speech2text(flagship_args(faithful=True))
    init_params(model, 0)
    model.eval()
    dec = model.dec_fwd
    with torch.inference_mode():
        e = randn(N, T, D)
        key_cache = dec.precompute_keys(e)
        y = torch.randint(4, 10000, (N,), device=dev)
        if has_ws:
            ws = dec.step.workspace(key_cache, e, klens)

            def one_step(carry):
                return dec.decode_step(carry, y, key_cache, e, klens,
                                       ws=ws)[0]
        else:
            def one_step(carry):
                return dec.decode_step(carry, y, key_cache, e, klens)[0]

        def steps(n):
            carry = dec.init_carry(N, T, dev)
            for _ in range(n):
                carry = one_step(carry)

        steps(20)
        n_steps = 100
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps(n_steps)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / n_steps * 1e3)
        prof = device_profile(lambda: steps(n_steps), per=n_steps)
        k2_in = las_kernels(prof["kernels"])
        out["decode_step"] = {
            "shape": f"N{N} T{T}, flagship decoder, vocab 10000",
            "wall_ms_per_step": walls,
            "device_busy_ms_per_step": prof["device_busy_s"] * 1e3 / n_steps,
            "device_kernels_per_step": sum(
                v["launches"] for v in prof["kernels"].values()),
            "k2_device_ms_per_step": sum(v["ms"] for v in k2_in.values()),
            "k2_kernels": k2_in,
            "top_kernels": dict(list(prof["kernels"].items())[:8])}

    xs = np.zeros((len(UTT_FRAMES), max(UTT_FRAMES), 80), np.float32)
    utt_rng = np.random.default_rng(0)
    for i, t in enumerate(UTT_FRAMES):
        xs[i, :t] = utt_rng.standard_normal((t, 80))
    xlens = np.asarray(UTT_FRAMES, np.int64)
    loops = {}
    for name, conf in (("greedy", DecodeConfig(beam_width=1)),
                       ("beam10_device", DecodeConfig(beam_width=10,
                                                      device_beam=True))):
        sess = Speech2TextSession(model, conf)
        eouts = sess.encode(xs[3:], xlens[3:])
        sess.encode = lambda *_, eouts=eouts: eouts   # the loop alone
        sess.decode(xs[3:], xlens[3:])                # warm-up
        runs = []
        for _ in range(3):
            before = decode_steps()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hyp = sess.decode(xs[3:], xlens[3:])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_dec = decode_steps() - before
            runs.append(wall / n_dec * 1e3)
        prof = device_profile(lambda: sess.decode(xs[3:], xlens[3:]))
        loops[name] = {
            "decode_steps": n_dec, "hyp_len": len(hyp[0]),
            "wall_ms_per_step": runs,
            "profiled_wall_ms_per_step": prof["wall_s"] * 1e3 / n_dec,
            "device_busy_ms_per_step": prof["device_busy_s"] * 1e3 / n_dec,
            "idle_share": prof["idle_share"],
            "device_kernels_per_step": sum(
                v["launches"] for v in prof["kernels"].values()) / n_dec,
            "k2_device_ms_per_step": sum(
                v["ms"] for v in las_kernels(prof["kernels"]).values())
            / n_dec}
    out["loops, one 1600-frame utterance"] = loops

    # the same utterance, the loops cut short: what a loop builds at its
    # start weighs more the fewer steps follow
    short = {}
    for max_len in (10, 30, 60):
        ratio = max_len / T
        for name, conf in (
                ("greedy", DecodeConfig(beam_width=1, max_len_ratio=ratio)),
                ("beam10_device", DecodeConfig(
                    beam_width=10, device_beam=True, max_len_ratio=ratio)),
                ("beam10_host", DecodeConfig(beam_width=10,
                                             max_len_ratio=ratio))):
            sess = Speech2TextSession(model, conf)
            eouts = sess.encode(xs[3:], xlens[3:])
            sess.encode = lambda *_, eouts=eouts: eouts
            sess.decode(xs[3:], xlens[3:])
            walls = []
            for _ in range(5):
                before = decode_steps()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sess.decode(xs[3:], xlens[3:])
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                n_dec = decode_steps() - before
            short[f"{name}, {max_len} steps at most"] = {
                "decode_steps": n_dec, "wall_ms_per_loop": walls}
    out["short loops, one 1600-frame utterance"] = short

    if opts.tokens:
        toks = {}
        for name, conf in (
                ("beam10_ctc0.3", DecodeConfig(beam_width=10, ctc_weight=0.3)),
                ("beam10_device", DecodeConfig(beam_width=10,
                                               device_beam=True)),
                ("beam10_device_min_len0.1", DecodeConfig(
                    beam_width=10, device_beam=True, min_len_ratio=0.1)),
                ("greedy", DecodeConfig(beam_width=1))):
            toks[name] = Speech2TextSession(model, conf).decode(xs, xlens)
        out["tokens"] = toks
    del model

    out["K4 ctc_loss"] = [k4_times(tt) for tt in (188, 500)]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
