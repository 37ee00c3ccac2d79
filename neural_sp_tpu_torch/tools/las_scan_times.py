#!/usr/bin/env python3
"""Time the LAS kernels of one checkout of the port on the card with CUDA
events, each held against its plain version: K3 (las_scan, the
teacher-forced scan's forward) and K3b (las_scan_bwd, its backward) at the
training shape of ``chip_smoke.py`` phase 2b, and K2 (las_step, one decode
step) at N = 10 rows, T = 200 frames (phase 2), in one process.

    python3 neural_sp_tpu_torch/tools/las_scan_times.py \
        [--root DIR] [--label NAME] [--iters N]

``--root`` is the directory holding the ``neural_sp_tpu_torch`` package to
time (default: this checkout), so that two commits unpacked side by side
can be timed in turns on one card, each in its own process. Every wrapper
is called eagerly (the host's work included: what a caller sees) and as a
CUDA-graph replay of the same calls (the device's time alone), and the
device time and launch count of each of its kernels is read from
torch.profiler. For K3b, its kernel loop alone (``las_scan_bwd_chain``) and
the work after the loop (``las_scan_bwd_finish``: the weight-gradient
products and the sums of partials) are timed apart; a checkout without the
split reports the wrapper only. Prints one JSON line: the card's name and
power limit and, per kernel, the times, the bound (the module's ``*_cost``
over ``ops/kernels/roofline.py``), the kernels launched per call where the
checkout counts them, and the error (max |err| / max |plain| over the
outputs).
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
# chip_smoke.py phase 2b: B, U + 1, T, H, D, A, C, K, dropout rate
B, U, T, H, D, A, C, K, RATE = 32, 101, 188, 1024, 512, 512, 10, 201, 0.1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--iters", type=int, default=10)
    opts = ap.parse_args()
    sys.path.insert(0, str(opts.root.resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("las_scan_times: no CUDA device", file=sys.stderr)
        return 2
    m = importlib.import_module("neural_sp_tpu_torch.ops.kernels.las_scan")
    from neural_sp_tpu_torch.ops.kernels.roofline import (F32_TENSOR_FLOPS,
                                                          bound_ms)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            "float32")).to(dev)

    def cuda_ms(fn, iters):
        for _ in range(2):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def graph_ms(fn, calls=3):
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
        ms = cuda_ms(graph.replay, max(1, opts.iters // 3)) / calls
        del graph
        return ms

    def kernel_profile(fn):
        """Device time (ms) and launches per kernel name over one call."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", 0) or getattr(
                e, "cuda_time_total", 0)
            if us > 0:
                out[e.key[:80]] = {"ms": us / 1e3, "launches": e.count}
        return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"]))

    def times(fn, scale=1):
        """Eager and graph-replay ms; ``scale`` times the calls for a
        short kernel."""
        return {"ms": cuda_ms(fn, opts.iters * scale),
                "device_ms": graph_ms(fn, calls=3 * scale)}

    def card_bound(cost):
        bound, by = bound_ms(*cost, F32_TENSOR_FLOPS)
        return {"bound_ms": bound, "bound_by": by}

    def rel_err(got, want):
        return max(float((x - y).abs().max() / y.abs().max())
                   for x, y in zip(got, want))

    keep = (torch.from_numpy((rng.random((U, B, H)) >= RATE).astype(
        "float32")) / (1 - RATE)).to(dev)
    kl = [T - 3 * i for i in range(B)]
    klens = torch.tensor(kl, dtype=torch.int32, device=dev)
    w_ctx = randn(D, 4 * H, scale=(D + H) ** -0.5)
    w_h = randn(H, 4 * H, scale=(D + H) ** -0.5)
    w_q, conv_w = randn(A, H, scale=H ** -0.5), randn(C, K, scale=K ** -0.5)
    w_f, v = randn(A, C, scale=C ** -0.5), randn(A, scale=A ** -0.5)
    kc, values = randn(B, T, A), randn(B, T, D)
    bias = randn(4 * H, scale=0.1)
    fwd = (randn(U, B, 4 * H, scale=0.5), w_ctx, w_h, bias, w_q, conv_w, w_f,
           v, kc, values, klens, keep)
    with torch.no_grad():
        refs = m.las_scan_ref(*fwd)
        h, c, gates, q, aw, ctx = refs
        k3 = {"shape": f"B{B} U{U} T{T} H{H} D{D} A{A} C{C} K{K}",
              "rel_err": rel_err(m.las_scan(*fwd), refs),
              **times(lambda: m.las_scan(*fwd)),
              "kernels": kernel_profile(lambda: m.las_scan(*fwd)),
              **card_bound(m.las_scan_cost(U, B, T, H, D, A, C, K, kl))}
        if hasattr(m.las_scan, "kernel_launches_per_call"):
            k3["kernel_launches_per_call"] = \
                m.las_scan.kernel_launches_per_call

        bargs = (w_ctx, w_h, w_q, conv_w, w_f, v, kc, values, klens, keep,
                 h, c, gates, q, aw, ctx, randn(U, B, H), randn(U, B, D))
        k3b = {"shape": k3["shape"],
               "rel_err": rel_err(m.las_scan_bwd(*bargs),
                                  m.las_scan_bwd_ref(*bargs)),
               "wrapper": times(lambda: m.las_scan_bwd(*bargs)),
               **card_bound(m.las_scan_bwd_cost(U, B, T, H, D, A, C, K, kl))}
        if hasattr(m, "las_scan_bwd_chain"):
            raw = m.las_scan_bwd_chain(*bargs)
            k3b["chain"] = times(lambda: m.las_scan_bwd_chain(*bargs))
            k3b["outside"] = times(
                lambda: m.las_scan_bwd_finish(h, ctx, keep, aw, *raw))
            k3b["kernel_launches_per_call"] = \
                m.las_scan_bwd.kernel_launches_per_call
            k3b["chain_kernels"] = kernel_profile(
                lambda: m.las_scan_bwd_chain(*bargs))
            del raw

        # K2 at chip_smoke.py phase 2's decode shape
        n, t2 = 10, 200
        kl2 = [t2 - 3 * i for i in range(n)]
        step = (randn(n, 4 * H, scale=0.5), randn(n, D),
                randn(n, H, scale=0.5), randn(n, H),
                torch.softmax(randn(n, t2, scale=3.0), -1), w_ctx, w_h, bias,
                w_q, conv_w, w_f, v, randn(n, t2, A), randn(n, t2, D),
                torch.tensor(kl2, dtype=torch.int32, device=dev))
        s = importlib.import_module("neural_sp_tpu_torch.ops.kernels.las_step")
        k2 = {"shape": f"N{n} T{t2} H{H} D{D} A{A} C{C} K{K}",
              "rel_err": rel_err(s.las_step(*step), s.las_step_ref(*step)),
              **times(lambda: s.las_step(*step), scale=10),
              "kernels": kernel_profile(lambda: s.las_step(*step)),
              **card_bound(s.las_step_cost(n, t2, H, D, A, C, K, kl2))}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"label": opts.label, "root": str(opts.root),
                      "card": card, "K3 las_scan": k3,
                      "K3b las_scan_bwd": k3b, "K2 las_step": k2}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
