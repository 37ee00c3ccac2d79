#!/usr/bin/env python3
"""Time K3b (las_scan_bwd, the LAS scan's backward) of one checkout of the
port on the card, at the training shape of ``chip_smoke.py`` phase 2b, with
CUDA events, and hold it against its plain version.

    python3 neural_sp_tpu_torch/tools/las_scan_times.py \
        [--root DIR] [--label NAME] [--iters N]

``--root`` is the directory holding the ``neural_sp_tpu_torch`` package to
time (default: this checkout), so that two commits unpacked side by side
can be timed in turns on one card, each in its own process. Three things
are timed, each called eagerly (the host's work included: what a caller
sees) and as a CUDA-graph replay of the same calls (the device's time
alone): the whole wrapper ``las_scan_bwd``; its kernel loop alone
(``las_scan_bwd_chain``); and the work after the loop
(``las_scan_bwd_finish``: the weight-gradient products and the sums of
partials), with the kernel loop's device time per kernel (torch.profiler).
A checkout without the split reports the wrapper only. Prints one JSON
line: the card's name and power limit, the times, the bound
(``las_scan_bwd_cost`` over ``ops/kernels/roofline.py``), the kernels
launched per call where the checkout counts them, and the error (max
|err| / max |plain| over the ten gradients).
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
        ms = cuda_ms(graph.replay, max(1, opts.iters // calls)) / calls
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

    def times(fn):
        return {"ms": cuda_ms(fn, opts.iters), "device_ms": graph_ms(fn)}

    keep = (torch.from_numpy((rng.random((U, B, H)) >= RATE).astype(
        "float32")) / (1 - RATE)).to(dev)
    kl = [T - 3 * i for i in range(B)]
    klens = torch.tensor(kl, dtype=torch.int32, device=dev)
    w_ctx = randn(D, 4 * H, scale=(D + H) ** -0.5)
    w_h = randn(H, 4 * H, scale=(D + H) ** -0.5)
    w_q, conv_w = randn(A, H, scale=H ** -0.5), randn(C, K, scale=K ** -0.5)
    w_f, v = randn(A, C, scale=C ** -0.5), randn(A, scale=A ** -0.5)
    kc, values = randn(B, T, A), randn(B, T, D)
    fwd = (randn(U, B, 4 * H, scale=0.5), w_ctx, w_h, randn(4 * H, scale=0.1),
           w_q, conv_w, w_f, v, kc, values, klens, keep)
    with torch.no_grad():
        h, c, gates, q, aw, ctx = m.las_scan_ref(*fwd)
        bargs = (w_ctx, w_h, w_q, conv_w, w_f, v, kc, values, klens, keep,
                 h, c, gates, q, aw, ctx, randn(U, B, H), randn(U, B, D))
        want = m.las_scan_bwd_ref(*bargs)
        got = m.las_scan_bwd(*bargs)
        err = max(float((x - y).abs().max() / y.abs().max())
                  for x, y in zip(got, want))
        del got, want
        out = {"wrapper": times(lambda: m.las_scan_bwd(*bargs))}
        if hasattr(m, "las_scan_bwd_chain"):
            raw = m.las_scan_bwd_chain(*bargs)
            out["chain"] = times(lambda: m.las_scan_bwd_chain(*bargs))
            out["outside"] = times(
                lambda: m.las_scan_bwd_finish(h, ctx, keep, aw, *raw))
            out["kernel_launches_per_call"] = \
                m.las_scan_bwd.kernel_launches_per_call
            out["chain_kernels"] = kernel_profile(
                lambda: m.las_scan_bwd_chain(*bargs))
    flops, nbytes = m.las_scan_bwd_cost(U, B, T, H, D, A, C, K, kl)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    bound, by = bound_ms(flops, nbytes, F32_TENSOR_FLOPS)
    print(json.dumps({"label": opts.label, "root": str(opts.root),
                      "card": card, "kernel": "K3b las_scan_bwd",
                      "shape": f"B{B} U{U} T{T} H{H} D{D} A{A} C{C} K{K}",
                      "bound_ms": bound, "bound_by": by, "rel_err": err,
                      **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
