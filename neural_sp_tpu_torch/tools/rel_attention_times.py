#!/usr/bin/env python3
"""Time K1 (rel_attention forward) and K1b (its backward) of one checkout
of the port on the card, at the main path's shapes, with CUDA events, and
hold each against its plain version.

    python3 neural_sp_tpu_torch/tools/rel_attention_times.py \
        [--root DIR] [--label NAME] [--iters N] [--dtype float32|bfloat16]

``--root`` is the directory holding the ``neural_sp_tpu_torch`` package to
time (default: this checkout), so that two commits unpacked side by side
can be timed in turns on one card, each in its own process. Prints one
JSON line: the card's name and power limit, and per shape the kernel's ms
called eagerly (the wrapper's host work included: what a caller sees),
its device ms (the same calls captured in a CUDA graph and replayed: the
device's time alone) and its error (max |err| / max |plain|).
``--dtype bfloat16`` times the bf16 entries on bf16 inputs (a checkout
from before they existed has none).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
# (what, B, H, T, dk, R, klens or None for full lengths): the serving
# shape of chip_smoke.py phase 2 and the training shapes of phase 2b
# (K1b with phase 2b's ragged lengths and with phase 5's full ones)
FWD_SHAPES = [("K1", 4, 8, 800, 64, 11, [800, 600, 400, 267]),
              ("K1", 4, 8, 400, 64, 11, [400, 300, 200, 134]),
              ("K1", 4, 8, 200, 64, 11, [200, 150, 100, 67]),
              ("K1", 32, 8, 750, 64, 11, None),
              ("K1", 32, 8, 375, 64, 11, None),
              ("K1", 32, 8, 188, 64, 11, None)]
BWD_SHAPES = [("K1b", 32, 8, t, 64, 11, kl) for kl in ("ragged", None)
              for t in (750, 375, 188)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    opts = ap.parse_args()
    sys.path.insert(0, str(opts.root.resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("rel_attention_times: no CUDA device", file=sys.stderr)
        return 2
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_bwd, rel_attention_bwd_ref, rel_attention_fwd,
        rel_attention_ref)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    dtype = getattr(torch, opts.dtype)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            "float32")).to(dev).to(dtype)

    def cuda_ms(fn):
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(opts.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / opts.iters

    def graph_ms(fn, calls=10):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        return cuda_ms(graph.replay) / calls

    def rel(got, want):
        got, want = got.float(), want.float()
        return float((got - want).abs().max() / want.abs().max())

    results = []
    for what, b, h, t, dk, r, kl in FWD_SHAPES + BWD_SHAPES:
        if kl is None:
            kl = [t] * b
        elif kl == "ragged":             # chip_smoke.py phase 2b's lengths
            kl = np.maximum(t - (np.arange(b) * t) // (2 * b), 1).tolist()
        q = randn(b, h, t, dk, scale=dk ** -0.5)
        k, v = randn(b, h, t, dk), randn(b, h, t, dk)
        p = randn(b, h, t, r, scale=dk ** -0.5)
        klens = torch.tensor(kl, dtype=torch.int32, device=dev)
        fwd = (q, k, v, p, klens)
        if what == "K1":
            err = rel(rel_attention_fwd(*fwd)[0], rel_attention_ref(*fwd))
            call = lambda: rel_attention_fwd(*fwd)  # noqa: E731
        else:
            args = (*fwd, *rel_attention_fwd(*fwd), randn(b, h, t, dk))
            err = max(rel(x, y) for x, y in zip(
                rel_attention_bwd(*args), rel_attention_bwd_ref(*args)))
            call = lambda: rel_attention_bwd(*args)  # noqa: E731
        results.append({"kernel": what, "shape": f"B{b} H{h} T{t} dk{dk} R{r}",
                        "klens": "full" if kl == [t] * b else kl[:4],
                        "ms": cuda_ms(call), "device_ms": graph_ms(call),
                        "rel_err": err})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"label": opts.label, "root": str(opts.root),
                      "dtype": opts.dtype, "card": card,
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
