#!/usr/bin/env python3
"""Time the training optimizer step of one checkout of the port on the
card: the flagship (``flagship_args(faithful=True)``, seeded weights) in
``train()`` mode on ``chip_smoke.py`` phase 5's batch shape (B = 32
utterances of 1500 frames x 80, U = 100 labels, numpy seed 0), noam-Adam
with clip 5 and 4 accumulated microsteps, in float32 and at bf16 compute,
in one process.

    python3 neural_sp_tpu_torch/tools/train_step_times.py \\
        [--root DIR] [--label NAME] [--steps N]

``--root`` is the directory holding the ``neural_sp_tpu_torch`` package to
time (default: this checkout), so that two commits unpacked side by side
can be timed in turns on one card, each in its own process. For each
dtype: one optimizer step to warm up, then ``--steps`` optimizer steps,
each read apart: its wall (synchronised after its last microstep) and the
host's part of it (until the last microstep's call returns, before the
synchronise); then one microstep under torch.profiler: its wall, the
device's busy time (the union of the device events' intervals) and the
idle share. Prints one JSON line, the card's name and power limit
included.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
B, FRAMES, U, ACCUM, SEED = 32, 1500, 100, 4, 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--steps", type=int, default=5)
    opts = ap.parse_args()
    sys.path.insert(0, str(opts.root.resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("train_step_times: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from neural_sp_tpu_torch.configs import flagship_args
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.parallel.mesh import make_train_step
    from neural_sp_tpu_torch.trainers.lr_scheduler import noam_schedule
    from neural_sp_tpu_torch.trainers.optimizer import build_optimizer
    from neural_sp_tpu_torch.utils.init_params import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    xs = rng.standard_normal((B, FRAMES, 80)).astype("float32")
    ys = rng.integers(4, 10000, (B, U)).astype("int32")
    batch = (torch.from_numpy(xs).to(dev),
             torch.full((B,), FRAMES, dtype=torch.int32, device=dev),
             torch.from_numpy(ys).to(dev),
             torch.full((B,), U, dtype=torch.int32, device=dev))
    model = init_params(build_speech2text(flagship_args(faithful=True)),
                        SEED)
    model.train()

    def busy(fn) -> tuple[float, float]:
        """(wall s, device busy s) of fn under torch.profiler."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        total, last = 0.0, float("-inf")
        for start, end in spans:
            if end > last:
                total += end - max(start, last)
                last = end
        return wall, total / 1e6

    results = {}
    for dtype in ("float32", "bfloat16"):
        step = make_train_step(model, build_optimizer(
            "noam", schedule=noam_schedule(512, 25000, factor=5.0),
            clip_grad_norm=5.0, accum_grad_n_steps=ACCUM),
            compute_dtype=None if dtype == "float32" else torch.bfloat16)
        gen = torch.Generator().manual_seed(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls, hosts, losses = [], [], []
        for n in range(opts.steps + 1):       # step 0 warms up, untimed
            t0 = time.perf_counter()
            for _ in range(ACCUM):
                m = step(*batch, gen=gen)
            host = time.perf_counter() - t0
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            losses.append(float(m["loss"]))
            if n:
                walls.append(wall * 1e3)
                hosts.append(host * 1e3)
        micro_wall, micro_busy = busy(lambda: step(*batch, gen=gen))
        model.zero_grad(set_to_none=True)
        results[dtype] = {
            "optimizer_step_ms": walls, "host_ms": hosts,
            "mean_ms": sum(walls) / len(walls), "last_losses": losses[-2:],
            "profiled_microstep_wall_ms": micro_wall * 1e3,
            "profiled_microstep_busy_ms": micro_busy * 1e3,
            "idle_share": 1.0 - micro_busy / micro_wall,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        del step
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"label": opts.label, "root": str(opts.root),
                      "card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
