#!/usr/bin/env python3
"""Time the RNN layers of one checkout of the port on the card, and read
how far the cuDNN encoder is from its layers' written-out loop with
cuDNN's TF32 off and on.

    python3 neural_sp_tpu_torch/tools/rnn_times.py \\
        [--root DIR] [--label NAME] [--iters N]

``--root`` is the directory holding the ``neural_sp_tpu_torch`` package to
time (default: this checkout), so that two commits unpacked side by side
can be timed in turns on one card, each in its own process. What is
measured, float32, TF32 off unless said, CUDA-event times:

- the LibriSpeech BLSTM-LAS's encoder (``configs.
  librispeech_blstm_las_args``, seeded weights, ``eval()``) on
  ``chip_smoke.py`` phase 3's batch shape (4 utterances of 700, 1000, 1300
  and 1600 frames x 80, numpy seed 0): without autograd, as served;
- the same encoder, forward and backward of a weighted sum of its outputs,
  at B = 32 utterances of 1600 down to 825 frames, as a training
  microbatch; and under torch.profiler, the device time of its copies
  (``Memcpy``) and of all its kernels;
- the recipe's rnnlm_6L (``configs.librispeech_rnnlm_args``, seeded) one
  ``predict`` step at N = 10, as a beam step with shallow fusion takes it;
- the max |cuDNN encoder - loop encoder| (``RNNLayer.forward_ref`` in
  every layer) on the four utterances, with TF32 off and with it on.

Prints one JSON line, the card's name and power limit included.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

HERE = Path(__file__).resolve().parents[2]
FRAMES, SEED = (700, 1000, 1300, 1600), 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--iters", type=int, default=20)
    opts = ap.parse_args()
    sys.path.insert(0, str(opts.root.resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("rnn_times: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from neural_sp_tpu_torch.configs import (librispeech_blstm_las_args,
                                             librispeech_rnnlm_args)
    from neural_sp_tpu_torch.models.lm.build import build_lm
    from neural_sp_tpu_torch.models.modules.recurrent import RNNLayer
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.utils.init_params import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def cuda_ms(fn, iters=opts.iters):
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

    def batch(frames):
        xs = np.zeros((len(frames), max(frames), 80), np.float32)
        for i, t in enumerate(frames):
            xs[i, :t] = rng.standard_normal((t, 80))
        return (torch.from_numpy(xs).to(dev),
                torch.tensor(frames, dtype=torch.int32, device=dev))

    model = init_params(build_speech2text(librispeech_blstm_las_args()),
                        SEED).eval()
    enc = model.encoder
    out = {"label": opts.label, "root": str(opts.root)}

    xs, xlens = batch(FRAMES)
    with torch.inference_mode():
        out["encode_ms"] = cuda_ms(lambda: enc(xs, xlens))
        e = enc(xs, xlens)["ys"]["xs"]
        torch.backends.cudnn.allow_tf32 = True
        e_tf32 = enc(xs, xlens)["ys"]["xs"]
        torch.backends.cudnn.allow_tf32 = False
        with mock.patch.object(RNNLayer, "forward", RNNLayer.forward_ref):
            e_loop = enc(xs, xlens)["ys"]["xs"]
    out["encoder_max_abs_err"] = float((e - e_loop).abs().max())
    out["encoder_tf32_max_abs_err"] = float((e_tf32 - e_loop).abs().max())

    txs, txlens = batch([1600 - 25 * i for i in range(32)])

    def train_pass():
        h = enc(txs, txlens)["ys"]["xs"]
        (h * torch.linspace(-1, 1, h.shape[-1], device=dev)).sum().backward()

    out["encode_fwd_bwd_ms"] = cuda_ms(train_pass, max(5, opts.iters // 4))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        train_pass()
        torch.cuda.synchronize()
    spans = [(k.name, k.time_range.elapsed_us()) for k in prof.events()
             if k.device_type == torch.autograd.DeviceType.CUDA]
    out["fwd_bwd_device_ms"] = sum(us for _, us in spans) / 1e3
    out["fwd_bwd_memcpy_ms"] = sum(us for name, us in spans
                                   if "Memcpy" in name) / 1e3
    model.zero_grad(set_to_none=True)
    del model, enc, prof
    torch.cuda.empty_cache()

    lm = init_params(build_lm(librispeech_rnnlm_args()), SEED).eval()
    y = torch.randint(4, 1000, (10,), device=dev)
    with torch.inference_mode():
        state = lm.predict(y)[1]
        out["lm_step_ms"] = cuda_ms(lambda: lm.predict(y, state),
                                    5 * opts.iters)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
