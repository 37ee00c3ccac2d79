#!/usr/bin/env python3
"""Time the relative attention's distance table on the card, in turns: as
the port keeps it (``RelativeMultiheadAttention._distance_table``: built
once, kept on the device and sliced) against the table built in numpy and
copied to the device at every layer's call, as the port did before the
Transformer-XL's one-token steps came (patched in).

    python3 neural_sp_tpu_torch/tools/rel_table_times.py [--rounds N]
        [--tokens N]

Float32, TF32 off, seeded random weights. Per round, each variant in turn
(kept, per call, per call, kept, ...):

- the swbd Transformer-XL LM conf (``examples/swbd/conf/lm/
  transformer_xl.yaml``, V 10,000) in ``LMSession.ppl_with_cache`` over
  ``--tokens`` tokens at B 1 with a cache of 100: the wall per one-token
  step (the eval CLI's ``--recog_n_caches`` path);
- the flagship conformer (``configs.flagship_args(faithful=True)``) encoding
  four utterances of 700-1600 frames under ``no_grad``, and one forward and
  backward of its encoder's output sum on the same batch in ``train()``
  mode: the wall of each (a synchronise after the call).

Prints one JSON line: the card's name and power limit, and per workload
and variant the readings of every round.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parents[2]
XL_CONF = "examples/swbd/conf/lm/transformer_xl.yaml"
UTT_FRAMES = (700, 1000, 1300, 1600)
VOCAB = 10000


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=200)
    opts = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch
    import yaml
    if not torch.cuda.is_available():
        print("rel_table_times: no CUDA device", file=sys.stderr)
        return 2
    from neural_sp_tpu_torch.configs import flagship_args
    from neural_sp_tpu_torch.models.lm.build import build_lm
    from neural_sp_tpu_torch.models.lm.session import LMSession
    from neural_sp_tpu_torch.models.modules import \
        relative_multihead_attention as rma
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.utils.init_params import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    kept = rma.RelativeMultiheadAttention._distance_table

    def per_call(self, n_rel, like):
        return torch.from_numpy(rma.rel_distance_table(
            n_rel, self.d_model)).to(like.device, like.dtype)

    lm = init_params(build_lm(SimpleNamespace(**yaml.safe_load(
        (HERE / XL_CONF).read_text()), vocab=VOCAB)), 5).eval()
    sess = LMSession(lm, cache_size=100)
    stream = [int(t) for t in rng.integers(4, VOCAB, opts.tokens)]
    model = init_params(build_speech2text(flagship_args(faithful=True)), 0)
    xs = np.zeros((len(UTT_FRAMES), max(UTT_FRAMES), 80), np.float32)
    for i, t in enumerate(UTT_FRAMES):
        xs[i, :t] = rng.standard_normal((t, 80))
    xs = torch.from_numpy(xs).cuda()
    xlens = torch.tensor(UTT_FRAMES).cuda()

    def wall(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def encode():
        model.eval()
        with torch.no_grad():
            model.encode(xs, xlens)

    def encoder_step():
        model.train()
        model.zero_grad(set_to_none=True)
        eouts, _ = model.encode(xs, xlens)
        eouts["ys"]["xs"].sum().backward()

    work = {"xl_cache_step_ms": lambda: 1e3 * wall(
                lambda: sess.ppl_with_cache(stream)) / len(stream),
            "conformer_encode_ms": lambda: 1e3 * wall(encode),
            "conformer_encoder_fwd_bwd_ms": lambda: 1e3 * wall(encoder_step)}
    variants = {"kept": kept, "per_call": per_call}
    out = {name: {v: [] for v in variants} for name in work}
    for rnd in range(opts.rounds + 1):     # round 0 warms up, not kept
        order = list(variants) if rnd % 2 == 0 else list(variants)[::-1]
        for v in order:
            rma.RelativeMultiheadAttention._distance_table = variants[v]
            for name, fn in work.items():
                ms = fn()
                if rnd > 0:
                    out[name][v].append(ms)
    rma.RelativeMultiheadAttention._distance_table = kept
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(json.dumps({"card": card, "rounds": opts.rounds,
                      "tokens": opts.tokens, "readings": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
