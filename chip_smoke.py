#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port (``neural_sp_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build the CUDA kernels from ``neural_sp_tpu_torch/ops/kernels/csrc``
     with nvcc (sm_90a) and time the build;
  2. hold each kernel against its plain PyTorch twin at the serving path's
     shapes (K1 rel_attention: B=4, H=8, dk=64, R=11, T in 800/400/200 with
     ragged lengths; K2 las_step: N=10 hypotheses, T in 200/400), TF32 off,
     and time kernel and twin with CUDA events;
  3. build the flagship Conformer-LAS (``configs.flagship_args(faithful=
     True)``, full widths, seeded random weights) on the card and serve a
     batch of 4 fbank-shaped utterances (700/1000/1300/1600 frames x 80)
     through ``Speech2TextSession.decode`` with beam 10 + CTC weight 0.3,
     with the on-device batched beam 10 (no CTC) and with greedy
     decoding; launch counters are zeroed just before and
     read just after, and both kernels must have run;
     then time the encoder alone and profile one beam request (device
     busy time against wall time, the kernels taking the most time);
  4. run the encoder with the twins in place of the kernels and compare
     the encoder outputs, then replay the best beam hypothesis through the
     twin decode step and compare the logits at every step.

Prints the card's ``name, power.limit`` (nvidia-smi), then one JSON line of
per-kernel results, and as its last line
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
# Whole encoder (12 layers) and a replayed decoder chain: the per-kernel
# rounding differences above, carried through every layer / step.
PATH_ATOL = 2e-3


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


def max_err(a, b) -> float:
    return float((a - b).abs().max())


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
    dev = torch.device("cuda")

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype("float32")).to(dev)

    res = {"rel_attention": {"max_abs_err": 0.0},
           "las_step": {"max_abs_err": 0.0}}
    b, h, dk, r = 4, 8, 64, 11
    for tt in (800, 400, 200):
        q, k, v = t(b, h, tt, dk, scale=dk ** -0.5), t(b, h, tt, dk), \
            t(b, h, tt, dk)
        p = t(b, h, tt, r, scale=dk ** -0.5)
        klens = torch.tensor([tt, tt - tt // 4, tt // 2, tt // 3 + 1],
                             dtype=torch.int32, device=dev)
        args = (q, k, v, p, klens)
        err = max_err(rel_attention(*args), rel_attention_ref(*args))
        ms, ref_ms = cuda_ms(lambda: rel_attention(*args)), \
            cuda_ms(lambda: rel_attention_ref(*args))
        log(f"[2] K1 rel_attention B={b} H={h} T={tt} dk={dk} R={r}: "
            f"max_abs_err {err:.3e}  kernel {ms:.4f} ms  twin {ref_ms:.4f} ms")
        expect(err <= KERNEL_ATOL, f"K1 T={tt}: error {err} > {KERNEL_ATOL}")
        res["rel_attention"]["max_abs_err"] = max(
            res["rel_attention"]["max_abs_err"], err)
        if tt == 800:
            res["rel_attention"].update(ms=ms, plain_ms=ref_ms)

    n, hd, d, a, c, kw = 10, 1024, 512, 512, 10, 201
    for tt in (200, 400):
        aw_prev = torch.softmax(t(n, tt, scale=3.0), -1)
        args = (t(n, 4 * hd, scale=0.5), t(n, d), t(n, hd, scale=0.5),
                t(n, hd), aw_prev, t(d, 4 * hd, scale=(d + hd) ** -0.5),
                t(hd, 4 * hd, scale=(d + hd) ** -0.5), t(4 * hd, scale=0.1),
                t(a, hd, scale=hd ** -0.5), t(c, kw, scale=kw ** -0.5),
                t(a, c, scale=c ** -0.5), t(a, scale=a ** -0.5),
                t(n, tt, a), t(n, tt, d),
                torch.tensor([tt - 3 * i for i in range(n)],
                             dtype=torch.int32, device=dev))
        outs, refs = las_step(*args), las_step_ref(*args)
        err = max(max_err(x, y) for x, y in zip(outs, refs))
        ms, ref_ms = cuda_ms(lambda: las_step(*args)), \
            cuda_ms(lambda: las_step_ref(*args))
        log(f"[2] K2 las_step N={n} T={tt} H={hd} D={d} A={a} C={c} K={kw}: "
            f"max_abs_err {err:.3e}  kernel {ms:.4f} ms  twin {ref_ms:.4f} ms")
        expect(err <= KERNEL_ATOL, f"K2 T={tt}: error {err} > {KERNEL_ATOL}")
        res["las_step"]["max_abs_err"] = max(
            res["las_step"]["max_abs_err"], err)
        if tt == 200:
            res["las_step"].update(ms=ms, plain_ms=ref_ms)
    return res


def flagship_model(torch):
    from neural_sp_tpu_torch.configs import flagship_args
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.utils.init_params import init_params
    model = build_speech2text(flagship_args(faithful=True))
    init_params(model, SEED)
    return model.to("cuda").eval()


def utterances(rng):
    import numpy as np
    xs = np.zeros((len(UTT_FRAMES), max(UTT_FRAMES), 80), np.float32)
    for i, t in enumerate(UTT_FRAMES):
        xs[i, :t] = rng.standard_normal((t, 80))
    return xs, np.asarray(UTT_FRAMES, np.int64)


def phase_serve(torch, model, xs, xlens):
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
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
        t0 = time.perf_counter()
        hyps = sess.decode(xs, xlens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        expect(len(hyps) == len(UTT_FRAMES) and all(
            all(isinstance(y, int) and 0 <= y < model.dec_fwd.vocab
                for y in hyp) for hyp in hyps), f"{name}: malformed {hyps}")
        out[name] = {"hyp_lens": [len(h) for h in hyps], "wall_s": wall,
                     "wall_s_per_utt": wall / len(hyps),
                     "rtf": wall / audio_sec,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        if name == "beam10_ctc0.3":
            out["best_hyp0"] = hyps[0]
        log(f"[3] {name}: hyp lens {out[name]['hyp_lens']}  wall "
            f"{wall:.3f} s ({wall / len(hyps):.3f} s/utt)  RTF "
            f"{wall / audio_sec:.4f}  peak mem "
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
            by_name[evt.name[:60]] += (end - start) / 1e3
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
                                         key=lambda kv: -kv[1])[:8]))
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
    t0 = time.perf_counter()
    beam.encode(xs, xlens)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    log(f"[3b] encoder, batch of {len(UTT_FRAMES)}: {enc_s:.4f} s")
    n = UTT_FRAMES[0]
    return {"encode_batch_s": enc_s,
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
    from neural_sp_tpu_torch.ops.kernels import las_step_ref, \
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
    log(f"[4] best hypothesis replay, {len(tokens)} steps: kernels vs twins "
        f"logits max_abs_err {step_err:.3e}")
    expect(step_err <= PATH_ATOL, f"decoder error {step_err} > {PATH_ATOL}")
    return enc_err, step_err


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
    enc_err, dec_err = phase_twins(torch, model, xs, xlens,
                                   served["best_hyp0"])

    srcs = {"rel_attention": (
        "neural_sp_tpu_torch/ops/kernels/csrc/rel_attention.cu",
        "neural_sp_tpu/ops/rel_attention_pallas.py:61 (583dfc4~1)"),
        "las_step": (
        "neural_sp_tpu_torch/ops/kernels/csrc/las_step.cu",
        "neural_sp_tpu/ops/las_scan_pallas.py:74 (63255ae~1)")}
    log(json.dumps({"build_s": build_sec, "encoder_max_abs_err": enc_err,
                    "decoder_max_abs_err": dec_err,
                    "serve": {k: v for k, v in served.items()
                              if k != "best_hyp0"},
                    "breakdown": breakdown}))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"]}
        for name, (src, rep) in srcs.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
