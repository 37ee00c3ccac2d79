#!/usr/bin/env python3
"""Two diagnoses of the training microstep on the card, for one checkout
of the port (``--root``, default this one).

``determinism``: is one microstep the same bits twice? The flagship
(``flagship_args(faithful=True)``, seeded weights) in ``train()`` mode on
``chip_smoke.py`` phase 5's batch (B = 32 x 1500 frames x 80, U = 100,
numpy seed 0), each run from a fresh ``torch.Generator`` of one seed. It
runs the microstep twice and compares the loss and every gradient leaf
bit for bit, in float32 and at bf16 compute; then again with each kernel
pair in turn replaced by its plain twin (K1 / K1b, K3 / K3b, K4), with
all of them replaced, with ``torch.backends.cudnn.deterministic``, and
under ``torch.use_deterministic_algorithms(True, warn_only=True)`` (the
operations that warn are listed); last, each kernel wrapper alone is
called twice on the inputs it received in the first microstep and its
outputs compared bit for bit.

``bf16-gap``: where does the bf16 microstep's distance from float32 come
from on a CLI microbatch? Trains ``chip_smoke.py`` phase 7's conf through
the train CLI (2 epochs, then a third resumed, phase 7's corpus and
overrides), keeps the microbatch with the most utterances and the one
with the most padded frames, and on the epoch-3 weights (and on seeded
ones) takes ``eval()`` microsteps: plain float32, plain bf16, and at bf16
the kernels, K1 alone plain (its forward; K1b kernel), K1b alone plain;
with the lengths as they are and all set to the longest, and the batch
padded to 1500 frames (K1 at T = 750 / 375 / 188). For each it prints the
six leaves nearest phase 6b's limit (each leaf's L2 distance from plain
float32 over twice plain bf16's plus phase 6's float32 tolerance).

    python3 neural_sp_tpu_torch/tools/train_diagnosis.py determinism
    python3 neural_sp_tpu_torch/tools/train_diagnosis.py bf16-gap

Each prints one JSON line (the card's name and power limit included) and
writes it to ``chiprun_out/train_diagnosis_<mode>.json``.
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import warnings
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

HERE = Path(__file__).resolve().parents[2]
B, FRAMES, U, SEED = 32, 1500, 100, 0


def kernel_module(name):
    """A module of ``ops.kernels`` (the package exports functions of the
    same names, which hide the modules from ``from ... import``)."""
    import importlib
    return importlib.import_module(f"neural_sp_tpu_torch.ops.kernels.{name}")


def twins(torch, which):
    """The patches that put plain twins in place of the kernels named in
    ``which`` (a subset of "k1", "k1b", "las", "ctc"): K1 and K1b each on
    its own (the other one stays the kernel), K3 with K3b, K4 forward
    with its backward."""
    import chip_smoke
    from neural_sp_tpu_torch.models.decoders import las
    from neural_sp_tpu_torch.models.modules import \
        relative_multihead_attention as rma
    from neural_sp_tpu_torch.ops import ctc
    from neural_sp_tpu_torch.ops.kernels.ctc_loss import ctc_forward_alphas
    ra = kernel_module("rel_attention")
    out = []
    if "k1" in which or "k1b" in which:
        plain_fwd, plain_bwd = "k1" in which, "k1b" in which

        class Mixed(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v, p, klens):
                if plain_fwd:
                    o = ra.rel_attention_ref(q, k, v, p, klens)
                    m, l = ra.rel_attention_stats_ref(q, k, p, klens)
                else:
                    o, m, l = ra.rel_attention_fwd(q, k, v, p, klens)
                ctx.save_for_backward(q, k, v, p, klens, o, m, l)
                return o

            @staticmethod
            def backward(ctx, do):
                bwd = ra.rel_attention_bwd_ref if plain_bwd else \
                    ra.rel_attention_bwd
                return (*bwd(*ctx.saved_tensors, do.contiguous()), None)

        out.append((rma, "rel_attention", Mixed.apply))
    if "las" in which:
        out.append((las, "LASScan", chip_smoke.PlainLASScan))
    if "ctc" in which:
        out.append((ctc, "ctc_nll", lambda *a: ctc_forward_alphas(*a)[0]))
    return out


def microstep(torch, model, batch, dtype=None, plain=(), seed=None):
    """(loss, {leaf: gradient}) of one microstep in the model's mode, the
    kernels in ``plain`` replaced by their twins; ``seed``: a fresh
    generator of that seed draws the step's randomness."""
    from neural_sp_tpu_torch.parallel.mesh import compute_loss
    model.zero_grad(set_to_none=True)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    with ExitStack() as stack:
        for target, name, value in twins(torch, plain):
            stack.enter_context(mock.patch.object(target, name, value))
        loss, _ = compute_loss(model, dtype, *batch, gen)
        loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach().float(), grads


def bitwise(torch, a, b) -> dict:
    """How two microsteps' results differ: the loss's bits, and the leaves
    whose gradients are not bitwise equal (with their max |difference|
    over the leaf's max)."""
    la, ga = a
    lb, gb = b
    differ = {}
    for name, x in ga.items():
        y = gb[name]
        if not torch.equal(x, y):
            scale = float(x.abs().max()) or 1.0
            differ[name] = float((x - y).abs().max()) / scale
    ranked = sorted(differ.items(), key=lambda kv: -kv[1])
    return {"loss_equal": bool(torch.equal(la, lb)),
            "loss_diff": float((la - lb).abs()),
            "leaves_differ": len(differ), "leaves": len(ga),
            "worst": ranked[:8]}


def fingerprint(torch, x) -> int:
    """An exact fingerprint of a tensor's bits: its words as integers,
    summed with position weights."""
    x = x.detach().contiguous()
    words = x.view(torch.int16 if x.element_size() == 2 else torch.int32)
    words = words.reshape(-1).long()
    w = torch.arange(words.numel(), device=x.device) % 65521 + 1
    return int((words * w).sum())


def backward_trace(torch, model, batch, dtype, seed):
    """One microstep with a full backward hook on every leaf module: the
    modules in the order the backward reached them, each with the
    fingerprints of its output's and its input's gradient."""
    trace = []
    handles = []
    for name, mod in model.named_modules():
        if next(mod.children(), None) is not None:
            continue

        def hook(m, g_in, g_out, _name=name):
            first = lambda gs: next((g for g in gs if g is not None), None)
            gi, go = first(g_in), first(g_out)
            trace.append((_name, None if go is None else fingerprint(torch, go),
                          None if gi is None else fingerprint(torch, gi)))

        handles.append(mod.register_full_backward_hook(hook))
    try:
        _, grads = microstep(torch, model, batch, dtype, (), seed)
    finally:
        for h in handles:
            h.remove()
    return trace, grads


def first_drift(torch, model, batch, dtype, seed) -> dict:
    """Where two runs of one microstep part: the first modules in backward
    order whose output gradient agrees but whose input gradient or
    parameter gradient does not."""
    (ta, ga), (tb, gb) = (backward_trace(torch, model, batch, dtype, seed)
                          for _ in range(2))
    out = {"modules_in_order": len(ta), "same_order": [n for n, _, _ in ta]
           == [n for n, _, _ in tb]}
    culprits = []
    for (name, oa, ia), (_, ob, ib) in zip(ta, tb):
        params = [n for n in ga if n.rsplit(".", 1)[0] == name]
        p_differ = [n for n in params if not torch.equal(ga[n], gb[n])]
        if oa == ob and (ia != ib or p_differ):
            culprits.append({"module": name, "type": type(
                model.get_submodule(name)).__name__,
                "input_grad_differs": ia != ib, "param_grads_differ": p_differ})
    first_out = next((n for (n, oa, _), (_, ob, _) in zip(ta, tb)
                      if oa != ob), None)
    out["culprits"] = culprits[:12]
    out["n_culprits"] = len(culprits)
    out["first_module_whose_output_grad_differs"] = first_out
    out["leaves_equal"] = [n for n in ga if torch.equal(ga[n], gb[n])]
    return out


def record_calls(torch):
    """Wrap each kernel wrapper so that its first call's arguments are
    kept; returns (patches, calls)."""
    ra, las_scan, ctc_loss = (kernel_module(m) for m in (
        "rel_attention", "las_scan", "ctc_loss"))
    calls = {}
    patches = []
    for mod, name in ((ra, "rel_attention_fwd"), (ra, "rel_attention_bwd"),
                      (las_scan, "las_scan"), (las_scan, "las_scan_bwd"),
                      (ctc_loss, "ctc_loss_fwd"), (ctc_loss, "ctc_loss_bwd")):
        real = getattr(mod, name)

        @functools.wraps(real)
        def wrapper(*args, _real=real, _name=name):
            if _name not in calls:
                calls[_name] = (_real, tuple(
                    x.clone() if torch.is_tensor(x) else x for x in args))
            return _real(*args)

        patches.append(mock.patch.object(mod, name, wrapper))
    return patches, calls


def kernels_twice(torch, calls) -> dict:
    """Each recorded wrapper called twice on its recorded inputs: are the
    outputs the same bits?"""
    out = {}
    for name, (fn, args) in calls.items():
        a = fn(*args)
        b = fn(*args)
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        diffs = []
        for x, y in zip(a, b):
            if torch.is_tensor(x):
                same = torch.equal(x, y)
                diffs.append(0.0 if same else float(
                    (x.float() - y.float()).abs().max()))
        out[name] = {"equal": all(d == 0.0 for d in diffs),
                     "max_abs_diff": max(diffs),
                     "dtype": str(args[0].dtype)}
    return out


def determinism(torch, model, log, dev="cuda", shape=(B, FRAMES, U),
                vocab=10000) -> dict:
    import numpy as np
    bs, frames, u = shape
    rng = np.random.default_rng(SEED)
    xs = rng.standard_normal((bs, frames, 80)).astype("float32")
    ys = rng.integers(4, vocab, (bs, u)).astype("int32")
    batch = (torch.from_numpy(xs).to(dev),
             torch.full((bs,), frames, dtype=torch.int32, device=dev),
             torch.from_numpy(ys).to(dev),
             torch.full((bs,), u, dtype=torch.int32, device=dev))
    model.train()
    res = {}

    def twice(tag, dtype=None, plain=()):
        a = microstep(torch, model, batch, dtype, plain, SEED)
        b = microstep(torch, model, batch, dtype, plain, SEED)
        res[tag] = bitwise(torch, a, b)
        log(f"[{tag}] {res[tag]}")

    twice("kernels f32")
    twice("kernels bf16", torch.bfloat16)
    for which in (("k1", "k1b"), ("las",), ("ctc",)):
        twice(f"twins {'+'.join(which)} f32", plain=which)
    twice("all twins f32", plain=("k1", "k1b", "las", "ctc"))
    torch.backends.cudnn.deterministic = True
    twice("kernels f32, cudnn deterministic")
    torch.backends.cudnn.deterministic = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            twice("kernels f32, deterministic algorithms")
        finally:
            torch.use_deterministic_algorithms(False)
    res["nondeterministic_ops"] = sorted({str(w.message).split("\n")[0]
                                          for w in caught})
    log(f"nondeterministic ops: {res['nondeterministic_ops']}")
    for dtype, tag in ((None, "f32"), (torch.bfloat16, "bf16")):
        res[f"first drift {tag}"] = first_drift(torch, model, batch, dtype,
                                                SEED)
        log(f"[first drift {tag}] {res[f'first drift {tag}']}")
    for dtype, tag in ((None, "f32"), (torch.bfloat16, "bf16")):
        patches, calls = record_calls(torch)
        with ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            microstep(torch, model, batch, dtype, (), SEED)
        res[f"kernels twice {tag}"] = kernels_twice(torch, calls)
        log(f"[kernels twice {tag}] {res[f'kernels twice {tag}']}")
    return res


def gap_leaves(torch, runs, ref32, ref16):
    """Phase 6b's rule per leaf for each run in ``runs`` ({tag: (loss,
    grads)}), against plain float32 ``ref32`` and plain bf16 ``ref16``:
    the six leaves nearest the limit, with (share, |run - f32|, |plain
    bf16 - f32|)."""
    import chip_smoke
    norm = torch.linalg.vector_norm
    _, g32 = ref32
    _, g16 = ref16
    g_max = max(float(g.abs().max()) for g in g32.values())
    out = {}
    for tag, (loss, grads) in runs.items():
        leaves = {}
        for name, g in grads.items():
            per = chip_smoke.GRAD_FLOOR * g_max \
                if name.endswith(chip_smoke.ZERO_GRAD_LEAF) \
                else chip_smoke.GRAD_RTOL * float(g32[name].abs().max())
            floor = per * g32[name].numel() ** 0.5
            cost = float(norm(g16[name] - g32[name]))
            err = float(norm(g - g32[name]))
            tol = chip_smoke.BF16_PATH_FACTOR * cost + floor
            leaves[name] = (err / tol, err, cost)
        ranked = sorted(leaves.items(), key=lambda kv: -kv[1][0])
        out[tag] = {"loss": float(loss), "worst": ranked[:6],
                    "leaves_over": sum(1 for _, v in ranked if v[0] > 1.0)}
    return out


def bf16_gap(torch, log) -> dict:
    import tempfile
    from types import SimpleNamespace
    import chip_smoke
    from neural_sp_tpu_torch.bin.asr import eval as cli_eval
    from neural_sp_tpu_torch.bin.asr import train as cli_train
    from neural_sp_tpu_torch.parallel.mesh import TrainStep
    from neural_sp_tpu_torch.utils.init_params import init_params
    kept = {}
    orig_call = TrainStep.__call__

    def keeping_call(self, xs, xlens, ys, ylens, *a, **kw):
        for key, size in (("by_utts", (xs.shape[0], xs.shape[1])),
                          ("by_frames", (xs.shape[1], xs.shape[0]))):
            if key not in kept or size > kept[key][0]:
                kept[key] = (size, (xs, xlens, ys, ylens))
        return orig_call(self, xs, xlens, ys, ylens, *a, **kw)

    res = {}
    with tempfile.TemporaryDirectory(prefix="nsp_gap_") as tmp:
        root = Path(tmp)
        corpus = chip_smoke.synth_corpus(root / "data", chip_smoke.CLI_UTTS,
                                         chip_smoke.CLI_VOCAB)
        exp = str(root / "exp")
        data = ["--train_set", corpus["train"], "--dev_set", corpus["dev"],
                "--dict", corpus["dict"], "--model_save_dir", exp]
        with mock.patch.object(TrainStep, "__call__", keeping_call):
            for resume in ((), ("--resume", f"{exp}/ckpt.epoch-2",
                                "--n_epochs", "3")):
                cli_train.main(["--config", str(HERE / chip_smoke.CLI_CONF)]
                               + data + list(chip_smoke.CLI_OVERRIDES)
                               + list(resume))
        trained, args, _ = cli_eval.load_model_for_eval(SimpleNamespace(
            recog_model=f"{exp}/ckpt.epoch-3", recog_n_average=1))
    for key in ("by_utts", "by_frames"):
        xs, xlens, ys, ylens = kept[key][1]
        gap_report(torch, trained, (xs, xlens, ys, ylens), f"{key}, trained",
                   res, log)
        res[f"{key}, trained, K1 forward"] = k1_forward_report(
            torch, trained, (xs, xlens, ys, ylens))
        log(f"[{key}, trained, K1 forward] "
            f"{res[f'{key}, trained, K1 forward']}")
        full = torch.full_like(xlens, xs.shape[1])
        gap_report(torch, trained, (xs, full, ys, ylens),
                   f"{key}, trained, full lengths", res, log)
        if xs.shape[1] < FRAMES:
            pad = torch.nn.functional.pad(xs, (0, 0, 0, FRAMES - xs.shape[1]))
            gap_report(torch, trained, (pad, xlens, ys, ylens),
                       f"{key}, trained, padded to {FRAMES} frames", res, log)
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    del trained
    torch.cuda.empty_cache()
    seeded = init_params(build_speech2text(args), SEED)
    xs, xlens, ys, ylens = kept["by_utts"][1]
    gap_report(torch, seeded, (xs, xlens, ys, ylens), "by_utts, seeded", res,
               log)
    return res


def k1_forward_report(torch, model, batch) -> list:
    """K1's bf16 forward against its plain bf16 version on the inputs each
    layer gave it in one bf16 microstep, both measured against the plain
    float32 version on the same (bf16-valued) inputs: per layer the L2
    distances of o over the valid query rows and over the padded ones, the
    share of o's elements where kernel and plain bf16 differ, and the
    largest relative differences of m and l."""
    ra = kernel_module("rel_attention")
    seen = []
    real = ra.rel_attention_fwd

    @functools.wraps(real)
    def keep(*args):
        seen.append(tuple(x.detach().clone() for x in args))
        return real(*args)

    with mock.patch.object(ra, "rel_attention_fwd", keep):
        microstep(torch, model, batch, torch.bfloat16)
    norm = torch.linalg.vector_norm
    rows = []
    for q, k, v, p, klens in seen:
        o_k, m_k, l_k = ra.rel_attention_fwd(q, k, v, p, klens)
        o_p = ra.rel_attention_ref(q, k, v, p, klens)
        m_p, l_p = ra.rel_attention_stats_ref(q, k, p, klens)
        o_32 = ra.rel_attention_ref(q.float(), k.float(), v.float(),
                                    p.float(), klens)
        t = q.shape[2]
        valid = (torch.arange(t, device=q.device)[None]
                 < klens[:, None])[:, None, :, None].expand_as(o_32)
        row = {"T": t}
        for part, sel in (("valid", valid), ("padded", ~valid)):
            ref = o_32[sel]
            row[part] = [float(norm(o_k.float()[sel] - ref)),
                         float(norm(o_p.float()[sel] - ref))]
        row["o_differs"] = float((o_k != o_p).float().mean())
        row["m_rel"] = float(((m_k - m_p).abs() / m_p.abs().clamp_min(
            1e-30)).max())
        row["l_rel"] = float(((l_k - l_p).abs() / l_p).max())
        rows.append(row)
    return rows


def gap_report(torch, model, batch, tag, res, log):
    """Phase 6b's rule on one batch (``gap_leaves``): the kernels, K1 alone
    plain and K1b alone plain, all at bf16, into ``res[tag]``."""
    bf = torch.bfloat16
    plain_all = ("k1", "k1b", "las", "ctc")
    model.eval()
    ref32 = microstep(torch, model, batch, None, plain_all)
    ref16 = microstep(torch, model, batch, bf, plain_all)
    runs = {"kernels": microstep(torch, model, batch, bf),
            "K1 plain": microstep(torch, model, batch, bf, ("k1",)),
            "K1b plain": microstep(torch, model, batch, bf, ("k1b",))}
    res[tag] = gap_leaves(torch, runs, ref32, ref16)
    res[tag]["shape"] = [list(batch[0].shape), list(batch[2].shape)]
    res[tag]["plain_losses"] = [float(ref32[0]), float(ref16[0])]
    for k, v in res[tag].items():
        log(f"[{tag}] {k}: {v}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("determinism", "bf16-gap"))
    ap.add_argument("--root", type=Path, default=HERE)
    opts = ap.parse_args()
    sys.path.insert(0, str(opts.root.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("train_diagnosis: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    if opts.mode == "determinism":
        from neural_sp_tpu_torch.configs import flagship_args
        from neural_sp_tpu_torch.models.speech2text import build_speech2text
        from neural_sp_tpu_torch.utils.init_params import init_params
        model = init_params(build_speech2text(flagship_args(faithful=True)),
                            SEED)
        res = determinism(torch, model, log)
    else:
        res = bf16_gap(torch, log)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    line = json.dumps({"mode": opts.mode, "root": str(opts.root),
                       "card": card, "torch": torch.__version__,
                       "results": res})
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"train_diagnosis_{opts.mode.replace('-', '_')}.json").write_text(
        line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
