"""ASR training CLI (counterpart of ``neural_sp_tpu/bin/asr/train.py``).

Usage:
  python -m neural_sp_tpu_torch.bin.asr.train --config conf.yml \\
      --train_set train.tsv --dev_set dev.tsv --dict dict.txt \\
      --model_save_dir exp/ [--resume exp/ckpt.epoch-N]

One ``make_train_step`` serves the run, on the CUDA card
(``main(argv, device="cpu")`` trains on the CPU). Per epoch: the training
batches (with ``train_dtype: bfloat16``, bf16 compute over float32
masters), the dev loss in float32, the epoch controller's lr decay (which
reaches the step as ``lr_scale``, the controller's lr over the conf's),
``history.csv``, and a checkpoint, keeping the ``n_keep_best_checkpoints``
best epochs; early stop as the controller says. At the end of epoch
``convert_to_sgd_epoch``, after its dev loss, the run switches to plain
SGD at ``sgd_lr`` (default 1e-4) with the conf's clip and neither
accumulation, weight decay nor schedule, and the controller's decay stops,
as the JAX CLI's switch. ``--resume`` continues from a checkpoint's model,
optimizer and controller states (a JAX checkpoint after
``utils/convert_params.py::convert_checkpoint``); like the JAX CLI's, it
builds the conf's optimizer, so a checkpoint past the switch (SGD's state)
raises (ROADMAP C10).

The batches are padded on the JAX CLI's grid (frames to 128, labels to
32). Initialisation is the port's (``utils/init_params.py``), seeded by
``--seed``: it draws other numbers than flax's. Scheduled sampling
(``ss_prob``) starts at ``ss_start_epoch`` when that is set, as the JAX
CLI's curriculum; so do MoChA's quantity loss, latency loss and
StableEmit at ``mocha_{quantity_loss,latency_loss,stableemit}_start_epoch``
(weight 0 before), and a transformer decoder's MMA quantity loss at
``mocha_quantity_loss_start_epoch``. The hierarchical sub-tasks read
their labels from ``--dict_sub1`` / ``--dict_sub2`` (with ``unit_sub*``
and ``wp_model_sub*``); their vocabularies go into the saved conf as
``vocab_sub1`` / ``vocab_sub2``. With ``mtl_per_batch`` each batch trains
one task, round-robin over the main task and each sub-task, as the JAX
CLI: the same modules with the other tasks' weights zeroed, a sub-task's
weight scaled to 1 with its attention / CTC ratio kept (``mtl_tasks``);
the dev loss takes the conf's weights.

``--train_word_alignment`` / ``--train_ctc_alignment`` give the batches
trigger points (``datasets/asr/dataset.py``), which reach the model's
loss; as in the JAX CLI, the dev set is read with the same directories
(``dev_word_alignment`` is not read) and the dev loss takes no trigger
points. Random state passing (``rsp_prob``, or the recipes'
``rsp_prob_enc`` when ``rsp_prob`` is unset: ROADMAP C16) needs an RNN
encoder, as JAX's assertion: each step starts the encoder from the
previous batch's carry with that probability (``make_rsp_train_step``),
a batch of another size from zeros.

Minimum-Bayes-risk training (``mbr_training``, from ``mbr_start_epoch``,
default 1) replaces an epoch's training loop, as the JAX CLI's: per batch,
each utterance's n-best of ``mbr_nbest`` (default 4) from the LAS beam at
width max(``mbr_nbest``, 4) (``Speech2TextSession._beam_one``), padded to
``mbr_nbest`` with its last entry (``[eos]`` when empty), each
hypothesis's risk its word errors against the transcript
(``compute_wer``'s S + I + D), the hypotheses padded to at least 8 labels
per utterance, then across the batch; then one step of
``Speech2Text.mbr_loss`` (``mbr_ce_weight``, default 0.01, times the
model's own loss) in ``eval()`` and float32, through the optimizer with
no epoch lr scale, as JAX's ``mbr_step``; every ``mbr_ckpt_interval``
batches a checkpoint ``ckpt.epoch-N-step-M``. The dev loss, the
controller and the epoch's checkpoint follow as in any epoch. The JAX
CLI's distillation, tensor parallelism and the profiler window raise
(ROADMAP).
"""
from __future__ import annotations

import logging
import os
import re
import shutil
import sys
import time

import numpy as np
import torch

from ... import EOS, PAD, configs
from ...datasets.asr.build import build_dataloader
from ...evaluators.edit_distance import compute_wer
from ...models.decoders.decoding import DecodeConfig, Speech2TextSession
from ...models.decoders.las import RNNDecoder
from ...models.decoders.transformer import TransformerDecoder
from ...models.encoders.rnn import RNNEncoder
from ...models.speech2text import WEIGHTS, build_speech2text
from ...models.utils import model_device, np_pad_lists
from ...parallel.mesh import make_rsp_train_step, make_train_step
from ...trainers.checkpoint import load_checkpoint, save_checkpoint
from ...trainers.lr_scheduler import (
    EpochController, noam_schedule, warmup_schedule)
from ...trainers.optimizer import build_optimizer
from ...trainers.reporter import Reporter
from ...utils.init_params import init_params
from ..args import parse_args_train, save_config

logger = logging.getLogger(__name__)

# options of the JAX CLI the port does not have: each raises when set
_NOT_PORTED = ("teacher", "profile_n_steps")
_SUB_LABELS = ("ys_sub1", "ylens_sub1", "ys_sub2", "ylens_sub2")
# what a training step takes from a batch besides xs, xlens, ys, ylens
_STEP_LABELS = _SUB_LABELS + ("trigger_points",)


def compute_subsampling_factor(args) -> int:
    """The encoder's total time subsampling: the conv front end's pooling
    strides times the interlayer subsampling factors."""
    f = 1
    enc = str(getattr(args, "enc_type", ""))
    if enc.startswith("conv") and getattr(args, "conv_poolings", ""):
        for m in re.findall(r"\((\d+)\s*,\s*\d+\)", str(args.conv_poolings)):
            f *= max(int(m), 1)
    for tok in str(getattr(args, "subsample", "") or "").split("_"):
        if tok.isdigit():
            f *= max(int(tok), 1)
    return f


def make_schedule(args):
    """noam for the noam optimizers, linear warmup when warmup_n_steps > 0,
    else None (a constant lr)."""
    if args.optimizer in ("noam", "noam_adam"):
        return noam_schedule(args.transformer_d_model,
                             max(args.warmup_n_steps, 1),
                             factor=getattr(args, "lr_factor", 1.0))
    if getattr(args, "warmup_n_steps", 0) > 0:
        return warmup_schedule(args.lr,
                               getattr(args, "warmup_start_lr", args.lr / 100),
                               args.warmup_n_steps)
    return None


def set_mocha_curriculum(dec, args, epoch: int) -> None:
    """MoChA's loss weights for ``epoch``, as the JAX CLI's phases: each of
    the quantity loss, the latency loss and StableEmit is 0 before its
    ``*_start_epoch`` (when that is set), else the conf's weight. A
    transformer decoder has the quantity loss alone (its MMA's: the JAX
    builder reads no other)."""
    def weight(flag, field):
        start = getattr(args, flag, 0)
        return 0.0 if start and epoch < start else getattr(args, field, 0.0)
    dec.quantity_loss_weight = weight("mocha_quantity_loss_start_epoch",
                                      "mocha_quantity_loss_weight")
    if isinstance(dec, TransformerDecoder):
        return
    dec.latency_loss_weight = weight("mocha_latency_loss_start_epoch",
                                     "mocha_latency_loss_weight")
    dec.step.attn.stableemit_weight = weight("mocha_stableemit_start_epoch",
                                             "mocha_stableemit_weight")


def mtl_tasks(args) -> list[dict]:
    """``mtl_per_batch``'s tasks, as the JAX CLI's: the weights of the
    main task (the sub-tasks' zeroed), then of each sub-task with a weight
    (the main task's zeroed, its own scaled to 1 with its CTC share kept);
    [] without ``mtl_per_batch``. A sub-task's weight needs its encoder
    tap (JAX's assertion)."""
    if not getattr(args, "mtl_per_batch", False):
        return []
    g = lambda name: getattr(args, name, 0.0)  # noqa: E731
    for sub in ("sub1", "sub2"):
        assert g(f"{sub}_weight") <= 0 or g(f"enc_n_layers_{sub}") > 0, (
            f"{sub}_weight > 0 needs --enc_n_layers_{sub} (the encoder tap "
            f"feeding that head)")
    zero = dict(sub1_weight=0.0, ctc_weight_sub1=0.0, sub2_weight=0.0,
                ctc_weight_sub2=0.0)
    tasks = [dict(zero, ctc_weight=g("ctc_weight"))]
    for sub in ("sub1", "sub2"):
        w = g(f"{sub}_weight")
        if w > 0:
            tasks.append(dict(zero, ctc_weight=0.0, **{
                f"{sub}_weight": 1.0,
                f"ctc_weight_{sub}": g(f"ctc_weight_{sub}") / w}))
    return tasks


def _to_device(batch: dict, device) -> tuple:
    return tuple(torch.from_numpy(batch[k]).to(device, non_blocking=True)
                 for k in ("xs", "xlens", "ys", "ylens"))


def _sub_labels(batch: dict, device, keys=_SUB_LABELS) -> dict:
    return {k: torch.from_numpy(batch[k]).to(device, non_blocking=True)
            for k in keys if k in batch}


def rsp_rate(args) -> float:
    """Random state passing's rate: ``rsp_prob`` (the JAX CLI's flag), else
    the recipes' ``rsp_prob_enc``, which the JAX CLI does not read (C16)."""
    return float(getattr(args, "rsp_prob", 0.0) or
                 getattr(args, "rsp_prob_enc", 0.0) or 0.0)


def make_step(model, opt, args):
    """The run's training step under the conf's compute dtype: random state
    passing's at ``rsp_rate(args)`` > 0, else ``make_train_step``'s."""
    dtype = configs.compute_dtype(args)
    if rsp_rate(args) > 0:
        return make_rsp_train_step(model, opt, rsp_rate(args),
                                   compute_dtype=dtype)
    return make_train_step(model, opt, compute_dtype=dtype)


def mbr_nbest(session, batch, idx2token, n: int) -> tuple:
    """The JAX CLI's MBR n-best of a batch: per utterance, its beam's
    n-best (``session``'s, on the model as it is) padded to ``n`` with its
    last entry (``[eos]`` when empty), the word errors of each against the
    transcript, the hypotheses (``[eos]`` for an empty one) padded to at
    least 8 labels, then PAD across the batch. Returns numpy (nbest_ys
    [B, n, U] int32, nbest_ylens [B, n] int32, risks [B, n] float32)."""
    ys, lens, risks = [], [], []
    for b in range(len(batch["utt_ids"])):
        eo = session.encode(batch["xs"][b:b + 1], batch["xlens"][b:b + 1])
        _, nbest = session._beam_one(eo["ys"]["xs"], eo["ys"]["xlens"])
        nbest = (nbest + [nbest[-1] if nbest else [EOS]] * n)[:n]
        ref = batch["text"][b].split()
        risks.append([float(sum(compute_wer(ref, idx2token(h).split())[1:]))
                      for h in nbest])
        y, yl = np_pad_lists([h or [EOS] for h in nbest], min_len=8)
        ys.append(y)
        lens.append(yl)
    umax = max(y.shape[1] for y in ys)
    ys = np.stack([np.pad(y, ((0, 0), (0, umax - y.shape[1])),
                          constant_values=PAD) for y in ys])
    return ys, np.stack(lens), np.asarray(risks, np.float32)


def mbr_epoch(model, step_fn, train_set, args, reporter, epoch,
              save) -> None:
    """One MBR epoch (the module docstring): ``save(sub_step)`` writes the
    checkpoint within the epoch."""
    n = getattr(args, "mbr_nbest", 4)
    ce_weight = getattr(args, "mbr_ce_weight", 0.01)
    interval = getattr(args, "mbr_ckpt_interval", 0)
    session = Speech2TextSession(
        model, DecodeConfig(beam_width=max(n, 4), n_best=n))
    device = session.device
    model.eval()
    try:
        for i, batch in enumerate(train_set):
            nb_ys, nb_lens, risks = (torch.from_numpy(x).to(device)
                                     for x in mbr_nbest(
                                         session, batch,
                                         train_set.idx2token, n))
            xs, xlens, ys, ylens = _to_device(batch, device)
            metrics, _ = step_fn.update(
                lambda: model.mbr_loss(xs, xlens, nb_ys, nb_lens, risks, ys,
                                       ylens, ce_weight), 1.0)
            # the JAX CLI reports the MBR step's loss alone
            reporter.add_observation({"loss": metrics["loss"]})
            reporter.step_forward()
            logger.info("step %d (ep %d): MBR loss %.3f", reporter.step,
                        epoch, float(metrics["loss"]))
            if interval and (i + 1) % interval == 0:
                save(i + 1)
    finally:
        model.train()


@torch.no_grad()
def dev_loss(model, dev_set, reporter, device) -> float:
    """The mean over the dev batches of the float32 loss in eval mode."""
    model.eval()
    total, n = 0.0, 0
    for batch in dev_set:
        loss, obs = model(*_to_device(batch, device),
                          **_sub_labels(batch, device))
        reporter.add_observation(obs, is_eval=True)
        total += float(loss)
        n += 1
    model.train()
    return total / max(n, 1)


def main(argv=None, device=None) -> str:
    """Train; returns the save directory. The model goes on ``device``: the
    CUDA card when it is None."""
    args = parse_args_train(argv if argv is not None else sys.argv[1:])
    logging.basicConfig(level=logging.INFO)
    for name in _NOT_PORTED:
        if getattr(args, name, None):
            raise NotImplementedError(f"{name} is not ported yet, see ROADMAP")
    tasks = mtl_tasks(args)
    mbr_start = getattr(args, "mbr_start_epoch", 1) \
        if getattr(args, "mbr_training", False) else 0
    if int(getattr(args, "n_model", 1)) > 1:
        raise NotImplementedError(
            "tensor parallelism (--n_model) is not ported yet, see ROADMAP")
    device = model_device(device, "bin.asr.train")
    # float32 computes in float32: cuDNN's convolutions and LSTMs would take
    # TF32 by PyTorch's default (its cuBLAS matmuls do not)
    torch.backends.cudnn.allow_tf32 = False
    np.random.seed(args.seed)
    save_dir = args.model_save_dir
    os.makedirs(save_dir, exist_ok=True)

    loader_kw = dict(
        dict_path=args.dict, unit=args.unit,
        wp_model=getattr(args, "wp_model", None),
        batch_size=args.batch_size, batch_size_type=args.batch_size_type,
        dynamic_batching=args.dynamic_batching,
        min_n_frames=args.min_n_frames, max_n_frames=args.max_n_frames,
        subsample_factor=compute_subsampling_factor(args), seed=args.seed,
        n_stacks=getattr(args, "n_stacks", 1),
        n_skips=getattr(args, "n_skips", 1),
        n_splices=getattr(args, "n_splices", 1),
        pad_xlen_multiple=getattr(args, "pad_xlen_multiple", 128),
        pad_ylen_multiple=getattr(args, "pad_ylen_multiple", 32),
        dict_path_sub1=getattr(args, "dict_sub1", None) or None,
        unit_sub1=getattr(args, "unit_sub1", "char"),
        wp_model_sub1=getattr(args, "wp_model_sub1", None),
        dict_path_sub2=getattr(args, "dict_sub2", None) or None,
        unit_sub2=getattr(args, "unit_sub2", "char"),
        wp_model_sub2=getattr(args, "wp_model_sub2", None),
        # the trigger points (the dev set reads the same directories)
        word_alignment_dir=getattr(args, "train_word_alignment", None)
        or None,
        ctc_alignment_dir=getattr(args, "train_ctc_alignment", None) or None)
    bucketing = "shuffle" if getattr(args, "shuffle_bucket", False) \
        else args.bucketing
    train_set = build_dataloader(args.train_set, bucketing=bucketing,
                                 sort_stop_epoch=args.sort_stop_epoch,
                                 **loader_kw)
    dev_set = build_dataloader(args.dev_set, bucketing="sort", is_test=True,
                               **loader_kw)
    args.vocab = train_set.vocab
    for sub in ("sub1", "sub2"):
        if getattr(train_set, f"vocab_{sub}"):
            setattr(args, f"vocab_{sub}", getattr(train_set, f"vocab_{sub}"))
    if "xdim" in train_set.dataset.df:
        args.input_dim = int(train_set.dataset.df["xdim"][0])

    model = init_params(build_speech2text(args, device=device), args.seed)
    model.train()
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    logger.info("#params: %d", sum(p.numel() for p in model.parameters()))

    controller = EpochController(
        base_lr=args.lr, decay_type=args.lr_decay_type,
        decay_rate=args.lr_decay_rate,
        decay_patient_n_epochs=args.lr_decay_patient_n_epochs,
        decay_start_epoch=args.lr_decay_start_epoch,
        early_stop_patient_n_epochs=args.early_stop_patient_n_epochs)
    opt = build_optimizer(args.optimizer, lr=args.lr,
                          weight_decay=args.weight_decay,
                          clip_grad_norm=args.clip_grad_norm,
                          schedule=make_schedule(args),
                          accum_grad_n_steps=args.accum_grad_n_steps)
    rsp_prob = rsp_rate(args)
    assert rsp_prob <= 0 or isinstance(model.encoder, RNNEncoder), \
        "rsp_prob requires an RNN encoder"
    step_fn = make_step(model, opt, args)
    rsp_carry = None
    if mbr_start and not isinstance(model.dec_fwd, RNNDecoder):
        raise ValueError("mbr_training takes the LAS decoder's n-best (the "
                         "JAX CLI's _beam_one_las)")

    start_epoch = 1
    if args.resume:
        ck = load_checkpoint(args.resume)
        model.load_state_dict(ck["model"], strict=True)
        if "optimizer" in ck:
            opt.load_state_dict(ck["optimizer"], names)
        if "controller" in ck:
            controller.load_state_dict(ck["controller"])
        start_epoch = controller.epoch + 1
        logger.info("resumed from %s (epoch %d)", args.resume, start_epoch)

    save_config(vars(args), os.path.join(save_dir, "conf.yml"))
    for aux in ("dict", "wp_model"):
        p = getattr(args, aux, None)
        if p and os.path.exists(p):
            shutil.copy(p, save_dir)
    reporter = Reporter(save_dir)
    # the step's randomness (dropout key words, SpecAugment draws) is drawn
    # on the host, as the train step takes it
    gen = torch.Generator().manual_seed(args.seed)
    # the controller's decay reaches the step as a multiplier of the lr
    # the optimizer was built with
    lr_ref = args.lr
    ss_start = getattr(args, "ss_start_epoch", 0)
    sgd_epoch = getattr(args, "convert_to_sgd_epoch", 0)
    weights = {k: getattr(model, k) for k in WEIGHTS}
    # each LAS decoder's sampling rate as built (a sub-task decoder's with
    # its dec_config_sub* overrides)
    sampled = [(d, d.step.ss_prob) for d in (
        model.dec_fwd, model.dec_fwd_sub1, model.dec_fwd_sub2)
        if isinstance(d, RNNDecoder) and d.attn_type != "mocha"]

    for epoch in range(start_epoch, args.n_epochs + 1):
        lr_scale = controller.lr / lr_ref if lr_ref else 1.0
        if isinstance(model.dec_fwd, TransformerDecoder):
            set_mocha_curriculum(model.dec_fwd, args, epoch)
        elif isinstance(model.dec_fwd, RNNDecoder) and \
                model.dec_fwd.attn_type == "mocha":
            set_mocha_curriculum(model.dec_fwd, args, epoch)
        for dec, ss_prob in sampled:
            # the JAX CLI's curriculum: no sampling before ss_start_epoch
            dec.step.ss_prob = 0.0 if ss_start and epoch < ss_start \
                else ss_prob
        train_set.set_epoch(epoch)
        t0 = time.time()
        use_mbr = mbr_start and epoch >= mbr_start
        if use_mbr:
            mbr_epoch(model, step_fn, train_set, args, reporter, epoch,
                      lambda sub: save_checkpoint(
                          save_dir, epoch, model.state_dict(),
                          opt.state_dict(names), controller.state_dict(),
                          sub_step=sub))
        for i, batch in enumerate(train_set if not use_mbr else ()):
            if tasks:
                # one task per batch, round-robin (JAX's mtl_per_batch)
                model.set_weights(**tasks[i % len(tasks)])
                logger.info("step %d: task %d", reporter.step + 1,
                            i % len(tasks))
            if rsp_prob > 0:
                if rsp_carry is not None and \
                        batch["xs"].shape[0] != _rows(rsp_carry):
                    rsp_carry = None
                metrics, rsp_carry = step_fn(
                    rsp_carry, *_to_device(batch, device),
                    lr_scale=lr_scale, gen=gen)
            else:
                metrics = step_fn(*_to_device(batch, device),
                                  lr_scale=lr_scale, gen=gen,
                                  **_sub_labels(batch, device, _STEP_LABELS))
            metrics.pop("emitted")
            reporter.add_observation(metrics)
            reporter.step_forward()
            if reporter.step % args.print_step == 0:
                logger.info(
                    "step %d (ep %d): loss %.3f (%.1f utt/s)",
                    reporter.step, epoch, float(metrics["loss"]),
                    (i + 1) * len(batch["utt_ids"]) / (time.time() - t0))

        model.set_weights(**weights)
        # the dev loss; inf (never the best) before eval_start_epoch
        loss = dev_loss(model, dev_set, reporter, device) \
            if epoch >= getattr(args, "eval_start_epoch", 1) else float("inf")
        if sgd_epoch and epoch == sgd_epoch:
            kw = controller.convert_to_sgd(getattr(args, "sgd_lr", 1e-4))
            opt = build_optimizer(kw["optimizer"], lr=kw["lr"],
                                  clip_grad_norm=args.clip_grad_norm)
            step_fn = make_step(model, opt, args)
            lr_ref = kw["lr"]
            logger.info("converted to SGD (lr %.2g) at epoch %d", kw["lr"],
                        epoch)
        actions = controller.step_epoch(loss)
        reporter.epoch_summary(epoch, {"dev_loss_mean": loss,
                                       "lr": actions["lr"]})
        logger.info("epoch %d: dev loss %.3f (%.1fs)%s", epoch, loss,
                    time.time() - t0, " *best*" if actions["is_best"] else "")
        save_checkpoint(save_dir, epoch, model.state_dict(),
                        opt.state_dict(names), controller.state_dict(),
                        keep_epochs=controller.topk_epochs(
                            args.n_keep_best_checkpoints))
        reporter.snapshot()
        if actions["early_stop"]:
            logger.info("early stop at epoch %d", epoch)
            break
    return save_dir


def _rows(carry) -> int:
    """The batch rows of an encoder carry (nested tuples of [B, H])."""
    while not torch.is_tensor(carry):
        carry = carry[0]
    return carry.shape[0]


if __name__ == "__main__":
    main()
