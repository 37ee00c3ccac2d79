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
(weight 0 before). The JAX CLI's distillation, MBR, random state passing,
per-batch MTL, tensor parallelism and the profiler window raise
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

from ... import configs
from ...datasets.asr.build import build_dataloader
from ...models.speech2text import build_speech2text
from ...models.utils import model_device
from ...parallel.mesh import make_train_step
from ...trainers.checkpoint import load_checkpoint, save_checkpoint
from ...trainers.lr_scheduler import (
    EpochController, noam_schedule, warmup_schedule)
from ...trainers.optimizer import build_optimizer
from ...trainers.reporter import Reporter
from ...utils.init_params import init_params
from ..args import parse_args_train, save_config

logger = logging.getLogger(__name__)

# options of the JAX CLI the port does not have: each raises when set
_NOT_PORTED = ("teacher", "mbr_training", "rsp_prob", "mtl_per_batch",
               "profile_n_steps", "train_word_alignment",
               "train_ctc_alignment", "dict_sub1", "dict_sub2")

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
    ``*_start_epoch`` (when that is set), else the conf's weight."""
    def weight(flag, field):
        start = getattr(args, flag, 0)
        return 0.0 if start and epoch < start else getattr(args, field, 0.0)
    dec.quantity_loss_weight = weight("mocha_quantity_loss_start_epoch",
                                      "mocha_quantity_loss_weight")
    dec.latency_loss_weight = weight("mocha_latency_loss_start_epoch",
                                     "mocha_latency_loss_weight")
    dec.step.attn.stableemit_weight = weight("mocha_stableemit_start_epoch",
                                             "mocha_stableemit_weight")


def _to_device(batch: dict, device) -> tuple:
    return tuple(torch.from_numpy(batch[k]).to(device, non_blocking=True)
                 for k in ("xs", "xlens", "ys", "ylens"))


@torch.no_grad()
def dev_loss(model, dev_set, reporter, device) -> float:
    """The mean over the dev batches of the float32 loss in eval mode."""
    model.eval()
    total, n = 0.0, 0
    for batch in dev_set:
        loss, obs = model(*_to_device(batch, device))
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
        pad_ylen_multiple=getattr(args, "pad_ylen_multiple", 32))
    bucketing = "shuffle" if getattr(args, "shuffle_bucket", False) \
        else args.bucketing
    train_set = build_dataloader(args.train_set, bucketing=bucketing,
                                 sort_stop_epoch=args.sort_stop_epoch,
                                 **loader_kw)
    dev_set = build_dataloader(args.dev_set, bucketing="sort", is_test=True,
                               **loader_kw)
    args.vocab = train_set.vocab
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
    step_fn = make_train_step(model, opt,
                              compute_dtype=configs.compute_dtype(args))

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

    for epoch in range(start_epoch, args.n_epochs + 1):
        lr_scale = controller.lr / lr_ref if lr_ref else 1.0
        if model.dec_fwd is not None:
            # the JAX CLI's curriculum: no sampling before ss_start_epoch
            model.dec_fwd.step.ss_prob = 0.0 if ss_start and \
                epoch < ss_start else getattr(args, "ss_prob", 0.0)
            if model.dec_fwd.attn_type == "mocha":
                set_mocha_curriculum(model.dec_fwd, args, epoch)
        train_set.set_epoch(epoch)
        t0 = time.time()
        for i, batch in enumerate(train_set):
            metrics = step_fn(*_to_device(batch, device), lr_scale=lr_scale,
                              gen=gen)
            metrics.pop("emitted")
            reporter.add_observation(metrics)
            reporter.step_forward()
            if reporter.step % args.print_step == 0:
                logger.info(
                    "step %d (ep %d): loss %.3f (%.1f utt/s)",
                    reporter.step, epoch, float(metrics["loss"]),
                    (i + 1) * len(batch["utt_ids"]) / (time.time() - t0))

        # the dev loss; inf (never the best) before eval_start_epoch
        loss = dev_loss(model, dev_set, reporter, device) \
            if epoch >= getattr(args, "eval_start_epoch", 1) else float("inf")
        if sgd_epoch and epoch == sgd_epoch:
            kw = controller.convert_to_sgd(getattr(args, "sgd_lr", 1e-4))
            opt = build_optimizer(kw["optimizer"], lr=kw["lr"],
                                  clip_grad_norm=args.clip_grad_norm)
            step_fn = make_train_step(
                model, opt, compute_dtype=configs.compute_dtype(args))
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


if __name__ == "__main__":
    main()
