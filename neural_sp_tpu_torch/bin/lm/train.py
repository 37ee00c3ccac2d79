"""LM training CLI (counterpart of ``neural_sp_tpu/bin/lm/train.py``): BPTT
windows over the concatenated corpus, the state carried across them.

Usage:
  python -m neural_sp_tpu_torch.bin.lm.train --config conf/lm/x.yaml \\
      --train_set train.tsv --dev_set dev.tsv --dict dict.txt \\
      --unit word --model_save_dir exp/lm [--resume exp/lm/ckpt.epoch-N]

On the CUDA card (``main(argv, device="cpu")`` trains on the CPU), in
float32; ``train_dtype: bfloat16`` raises. As the JAX CLI:

* each epoch starts from the zero state and carries the LM's state (the
  RNNLM's (c, h), the Transformer-XL's memories) from window to window,
  detached; dropout keys come from a ``torch.Generator`` seeded by
  ``--seed`` (other masks than JAX's, ROADMAP C4);
* noam's schedule is over ``transformer_d_model`` and ``warmup_n_steps``
  without ``lr_factor`` (ROADMAP C33); the optimizer is built without
  ``accum_grad_n_steps`` (every window updates), and
  ``convert_to_sgd_epoch`` is not read (C34); nor are ``dropout_layer``
  and ``param_init`` (C35);
* the epoch controller's lr reaches the updates as a multiplier, its lr
  over the conf's;
* the dev PPL is the exp of the mean over the dev windows of their log
  PPL, in eval mode with the state carried (inf before
  ``eval_start_epoch``);
* a checkpoint holds the model and the controller but no optimizer state,
  so ``--resume`` starts a fresh optimizer, noam's count from 0 (C36).

Initialisation is the port's (``utils/init_params.py``), seeded by
``--seed``. The JAX CLI's data-parallel mesh is not ported (ROADMAP).
"""
from __future__ import annotations

import logging
import math
import os
import sys
import time

import numpy as np
import torch

from ...datasets.lm import LMDataset
from ...models.lm.build import build_lm
from ...models.utils import model_device
from ...trainers.checkpoint import load_checkpoint, save_checkpoint
from ...trainers.lr_scheduler import EpochController, noam_schedule
from ...trainers.optimizer import build_optimizer
from ...trainers.reporter import Reporter
from ...utils.init_params import init_params
from ..args import parse_cli, save_config

logger = logging.getLogger(__name__)

LM_DEFAULTS = dict(
    lm_type="lstm", unit="word", batch_size=32, bptt=64, n_epochs=20,
    optimizer="adam", lr=1e-3, weight_decay=1e-6, clip_grad_norm=5.0,
    lr_decay_type="metric", lr_decay_rate=0.5, lr_decay_start_epoch=5,
    lr_decay_patient_n_epochs=0, early_stop_patient_n_epochs=-1,
    n_keep_best_checkpoints=5, print_step=200, seed=1, resume="",
    warmup_n_steps=0, backward=False, serialize=False, lsm_prob=0.0,
)


def detach(state):
    """The state tree with every tensor detached (None stays None)."""
    if state is None:
        return None
    if isinstance(state, (list, tuple)):
        return type(state)(detach(s) for s in state)
    if isinstance(state, dict):
        return {k: detach(v) for k, v in state.items()}
    return state.detach()


def make_schedule(args):
    """noam over ``transformer_d_model`` and ``warmup_n_steps`` (no
    ``lr_factor``, as the JAX LM CLI) for the noam optimizers, else
    None."""
    if args.optimizer not in ("noam", "noam_adam"):
        return None
    return noam_schedule(getattr(args, "transformer_d_model", 512),
                         args.warmup_n_steps)


def _window(x, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).long().to(device)


@torch.no_grad()
def dev_ppl(lm, dev_set, device) -> float:
    """exp of the mean over the windows of their log PPL, in eval mode,
    the state carried."""
    lm.eval()
    state, tot, n = None, 0.0, 0
    for xi, xo in dev_set:
        _, state, obs = lm(_window(xi, device), _window(xo, device), state)
        tot += math.log(float(obs["ppl"]))
        n += 1
    lm.train()
    return float(np.exp(tot / max(n, 1)))


def main(argv=None, device=None) -> str:
    """Train; returns the save directory. The LM goes on ``device``: the
    CUDA card when it is None."""
    args = parse_cli(argv if argv is not None else sys.argv[1:], LM_DEFAULTS)
    logging.basicConfig(level=logging.INFO)
    if getattr(args, "train_dtype", "float32") in ("bfloat16", "bf16"):
        raise NotImplementedError(
            "LM training in bf16 is not ported yet (float32 only), see "
            "ROADMAP")
    device = model_device(device, "bin.lm.train")
    # float32 computes in float32: cuDNN's LSTMs would take TF32 by
    # PyTorch's default
    torch.backends.cudnn.allow_tf32 = False
    save_dir = args.model_save_dir
    os.makedirs(save_dir, exist_ok=True)

    ds_kw = dict(dict_path=args.dict, unit=args.unit,
                 wp_model=getattr(args, "wp_model", None),
                 batch_size=args.batch_size, bptt=args.bptt,
                 backward=bool(args.backward),
                 serialize=bool(args.serialize))
    train_set = LMDataset(args.train_set, **ds_kw)
    dev_set = LMDataset(args.dev_set, **ds_kw)
    args.vocab = train_set.vocab

    lm = init_params(build_lm(args, device=device), args.seed)
    lm.train()
    params = [p for p in lm.parameters() if p.requires_grad]
    logger.info("#params: %.2fM", sum(p.numel() for p in params) / 1e6)
    opt = build_optimizer(args.optimizer, lr=args.lr,
                          weight_decay=args.weight_decay,
                          clip_grad_norm=args.clip_grad_norm,
                          schedule=make_schedule(args))
    opt.init(params)
    controller = EpochController(
        base_lr=args.lr, decay_type=args.lr_decay_type,
        decay_rate=args.lr_decay_rate,
        decay_patient_n_epochs=args.lr_decay_patient_n_epochs,
        decay_start_epoch=args.lr_decay_start_epoch,
        early_stop_patient_n_epochs=args.early_stop_patient_n_epochs)

    start_epoch = 1
    if args.resume:
        ck = load_checkpoint(args.resume)
        lm.load_state_dict(ck["model"], strict=True)
        if "controller" in ck:
            controller.load_state_dict(ck["controller"])
        start_epoch = controller.epoch + 1
        logger.info("resumed from %s (epoch %d)", args.resume, start_epoch)

    save_config(vars(args), os.path.join(save_dir, "conf.yml"))
    reporter = Reporter(save_dir)
    gen = torch.Generator().manual_seed(args.seed)
    for epoch in range(start_epoch, args.n_epochs + 1):
        state = None
        t0 = time.time()
        lr_scale = controller.lr / args.lr if args.lr else 1.0
        for xi, xo in train_set:
            for p in params:
                p.grad = None
            loss, state, obs = lm(_window(xi, device), _window(xo, device),
                                  state, gen)
            loss.backward()
            state = detach(state)
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            with torch.no_grad():
                for p, u in zip(params, opt.update(grads)):
                    p.add_(u * lr_scale)
            reporter.add_observation({k: v.detach() for k, v in obs.items()})
            reporter.step_forward()
            if reporter.step % args.print_step == 0:
                logger.info("step %d: loss %.3f ppl %.1f", reporter.step,
                            float(obs["loss"].detach()),
                            float(obs["ppl"].detach()))
        ppl = dev_ppl(lm, dev_set, device) \
            if epoch >= getattr(args, "eval_start_epoch", 1) else float("inf")
        actions = controller.step_epoch(ppl)
        reporter.epoch_summary(epoch, {"dev_ppl": ppl, "lr": actions["lr"]})
        logger.info("epoch %d: dev ppl %.2f (%.1fs)%s", epoch, ppl,
                    time.time() - t0, " *best*" if actions["is_best"] else "")
        save_checkpoint(save_dir, epoch, lm.state_dict(), None,
                        controller.state_dict(),
                        keep_epochs=controller.topk_epochs(
                            args.n_keep_best_checkpoints))
        if actions["early_stop"]:
            break
    return save_dir


if __name__ == "__main__":
    main()
