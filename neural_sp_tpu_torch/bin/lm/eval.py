"""LM evaluation CLI (counterpart of ``neural_sp_tpu/bin/lm/eval.py``): the
PPL of each ``--recog_sets`` TSV under the latest checkpoint of the LM
trained in ``--recog_model``, or with ``--recog_n_caches N`` the unigram
cache model's PPL over the first row of the set's [B, n] token matrix.

Usage:
  python -m neural_sp_tpu_torch.bin.lm.eval --recog_model exp/lm \\
      --recog_sets test.tsv [--recog_n_caches 100]

On the CUDA card; ``main(argv, device="cpu")`` evaluates on the CPU.
Returns {tsv: {"ppl", "n_tokens"}}.
"""
from __future__ import annotations

import logging
import os
import sys
from types import SimpleNamespace

from ...datasets.lm import LMDataset
from ...evaluators.ppl import eval_ppl
from ...models.lm.build import build_lm
from ...models.lm.session import LMSession
from ...trainers.checkpoint import ckpt_path, latest_epoch, load_checkpoint
from ..args import load_config, parse_cli

logger = logging.getLogger(__name__)


def main(argv=None, device=None) -> dict:
    args = parse_cli(argv if argv is not None else sys.argv[1:],
                     dict(recog_n_caches=0, recog_cache_lambda=0.2,
                          recog_cache_theta=0.3))
    logging.basicConfig(level=logging.INFO)
    lm_dir = args.recog_model if os.path.isdir(args.recog_model) else \
        os.path.dirname(args.recog_model)
    targs = SimpleNamespace(**load_config(os.path.join(lm_dir, "conf.yml")))
    lm = build_lm(targs, device=device)
    state = load_checkpoint(ckpt_path(lm_dir, latest_epoch(lm_dir)))
    lm.load_state_dict(state["model"], strict=True)
    lm.eval()

    results = {}
    sets = args.recog_sets if isinstance(args.recog_sets, list) \
        else [args.recog_sets]
    for tsv in sets:
        ds = LMDataset(tsv, dict_path=targs.dict, unit=targs.unit,
                       wp_model=getattr(targs, "wp_model", None),
                       batch_size=getattr(targs, "batch_size", 32),
                       bptt=getattr(targs, "bptt", 64))
        if args.recog_n_caches > 0:
            sess = LMSession(lm, cache_size=args.recog_n_caches,
                             cache_lambda=args.recog_cache_lambda,
                             cache_theta=args.recog_cache_theta)
            stream = [int(t) for t in ds.xs[0]] if ds.xs.size else []
            m = {"ppl": sess.ppl_with_cache(stream),
                 "n_tokens": len(stream)}
        else:
            m = eval_ppl(lm, ds)
        logger.info("%s: PPL %.2f", tsv, m["ppl"])
        results[tsv] = m
    return results


if __name__ == "__main__":
    main()
