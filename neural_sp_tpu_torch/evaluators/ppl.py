"""LM perplexity over a BPTT stream (counterpart of
``neural_sp_tpu/evaluators/ppl.py``). The cache model's PPL is
``LMSession.ppl_with_cache``, which the eval CLI calls."""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import PAD


@torch.no_grad()
def eval_ppl(lm, dataset) -> dict:
    """{ppl, n_tokens} of ``lm`` (in eval mode) over ``dataset``'s windows,
    the state carried from window to window: the exp of the windows' log
    ppl weighted by their tokens (targets that are not PAD)."""
    lm.eval()
    device = next(lm.parameters()).device
    state = None
    total_nll, total_tok = 0.0, 0
    for ys_in, ys_out in dataset:
        _, state, obs = lm(torch.from_numpy(ys_in).long().to(device),
                           torch.from_numpy(ys_out).long().to(device), state)
        n = int(np.sum(ys_out != PAD))
        total_nll += math.log(float(obs["ppl"])) * n
        total_tok += n
    return {"ppl": float(np.exp(total_nll / max(total_tok, 1))),
            "n_tokens": total_tok}
