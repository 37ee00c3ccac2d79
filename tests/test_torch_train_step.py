"""Port parity: one accumulated, clipped optimizer update of the whole
model, ``parallel.mesh.make_train_step`` against the JAX package's.

The small flagship-shaped model of ``test_torch_train.py`` with dropout and
SpecAugment off (the JAX step always runs ``deterministic=False``; with
every rate 0 that is the deterministic model), Noam Adam with k = 2
accumulation and ``clip_grad_norm`` = 0.5, so the clip is active (the
accumulated mean's norm is ~20x that). Two microbatches go through both
steps; compared are

* each microstep's metrics (loss and its parts, and grad_norm, the norm of
  that microbatch's gradient before accumulation);
* the Adam moments after the emitted update: mu = (1 - b1) * clip(mean
  grad) and nu = (1 - b2) * clip(mean grad)^2, per leaf, relative to the
  leaf's largest value (atol 2e-4 of it; nu's 4e-4, being a square), plus
  1e-6 of the largest value over all leaves for leaves that are zero up
  to rounding;
* the parameter update itself. At the first Adam step it is about
  -lr * sign(g), so it is compared where the sign is well defined: on every
  element whose mu exceeds 1e-3 of its leaf's largest (and the moments'
  floor above), to 1e-3 of lr
  (float32 parameters round the difference new - old at ~1e-7); an
  element below that (gradients that are zero up to rounding, such as the
  attention key biases under the softmax) may take either sign, and only
  the bound |update| <= lr is asserted there.
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu.parallel.mesh import make_train_step as jax_make_step
from neural_sp_tpu.trainers.lr_scheduler import noam_schedule as jax_noam
from neural_sp_tpu.trainers.optimizer import (
    build_optimizer as jax_build_optimizer)
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.parallel.mesh import make_train_step
from neural_sp_tpu_torch.trainers.lr_scheduler import noam_schedule
from neural_sp_tpu_torch.trainers.optimizer import build_optimizer
from neural_sp_tpu_torch.utils.convert_params import convert_params

from test_torch_train import batch, small_args

RTOL = 2e-4
CLIP, K = 0.5, 2
SCHED = dict(d_model=64, warmup_n_steps=10, factor=1.0)


def _moments(opt_state):
    inner = opt_state.inner_opt_state
    return next(s for s in jax.tree.leaves(
        inner, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))


def test_accumulated_clipped_update_matches_jax():
    args = small_args(dropout_enc=0.0, dropout_dec=0.0, dropout_emb=0.0,
                      n_freq_masks=0, n_time_masks=0)
    batches = [batch(10), batch(11)]
    jm = jax_build(args)
    params = jm.init(jax.random.PRNGKey(0),
                     *map(jnp.asarray, batches[0]))["params"]
    params0 = convert_params(jax.tree.map(np.asarray, params))

    tx = jax_build_optimizer("noam", clip_grad_norm=CLIP,
                             schedule=jax_noam(**SCHED),
                             accum_grad_n_steps=K)
    jstep = jax_make_step(jm, tx, donate=False)
    opt_state = tx.init(params)
    model = build_speech2text(args, device="cpu")
    model.load_state_dict(params0, strict=True)
    model.train()
    step = make_train_step(
        model, build_optimizer("noam", clip_grad_norm=CLIP,
                               schedule=noam_schedule(**SCHED),
                               accum_grad_n_steps=K))
    for i, b in enumerate(batches):
        params, opt_state, jmet = jstep(params, opt_state,
                                        jax.random.PRNGKey(i),
                                        *map(jnp.asarray, b))
        met = step(*map(torch.from_numpy, b),
                   gen=torch.Generator().manual_seed(i))
        assert met["emitted"] == (i == K - 1)
        for name in ("loss", "loss_ctc", "loss_att", "acc_att", "ppl_att",
                     "grad_norm"):
            np.testing.assert_allclose(float(met[name]), float(jmet[name]),
                                       rtol=RTOL, err_msg=name)
    assert float(met["grad_norm"]) > CLIP     # the clip is active

    names = [n for n, _ in model.named_parameters()]
    moments = _moments(opt_state)
    lr = noam_schedule(**SCHED)(0)
    for which, ours, tol in (("mu", step.opt.mu, RTOL),
                             ("nu", step.opt.nu, 2 * RTOL)):
        want = convert_params(jax.tree.map(np.asarray,
                                           getattr(moments, which)))
        floor = 1e-6 * max(float(w.abs().max()) for w in want.values())
        for name, got in zip(names, ours):
            w = want[name].numpy()
            np.testing.assert_allclose(
                got.numpy(), w, rtol=0,
                atol=tol * float(np.abs(w).max()) + floor,
                err_msg=f"{which} {name}")

    new = convert_params(jax.tree.map(np.asarray, params))
    mu = convert_params(jax.tree.map(np.asarray, moments.mu))
    mu_floor = 1e-6 * max(float(m.abs().max()) for m in mu.values())
    state = model.state_dict()
    n_sure = n_all = 0
    for name in names:
        want_u = new[name].numpy() - params0[name].numpy()
        got_u = state[name].numpy() - params0[name].numpy()
        m = np.abs(mu[name].numpy())
        sure = (m > 1e-3 * m.max()) & (m > mu_floor)
        np.testing.assert_allclose(got_u[sure], want_u[sure], rtol=0,
                                   atol=1e-3 * lr, err_msg=name)
        assert np.abs(got_u).max() <= lr * (1 + 1e-5)
        n_sure += int(sure.sum())
        n_all += sure.size
    assert n_sure > 0.9 * n_all
