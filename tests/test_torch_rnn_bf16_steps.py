"""Port parity: the RNN models' train steps at bf16 compute over float32
master weights (the JAX step's ``compute_dtype=jnp.bfloat16``), on the
CPU, by ``tests/test_torch_bf16.py``'s rule and ``test_torch_rnn_bf16.py``'s
gate (``GATED``: the conv front end's leaves):

* a small BLSTM-LAS's loss, grad_norm and moments (its gradients,
  accumulated) through one clipped Adam update;
* the random-state-passing step of a small LSTM-LAS at bf16 on pinned
  draws (carry passed, passed, dropped): losses, carries and their dtype
  (bf16, as JAX's step casts the carry), the SGD updates.
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

import neural_sp_tpu_torch.parallel.mesh as port_mesh
from neural_sp_tpu.parallel.mesh import cast_floating
from neural_sp_tpu.parallel.mesh import make_rsp_train_step as jax_rsp_step
from neural_sp_tpu.parallel.mesh import make_train_step as jax_make_step
from neural_sp_tpu.trainers.optimizer import (
    build_optimizer as jax_build_optimizer)
from neural_sp_tpu_torch.parallel.mesh import (
    make_rsp_train_step, make_train_step)
from neural_sp_tpu_torch.trainers.optimizer import build_optimizer
from neural_sp_tpu_torch.utils.convert_params import convert_params

from test_torch_bf16 import _converted, _per_element_allowance, assert_rule
from test_torch_rnn_bf16 import (
    BF16, _flat, _models, _port, assert_leaves_gated, in_threads)
from test_torch_rnn_encoder import las_batch
from test_torch_rsp import _decisions, _jax_draw
from test_torch_train_step import _moments


def test_blstm_las_bf16_update_matches_jax():
    """Two microbatches, Adam with k = 2 accumulation and clip 0.5 (active)
    at bf16 against JAX ``make_train_step(..., compute_dtype=bf16)`` and
    its float32 step: each microstep's loss and grad_norm, the Adam
    moments, and the updated parameters where their direction is decided,
    by the rule (``test_torch_bf16.py``'s)."""
    clip, k, lr = 0.5, 2, 1e-3
    args, jm, params0 = _models("blstm_las")
    batches = [las_batch(10), las_batch(11)]

    def jrun(dt):
        tx = jax_build_optimizer("adam", lr=lr, clip_grad_norm=clip,
                                 accum_grad_n_steps=k)
        jstep = jax_make_step(jm, tx, donate=False, compute_dtype=dt)
        params, state, mets = params0, tx.init(params0), []
        for i, b in enumerate(batches):
            params, state, met = jstep(params, state, jax.random.PRNGKey(i),
                                       *map(jnp.asarray, b))
            mets.append({n: float(met[n]) for n in ("loss", "grad_norm")})
        mom = _moments(state)
        return (mets, _converted(params), _converted(mom.mu),
                _converted(mom.nu))

    (met_b, new_b, mu_b, nu_b), (met_f, new_f, mu_f, nu_f) = in_threads(
        lambda: jrun(BF16), lambda: jrun(None))
    model = _port("blstm_las")
    step = make_train_step(model.train(), build_optimizer(
        "adam", lr=lr, clip_grad_norm=clip, accum_grad_n_steps=k),
        compute_dtype=torch.bfloat16)
    for i, b in enumerate(batches):
        met = step(*map(torch.from_numpy, b),
                   gen=torch.Generator().manual_seed(i))
        assert met["emitted"] == (i == k - 1)
        for n in ("loss", "grad_norm"):
            assert_rule(float(met[n]), met_b[i][n], met_f[i][n],
                        f"microstep {i} {n}")
    assert float(met["grad_norm"]) > clip
    names = [n for n, _ in model.named_parameters()]
    assert_leaves_gated({n: m.numpy() for n, m in zip(names, step.opt.mu)},
                        mu_b, mu_f, "mu")
    sq = lambda d: {n: np.sqrt(x) for n, x in d.items()}  # noqa: E731
    assert_leaves_gated(
        sq({n: m.numpy() for n, m in zip(names, step.opt.nu)}),
        sq(nu_b), sq(nu_f), "sqrt(nu)")
    state = model.state_dict()
    start = convert_params(params0)
    n_sure = n_all = 0
    for n in names:
        got = state[n].numpy()
        sure = np.abs(mu_f[n]) > 4 * _per_element_allowance(mu_b[n],
                                                             mu_f[n])
        assert_rule(got[sure], new_b[n][sure], new_f[n][sure],
                    f"updated {n}")
        assert (np.abs(got - start[n].numpy()) <= lr * (1 + 1e-5) +
                np.spacing(np.abs(start[n].numpy()))).all(), n
        n_sure += int(sure.sum())
        n_all += sure.size
    assert n_sure > 0.4 * n_all


def test_rsp_step_bf16_matches_jax_on_pinned_draws(monkeypatch):
    """``make_rsp_train_step(..., compute_dtype=bf16)`` against JAX's on
    pinned draws (``test_torch_rsp.py``'s: carry passed, passed, dropped),
    three SGD steps of a small LSTM-LAS: each step's losses and grad_norm,
    the carry it returns (bf16, as JAX's) and its update lr g, by the
    rule against JAX's bf16 and float32 steps."""
    lr = 0.1
    args, jm, params0 = _models("lstm_las")
    batches = [las_batch(20 + i) for i in range(3)]
    seeds, draws = _decisions(3)
    monkeypatch.setattr(jax.random, "bernoulli", _jax_draw)
    # the JAX CLI's first carry: zeros of the encoder's carry (float32)
    _, jcarry0 = jax.eval_shape(lambda p, x, xl: jm.apply(
        {"params": p}, x, xl, method=jm.encode),
        params0, *map(jnp.asarray, batches[0][:2]))
    jcarry0 = jax.tree.map(lambda c: jnp.zeros(c.shape, c.dtype), jcarry0)

    def jrun(dt):
        tx = jax_build_optimizer("sgd", lr=lr)
        jstep = jax_rsp_step(jm, tx, 0.5, compute_dtype=dt)
        # the CLI's float32 zeros in the type the step casts them to at
        # once: the same first step, and one program for every step
        carry = jcarry0 if dt is None else cast_floating(jcarry0, dt)
        params, state, out = params0, tx.init(params0), []
        for seed, b in zip(seeds, batches):
            before = _converted(params)
            params, state, carry, met = jstep(
                params, state, jax.random.PRNGKey(seed), carry,
                *map(jnp.asarray, b))
            after = _converted(params)
            out.append((met, carry, {n: after[n] - before[n]
                                     for n in after}))
        return out

    want_b, want_f = in_threads(lambda: jrun(BF16), lambda: jrun(None))
    tm = _port("lstm_las").train()
    pinned = iter(draws)
    monkeypatch.setattr(port_mesh, "rsp_draw", lambda gen, p: next(pinned))
    step = make_rsp_train_step(tm, build_optimizer("sgd", lr=lr), 0.5,
                               compute_dtype=torch.bfloat16)
    carry = None
    for i, (seed, b) in enumerate(zip(seeds, batches)):
        before = {n: p.detach().clone() for n, p in tm.named_parameters()}
        met, carry = step(carry, *map(torch.from_numpy, b),
                          gen=torch.Generator().manual_seed(seed))
        (jmb, cb, ub), (jmf, cf, uf) = want_b[i], want_f[i]
        for n in ("loss", "loss_ctc", "loss_att", "grad_norm"):
            assert_rule(float(met[n]), float(jmb[n]), float(jmf[n]),
                        f"step {i} {n}")
        for j, (g, wb, wf) in enumerate(zip(_flat(carry), _flat(cb),
                                            _flat(cf))):
            assert g.dtype == torch.bfloat16 and str(wb.dtype) == "bfloat16"
            assert not g.requires_grad
            assert_rule(g.double(), np.asarray(wb, np.float64), wf,
                        f"step {i} carry {j}")
        got = {n: (p.detach() - before[n]).numpy()
               for n, p in tm.named_parameters()}
        assert_leaves_gated(got, ub, uf, f"step {i} update")
