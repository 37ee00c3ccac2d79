"""Port parity: MoChA at bf16 compute over float32 master weights (the JAX
step's ``compute_dtype=jnp.bfloat16``), on the CPU, by
``tests/test_torch_bf16.py``'s rule: each quantity X (a loss, a gradient
leaf, an Adam moment, an updated parameter) is held, per leaf in the L2
norm, to

    |X_port,bf16 - X_jax,bf16| <= 2 |X_jax,bf16 - X_jax,f32|
                                  + 1e-3 |X_jax,f32|

with that file's two stated exceptions (the attention key biases' scale,
the updated parameters on the elements whose direction is decided), and
JAX's float64 value in place of its float32 one as the reference (one
JAX compile less per test; C29 makes float32 itself a rounded value
here).

The port departs from JAX on purpose here (ROADMAP C39): JAX computes
MoChA in the input's dtype, so at bf16 its expected alignment (the
clipped cumulative product over T frames, the moving sums, beta) carries
an 8-bit mantissa; the port computes the energies in bf16 and the
alignment recurrence, the quantity and ``ctc_sync`` losses in float32,
cast at the module's boundary. ``test_c39_bf16_alignment_is_closer_to_
float64_than_jax`` shows the reason: over 20 chained steps at T 200,
JAX's bf16 beta lies farther from JAX's float64 beta than the port's bf16
beta does.

The rule holds where both sides' bf16 errors are of one size. For the
whole uni-Conformer-MoChA microstep it holds for the loss, its parts and
most gradient leaves; a leaf outside it (the conv front end's: the port's
bf16 convolutions on the CPU round more than XLA's; the chunk energy's:
per-op rounding in the decoder's loop, where XLA's CPU fusions keep
float32 between ops) is held instead by C29's gate, as the card holds
11d's whole microstep: no farther from JAX's float64 value than
``GRAD_MULT`` times JAX's own bf16 value is.

* A small uni-Conformer-MoChA (the LibriSpeech recipe's shape cut, as
  ``test_torch_uni_conformer.py``'s; K1 / K1b's causal bf16 entries'
  plain versions): the loss and every gradient leaf in ``train()`` with
  dropout and noise off (MoChA in parallel mode, the quantity loss on),
  and one accumulated clipped Adam update.
* The LSTM-MoChA decoder (the LibriSpeech LSTM-MoChA's decoder cut, fed
  encoder outputs directly: the RNN encoder does not compute in bf16,
  ROADMAP A5) with the ``ctc_sync`` latency loss on given trigger points:
  the loss, its parts and every gradient (the encoder outputs' included).
* The dtypes: the energies' projections take bf16 inputs; alpha, beta and
  the latency losses are float32; the loss is finite. MMA at bf16 gives a
  finite loss (its parity: ``tests/test_torch_mma_bf16.py``).
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch.func import functional_call

from neural_sp_tpu.models.decoders.build import (
    build_decoder as jax_build_decoder)
from neural_sp_tpu.models.modules import mocha as jmocha
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu.parallel.mesh import cast_floating
from neural_sp_tpu.parallel.mesh import make_train_step as jax_make_step
from neural_sp_tpu.trainers.optimizer import (
    build_optimizer as jax_build_optimizer)
from neural_sp_tpu_torch.configs import librispeech_lstm_mocha_args
from neural_sp_tpu_torch.models.decoders.build import build_decoder
from neural_sp_tpu_torch.models.modules import mocha
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.parallel.mesh import compute_loss, make_train_step
from neural_sp_tpu_torch.trainers.optimizer import build_optimizer
from neural_sp_tpu_torch.utils.convert_params import convert_params
from neural_sp_tpu_torch.utils.init_params import init_params

from test_torch_bf16 import (
    ZERO_GRAD_LEAF, _converted, _np, _per_element_allowance, assert_leaves,
    assert_rule)
from test_torch_train_step import _moments
from test_torch_uni_conformer import small_uni_conformer, uni_batch

BF16 = jnp.bfloat16
# C29's gate for a whole MoChA microstep at bf16: a leaf outside the rule
# may lie at most this many times farther from JAX's float64 value than
# JAX's own bf16 value does. Measured here: gradients at most 6.0 (the
# chunk energy's query weights; the conv front end's 3.8), the first
# moment of the monotonic offset r 13.8 (its gradient sums every frame's
# energy gradient, which cancel to 2e-4 of their size there)
GRAD_MULT = 20.0


def _x64(tree):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), tree)


def assert_leaves_c29(got, want_bf16, want_f64, what):
    """Every leaf by the rule (JAX's float64 value in place of its
    float32 one), or else by C29's gate; returns the leaves the rule alone
    did not hold."""
    loose = []
    assert set(got) == set(want_bf16) == set(want_f64)
    for name in got:
        scale = None
        if name.endswith(ZERO_GRAD_LEAF):
            scale = np.linalg.norm(want_f64[name[:-len("bias")] + "weight"])
        try:
            assert_rule(got[name], want_bf16[name], want_f64[name],
                        f"{what} {name}", scale)
        except AssertionError:
            g, wb, w64 = (np.asarray(x, np.float64) for x in (
                got[name], want_bf16[name], want_f64[name]))
            err, ref = np.linalg.norm(g - w64), np.linalg.norm(wb - w64)
            assert err <= GRAD_MULT * ref, (
                f"{what} {name}: |port - jax f64| {err:.3e} > {GRAD_MULT} x "
                f"|jax bf16 - jax f64| {ref:.3e}")
            loose.append(name)
    return loose


@functools.cache
def _uni_conformer():
    args = small_uni_conformer()
    jm = jax_build(args)
    rng = np.random.RandomState(3)
    params = jax.tree.map(lambda x: x + 0.05 * rng.randn(*x.shape).astype(
        np.float32), _np(jax.jit(jm.init)(
            jax.random.PRNGKey(0), *map(jnp.asarray, uni_batch()))[
                "params"]))
    return args, jm, params


def _uni_loss_and_grads(dt, b):
    """JAX's loss, its parts and gradients at ``dt`` (bf16: params and
    features cast as ``make_train_step`` casts them; float64 under
    ``jax.enable_x64``) in train mode, dropout and noise off."""
    args, jm, params = _uni_conformer()
    jargs = tuple(map(jnp.asarray, b))

    def loss(p):
        x = jargs[0]
        if dt is not None:
            p, x = cast_floating(p, dt), x.astype(dt)
        out, obs = jm.apply({"params": p}, x, *jargs[1:],
                            deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(1),
                                  "specaug": jax.random.PRNGKey(2)})
        return out.astype(jnp.float64 if dt == jnp.float64 else
                          jnp.float32), obs
    (val, obs), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        _x64(params) if dt == jnp.float64 else params)
    return float(val), {k: float(v) for k, v in obs.items()}, \
        {k: v.numpy() for k, v in convert_params(jax.tree.map(
            lambda x: np.asarray(x, np.float64), grads)).items()}


def test_uni_conformer_mocha_bf16_loss_and_grads_match_jax():
    """The loss and its parts by the rule; every gradient leaf by the rule
    or, the whole microstep rounding as C29 says, by its gate against
    JAX's float64 gradients. Most leaves hold the rule; the conv front
    end's and the chunk energy's are the ones that need the gate here
    (the port's CPU bf16 convolutions and per-op rounding in the
    decoder's loop, where XLA's CPU fusions round less often)."""
    args, _, params = _uni_conformer()
    b = uni_batch(1)
    loss_b, obs_b, g_b = _uni_loss_and_grads(BF16, b)
    with jax.enable_x64(True):
        loss_64, obs_64, g_64 = _uni_loss_and_grads(jnp.float64, b)
    assert np.isfinite(loss_b)
    tm = build_speech2text(args, device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    loss, obs = compute_loss(tm.train(), torch.bfloat16,
                             *map(torch.from_numpy, b),
                             gen=torch.Generator().manual_seed(0))
    loss.backward()
    assert loss.dtype == torch.float32
    assert obs["loss_quantity"].dtype == torch.float32
    assert_rule(float(loss.detach()), loss_b, loss_64, "loss")
    for k in ("loss_ctc", "loss_att", "loss_quantity"):
        assert_rule(float(obs[k].detach()), obs_b[k], obs_64[k], k)
    loose = assert_leaves_c29(
        {n: p.grad.numpy() for n, p in tm.named_parameters()}, g_b, g_64,
        "gradient")
    assert len(loose) <= 0.5 * len(g_b), loose


def test_uni_conformer_mocha_bf16_update_matches_jax():
    """Two microbatches, Adam with k = 2 accumulation and clip 0.5
    (active), at bf16 compute against JAX ``make_train_step(...,
    compute_dtype=jnp.bfloat16)`` and JAX's float64 step: each
    microstep's loss and grad_norm by the rule, the Adam moments by the
    rule or C29's gate, the updated parameters where their direction is
    decided by the rule (``test_torch_bf16.py``'s)."""
    clip, k, lr = 0.5, 2, 1e-3
    args, jm, params0 = _uni_conformer()
    batches = [uni_batch(10), uni_batch(11)]

    def jrun(dt):
        tx = jax_build_optimizer("adam", lr=lr, clip_grad_norm=clip,
                                 accum_grad_n_steps=k)
        jstep = jax_make_step(jm, tx, donate=False,
                              compute_dtype=None if dt == jnp.float64 else dt)
        p0 = _x64(params0) if dt == jnp.float64 else params0
        params, state, mets = p0, tx.init(p0), []
        for i, b in enumerate(batches):
            x = jnp.asarray(b[0], jnp.float64 if dt == jnp.float64 else
                            jnp.float32)
            params, state, met = jstep(params, state, jax.random.PRNGKey(i),
                                       x, *map(jnp.asarray, b[1:]))
            mets.append({n: float(met[n]) for n in ("loss", "grad_norm")})
        mom = _moments(state)
        conv = lambda t: {n: v.numpy() for n, v in convert_params(  # noqa
            jax.tree.map(lambda x: np.asarray(x, np.float64), t)).items()}
        return mets, conv(params), conv(mom.mu), conv(mom.nu)

    met_b, new_b, mu_b, nu_b = jrun(BF16)
    with jax.enable_x64(True):
        met_64, new_64, mu_64, nu_64 = jrun(jnp.float64)
    model = build_speech2text(args, device="cpu")
    model.load_state_dict(convert_params(params0), strict=True)
    step = make_train_step(model.train(), build_optimizer(
        "adam", lr=lr, clip_grad_norm=clip, accum_grad_n_steps=k),
        compute_dtype=torch.bfloat16)
    for i, b in enumerate(batches):
        met = step(*map(torch.from_numpy, b),
                   gen=torch.Generator().manual_seed(i))
        assert met["emitted"] == (i == k - 1)
        for n in ("loss", "grad_norm"):
            assert_rule(float(met[n]), met_b[i][n], met_64[i][n],
                        f"microstep {i} {n}")
    assert float(met["grad_norm"]) > clip
    names = [n for n, _ in model.named_parameters()]
    mu = {n: m.numpy() for n, m in zip(names, step.opt.mu)}
    nu = {n: m.numpy() for n, m in zip(names, step.opt.nu)}
    assert_leaves_c29(mu, mu_b, mu_64, "mu")
    sq = lambda d: {n: np.sqrt(x) for n, x in d.items()}  # noqa: E731
    assert_leaves_c29(sq(nu), sq(nu_b), sq(nu_64), "sqrt(nu)")
    state = model.state_dict()
    start = convert_params(params0)
    n_sure = n_all = 0
    for n in names:
        got = state[n].numpy()
        sure = np.abs(mu_64[n]) > 4 * _per_element_allowance(mu_b[n],
                                                              mu_64[n])
        assert_rule(got[sure], new_b[n][sure], new_64[n][sure],
                    f"updated {n}")
        assert (np.abs(got - start[n].numpy()) <= lr * (1 + 1e-5) +
                np.spacing(np.abs(start[n].numpy()))).all(), n
        n_sure += int(sure.sum())
        n_all += sure.size
    # measured 0.45 of the elements decided (0.5 at test_torch_bf16.py's
    # conformer-LAS): MoChA's decoder leaves many small gradients
    assert n_sure > 0.4 * n_all


def small_lstm_mocha(**over):
    """The LibriSpeech LSTM-MoChA's decoder with its widths cut: LSTM 32,
    attention 16, vocab 50, over 24-wide encoder outputs; chunk 4, the
    quantity loss and the ``ctc_sync`` latency loss on; dropout and noise
    off."""
    args = vars(librispeech_lstm_mocha_args())
    args.update(dec_n_units=32, emb_dim=16, dec_bottleneck_dim=32,
                attn_dim=16, vocab=50, dropout_dec=0.0, dropout_emb=0.0,
                mocha_std=0.0, mocha_init_r=-1.0,
                mocha_latency_metric="ctc_sync",
                mocha_latency_loss_weight=0.5)
    args.update(over)
    return SimpleNamespace(**args)


def test_lstm_mocha_decoder_bf16_matches_jax():
    """The decoder alone, in ``train()`` (parallel mode), its parameters
    and the encoder outputs cast to bf16 (as JAX's step casts them): the
    loss (the cross entropy, the quantity and latency losses) and the
    gradients of every parameter and of the encoder outputs."""
    args = small_lstm_mocha()
    enc_dim, bs, t = 24, 3, 60
    rng = np.random.RandomState(0)
    eouts = (0.8 * rng.randn(bs, t, enc_dim)).astype(np.float32)
    elens = np.array([60, 47, 31], np.int32)
    ylens = np.array([6, 4, 3], np.int32)
    ys = np.full((bs, 6), 3, np.int32)
    trig = np.full((bs, 6), -1, np.int32)
    for b, u in enumerate(ylens):
        ys[b, :u] = rng.randint(4, 50, u)
        trig[b, :u] = np.sort(rng.choice(elens[b], u, replace=False))
    jd = jax_build_decoder(args, args.vocab, enc_dim)
    jargs = tuple(map(jnp.asarray, (eouts, elens, ys, ylens)))
    params = _np(jax.jit(jd.init)(jax.random.PRNGKey(0), *jargs)["params"])
    rng = np.random.RandomState(1)
    params = jax.tree.map(lambda x: x + 0.1 * rng.randn(*x.shape).astype(
        np.float32), params)

    def jrun(dt):
        def loss(p, x):
            if dt is not None:
                p, x = cast_floating(p, dt), x.astype(dt)
            out, obs = jd.apply({"params": p}, x, *jargs[1:],
                                deterministic=False,
                                trigger_points=jnp.asarray(trig),
                                rngs={"dropout": jax.random.PRNGKey(1)})
            return out.astype(jnp.float32), obs
        (val, obs), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, jargs[0])
        return float(val), {k: float(v) for k, v in obs.items()}, \
            _converted(gp), np.asarray(gx, np.float32)

    (loss_b, obs_b, g_b, gx_b), (loss_f, obs_f, g_f, gx_f) = \
        jrun(BF16), jrun(None)
    td = build_decoder(args, args.vocab, enc_dim)
    td.load_state_dict(convert_params(params), strict=True)
    td.train()
    x = torch.from_numpy(eouts).requires_grad_()
    p16 = {n: p.to(torch.bfloat16) for n, p in td.named_parameters()}
    loss, obs = functional_call(td, p16, (
        x.to(torch.bfloat16), torch.from_numpy(elens),
        torch.from_numpy(ys), torch.from_numpy(ylens),
        torch.Generator().manual_seed(0), torch.from_numpy(trig)))
    loss = loss.float()
    loss.backward()
    assert obs["loss_quantity"].dtype == obs["loss_latency"].dtype == \
        torch.float32
    assert_rule(float(loss.detach()), loss_b, loss_f, "loss")
    for k in ("loss_att", "loss_quantity", "loss_latency"):
        assert_rule(float(obs[k].detach()), obs_b[k], obs_f[k], k)
    assert_leaves({n: p.grad.numpy() for n, p in td.named_parameters()},
                  g_b, g_f, "gradient")
    assert_rule(x.grad.numpy(), gx_b, gx_f, "encoder outputs' gradient")


def test_c39_bf16_alignment_is_closer_to_float64_than_jax():
    """ROADMAP C39, a departure: MoChA's alignment over 20 chained
    parallel-mode steps at T 200 (ragged, chunk 4, keys and queries 64
    wide, attention 32; init_r -4), in bf16 inputs and weights. JAX's
    module computes alpha and beta in bf16, the port in float32 after its
    bf16 energies: against the JAX module in float64, the port's beta (and
    alpha) lie closer than JAX's own bf16 ones."""
    b, t, kdim, adim, steps = 3, 200, 64, 32, 20
    rng = np.random.RandomState(0)
    key = (0.5 * np.tanh(rng.randn(b, t, kdim))).astype(np.float32)
    qs = (0.5 * np.tanh(rng.randn(steps, b, kdim))).astype(np.float32)
    mask = np.arange(t)[None] < np.array([200, 150, 90])[:, None]
    a0 = np.zeros((b, 1, t), np.float32)
    a0[..., 0] = 1.0
    kw = dict(kdim=kdim, qdim=kdim, adim=adim, chunk_size=4, init_r=-4.0)
    jm = jmocha.MoChA(**kw)
    params = _np(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, kdim)), jnp.zeros((1, kdim)),
        jnp.zeros((1, 1, 8)),
        method=lambda m, k, q, a: m(m.precompute(k), q, a))["params"])

    def jax_run(dt):
        p = jax.tree.map(lambda x: jnp.asarray(x, dt), params)
        kc = jm.apply({"params": p}, jnp.asarray(key, dt),
                      method=jmocha.MoChA.precompute)
        step = jax.jit(lambda kc, q, a: jm.apply(
            {"params": p}, kc, q, a, mode="parallel", mask=jnp.asarray(mask)))
        a, outs = jnp.asarray(a0, dt), []
        for i in range(steps):
            _, a, be = step(kc, jnp.asarray(qs[i], dt), a)
            outs.append([np.asarray(x, np.float64) for x in (a, be)])
        return outs

    with jax.enable_x64(True):
        want = jax_run(jnp.float64)
    jax_bf16 = jax_run(BF16)
    tm = mocha.MoChA(**kw)
    tm.load_state_dict(convert_params(params), strict=True)
    tm.to(torch.bfloat16)
    with torch.no_grad():
        kc = tm.precompute(torch.from_numpy(key).to(torch.bfloat16))
        a, got = torch.from_numpy(a0), []
        for i in range(steps):
            _, a, be = tm(kc, torch.from_numpy(qs[i]).to(torch.bfloat16), a,
                          "parallel", torch.from_numpy(mask))
            assert a.dtype == be.dtype == torch.float32
            got.append([x.double().numpy() for x in (a, be)])

    def err(outs, j):
        return float(np.sqrt(sum(np.square(o[j] - w[j]).sum()
                                 for o, w in zip(outs, want))))

    for j, name in enumerate(("alpha", "beta")):
        port, ref = err(got, j), err(jax_bf16, j)
        assert port < ref, (name, port, ref)


def test_bf16_mocha_dtypes(monkeypatch):
    """In a bf16 train() microstep of the uni-Conformer-MoChA (dropout on):
    the energies' query projection takes bf16, each step's alpha and beta
    are float32, the loss and its parts finite."""
    args, _, params = _uni_conformer()
    tm = build_speech2text(small_uni_conformer(dropout_dec=0.2, mocha_std=1.0),
                           device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    seen = {"query": set(), "alpha": set(), "beta": set()}
    attn = tm.dec_fwd.step.attn
    attn.monotonic_energy.w_query.register_forward_hook(
        lambda m, i, o: seen["query"].add(i[0].dtype))
    orig = mocha.MoChA.forward

    def spy(self, *a, **kw):
        ctx, alpha, beta = orig(self, *a, **kw)
        seen["alpha"].add(alpha.dtype)
        seen["beta"].add(beta.dtype)
        return ctx, alpha, beta

    monkeypatch.setattr(mocha.MoChA, "forward", spy)
    loss, obs = compute_loss(tm.train(), torch.bfloat16,
                             *map(torch.from_numpy, uni_batch(2)),
                             gen=torch.Generator().manual_seed(3))
    assert seen == {"query": {torch.bfloat16}, "alpha": {torch.float32},
                    "beta": {torch.float32}}
    assert all(bool(torch.isfinite(v)) for v in obs.values()
               if torch.is_tensor(v) and v.ndim == 0)
    loss.backward()


def test_mma_at_bf16_still_raises():
    """MMA trains at bf16 now (the name is kept): a bf16 microstep of the
    small Transformer-MMA gives a finite float32 loss and quantity loss
    (the parity: ``tests/test_torch_mma_bf16.py``)."""
    from test_torch_mma import batch as mma_batch, small_mma
    tm = init_params(build_speech2text(small_mma(), device="cpu"), 0)
    loss, obs = compute_loss(tm.train(), torch.bfloat16,
                             *map(torch.from_numpy, mma_batch()),
                             gen=torch.Generator().manual_seed(0))
    assert loss.dtype == obs["loss_quantity"].dtype == torch.float32
    assert bool(torch.isfinite(loss))
