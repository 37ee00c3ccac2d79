"""Port parity: the transformer decoder's MMA (monotonic multihead
attention) at bf16 compute over float32 master weights, on the CPU, by
``tests/test_torch_bf16.py``'s rule with ``tests/test_torch_mocha_bf16.py``'s
reference and exceptions: JAX's float64 value in place of its float32 one
(C29 makes float32 itself a rounded value for a MoChA microstep), and a
leaf outside the rule held by C29's gate (no farther from JAX's float64
value than ``GRAD_MULT`` times JAX's own bf16 value).

Under a transformer encoder everything is bf16 in JAX, MMA's alignment
too. The port computes MMA's energies in bf16 and its alignment
recurrence (alpha, beta, their carry from position to position and the
energies' noise) in float32, cast at ``MoChA``'s boundary, as the LAS
decoder's MoChA (ROADMAP C39); ``test_c39_mma_alignment_is_closer_to_
float64_than_jax`` extends C39's evidence to MMA's multihead alignment.

* A small Transformer-MMA (``test_torch_mma.py``'s, two MMA layers of 2 x 2
  heads) in ``train()`` with its noise pinned: the loss, its parts and
  every gradient leaf. JAX's MMA does not train at bf16 as it stands
  (ROADMAP C49: its noise is drawn in float32, which makes the alignment
  float32 inside a scan whose carry is bf16, and flax refuses the scan):
  JAX's noise is drawn here in bf16, the energies' type, so that its bf16
  microstep runs.
* C39 for MMA: 20 chained ``MMAStep`` positions at T 200.
* The dtypes: the energies' query projection takes bf16, each position's
  alpha is float32, the context bf16, the loss finite.
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from neural_sp_tpu.models.modules import mocha as jmocha
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu.parallel.mesh import cast_floating
from neural_sp_tpu_torch.models.modules import mocha
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.parallel.mesh import compute_loss
from neural_sp_tpu_torch.utils.convert_params import convert_params

from test_torch_bf16 import _np, assert_rule
from test_torch_mma import batch, pin_noise, small_mma
from test_torch_mocha_bf16 import _x64, assert_leaves_c29
from test_torch_rnn_bf16 import in_threads, random_params

BF16 = jnp.bfloat16


def _mma():
    args = small_mma()
    jm = jax_build(args)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            *map(jnp.asarray, batch()))["params"]
    return args, jm, random_params(shapes, 3)


def test_mma_bf16_loss_and_grads_match_jax(monkeypatch):
    """The loss and its parts (the quantity loss among them) by the rule;
    every gradient leaf by the rule or C29's gate, most by the rule."""
    args, jm, params = _mma()
    b = batch(1)
    noise = np.random.RandomState(7).randn(3, 2, 20).astype(np.float32)
    pin_noise(monkeypatch, noise)
    pinned = jax.random.normal
    # C49: JAX draws MMA's noise in float32 (its default type), which makes
    # alpha float32 inside a scan whose carry is bf16, and flax refuses the
    # scan; the noise is drawn here in the energies' type (float64 under
    # enable_x64, which is per thread)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=None:
                        pinned(key, shape, jnp.float64 if
                               jax.config.jax_enable_x64 else BF16))
    jargs = tuple(map(jnp.asarray, b))

    def jrun(dt):
        if dt != BF16:
            with jax.enable_x64(True):
                return jrun_at(dt)
        return jrun_at(dt)

    def jrun_at(dt):
        def loss(p):
            x = jargs[0]
            if dt == BF16:
                p, x = cast_floating(p, dt), x.astype(dt)
            out, obs = jm.apply({"params": p}, x, *jargs[1:],
                                deterministic=False,
                                rngs={"dropout": jax.random.PRNGKey(1),
                                      "specaug": jax.random.PRNGKey(2)})
            return out.astype(jnp.float64 if dt != BF16 else jnp.float32), \
                obs
        (val, obs), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params if dt == BF16 else _x64(params))
        return float(val), {k: float(v) for k, v in obs.items()}, \
            {k: v.numpy() for k, v in convert_params(jax.tree.map(
                lambda x: np.asarray(x, np.float64), grads)).items()}

    (loss_b, obs_b, g_b), (loss_64, obs_64, g_64) = in_threads(
        lambda: jrun(BF16), lambda: jrun(jnp.float64))
    tm = build_speech2text(args, device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    loss, obs = compute_loss(tm.train(), torch.bfloat16,
                             *map(torch.from_numpy, b),
                             gen=torch.Generator().manual_seed(0))
    loss.backward()
    assert loss.dtype == obs["loss_quantity"].dtype == torch.float32
    assert_rule(float(loss.detach()), loss_b, loss_64, "loss")
    for k in ("loss_ctc", "loss_att", "loss_quantity"):
        assert_rule(float(obs[k].detach()), obs_b[k], obs_64[k], k)
    loose = assert_leaves_c29(
        {n: p.grad.numpy() for n, p in tm.named_parameters()}, g_b, g_64,
        "gradient")
    assert len(loose) <= 0.5 * len(g_b), loose


def test_c39_mma_alignment_is_closer_to_float64_than_jax():
    """ROADMAP C39 for MMA: 20 chained ``MMAStep`` positions in parallel
    mode (noise off) at T 200 (ragged; 2 monotonic x 2 chunk heads, chunk
    4, attention 16 a head, queries 64 wide), the external key caches and
    the weights in bf16. JAX computes alpha and beta in bf16, the port in
    float32 after its bf16 energies: against the JAX module in float64,
    the port's alpha and beta lie closer than JAX's own bf16 ones."""
    b, t, kdim, adim, steps, h = 3, 200, 64, 16, 20, 2
    rng = np.random.RandomState(0)
    caches = {"mono": (b, t, h * adim), "value": (b, t, h * h * adim),
              "chunk": (b, t, h * h * adim)}
    caches = {k: (0.5 * np.tanh(rng.randn(*s))).astype(np.float32)
              for k, s in caches.items()}
    qs = (0.5 * np.tanh(rng.randn(steps, b, kdim))).astype(np.float32)
    mask = np.arange(t)[None] < np.array([200, 150, 90])[:, None]
    a0 = np.zeros((b, h, t), np.float32)
    a0[..., 0] = 1.0
    kw = dict(kdim=kdim, qdim=kdim, adim=adim, chunk_size=4,
              n_heads_mono=h, n_heads_chunk=h)
    jm = jmocha.MMAStep(noise_std=0.0, **kw)
    small = {k: jnp.zeros((1, 8, v.shape[-1])) for k, v in caches.items()}
    params = _np(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, h, 8)),
                         jnp.zeros((1, kdim)), small, None,
                         deterministic=False)["params"])

    def jax_run(dt):
        p = jax.tree.map(lambda x: jnp.asarray(x, dt), params)
        kc = {k: jnp.asarray(v, dt) for k, v in caches.items()}
        step = jax.jit(lambda q, a: jm.apply(
            {"params": p}, a, q, kc, jnp.asarray(mask),
            method=lambda m, a, q, kc, mk: m.mocha(
                kc, q, a, mode="parallel", mask=mk, deterministic=False),
            rngs={"dropout": jax.random.PRNGKey(0)}))
        a, outs = jnp.asarray(a0, dt), []
        for i in range(steps):
            _, a, be = step(jnp.asarray(qs[i], dt), a)
            outs.append([np.asarray(x, np.float64) for x in (a, be)])
        return outs

    with jax.enable_x64(True):
        want = jax_run(jnp.float64)
    jax_bf16 = jax_run(BF16)
    tm = mocha.MMAStep(**kw)
    tm.load_state_dict(convert_params(params), strict=True)
    tm.to(torch.bfloat16)
    kc = {k: torch.from_numpy(v).to(torch.bfloat16)
          for k, v in caches.items()}
    with torch.no_grad():
        a, got = torch.from_numpy(a0), []
        for i in range(steps):
            ctx, a, be = tm.mocha(kc, torch.from_numpy(qs[i]).to(
                torch.bfloat16), a, "parallel", torch.from_numpy(mask))
            assert a.dtype == be.dtype == torch.float32
            assert ctx.dtype == torch.bfloat16
            got.append([x.double().numpy() for x in (a, be)])

    def err(outs, j):
        return float(np.sqrt(sum(np.square(o[j] - w[j]).sum()
                                 for o, w in zip(outs, want))))

    for j, name in enumerate(("alpha", "beta")):
        port, ref = err(got, j), err(jax_bf16, j)
        assert port < ref, (name, port, ref)


def test_bf16_mma_dtypes(monkeypatch):
    """In a bf16 ``train()`` microstep of the small Transformer-MMA
    (dropout and the energies' noise on): the monotonic energy's query
    projection takes bf16, each position's alpha is float32 and its
    context bf16; the loss and its parts are finite."""
    args, _, params = _mma()
    tm = build_speech2text(small_mma(dropout_dec=0.1), device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    seen = {"query": set(), "alpha": set(), "ctx": set()}
    for blk in tm.dec_fwd.blocks:
        if blk.mma:
            blk.src_mma.mocha.monotonic_energy.w_query.register_forward_hook(
                lambda m, i, o: seen["query"].add(i[0].dtype))
    orig = mocha.MMAStep.forward

    def spy(self, *a, **kw):
        alpha, ctx = orig(self, *a, **kw)
        seen["alpha"].add(alpha.dtype)
        seen["ctx"].add(ctx.dtype)
        return alpha, ctx

    monkeypatch.setattr(mocha.MMAStep, "forward", spy)
    loss, obs = compute_loss(tm.train(), torch.bfloat16,
                             *map(torch.from_numpy, batch(2)),
                             gen=torch.Generator().manual_seed(3))
    assert seen == {"query": {torch.bfloat16}, "alpha": {torch.float32},
                    "ctx": {torch.bfloat16}}
    assert all(bool(torch.isfinite(v)) for v in obs.values()
               if torch.is_tensor(v) and v.ndim == 0)
    loss.backward()
