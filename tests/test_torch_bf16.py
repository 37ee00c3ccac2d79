"""Port parity at bf16 compute over float32 master weights (the JAX step's
``compute_dtype=jnp.bfloat16``): the port's ``make_train_step(...,
compute_dtype=torch.bfloat16)`` against the JAX package's, on CPU, where
every kernel wrapper takes its plain version (which rounds at the kernel's
points when given bf16).

The tolerance is measured, not guessed. The two frameworks round bf16 at
other places (JAX's attention rounds its scores to bf16, the port's
kernels keep them in float32; sums run in other orders), so neither is
"the" bf16 answer. Each quantity X (the loss, a module output, a gradient
leaf, an Adam moment, an updated parameter) is held, in the L2 norm and
for each leaf separately, to

    |X_port,bf16 - X_jax,bf16| <= 2 |X_jax,bf16 - X_jax,f32|
                                  + 1e-3 |X_jax,f32|

that is: the port may differ from JAX's bf16 result by at most twice what
bf16 itself costs JAX, plus 1e-3 of the quantity for leaves that bf16
happens to leave nearly unchanged. Two exceptions, each for a stated
reason:

* the self-attention key biases (``*.w_key.bias``): the softmax's shift
  invariance makes their gradient zero in exact arithmetic (about 1e-8 in
  float32), so at bf16 both sides hold rounding noise of O(1) terms that
  cancel, independent draws of it. Their 1e-3 term takes the norm of the
  same projection's weight gradient (``w_key.weight``) instead of their
  own, as the float32 tests give them an absolute floor;
* the updated parameters: at the first Adam step an update is about
  -lr sign(G), G the clipped mean gradient, so an element whose G is
  within bf16 rounding of zero may take either sign on either side. As
  ``test_torch_train_step.py`` does at float32, the rule holds the updated
  parameters on the elements whose direction is decided: |G| above four
  times the rule's allowance for G spread over the leaf's elements (2 rms
  of JAX's bf16 change of G plus 1e-3 rms of G; both frameworks' bf16
  noise on G measured at the same rms, and its largest draws at 2.7 times
  that allowance); elsewhere only |update| <= lr is asserted.
  The second moment nu = (1 - b2) G^2 is held through its square root,
  which is linear in G as the first moment is.

Dropout and SpecAugment are off where the port is compared with JAX (the
two draw different masks, ROADMAP C4); the dtype checks run with them on.
"""
import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch.func import functional_call

from neural_sp_tpu.models.modules.relative_multihead_attention import (
    RelativeMultiheadAttention as JaxRelMHA)
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu.ops.masks import make_pad_mask as jax_pad_mask, \
    make_san_mask as jax_san_mask
from neural_sp_tpu.parallel.mesh import cast_floating
from neural_sp_tpu.parallel.mesh import make_train_step as jax_make_step
from neural_sp_tpu.trainers.lr_scheduler import noam_schedule as jax_noam
from neural_sp_tpu.trainers.optimizer import (
    build_optimizer as jax_build_optimizer)
from neural_sp_tpu_torch.configs import compute_dtype, flagship_args
from neural_sp_tpu_torch.models.decoders import las
from neural_sp_tpu_torch.models.modules import \
    relative_multihead_attention as rma
from neural_sp_tpu_torch.models.modules.relative_multihead_attention import (
    RelativeMultiheadAttention)
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.ops.dropout import keep_mask
from neural_sp_tpu_torch.ops.kernels.las_scan import LASScan
from neural_sp_tpu_torch.parallel.mesh import compute_loss, make_train_step
from neural_sp_tpu_torch.trainers.lr_scheduler import noam_schedule
from neural_sp_tpu_torch.trainers.optimizer import build_optimizer
from neural_sp_tpu_torch.utils.convert_params import convert_params

from test_torch_train import batch, small_args
from test_torch_train_step import CLIP, K, SCHED, _moments

BF16 = jnp.bfloat16
ZERO_GRAD_LEAF = "w_key.bias"
rel = importlib.import_module("neural_sp_tpu_torch.ops.kernels.rel_attention")


def _np(tree):
    """A JAX (sub)tree as float32 numpy arrays."""
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _converted(tree):
    return {k: v.numpy() for k, v in convert_params(_np(tree)).items()}


def assert_rule(got, want_bf16, want_f32, what, scale=None):
    """The file's rule for one quantity; ``scale`` replaces |want_f32| in
    the 1e-3 term (the key biases)."""
    got, wb, wf = (np.asarray(x, np.float64)
                   for x in (got, want_bf16, want_f32))
    err = np.linalg.norm(got - wb)
    lim = 2 * np.linalg.norm(wb - wf) + 1e-3 * (
        np.linalg.norm(wf) if scale is None else scale)
    assert err <= lim, (f"{what}: |port - jax bf16| {err:.3e} > {lim:.3e} "
                        f"(|jax bf16 - jax f32| {np.linalg.norm(wb - wf):.3e},"
                        f" |jax f32| {np.linalg.norm(wf):.3e})")


def assert_leaves(got, want_bf16, want_f32, what):
    """The rule for every leaf of a converted tree (the key biases with
    their weight's scale)."""
    assert set(got) == set(want_bf16) == set(want_f32)
    for name in got:
        scale = None
        if name.endswith(ZERO_GRAD_LEAF):
            scale = np.linalg.norm(want_f32[name[:-len("bias")] + "weight"])
        assert_rule(got[name], want_bf16[name], want_f32[name],
                    f"{what} {name}", scale)


# ---- K1 / K1b through the module ------------------------------------------

@pytest.mark.parametrize("t,xlens", [
    (40, [40, 37, 1]),      # clamped one-hot branch, ragged, klen 1
    (7, [7, 4, 1]),         # skew branch (T <= clamp + 1), klen 1
    (40, [40, 21, 9]),      # ragged
])
def test_relative_mha_bf16_matches_jax(t, xlens):
    """The module at bf16 (its K1 / K1b plain versions at bf16) against
    the JAX module with ``cast_floating`` params: the output, and the
    gradients of the input and every weight, all of which flow through q,
    k, v and p."""
    d, h, clamp = 64, 4, 10
    rng = np.random.RandomState(t + sum(xlens))
    xs = rng.randn(3, t, d).astype(np.float32)
    dout = rng.randn(3, t, d).astype(np.float32)
    xl = np.asarray(xlens, np.int32)
    jm = JaxRelMHA(d_model=d, n_heads=h, clamp_len=clamp, xl_like=False)
    mask = jax_san_mask(jax_pad_mask(jnp.asarray(xl), t))
    params = jm.init(jax.random.PRNGKey(t), jnp.asarray(xs), mask=mask)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.randn(*x.shape).astype(
            np.float32), jax.tree.map(np.asarray, params))

    def jrun(dt):
        def loss(p, x):
            if dt is not None:
                p, x = cast_floating(p, dt), x.astype(dt)
            out, _, _ = jm.apply(p, x, mask=mask)
            return jnp.sum(out.astype(jnp.float32) * dout), out
        (_, out), (g_p, g_x) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(xs))
        return (np.asarray(out, np.float32), np.asarray(g_x, np.float32),
                _converted(g_p["params"]))

    out_b, gx_b, gp_b = jrun(BF16)
    out_f, gx_f, gp_f = jrun(None)

    tm = RelativeMultiheadAttention(d, h, clamp_len=clamp)
    tm.load_state_dict(convert_params(params["params"]), strict=True)
    x = torch.from_numpy(xs).requires_grad_(True)
    bf16 = {n: p.to(torch.bfloat16) for n, p in tm.named_parameters()}
    out = functional_call(tm, bf16, (x.to(torch.bfloat16),
                                     torch.from_numpy(xl)))
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(dout)).sum().backward()
    assert_rule(out.detach().float().numpy(), out_b, out_f, "output")
    assert_rule(x.grad.numpy(), gx_b, gx_f, "input gradient")
    assert_leaves({n: p.grad.numpy() for n, p in tm.named_parameters()},
                  gp_b, gp_f, "gradient")


@pytest.mark.parametrize("t,r,klens", [
    (40, 11, [40, 23, 1]),  # clamped table, ragged, klen 1
    (9, 9, [9, 0, 4]),      # unclamped R = T, a row with every key masked
])
def test_rel_attention_plain_bf16_rounds_like_the_kernel(t, r, klens):
    """The plain versions at bf16: o, dq, dk, dv, dp in bf16, m and l in
    float32; the scores and softmax exactly the float32 ones on the same
    (bf16) inputs; and every output within bf16 rounding (1e-2 of its
    largest magnitude) of the float32 plain version on those inputs."""
    rng = np.random.RandomState(t)
    q, k, v, do = (torch.from_numpy(rng.randn(3, 2, t, 16).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    p = torch.from_numpy(rng.randn(3, 2, t, r).astype(np.float32)).to(
        torch.bfloat16)
    kl = torch.tensor(klens, dtype=torch.int32)
    o, m, l = rel.rel_attention_fwd(q, k, v, p, kl)
    assert (o.dtype, m.dtype, l.dtype) == (torch.bfloat16,) + \
        (torch.float32,) * 2
    f32 = [x.float() for x in (q, k, v, p)]
    o32, m32, l32 = rel.rel_attention_fwd(*f32, kl)
    assert torch.equal(m, m32) and torch.equal(l, l32)
    grads = rel.rel_attention_bwd(q, k, v, p, kl, o, m, l, do)
    grads32 = rel.rel_attention_bwd(*f32, kl, o.float(), m, l, do.float())
    assert all(g.dtype == torch.bfloat16 for g in grads)
    for name, x, y in zip(("o", "dq", "dk", "dv", "dp"), (o, *grads),
                          (o32, *grads32)):
        err = float((x.float() - y).abs().max())
        assert err <= 1e-2 * float(y.abs().max()) + 1e-6, name


# ---- the whole model ------------------------------------------------------

def test_model_loss_and_grads_bf16_match_jax():
    """Loss and every gradient leaf at bf16 compute, deterministic, against
    ``jax.grad`` of the JAX loss with ``cast_floating(params, bf16)`` and
    bf16 features (as JAX ``make_train_step`` builds its loss)."""
    args = small_args()
    xs, xlens, ys, ylens = batch()
    jargs = tuple(map(jnp.asarray, (xs, xlens, ys, ylens)))
    jm = jax_build(args)
    params = jm.init(jax.random.PRNGKey(0), *jargs)["params"]

    def jrun(dt):
        def loss(p):
            x = jargs[0]
            if dt is not None:
                p, x = cast_floating(p, dt), x.astype(dt)
            out, _ = jm.apply({"params": p}, x, *jargs[1:],
                              deterministic=True)
            return out.astype(jnp.float32)
        val, grads = jax.jit(jax.value_and_grad(loss))(params)
        return float(val), _converted(grads)

    (loss_b, g_b), (loss_f, g_f) = jrun(BF16), jrun(None)
    tm = build_speech2text(args, device="cpu")
    tm.load_state_dict(convert_params(jax.tree.map(np.asarray, params)),
                       strict=True)
    tm.eval()
    loss, _ = compute_loss(tm, torch.bfloat16,
                           *map(torch.from_numpy, (xs, xlens, ys, ylens)))
    loss.backward()
    assert loss.dtype == torch.float32
    assert_rule(float(loss.detach()), loss_b, loss_f, "loss")
    assert_leaves({n: p.grad.numpy() for n, p in tm.named_parameters()},
                  g_b, g_f, "gradient")


def test_accumulated_update_bf16_matches_jax():
    """One accumulated (k = 2), clipped noam-Adam update at bf16 compute
    against JAX ``make_train_step(..., compute_dtype=jnp.bfloat16)``: each
    microstep's loss and grad_norm, the Adam moments, and the updated
    parameters (on the elements whose direction is decided)."""
    args = small_args(dropout_enc=0.0, dropout_dec=0.0, dropout_emb=0.0,
                      n_freq_masks=0, n_time_masks=0)
    batches = [batch(10), batch(11)]
    jm = jax_build(args)
    params0 = jm.init(jax.random.PRNGKey(0),
                      *map(jnp.asarray, batches[0]))["params"]
    start = _converted(params0)

    def jrun(dt):
        tx = jax_build_optimizer("noam", clip_grad_norm=CLIP,
                                 schedule=jax_noam(**SCHED),
                                 accum_grad_n_steps=K)
        jstep = jax_make_step(jm, tx, donate=False, compute_dtype=dt)
        params, state, mets = params0, tx.init(params0), []
        for i, b in enumerate(batches):
            params, state, met = jstep(params, state, jax.random.PRNGKey(i),
                                       *map(jnp.asarray, b))
            mets.append({k: float(met[k]) for k in ("loss", "grad_norm")})
        mom = _moments(state)
        return mets, _converted(params), _converted(mom.mu), \
            _converted(mom.nu)

    (met_b, new_b, mu_b, nu_b), (met_f, new_f, mu_f, nu_f) = \
        jrun(BF16), jrun(None)

    model = build_speech2text(args, device="cpu")
    model.load_state_dict(convert_params(_np(params0)), strict=True)
    model.train()
    step = make_train_step(
        model, build_optimizer("noam", clip_grad_norm=CLIP,
                               schedule=noam_schedule(**SCHED),
                               accum_grad_n_steps=K),
        compute_dtype=torch.bfloat16)
    for i, b in enumerate(batches):
        met = step(*map(torch.from_numpy, b),
                   gen=torch.Generator().manual_seed(i))
        assert met["emitted"] == (i == K - 1)
        for name in ("loss", "grad_norm"):
            assert_rule(float(met[name]), met_b[i][name], met_f[i][name],
                        f"microstep {i} {name}")
    assert float(met["grad_norm"]) > CLIP       # the clip is active

    names = [n for n, _ in model.named_parameters()]
    mu = {n: m.numpy() for n, m in zip(names, step.opt.mu)}
    nu = {n: m.numpy() for n, m in zip(names, step.opt.nu)}
    assert_leaves(mu, mu_b, mu_f, "mu")
    assert_leaves({n: np.sqrt(x) for n, x in nu.items()},
                  {n: np.sqrt(x) for n, x in nu_b.items()},
                  {n: np.sqrt(x) for n, x in nu_f.items()}, "sqrt(nu)")

    lr = noam_schedule(**SCHED)(0)
    state = model.state_dict()
    n_sure = n_all = 0
    for name in names:
        got = state[name].numpy()
        g_f, g_b = mu_f[name], mu_b[name]
        sure = np.abs(g_f) > 4 * _per_element_allowance(g_b, g_f)
        assert_rule(got[sure], new_b[name][sure], new_f[name][sure],
                    f"updated {name}")
        assert np.abs(got - start[name]).max() <= lr * (1 + 1e-5), name
        n_sure += int(sure.sum())
        n_all += sure.size
    assert n_sure > 0.5 * n_all


def _per_element_allowance(want_bf16, want_f32):
    """The rule's allowance spread over a leaf's elements (its RMS form):
    2 rms(want_bf16 - want_f32) + 1e-3 rms(want_f32)."""
    rms = lambda x: np.sqrt(np.mean(np.square(x, dtype=np.float64)))  # noqa
    return 2 * rms(want_bf16 - want_f32) + 1e-3 * rms(want_f32)


# ---- dtype discipline -------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_step():
    """One emitted bf16 update in train() mode (dropout and SpecAugment on),
    with the inputs of every Linear, Conv and LayerNorm, of LASScan and of
    K1's wrapper recorded."""
    args = small_args()
    model = build_speech2text(args, device="cpu")
    torch.manual_seed(0)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.1)
    model.train()
    seen = {"layers": {}, "las_scan": [], "rel_attention": []}
    kinds = (torch.nn.Linear, torch.nn.Conv1d, torch.nn.Conv2d,
             torch.nn.LayerNorm)

    def hook(name):
        def record(_module, inputs):
            seen["layers"].setdefault(name, set()).add(inputs[0].dtype)
        return record

    handles = [m.register_forward_pre_hook(hook(n))
               for n, m in model.named_modules() if isinstance(m, kinds)]

    class ScanSpy(LASScan):
        @staticmethod
        def forward(ctx_, *args):
            seen["las_scan"].append({a.dtype for a in args
                                     if a.is_floating_point()})
            return LASScan.forward(ctx_, *args)

    def k1_spy(*args):
        seen["rel_attention"].append({a.dtype for a in args
                                      if a.is_floating_point()})
        return rel.rel_attention(*args)

    step = make_train_step(model, build_optimizer(
        "noam", clip_grad_norm=5.0, schedule=noam_schedule(**SCHED)),
        compute_dtype=torch.bfloat16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(las, "LASScan", ScanSpy)
        mp.setattr(rma, "rel_attention", k1_spy)
        met = step(*map(torch.from_numpy, batch()),
                   gen=torch.Generator().manual_seed(0))
    for h in handles:
        h.remove()
    assert met["emitted"]
    return model, step, met, seen


@pytest.mark.parametrize("what", ["layers", "las_scan", "rel_attention",
                                  "loss_and_grad_norm", "grads",
                                  "moments_and_masters"])
def test_bf16_step_dtypes(bf16_step, what):
    """bf16 reaches every Linear, Conv and LayerNorm, LASScan and K1's
    wrapper; the loss, grad_norm, every gradient, the Adam moments and the
    updated (master) parameters are float32."""
    model, step, met, seen = bf16_step
    bf16, f32 = torch.bfloat16, torch.float32
    if what in ("layers", "las_scan", "rel_attention"):
        assert seen[what], f"no {what} call was recorded"
        calls = seen[what].values() if what == "layers" else seen[what]
        assert all(dtypes == {bf16} for dtypes in calls), seen[what]
    elif what == "loss_and_grad_norm":
        assert all(met[k].dtype == f32 for k in ("loss", "grad_norm",
                                                 "loss_ctc", "loss_att"))
        assert all(np.isfinite(float(met[k])) for k in ("loss", "grad_norm"))
    elif what == "grads":
        assert all(p.grad.dtype == f32 for p in model.parameters())
        assert all(bool(torch.isfinite(p.grad).all())
                   for p in model.parameters())
    else:
        assert all(m.dtype == f32 for m in (*step.opt.mu, *step.opt.nu))
        assert all(p.dtype == f32 for p in model.parameters())


def test_las_scan_bf16_casts_at_its_boundary():
    """LASScan given bf16 runs the float32 scan on the upcast inputs: h,
    ctx and aw come back bf16, equal to the float32 run's rounded, and each
    gradient in its input's type, equal to the float32 run's rounded."""
    rng = np.random.RandomState(0)
    b, u, t, hd, d, a, ch, kw = 2, 3, 7, 8, 6, 5, 2, 3

    def f(*shape, scale=0.5):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to(torch.bfloat16)

    floats = [f(b, u, 4 * hd), f(d, 4 * hd), f(hd, 4 * hd), f(4 * hd),
              f(a, hd), f(ch, kw), f(a, ch), f(a), f(b, t, a), f(b, t, d)]
    klens = torch.tensor([7, 3], dtype=torch.int32)
    keep = keep_mask(torch.Generator().manual_seed(0), 0.1, (b, u, hd),
                     dtype=torch.bfloat16)
    dh, dctx = f(b, u, hd), f(b, u, d)
    runs = []
    for dtype in (torch.bfloat16, torch.float32):
        leaves = [x.detach().to(dtype).requires_grad_() for x in floats]
        h, ctx, aw = LASScan.apply(*leaves, klens, keep.to(dtype))
        torch.autograd.backward((h, ctx), (dh.to(dtype), dctx.to(dtype)))
        runs.append(((h, ctx, aw), [x.grad for x in leaves]))
    (outs, grads), (outs32, grads32) = runs
    for x, y in zip((*outs, *grads), (*outs32, *grads32)):
        assert x.dtype == torch.bfloat16
        assert torch.equal(x, y.to(torch.bfloat16))


def test_keep_mask_takes_the_activations_dtype():
    """A float32 mask would lift bf16 activations to float32 (PyTorch's
    type promotion): the mask comes in the asked type, the float32 mask
    rounded."""
    shape = (3, 5, 7)
    m32 = keep_mask(torch.Generator().manual_seed(1), 0.1, shape)
    m16 = keep_mask(torch.Generator().manual_seed(1), 0.1, shape,
                    dtype=torch.bfloat16)
    assert m32.dtype == torch.float32 and m16.dtype == torch.bfloat16
    assert torch.equal(m16, m32.to(torch.bfloat16))
    x = torch.ones(shape, dtype=torch.bfloat16)
    assert (x * m16).dtype == torch.bfloat16


# ---- the float32 path ---------------------------------------------------------

@pytest.mark.parametrize("dtype", [None, torch.float32])
def test_float32_step_is_unchanged(dtype):
    """compute_dtype None (and float32) gives, bit for bit, what the step
    gave before it had the option: the model's own forward, backward and
    the optimizer's update, over an emitted accumulation of two
    microsteps."""
    args = small_args(dropout_enc=0.0, dropout_dec=0.0, dropout_emb=0.0,
                      n_freq_masks=0, n_time_masks=0)

    def fresh():
        model = build_speech2text(args, device="cpu")
        torch.manual_seed(0)
        for p in model.parameters():
            torch.nn.init.normal_(p, std=0.1)
        return model.train(), build_optimizer(
            "noam", clip_grad_norm=CLIP, schedule=noam_schedule(**SCHED),
            accum_grad_n_steps=K)

    batches = [tuple(map(torch.from_numpy, batch(s))) for s in (10, 11)]
    model, opt = fresh()
    step = make_train_step(model, opt, compute_dtype=dtype)
    got = [step(*b) for b in batches]

    ref, ref_opt = fresh()
    params = [p for p in ref.parameters()]
    ref_opt.init(params)
    for b, met in zip(batches, got):
        for p in params:
            p.grad = None
        loss, _ = ref(*b)
        loss.backward()
        assert torch.equal(met["loss"], loss.detach())
        updates = ref_opt.update([p.grad for p in params])
        assert met["emitted"] == (updates is not None)
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u)
    for (name, p), q in zip(model.named_parameters(), params):
        assert torch.equal(p, q), name


def test_train_dtype_gives_the_compute_dtype():
    """``train_dtype`` as the JAX CLI reads it (default float32)."""
    args = flagship_args(faithful=True)
    assert compute_dtype(args) is None
    for name, want in (("bfloat16", torch.bfloat16), ("bf16", torch.bfloat16),
                       ("float32", None)):
        args.train_dtype = name
        assert compute_dtype(args) is want
    args.train_dtype = "float16"
    with pytest.raises(ValueError):
        compute_dtype(args)
