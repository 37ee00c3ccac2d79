"""Port parity: the RNN encoders and the models on them at bf16 compute
over float32 master weights (the JAX step's ``compute_dtype=jnp.bfloat16``),
on the CPU, by ``tests/test_torch_bf16.py``'s rule: each quantity X (a
loss, a module output, a carry, a gradient leaf, an Adam moment, an
updated parameter) is held, per leaf in the L2 norm, to

    |X_port,bf16 - X_jax,bf16| <= 2 |X_jax,bf16 - X_jax,f32|
                                  + 1e-3 |X_jax,f32|

with that file's stated exception for the updated parameters (held where
their direction is decided).

What JAX computes at bf16 here is mostly float32: flax's ``nn.RNN`` starts
from a float32 zero carry, so an LSTM layer runs its recurrence in float32
over the bf16-rounded weights and returns float32; every layer, head and
decoder after it then promotes its bf16 weights to float32 (flax's
``promote_dtype``). Only the conv front end, layer 0's input product and
the LAS decoder's hoisted embedding gates compute in bf16. The right-hand
side above is then the cost of rounding the weights, and the port must be
float32 where JAX is: the dtypes are asserted beside the values. One
rounding of JAX's is left out on purpose (``modules/recurrent.py``): cuDNN
forms layer 0's input product in float32 from the bf16 input and weights,
where flax rounds it to bf16 first; the rule holds with it left out.

Random state passing is the other way round: JAX's step casts the carry to
bf16, and a bf16 carry makes the whole recurrence bf16 (the carry it
returns too).

* The encoders (conv + BLSTM, conv + LSTM, the LC-BLSTM): outputs and
  carries from no carry and from a bf16 carry, with their dtypes.
* A small BLSTM-LAS (location attention), a BLSTM-triggered LAS (eval:
  its in-graph CTC triggers) and an LSTM-MoChA (train(), parallel mode,
  dropout and noise off): the loss, its parts and every gradient (a leaf
  of the conv front end or of MoChA's chunk energy by the gate stated at
  ``GATED``); the train steps (one clipped Adam update, random state
  passing) in ``test_torch_rnn_bf16_steps.py``.
* A small LC-BLSTM-RNN-T: the loss and every gradient.
* The conv front end alone at bf16, the port's and JAX's each against
  float64 over the same bf16 values: the cause of its leaves' gate.
* The LAS attention mask through ``LASScan``'s float32 boundary at bf16.
* MBR stays float32 under ``train_dtype: bfloat16``, as JAX's
  ``mbr_step`` ignores ``compute_dtype``.
"""
import functools
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import neural_sp_tpu_torch.parallel.mesh as port_mesh
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu.parallel.mesh import cast_floating
from neural_sp_tpu_torch.bin.asr import train as port_train
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.ops.kernels.las_scan import LASScan
from neural_sp_tpu_torch.parallel.mesh import compute_loss
from neural_sp_tpu_torch.trainers.optimizer import build_optimizer
from neural_sp_tpu_torch.utils.convert_params import convert_params

from test_torch_bf16 import _converted, assert_rule
from test_torch_rnn_encoder import las_batch, small_las
from test_torch_transducer import rnnt_batch, small_rnnt

BF16 = jnp.bfloat16
OFF = dict(dropout_enc=0.0, dropout_dec=0.0, dropout_emb=0.0, ss_prob=0.0)
# name -> (args, batch, train() mode)
MODELS = {
    "blstm_las": (lambda: small_las("conv_blstm", **OFF), las_batch, False),
    "lstm_las": (lambda: small_las("conv_lstm", **OFF), las_batch, False),
    "blstm_triggered": (lambda: small_las("conv_blstm", attn_type="triggered",
                                          **OFF), las_batch, False),
    "lstm_mocha": (lambda: small_las(
        "conv_lstm", attn_type="mocha", mocha_chunk_size=4,
        mocha_init_r=-4.0, mocha_std=0.0, **OFF), las_batch, True),
    "lcblstm_rnnt": (small_rnnt, rnnt_batch, False),
}


def in_threads(*fns):
    """Each function's result, the functions run in threads of their own:
    XLA compiles without the GIL, so JAX's bf16 and float32 programs
    compile side by side."""
    with ThreadPoolExecutor(len(fns)) as pool:
        return [f.result() for f in [pool.submit(fn) for fn in fns]]


def random_params(shapes, seed=0):
    """Seeded float32 values for a tree of JAX shapes (``jax.eval_shape``
    of a model's init: no compile): kernels of std 1/sqrt(fan in), vectors
    of std 0.1."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda s: (rng.randn(*s.shape) * (
        0.1 if len(s.shape) < 2 else 1 / np.sqrt(np.prod(s.shape[:-1])))
    ).astype(np.float32), shapes)


@functools.cache
def _models(name):
    """(args, JAX model, its seeded float32 params as numpy)."""
    make_args, make_batch, _ = MODELS[name]
    args = make_args()
    jm = jax_build(args)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *map(
        jnp.asarray, make_batch()))["params"]
    return args, jm, random_params(shapes)


def _port(name):
    args, _, params = _models(name)
    tm = build_speech2text(args, device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    return tm


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def _flat(tree):
    """The tensors / arrays of a nested carry, in order."""
    if hasattr(tree, "shape"):
        return [tree]
    return [x for t in tree for x in _flat(t)]


# The stated exceptions, each a group of leaves with a multiplier of its
# own: a leaf of a group may leave the rule, and is then held no farther
# from JAX's float32 value than the multiplier times JAX's own bf16 value
# is (|port - jax f32| <= m |jax bf16 - jax f32|). Each multiplier is about
# 1.5 times the worst reading on the CPU here, of all the leaves below:
# * the conv front end's, 5: 3.13 and 3.06 (random state passing's second
#   update, conv2's and conv1's bias; no other conv leaf leaves the rule).
#   The two frameworks' bf16 convolutions round at other places: over the
#   same bf16 values the port's output and every gradient lie no farther
#   from float64 than JAX's, most of them several times nearer
#   (``test_conv_front_end_bf16_is_no_farther_from_float64_than_jax``), so
#   the port's conv leaves cannot follow JAX's rounding.
# * MoChA's chunk energy's, 10: 6.44 (the chunk key projection's bias) and
#   3.30 (the chunk energy's query projection), in the LSTM-MoChA's
#   gradients, which nearly cancel over each chunk's softmax, so that both
#   sides hold rounding noise (the port's bf16 deviation from float32 over
#   the same rounded weights is below JAX's on the median leaf, 0.77 of
#   it).
# Every other leaf, the location attention's among them, keeps the rule.
GATED = {"encoder.conv.": 5.0, "dec_fwd.key_proj_chunk.": 10.0,
         "dec_fwd.step.attn.chunk_energy.": 10.0}


def assert_leaves_gated(got, want_bf16, want_f32, what):
    """Every leaf by the rule, or one of ``GATED``'s by its group's
    gate."""
    assert set(got) == set(want_bf16) == set(want_f32)
    for name in got:
        try:
            assert_rule(got[name], want_bf16[name], want_f32[name],
                        f"{what} {name}")
        except AssertionError:
            mult = next((m for g, m in GATED.items()
                         if name.startswith(g)), None)
            assert mult is not None, f"{what} {name}"
            g, wb, wf = (np.asarray(x, np.float64) for x in (
                got[name], want_bf16[name], want_f32[name]))
            err, ref = np.linalg.norm(g - wf), np.linalg.norm(wb - wf)
            assert err <= mult * ref, (
                f"{what} {name}: |port - jax f32| {err:.3e} > {mult} "
                f"x |jax bf16 - jax f32| {ref:.3e}")


# ---- the encoders ---------------------------------------------------------

@pytest.mark.parametrize("name", ["blstm_las", "lstm_las", "lcblstm_rnnt"])
def test_rnn_encoder_bf16_matches_jax(name):
    """The encoder at bf16 (its weights and the input cast) against JAX's
    ``encode`` with cast parameters: the outputs and the carries at each
    row's last frame by the rule, their dtypes JAX's (float32 from no
    carry); then from a bf16 carry (random state passing's), where JAX's
    recurrence is bf16. ROADMAP C48: from a bf16 carry JAX's LC-BLSTM of
    two layers fails (its second layer's input is float32, the merge of a
    bf16 forward and a float32 backward direction, so its scan's carry
    changes type); the port computes that layer in float32 and returns its
    carry so."""
    _, jm, params = _models(name)
    xs, xlens = MODELS[name][1](2)[:2]
    rng = np.random.RandomState(4)

    def jenc(p, carry, dt):
        x = jnp.asarray(xs)
        if dt is not None:
            p, x = cast_floating(p, dt), x.astype(dt)
            carry = cast_floating(carry, dt)
        out, new = jm.apply({"params": p}, x, jnp.asarray(xlens),
                            carry=carry, method=jm.encode)
        return out["ys"]["xs"], new

    tm = _port(name).eval()
    enc = tm.encoder.to(torch.bfloat16)
    _, c0 = jax.eval_shape(functools.partial(jenc, dt=None), params, None)
    carry = jax.tree.map(lambda c: 0.5 * rng.randn(*c.shape).astype(
        np.float32), c0)
    # JAX's (bf16, float32) outputs from no carry and from the carry (C48:
    # not for the LC-BLSTM's bf16 one), their programs compiled side by side
    givens = (None,) if name == "lcblstm_rnnt" else (None, carry)
    wants = in_threads(*(functools.partial(
        jax.jit(functools.partial(jenc, dt=dt)), params, given)
        for given in givens for dt in (BF16, None)))
    for k, given in enumerate((None, carry)):
        tc = None if given is None else jax.tree.map(
            lambda c: torch.from_numpy(np.asarray(c)), given)
        with torch.no_grad():
            eo, got_c = enc.forward_with_carry(
                torch.from_numpy(xs).to(torch.bfloat16),
                torch.from_numpy(xlens),
                None if tc is None else port_mesh.cast_floating(
                    _nest(tc), torch.bfloat16))
        if given is not None and name == "lcblstm_rnnt":
            with pytest.raises(TypeError, match="carry"):
                jax.eval_shape(functools.partial(jenc, dt=BF16), params,
                               given)
            assert [_dtype_name(c) for c in _flat(got_c)] == \
                ["bfloat16"] * 2 + ["float32"] * 2
            assert torch.isfinite(eo["ys"]["xs"]).all()
            continue
        want_b, want_f = wants[2 * k:2 * k + 2]
        ys = eo["ys"]["xs"]
        what = f"{name} carry={'bf16' if given is not None else 'none'}"
        assert _dtype_name(ys) == str(want_b[0].dtype), what
        # the valid frames (the packed layers' outputs past a row's
        # length are zero, JAX's are not: nothing reads them)
        valid = (np.arange(ys.shape[1])[None] <
                 eo["ys"]["xlens"].numpy()[:, None])[..., None]
        assert_rule(ys.double().numpy() * valid,
                    np.asarray(want_b[0], np.float64) * valid,
                    np.asarray(want_f[0]) * valid, what + " ys")
        for i, (g, wb, wf) in enumerate(zip(
                _flat(got_c), _flat(want_b[1]), _flat(want_f[1]))):
            assert _dtype_name(g) == str(wb.dtype), (what, i)
            assert_rule(g.double(), np.asarray(wb, np.float64), wf,
                        f"{what} carry {i}")
        if given is None:
            assert {str(x.dtype) for x in _flat(want_b[1])} == {"float32"}


def _nest(tree):
    """JAX's carry (lists) as the port's (lists of tuples)."""
    if torch.is_tensor(tree):
        return tree
    return tuple(_nest(t) for t in tree)


# ---- whole models ---------------------------------------------------------

def _jax_loss_and_grads(name, b):
    """JAX's loss, obs and gradients at bf16 and float32."""
    _, jm, params = _models(name)
    train = MODELS[name][2]

    def loss(p, dt):
        x = jnp.asarray(b[0])
        if dt is not None:
            p, x = cast_floating(p, dt), x.astype(dt)
        out, obs = jm.apply({"params": p}, x, *map(jnp.asarray, b[1:]),
                            deterministic=not train,
                            rngs={"dropout": jax.random.PRNGKey(1),
                                  "specaug": jax.random.PRNGKey(2)})
        return out.astype(jnp.float32), obs

    return in_threads(*(functools.partial(jax.jit(jax.value_and_grad(
        functools.partial(loss, dt=dt), has_aux=True)), params)
        for dt in (BF16, None)))


@pytest.mark.parametrize("name", ["blstm_triggered", "lstm_mocha",
                                  "lcblstm_rnnt"])
def test_model_bf16_loss_and_grads_match_jax(name):
    """The loss, its parts and every gradient leaf at bf16 by the rule
    (the BLSTM-LAS's: ``test_blstm_las_bf16_update_matches_jax``)."""
    b = MODELS[name][1](1)
    ((lb, ob), gb), ((lf, of), gf) = _jax_loss_and_grads(name, b)
    tm = _port(name)
    tm.train(MODELS[name][2])
    loss, obs = compute_loss(tm, torch.bfloat16, *map(torch.from_numpy, b))
    loss.backward()
    assert loss.dtype == torch.float32
    assert_rule(float(loss.detach()), float(lb), float(lf), f"{name} loss")
    for k in set(obs) & set(ob):
        if torch.is_tensor(obs[k]) and obs[k].ndim == 0 and \
                not k.startswith("acc"):
            assert_rule(float(obs[k].detach()), float(ob[k]), float(of[k]),
                        f"{name} {k}")
    got = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert all(p.grad.dtype == torch.float32 for p in tm.parameters())
    assert_leaves_gated(got, _converted(gb), _converted(gf),
                        f"{name} grad")


# ---- the conv front end's gate -------------------------------------------

def test_conv_front_end_bf16_is_no_farther_from_float64_than_jax():
    """The cause of the conv leaves' gate (``GATED``): the small LSTM-LAS's
    conv front end at bf16, the port's and JAX's (``encoder.conv`` of
    each), from the same bf16 weights and input, with one bf16 cotangent;
    each against the port's conv in float64 over those bf16 values. The
    port's output, input gradient and every weight gradient lie no farther
    from float64 than JAX's, to 1.25 x (measured here: the output 0.67 x
    JAX's distance, the input gradient 0.55 x, the weights' 0.25-0.32 x,
    conv2's bias 0.19 x, conv1's bias 1.02 x): the two round at other
    places, and the port the less."""
    _, jm, params = _models("lstm_las")
    xs, xlens = MODELS["lstm_las"][1](2)[:2]
    bf = torch.bfloat16
    x = torch.from_numpy(xs).to(bf)
    conv = _port("lstm_las").encoder.conv
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(p.to(bf).float())

    def jconv(p, x_):
        return jm.apply({"params": p}, x_, jnp.asarray(xlens),
                        method=lambda m, *a: m.encoder.conv(*a)[0])

    @jax.jit
    def forward_backward(p, x_, c):
        y, vjp = jax.vjp(jconv, p, x_)
        return (y, *vjp(c))

    args = (cast_floating(params, BF16), jnp.asarray(x.float().numpy(), BF16))
    ct = torch.from_numpy(np.random.RandomState(0).randn(*jax.eval_shape(
        jconv, *args).shape).astype(np.float32)).to(bf)
    y_j, g_j, gx_j = forward_backward(*args,
                                      jnp.asarray(ct.float().numpy(), BF16))
    g_j = {n[len("encoder.conv."):]: v for n, v in _converted(jax.tree.map(
        lambda v: np.asarray(v, np.float32), g_j)).items()
        if n.startswith("encoder.conv.")}

    def port(dt):
        """The output, input gradient and weight gradients at ``dt``."""
        c = conv.to(dt)
        c.zero_grad(set_to_none=True)
        x_ = x.to(dt).requires_grad_(True)
        y, _ = c(x_, torch.from_numpy(xlens))
        y.backward(ct.to(dt))
        return {"output": y.detach(), "input grad": x_.grad,
                **{n: p.grad for n, p in c.named_parameters()}}

    want = {n: v.double().numpy() for n, v in port(torch.float64).items()}
    got = {n: v.double().numpy() for n, v in port(bf).items()}
    jax_got = {"output": y_j, "input grad": gx_j, **g_j}
    assert set(jax_got) == set(got) == set(want)
    for n in want:
        dist = [np.linalg.norm(np.asarray(v, np.float64) - want[n]) /
                np.linalg.norm(want[n]) for v in (got[n], jax_got[n])]
        assert dist[0] <= 1.25 * dist[1], (n, dist)


# ---- the attention mask at LASScan's boundary -----------------------------

def _rounded_from(got, want):
    """got is the float32 ``want`` (to 1e-6 of its largest: the plain
    versions' float32 sums), rounded to got's type."""
    half_ulp = 2.0 ** -8 if got.dtype == torch.bfloat16 else 0.0
    tol = half_ulp * want.abs() + 1e-6 * float(want.abs().max())
    assert ((got.float() - want).abs() <= tol).all()


def test_las_attention_mask_at_bf16_through_lasscan():
    """``LASScan`` given bf16 operands and the attention dropout's scale
    (``att_keep``, float32 or bf16) computes K3 / K3b's plain versions in
    float32: its outputs are the float32 call's on the same (rounded)
    values, each gradient too, rounded to its operand's type; the
    outputs come back in the promoted type of the embedding gates and the
    encoder outputs (bf16 over bf16 values, float32 over float32 ones:
    an RNN encoder's at bf16)."""
    g = torch.Generator().manual_seed(0)
    b, u1, t, h, d, a, c, kw = 2, 5, 9, 8, 6, 4, 3, 5

    def r(*shape, s=0.3):
        return s * torch.randn(*shape, generator=g)

    ops = [r(b, u1, 4 * h), r(d, 4 * h), r(h, 4 * h), r(4 * h), r(a, h),
           r(c, kw), r(a, c), r(a), r(b, t, a), r(b, t, d)]
    klens = torch.tensor([t, t - 3], dtype=torch.int32)
    keep = torch.ones(b, u1, h)
    att = (torch.rand(b, u1, t, generator=g) > 0.2).float() / 0.8
    for values_dt in (torch.bfloat16, torch.float32):
        for att_dt in (torch.float32, torch.bfloat16):
            low = [x.to(torch.bfloat16) for x in ops[:9]] + \
                [ops[9].to(values_dt)]
            up = [x.float() for x in low]
            for x in low + up:
                x.requires_grad_(True)
            out_low = LASScan.apply(*low[:10], klens, keep.bfloat16(),
                                    att.to(att_dt))
            out_up = LASScan.apply(*up[:10], klens, keep, att)
            want_dt = torch.promote_types(torch.bfloat16, values_dt)
            assert [o.dtype for o in out_low] == [want_dt] * 3
            for o, w in zip(out_low, out_up):
                _rounded_from(o, w)
            # cotangents a bf16 output carries exactly
            w_h, w_c = (x.bfloat16().float() for x in (r(b, u1, h),
                                                      r(b, u1, d)))
            ((out_low[0].float() * w_h).sum() +
             (out_low[1].float() * w_c).sum()).backward()
            ((out_up[0] * w_h).sum() + (out_up[1] * w_c).sum()).backward()
            for x, y in zip(low, up):
                assert x.grad.dtype == x.dtype
                _rounded_from(x.grad, y.grad)


# ---- MBR at train_dtype bfloat16 ------------------------------------------

class _Set(list):
    @staticmethod
    def idx2token(ids):
        return " ".join(str(int(i)) for i in ids)


class _Reporter:
    step = 0

    def add_observation(self, obs):
        self.loss = obs["loss"]

    def step_forward(self):
        self.step += 1


def test_mbr_stays_float32_under_bf16():
    """The train CLI's step at ``train_dtype: bfloat16`` computes its
    microsteps at bf16, but its MBR epoch takes the model as it is (JAX's
    ``mbr_step`` ignores ``compute_dtype``): the encoder sees float32
    weights and inputs, and the MBR step's loss is the float32
    ``mbr_loss`` exactly."""
    tm = _port("blstm_las")
    args = SimpleNamespace(train_dtype="bfloat16", mbr_nbest=2,
                           mbr_ce_weight=0.01, mbr_ckpt_interval=0)
    step = port_train.make_step(tm, build_optimizer("sgd", lr=0.0), args)
    assert step.compute_dtype == torch.bfloat16
    xs, xlens, ys, ylens = las_batch(3, bs=2)
    batch = dict(utt_ids=["a", "b"], xs=xs, xlens=xlens, ys=ys, ylens=ylens,
                 text=["4 5 6", "7 8"])
    seen = []
    hook = tm.encoder.register_forward_pre_hook(lambda m, a: seen.append(
        (a[0].dtype, m.rnns[0].lstm.weight_hh_l0.dtype)))
    rep = _Reporter()
    port_train.mbr_epoch(tm, step, _Set([batch]), args, rep, 1,
                         lambda i: None)
    assert seen and set(seen) == {(torch.float32, torch.float32)}
    seen.clear()
    compute_loss(tm.train(), step.compute_dtype,
                 *map(torch.from_numpy, (xs, xlens, ys, ylens)))
    assert set(seen) == {(torch.bfloat16, torch.bfloat16)}
    hook.remove()
    assert rep.loss.dtype == torch.float32 and torch.isfinite(rep.loss)
