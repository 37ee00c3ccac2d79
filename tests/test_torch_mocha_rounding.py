"""ROADMAP C29: at the repo's streaming conf
(``examples/librispeech/conf/asr/uni_conformer_mocha_streaming.yaml``:
LSTM-512 MoChA decoder, chunk 4, quantity loss 1.0, decoder T 400) a
float32 train() microstep is rounding, in the JAX package as in the port.

The decoder alone runs here, on the output of the conf's 12-layer encoder
(the port's, seeded weights, float64): the JAX package cannot run the
mask-mode encoder in float64 (its attention softmax casts finfo(float64).min
/ 2 to float32, -inf, so a query with no allowed key gives NaN; the second
test). The decoder's weights are the port's seeded ones carried into the
JAX tree, and MoChA's noise is one seeded draw per case, the same in the
two packages and at both precisions. On these inputs the two packages in
float64 compute the same loss and gradients, while JAX's own float32 loss
and gradients lie far from its float64 ones, on the typical draw farther
than the gradients' norm: no float32 run can be held to float64 there.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import torch

from neural_sp_tpu.models.modules.relative_multihead_attention import (
    RelativeMultiheadAttention as JRelMHA)
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu_torch import PAD
from neural_sp_tpu_torch.configs import uni_conformer_mocha_streaming_args
from neural_sp_tpu_torch.models.decoders import las
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.utils.convert_params import convert_params
from neural_sp_tpu_torch.utils.init_params import init_params

UTT_FRAMES = (700, 1000, 1300, 1600)   # decoder T 175 .. 400
U = (40, 60, 80, 100)
N_DRAWS = 4


def _jax_tree_from_port(state: dict, template):
    """The JAX param tree holding the port's ``state``: ``convert_params``
    only moves elements, so converting a tree of leaf indices and one of
    element indices says where each port element came from."""
    leaves, tdef = jax.tree.flatten(template)
    which = convert_params(jax.tree.unflatten(
        tdef, [np.full(x.shape, i + 1.0) for i, x in enumerate(leaves)]))
    where = convert_params(jax.tree.unflatten(
        tdef, [np.arange(x.size, dtype=np.float64).reshape(x.shape)
               for x in leaves]))
    out = [np.array(x) for x in leaves]
    for name, leaf in which.items():
        li = leaf.numpy().astype(np.int64).ravel() - 1
        ei = where[name].numpy().astype(np.int64).ravel()
        val = state[name].numpy().ravel()
        for i in np.unique(li):
            out[i].reshape(-1)[ei[li == i]] = val[li == i]
    tree = jax.tree.unflatten(tdef, out)
    back = convert_params(tree)
    assert all(torch.equal(back[n], state[n]) for n in back)
    return tree


def _rel_dist(got: dict, want: dict) -> np.ndarray:
    """|g - g64| / |g64| per gradient leaf."""
    return np.array([np.linalg.norm(got[n] - want[n]) /
                     max(np.linalg.norm(want[n]), 1e-30) for n in want])


def test_c29_streaming_mocha_float32_microstep_is_rounding_in_jax_too(
        monkeypatch):
    args = uni_conformer_mocha_streaming_args()
    model = build_speech2text(args, device="cpu")
    init_params(model, 0)
    rng = np.random.default_rng(0)
    xs = np.zeros((4, max(UTT_FRAMES), 80))
    for i, t in enumerate(UTT_FRAMES):
        xs[i, :t] = rng.standard_normal((t, 80))
    with torch.no_grad():
        eo = model.double().eval().encoder(
            torch.from_numpy(xs), torch.tensor(UTT_FRAMES))["ys"]
    eouts = eo["xs"].float().numpy()
    elens = eo["xlens"].numpy().astype(np.int32)
    assert eouts.shape[1] == 400
    ys = np.full((4, max(U)), PAD, np.int32)
    for b, u in enumerate(U):
        ys[b, :u] = rng.integers(4, args.vocab, u)
    ylens = np.array(U, np.int32)
    noises = rng.standard_normal((N_DRAWS, 4, 1, 400)).astype(np.float32)

    dec32 = model.dec_fwd.float().train()
    dec64 = copy.deepcopy(dec32).double()
    jm = jax_build(args)

    def decoder(m, e, el, y, yl, deterministic=True):
        return m.dec_fwd(e, el, y, yl, deterministic=deterministic)

    template = jax.jit(lambda k: jm.init(
        k, jnp.zeros((1, 8, 256)), jnp.array([8]), jnp.asarray(ys[:1, :3]),
        jnp.array([3]), method=decoder))(jax.random.PRNGKey(0))["params"]
    params = _jax_tree_from_port(
        {"dec_fwd." + k: v for k, v in dec32.state_dict().items()},
        jax.tree.map(np.asarray, template))

    # MoChA's noise: the draw in both packages, at every decoder step
    pinned, real = {}, jax.random.normal

    def fake_normal(key, shape=(), dtype=jnp.float32):
        z = pinned.get("z")
        if z is not None and tuple(shape) == z.shape:
            return z.astype(dtype)
        return real(key, shape, dtype)

    def fake_noise(gen, shape, device, dtype=torch.float32):
        return torch.from_numpy(pinned["np"])[:, None].expand(shape).to(dtype)

    monkeypatch.setattr(jax.random, "normal", fake_normal)
    monkeypatch.setattr(las, "mocha_noise", fake_noise)

    def jax_loss(p, e, z):
        pinned["z"] = z
        try:
            return jm.apply({"params": p}, e, jnp.asarray(elens),
                            jnp.asarray(ys), jnp.asarray(ylens),
                            deterministic=False, method=decoder,
                            rngs={"dropout": jax.random.PRNGKey(1)})
        finally:
            pinned.pop("z")

    def jax_run(dt, steps):
        if dt not in steps:
            steps[dt] = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))
        p = jax.tree.map(lambda x: jnp.asarray(x, dt), params)
        (loss, _), g = steps[dt](p, jnp.asarray(eouts, dt),
                                 jnp.asarray(pinned["np"], dt))
        g = convert_params(jax.tree.map(lambda x: np.asarray(x, np.float64),
                                        g))
        return float(loss), {n: v.double().numpy() for n, v in g.items()}

    def port_run(dec):
        dt = next(dec.parameters()).dtype
        dec.zero_grad(set_to_none=True)
        loss, _ = dec(torch.from_numpy(eouts).to(dt), torch.from_numpy(elens),
                      torch.from_numpy(ys).long(),
                      torch.from_numpy(ylens).long(),
                      torch.Generator().manual_seed(0), None)
        loss.backward()
        return float(loss.detach()), {"dec_fwd." + n: p.grad.double().numpy()
                             for n, p in dec.named_parameters()}

    steps32, steps64 = {}, {}
    jax32, port32, jax32_loss, port32_loss = [], [], [], []
    for z in noises:
        pinned["np"] = z
        with jax.enable_x64(True):
            l64, g64 = jax_run(jnp.float64, steps64)
        l32, g32 = jax_run(jnp.float32, steps32)
        p64, pg64 = port_run(dec64)
        p32, pg32 = port_run(dec32)
        # each package's float32 against its own float64 (per gradient
        # leaf, the median)
        jax32.append(float(np.median(_rel_dist(g32, g64))))
        port32.append(float(np.median(_rel_dist(pg32, pg64))))
        jax32_loss.append(abs(l32 - l64) / abs(l64))
        port32_loss.append(abs(p32 - p64) / abs(p64))
        # the two packages in float64 compute one function: the same loss,
        # and gradients far closer to each other than JAX's float32 ones to
        # its float64 ones (both packages take the loss heads in float32,
        # whose rounding the backward amplifies too)
        assert abs(p64 - l64) <= 1e-6 * abs(l64), (p64, l64)
        same = float(np.median(_rel_dist(pg64, g64)))
        assert same <= jax32[-1] / 10, (same, jax32[-1])

    def gmean(v):
        return float(np.exp(np.mean(np.log(v))))

    # on the typical draw JAX's float32 gradients lie farther than their
    # norm from its float64 ones; the port's float32 lies no farther from
    # its float64, in the gradients and in the loss
    assert gmean(jax32) > 1.0, jax32
    assert gmean(port32) <= gmean(jax32), (port32, jax32)
    assert gmean(port32_loss) <= gmean(jax32_loss), (port32_loss, jax32_loss)


def test_c29_jax_float64_attention_nans_on_a_row_with_no_key():
    """The JAX relative attention in float64 gives NaN where a query may
    attend no key (a pad query of the mask-mode encoder), float32 uniform
    weights: its softmax casts finfo(float64).min / 2 to float32."""
    m = JRelMHA(d_model=8, n_heads=2)
    x = np.random.RandomState(0).randn(1, 4, 8)
    mask = np.ones((1, 4, 4), bool)
    mask[0, 3] = False                       # query 3 may attend no key
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32),
                    mask=jnp.asarray(mask))
    out32 = m.apply(params, jnp.asarray(x, jnp.float32),
                    mask=jnp.asarray(mask))[0]
    assert np.isfinite(np.asarray(out32)).all()
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), params)
        out64 = np.asarray(m.apply(p64, jnp.asarray(x, jnp.float64),
                                   mask=jnp.asarray(mask))[0])
    assert np.isnan(out64[0, 3]).all() and np.isfinite(out64[0, :3]).all()
