"""Port parity: MMA, the transformer decoder's monotonic multihead source
attention (``MMAStep`` in ``models/modules/mocha.py``, the MMA blocks of
``models/decoders/transformer.py``), against the JAX package on the same
numpy inputs with the JAX weights converted, float32, atol = rtol = 2e-4
(the repo's) unless a test says otherwise.

The model is the LibriSpeech offline Transformer-MMA conf's shape with its
widths cut (``small_mma``): 2 encoder blocks, 3 decoder blocks of d 24
(a bridge), MMA from layer 2 with 2 monotonic x 2 chunk heads (adim 6),
chunk 4, shared chunk heads, the quantity loss at weight 1.0.

* ``train()`` (MoChA in parallel mode; dropout 0): the loss, its parts
  (the quantity loss averaged over the MMA layers) and every gradient leaf
  against ``jax.grad``, with the energies' noise pinned in both packages
  (``jax.random.normal`` in JAX's scan, traced once, and the port's
  ``mocha_noise`` give one fixed standard normal draw for every
  position); then the MMA recurrence alone (``MMAStep`` over
  8 positions) in float64 against JAX in ``jax.enable_x64`` at T = 80,
  the port's float32 held to it too (JAX's float32 moving sums lose beta
  to cancellation at such lengths: ROADMAP C18).
* ``eval()``: the loss against JAX's ``deterministic=True`` loss, MoChA in
  hard mode (the dev loss), on perturbed weights where boundaries fire.
* Decoding on perturbed weights: a chain of ``decode_step`` (hard mode,
  the alpha carried) against JAX's, and beam 4 + CTC 0.3 tokens against
  the JAX session's, with the search margin: every monotonic energy the
  boundary search reads at least 1e-3 from 0.
* ROADMAP C22: the conf's ``mocha_init_r`` (-2.0) and ``mocha_std`` are
  not read: ``r`` starts at -4.0 and the noise's std is 1.0, as JAX's.
* The train CLI's curriculum gates the MMA quantity loss by epoch; bf16
  compute with MMA raises.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from neural_sp_tpu.models.decoders.decoding import (
    DecodeConfig as JaxDecodeConfig, Speech2TextSession as JaxSession)
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu_torch.bin.asr.train import set_mocha_curriculum
from neural_sp_tpu_torch.configs import librispeech_transformer_mma_args
from neural_sp_tpu_torch.models.decoders import transformer as tdec
from neural_sp_tpu_torch.models.decoders.decoding import (
    DecodeConfig, Speech2TextSession)
from neural_sp_tpu_torch.models.modules import mocha
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.utils.convert_params import convert_params
from neural_sp_tpu_torch.utils.init_params import init_params

ATOL = RTOL = 2e-4
MARGIN = 1e-3


def _tree(params):
    return jax.tree.map(np.asarray, params)


def _close(got, want, err_msg="", rel=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0,
        atol=rel * max(float(np.abs(want).max()), 1e-6), err_msg=err_msg)


def _perturbed(params, scale, seed=5):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: np.asarray(x) + scale * rng.randn(
        *x.shape).astype(np.float32), params)


def small_mma(**over):
    args = vars(librispeech_transformer_mma_args())
    args.update(input_dim=20, conv_channels="4", conv_kernel_sizes="(3,3)",
                conv_strides="(1,1)", conv_poolings="(2,2)", enc_n_layers=2,
                transformer_enc_d_model=32, transformer_enc_d_ff=64,
                dec_n_layers=3, transformer_dec_d_model=24,
                transformer_dec_d_ff=48, mocha_first_layer=2,
                mocha_n_heads_mono=2, mocha_n_heads_chunk=2,
                mocha_chunk_size=4, mocha_quantity_loss_weight=1.0,
                vocab=50, ctc_fc_list="16", dropout_enc=0.0,
                dropout_dec=0.0, dropout_emb=0.0)
    args.update(over)
    return SimpleNamespace(**args)


def batch(seed=0, bs=3, t=40):
    rng = np.random.RandomState(seed)
    xs = rng.randn(bs, t, 20).astype(np.float32)
    xlens = np.array([t, t - 11, t - 23][:bs], np.int32)
    ylens = np.array([5, 3, 2][:bs], np.int32)
    ys = np.full((bs, 5), 3, np.int32)
    for b, u in enumerate(ylens):
        ys[b, :u] = rng.randint(4, 50, u)
    return xs, xlens, ys, ylens


_INIT = {}


def models(seed=0, **over):
    args = small_mma(**over)
    jm = jax_build(args)
    if seed not in _INIT:
        _INIT[seed] = _tree(jax.jit(jm.init)(
            jax.random.PRNGKey(seed), *map(jnp.asarray, batch()))["params"])
    params = _INIT[seed]
    tm = build_speech2text(args, device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    return jm, params, tm


def pin_noise(monkeypatch, noise):
    """One fixed draw [B, H_ma, T] for every MMA layer and position, in
    both packages."""
    real = jax.random.normal

    def fake_normal(key, shape=(), dtype=jnp.float32):
        if tuple(shape) == noise.shape:
            return jnp.asarray(noise, dtype)
        return real(key, shape, dtype)

    def fake_noise(gen, shape, device, dtype=torch.float32):
        bs, u1, h, t = shape
        assert (bs, h, t) == noise.shape
        return torch.from_numpy(noise)[:, None].expand(shape).to(dtype)

    monkeypatch.setattr(jax.random, "normal", fake_normal)
    monkeypatch.setattr(tdec, "mocha_noise", fake_noise)


def assert_grads_close(tm, grads, rel=RTOL):
    """Each leaf to ``rel`` of its own max; an attention key bias (zero
    gradient in exact arithmetic) to 1e-5 of the largest gradient."""
    want_g = convert_params(_tree(grads))
    assert set(want_g) == {n for n, _ in tm.named_parameters()}
    floor = 1e-5 * max(float(g.abs().max()) for g in want_g.values())
    for name, p in tm.named_parameters():
        g = p.grad.double().numpy()
        if name.endswith("w_key.bias"):
            np.testing.assert_allclose(g, want_g[name].numpy(), rtol=0,
                                       atol=floor, err_msg=name)
        else:
            _close(g, want_g[name].numpy(), name, rel)


def test_mma_loss_and_grads_match_jax(monkeypatch):
    jm, params, tm = models()
    b = batch(1)
    pin_noise(monkeypatch,
              np.random.RandomState(7).randn(3, 2, 20).astype(np.float32))

    def jloss(p):
        return jm.apply({"params": p}, *map(jnp.asarray, b),
                        deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(1),
                              "specaug": jax.random.PRNGKey(2)})

    (want, jobs), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    loss, obs = tm.train()(*map(torch.from_numpy, b),
                           torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=RTOL)
    for name in ("loss_ctc", "loss_att", "acc_att", "ppl_att",
                 "loss_quantity"):
        np.testing.assert_allclose(float(obs[name].detach()),
                                   float(jobs[name]), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    assert float(obs["loss_quantity"].detach()) > 0.1
    assert_grads_close(tm, grads)


def test_mma_parallel_mode_holds_to_jax_in_float64(monkeypatch):
    """The MMA recurrence in parallel mode, ``MMAStep`` over 8 positions
    with the alpha carried (2 x 2 heads, adim 6, chunk 4, shared chunk
    heads, the noise pinned), at T = 80 frames with keys of std 3 and a
    row of 61 valid frames: the port's float64 and float32 ctx, alphas and
    every gradient (the step's weights, the queries, the three key sets)
    against the JAX module in float64 (``jax.enable_x64``), at 1e-6 and
    2e-4 of each one's max. (JAX's forms cancel in float64 too, at its
    precision: the two float64 runs part by up to 2e-8 of a gradient's max
    with keys of std 1, and more at std 3, where the cumulative product
    reaches its clip.) Not the whole model: both packages run the
    attention softmaxes and the cross entropy in float32 at any dtype.
    (JAX's own float32 moving sums lose beta to cancellation at such
    lengths, ROADMAP C18; ``tests/test_torch_mocha.py`` holds the same
    for MoChA in the LAS.)"""
    from neural_sp_tpu.models.modules.mocha import MMAStep as JaxMMAStep
    rng = np.random.RandomState(3)
    b, t, u, d, adim = 2, 80, 8, 24, 6
    kc = {"mono": 3 * rng.randn(b, t, 2 * adim),
          "value": 3 * rng.randn(b, t, 4 * adim),
          "chunk": 3 * rng.randn(b, t, 2 * adim)}
    q = rng.randn(b, u, d)
    mask = np.arange(t)[None] < np.array([t, 61])[:, None]
    # float32 numbers: JAX's scan draws the noise at its default float32
    draw = rng.randn(b, 2, t).astype(np.float32).astype(np.float64)
    w_ctx, w_alpha = rng.randn(b, u, d), rng.randn(b, u, 2, t)
    alpha0 = np.zeros((b, 2, t))
    alpha0[:, :, 0] = 1.0
    pin_noise(monkeypatch, draw)
    kw = dict(kdim=d, qdim=d, adim=adim, chunk_size=4, n_heads_mono=2,
              n_heads_chunk=2, share_ca=True)
    jstep = JaxMMAStep(**kw)
    with jax.enable_x64(True):
        # float32 numbers, which convert_params carries exactly
        params = jax.tree.map(lambda x: np.asarray(
            x, np.float32).astype(np.float64), _tree(
            jstep.init(jax.random.PRNGKey(0), jnp.asarray(alpha0),
                       jnp.asarray(q[:, 0]), jax.tree.map(jnp.asarray, kc),
                       jnp.asarray(mask))["params"]))

        def jloss(p, q, kc):
            alpha, total = jnp.asarray(alpha0), 0.0
            for i in range(u):
                alpha, (ctx, _) = jstep.apply(
                    {"params": p}, alpha, q[:, i], kc, jnp.asarray(mask),
                    False, rngs={"dropout": jax.random.PRNGKey(i)})
                total = total + jnp.sum(ctx * w_ctx[:, i]) + \
                    jnp.sum(alpha * w_alpha[:, i])
            return total

        want, grads = jax.jit(jax.value_and_grad(jloss, (0, 1, 2)))(
            params, jnp.asarray(q), jax.tree.map(jnp.asarray, kc))
        want, grads = float(want), _tree(grads)
    step = mocha.MMAStep(**kw)
    step.load_state_dict(convert_params(grads[0]), strict=True)
    named = convert_params(params)
    for dtype, rel in ((torch.float64, 1e-6), (torch.float32, RTOL)):
        step.load_state_dict({k: v.to(dtype) for k, v in named.items()})
        step.to(dtype).zero_grad()
        tq = torch.tensor(q, dtype=dtype, requires_grad=True)
        tkc = {k: torch.tensor(v, dtype=dtype, requires_grad=True)
               for k, v in kc.items()}
        alpha = torch.tensor(alpha0, dtype=dtype)
        noise = torch.tensor(draw, dtype=dtype)
        total = 0.0
        for i in range(u):
            alpha, ctx = step(alpha, tq[:, i], tkc, torch.from_numpy(mask),
                              "parallel", noise)
            total = total + (ctx * torch.from_numpy(w_ctx[:, i]).to(
                dtype)).sum() + (alpha * torch.from_numpy(
                    w_alpha[:, i]).to(dtype)).sum()
        total.backward()
        np.testing.assert_allclose(float(total), want, rtol=rel)
        want_g = convert_params(grads[0])
        for name, p in step.named_parameters():
            _close(p.grad.double().numpy(), want_g[name].double().numpy(),
                   name, rel)
        _close(tq.grad.double().numpy(), grads[1], "queries", rel)
        for k, v in tkc.items():
            _close(v.grad.double().numpy(), grads[2][k], k, rel)


def _assert_search_margin(e, alpha_prev, mask):
    """Every energy the hard boundary search reads, from the previous
    boundary up to the first that fires, lies MARGIN from 0."""
    t = e.shape[-1]
    idx = torch.arange(t)
    start = torch.where(alpha_prev.sum(-1) > 0, alpha_prev.argmax(-1), 0)
    fire = (torch.sigmoid(e) >= 0.5) & (idx >= start[..., None])
    first = torch.where(fire, idx, t).amin(-1)
    read = (idx >= start[..., None]) & (idx <= first[..., None]) & \
        mask[:, None, :]
    assert float(e.abs()[read].min()) >= MARGIN


@pytest.fixture(scope="module")
def perturbed():
    jm, params, tm = models()
    params = _perturbed(params, 1.0, seed=7)
    tm.load_state_dict(convert_params(params), strict=True)
    return jm, params, tm.eval()


def test_mma_eval_loss_matches_jax_hard_mode(perturbed, monkeypatch):
    jm, params, tm = perturbed
    b = batch(2)
    want, jobs = jax.jit(lambda p: jm.apply(
        {"params": p}, *map(jnp.asarray, b), deterministic=True))(params)
    seen = []
    real_hard = mocha.hard_monotonic_attention

    def spy(e, alpha_prev, eps_wait=-1):
        seen.append((e, alpha_prev, real_hard(e, alpha_prev, eps_wait)))
        return seen[-1][2]

    monkeypatch.setattr(mocha, "hard_monotonic_attention", spy)
    tb = tuple(map(torch.from_numpy, b))
    with torch.no_grad():
        loss, obs = tm(*tb)
    np.testing.assert_allclose(float(loss), float(want), rtol=RTOL)
    for name in ("loss_ctc", "loss_att", "acc_att"):
        np.testing.assert_allclose(float(obs[name]), float(jobs[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert "loss_quantity" not in obs
    assert len(seen) == 2 * (b[3].max() + 1)     # 2 MMA layers x U+1
    klens = tm.encoder(*tb[:2])["ys"]["xlens"]
    mask = torch.arange(seen[0][0].shape[-1])[None] < klens[:, None]
    for e, prev, _ in seen:
        _assert_search_margin(e, prev, mask)
    assert sum(int(a.sum()) for _, _, a in seen) > 0


def test_mma_decode_steps_and_beam_match_jax(perturbed, monkeypatch):
    jm, params, tm = perturbed
    xs, xlens, _, _ = batch(6)
    seen = []
    real_hard = mocha.hard_monotonic_attention

    def spy(e, alpha_prev, eps_wait=-1):
        seen.append((e, alpha_prev))
        return real_hard(e, alpha_prev, eps_wait)

    monkeypatch.setattr(mocha, "hard_monotonic_attention", spy)
    # a chain of decode steps, the alpha carried
    e = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(xs),
                                   jnp.asarray(xlens), method=jm.encode)[0][
        "ys"])(params)
    ex, el = np.asarray(e["xs"]), np.asarray(e["xlens"])
    src_mask = jnp.asarray(np.arange(ex.shape[1])[None] < el[:, None])[
        :, None]
    src = jm.apply({"params": params}, jnp.asarray(ex),
                   method=lambda m, e: m.dec_fwd.precompute_src(e))
    caches = jm.apply({"params": params}, method=lambda m: m.dec_fwd.
                      init_cache(3, jnp.float32, ex.shape[1]))
    toks = np.random.RandomState(9).randint(4, 50, (3, 4))
    toks[:, 0] = 2

    @jax.jit
    def jchain(p, caches, src):
        """JAX's chain of decode steps, unrolled in one compile: each
        step's logits and its MMA layers' alphas."""
        out = []
        for i in range(toks.shape[1]):
            caches, lg = jm.apply(
                {"params": p}, caches, src, jnp.asarray(toks[:, i]),
                src_mask, i, jnp.asarray(ex),
                method=lambda m, *a: m.dec_fwd.decode_step(*a))
            out.append((lg, [caches[lth]["alpha"] for lth in (1, 2)]))
        return out

    want = jchain(params, caches, src)
    loop = tm.dec_fwd.decode_loop(torch.from_numpy(ex), torch.from_numpy(el))
    with torch.no_grad():
        for i, (want_lg, want_alpha) in enumerate(want):
            got_lg, _ = loop.step(torch.from_numpy(toks[:, i]))
            _close(got_lg.numpy(), want_lg, f"step {i}")
            for lth, wa in zip((1, 2), want_alpha):
                np.testing.assert_array_equal(
                    loop.caches[lth]["alpha"].numpy(), np.asarray(wa))
    fired = sum(int(c["alpha"].sum()) for c in loop.caches[1:])
    assert fired > 0
    mask = torch.arange(ex.shape[1])[None] < torch.from_numpy(el)[:, None]
    for e_, prev in seen:
        _assert_search_margin(e_, prev, mask)
    # beam 4 + CTC 0.3, one utterance a request; hypotheses of at most
    # 0.4 tokens a frame, which CTC can always emit
    seen.clear()
    conf = dict(beam_width=4, ctc_weight=0.3, n_best=2, max_len_ratio=0.4)
    jsess = JaxSession(jm, params, JaxDecodeConfig(**conf))
    tsess = Speech2TextSession(tm, DecodeConfig(**conf))
    for b in range(2):
        want = jsess.decode(xs[b:b + 1], xlens[b:b + 1])
        got = tsess.decode(xs[b:b + 1], xlens[b:b + 1])
        assert got == want, b
        assert len(got[0]) > 0
        sc = tsess._last_nbest_scores
        assert sc[0] - sc[1] > MARGIN, sc
        klen = int(tsess.encode(xs[b:b + 1], xlens[b:b + 1])["ys"]["xlens"])
        for e_, prev in seen:
            _assert_search_margin(e_, prev, torch.arange(
                e_.shape[-1])[None].expand(e_.shape[0], -1) < klen)
        seen.clear()


def test_mma_init_r_and_noise_std_are_not_read():
    """C22: the conf's -2.0 and std do not reach MMA, in JAX or the
    port."""
    args = small_mma(mocha_init_r=-2.0, mocha_std=0.5)
    jm = jax_build(args)
    params = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, batch())))["params"]
    jr = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), *map(
        jnp.asarray, batch()))["params"]["dec_fwd"]["blocks_1"]["src_mma"][
        "mocha"]["monotonic_energy"]["r"])()
    assert "src_mma" in params["dec_fwd"]["blocks_2"]
    tm = init_params(build_speech2text(args, device="cpu"), 0)
    for blk in tm.dec_fwd.blocks[1:]:
        energy = blk.src_mma.mocha.monotonic_energy
        assert torch.equal(energy.r, torch.full((2,), -4.0))
        assert blk.src_mma.mocha.noise_std == 1.0
    np.testing.assert_array_equal(np.asarray(jr), np.full(2, -4.0))
    assert not tm.dec_fwd.blocks[0].mma


def test_train_cli_curriculum_gates_the_mma_quantity_loss():
    tm = build_speech2text(small_mma(), device="meta")
    args = SimpleNamespace(mocha_quantity_loss_weight=1.0,
                           mocha_quantity_loss_start_epoch=3)
    got = []
    for epoch in (1, 2, 3):
        set_mocha_curriculum(tm.dec_fwd, args, epoch)
        got.append(tm.dec_fwd.quantity_loss_weight)
    assert got == [0.0, 0.0, 1.0]


def test_bf16_raises_for_mma():
    """MMA computes at bf16 now (the name is kept): the decoder in bf16
    over bf16 encoder outputs gives a finite float32 loss, bf16 logits as
    JAX's, and the alignment in float32 (ROADMAP C39; the bf16 parity is
    ``tests/test_torch_mma_bf16.py``)."""
    tm = init_params(build_speech2text(small_mma(), device="cpu"), 0)
    e = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(0))
    dec = tm.dec_fwd.to(torch.bfloat16)
    logits = []
    dec.output.register_forward_hook(lambda m, i, o: logits.append(o.dtype))
    loss, obs = dec(e.to(torch.bfloat16), torch.tensor([8, 5]),
                    torch.ones(2, 3, dtype=torch.long), torch.tensor([3, 2]),
                    torch.Generator().manual_seed(1))
    assert logits == [torch.bfloat16]
    assert obs["loss_quantity"].dtype == torch.float32
    assert bool(torch.isfinite(loss.float()))
