"""Port parity: scheduled sampling in the LAS decoder's training loss
(``ss_prob > 0`` in ``train()``).

* The port's loss and the gradient of every weight and of the encoder
  outputs against ``jax.grad`` of the JAX ``RNNDecoder`` in training mode
  (``deterministic=False``, dropout 0), with every row sampled at every
  step (``ss_prob`` 1, where the JAX draw is all True too) and with a
  pinned mask per row: the JAX ``jax.random.bernoulli`` (its scan traces
  the step once, so the same rows are sampled at every step) and the
  port's ``fast_uniform`` are replaced by one fixed pattern.
* The tokens the port's pass 1 feeds (``RNNDecoder.fed_tokens``) against
  the stream read from the JAX decoder's logits (``return_logits``): the
  label where a row is not sampled, else the argmax of the step before
  (token 0 at step 0, as JAX's carry starts from zero logits). Each argmax
  that is fed has a top-2 margin of at least ``MARGIN``, so that no tie
  decided by rounding makes the comparison meaningless.
* With dropout on and the port's own masks (``sampling_masks`` from one
  seed), the two-pass loss and gradients against a plain single-pass loop
  under autograd, with the readout and the argmax inside the loop (the
  design proved on the port alone), to 1e-5 of each leaf's largest
  magnitude, and the same fed tokens.
* ``eval()`` and ``ss_prob`` 0 take the teacher-forced path and draw no
  sampling mask.

Tolerance against JAX: float32, atol = rtol = 2e-4 (the repo's); each
gradient to 2e-4 of its leaf's largest magnitude plus 1e-6.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from neural_sp_tpu.models.decoders.las import RNNDecoder as JaxRNNDecoder
import neural_sp_tpu_torch.ops.dropout as port_dropout
from neural_sp_tpu_torch import PAD
from neural_sp_tpu_torch.models.decoders.las import RNNDecoder
from neural_sp_tpu_torch.models.utils import append_sos_eos
from neural_sp_tpu_torch.ops.criterion import cross_entropy_lsm
from neural_sp_tpu_torch.ops.kernels.las_step import las_step_ref
from neural_sp_tpu_torch.utils.convert_params import convert_params

ATOL = RTOL = 2e-4
FLOOR = 1e-6
MARGIN = 1e-3
VOCAB, ENC, UNITS, EMB, BOTTLE, ADIM, CONV_K = 30, 24, 20, 12, 16, 10, 9
KW = dict(vocab=VOCAB, enc_n_units=ENC, n_units=UNITS, emb_dim=EMB,
          bottleneck_dim=BOTTLE, attn_dim=ADIM, attn_conv_kernel_size=CONV_K,
          lsm_prob=0.1)
PINNED = np.array([True, False, True])


def _inputs(seed):
    rng = np.random.RandomState(seed)
    bs, t = 3, 11
    eouts = rng.randn(bs, t, ENC).astype(np.float32)
    elens = np.array([11, 7, 4], np.int32)
    ylens = np.array([5, 3, 2], np.int32)
    ys = np.full((bs, 5), 3, np.int32)
    for i, n in enumerate(ylens):
        ys[i, :n] = rng.randint(4, VOCAB, n)
    return rng, eouts, elens, ys, ylens


def _jax_params(jdec, args, rng):
    v = jdec.init(jax.random.PRNGKey(0), *args)
    # non-zero biases, and logits spread wide enough for clear argmaxes
    return jax.tree.map(lambda x: np.asarray(x) + 0.3 * rng.randn(
        *x.shape).astype(np.float32), jax.tree.map(np.asarray, v["params"]))


def _pin(monkeypatch, rows, u1):
    """Both packages' sampling draws give ``rows`` (per row, every step)."""
    real = jax.random.bernoulli

    def fake_bernoulli(key, p=0.5, shape=None):
        if shape is not None and tuple(shape) == rows.shape:
            return jnp.asarray(rows)
        return real(key, p, shape)

    def fake_uniform(key, shape, device=None):
        assert tuple(shape) == (rows.shape[0], u1)
        u = np.where(rows, 0.0, 0.999)[:, None]
        return torch.from_numpy(np.broadcast_to(u, tuple(shape)).astype(
            np.float32).copy())

    monkeypatch.setattr(jax.random, "bernoulli", fake_bernoulli)
    monkeypatch.setattr(port_dropout, "fast_uniform", fake_uniform)


def _leaf_close(got, want, name):
    scale = max(float(np.abs(want).max()), FLOOR)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * scale + FLOOR, err_msg=name)


def _spy_fed(monkeypatch):
    """Keeps what ``RNNDecoder.fed_tokens`` returns."""
    seen = []
    real = RNNDecoder.fed_tokens

    def spy(self, *args):
        seen.append(real(self, *args))
        return seen[-1]

    monkeypatch.setattr(RNNDecoder, "fed_tokens", spy)
    return seen


def _run_both(monkeypatch, ss_prob, rows, seed):
    rng, eouts, elens, ys, ylens = _inputs(seed)
    if rows is not None:
        _pin(monkeypatch, rows, ys.shape[1] + 1)
    jdec = JaxRNNDecoder(ss_prob=ss_prob, **KW)
    jargs = tuple(map(jnp.asarray, (eouts, elens, ys, ylens)))
    params = _jax_params(jdec, jargs, rng)

    def jloss(p, e):
        return jdec.apply({"params": p}, e, *jargs[1:], deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(1)},
                          return_logits=True)

    (want, jobs), (g_p, g_e) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jargs[0])
    port = RNNDecoder(ss_prob=ss_prob, **KW)
    port.load_state_dict(convert_params(params), strict=True)
    port.train()
    seen = _spy_fed(monkeypatch)
    e_t = torch.from_numpy(eouts).requires_grad_(True)
    loss, obs = port(e_t, torch.from_numpy(elens), torch.from_numpy(ys),
                     torch.from_numpy(ylens), torch.Generator().manual_seed(0))
    loss.backward()
    return dict(ys=ys, ylens=ylens, want=want, jobs=jobs, g_p=g_p, g_e=g_e,
                port=port, loss=loss, obs=obs, e_t=e_t, fed=seen)


CASES = {"every_row": (1.0, None), "pinned_rows": (0.5, PINNED)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sampled_loss_and_grads_match_jax(monkeypatch, case):
    ss_prob, rows = CASES[case]
    r = _run_both(monkeypatch, ss_prob, rows, seed=3)
    np.testing.assert_allclose(float(r["loss"].detach()), float(r["want"]),
                               rtol=RTOL, atol=ATOL)
    for name in ("acc_att", "ppl_att"):
        np.testing.assert_allclose(float(r["obs"][name].detach()),
                                   float(r["jobs"][name]), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    _leaf_close(r["e_t"].grad.numpy(), np.asarray(r["g_e"]), "eouts")
    grads = convert_params(jax.tree.map(np.asarray, r["g_p"]))
    for name, p in r["port"].named_parameters():
        _leaf_close(p.grad.numpy(), grads[name].numpy(), name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fed_tokens_match_jax_logits(monkeypatch, case):
    ss_prob, rows = CASES[case]
    r = _run_both(monkeypatch, ss_prob, rows, seed=3)
    logits = np.asarray(r["jobs"]["logits"])              # [B, U+1, V]
    bs, u1, _ = logits.shape
    ys_in, _, _ = append_sos_eos(torch.from_numpy(r["ys"]).long(),
                                 torch.from_numpy(r["ylens"]).long())
    sampled = np.ones((bs, u1), bool) if rows is None else \
        np.broadcast_to(rows[:, None], (bs, u1))
    want = ys_in.numpy().copy()
    for u in range(u1):
        prev = np.zeros(bs, np.int64) if u == 0 else \
            logits[:, u - 1].argmax(-1)
        want[:, u] = np.where(sampled[:, u], prev, want[:, u])
    top2 = np.sort(logits[:, :-1], -1)[..., -2:]
    margin = (top2[..., 1] - top2[..., 0])[sampled[:, 1:]]
    assert margin.min() >= MARGIN, margin.min()
    (fed,) = r["fed"]
    np.testing.assert_array_equal(fed.numpy(), want)
    assert (fed.numpy() != ys_in.numpy()).any()


def _seeded(dec, seed):
    """Every weight of ``dec`` drawn from N(0, 0.3^2) by one seed."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in dec.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    return dec


def _single_pass(dec, eouts, elens, ys, ylens, masks):
    """Scheduled sampling as one loop under autograd: each step's
    embedding, LSTM and attention (``las_step_ref``), readout, dropout and
    vocabulary projection, and the next fed token from its own argmax.
    Returns (loss, fed tokens)."""
    step, cell = dec.step, dec.step.cells[0]
    ys_in, ys_out, _ = append_sos_eos(ys, ylens)
    bs, u1 = ys_in.shape
    kc = dec.precompute_keys(eouts)
    klens = elens.int()
    h = c = torch.zeros(bs, dec.n_units)
    aw = torch.zeros(bs, eouts.shape[1])
    ctx = torch.zeros(bs, dec.enc_n_units)
    prev = torch.zeros(bs, dtype=torch.long)
    logits, fed = [], []
    for u in range(u1):
        y = torch.where(masks.sample[:, u], prev, ys_in[:, u])
        fed.append(y)
        eg = (step.embed(y) * masks.emb[:, u]) @ cell.w_ih[:step.emb_dim]
        h, c, aw, ctx = las_step_ref(
            eg, ctx, h, c, aw, cell.w_ih[step.emb_dim:], cell.w_hh,
            cell.bias, *step.attn.kernel_weights(), kc, eouts, klens,
            keep=masks.keep[:, u])
        out = torch.tanh(step.w_gen(torch.cat([h * masks.keep[:, u], ctx],
                                              -1)))
        logits.append(step.output(out * masks.out[:, u]))
        prev = logits[-1].argmax(-1)
    loss, _ = cross_entropy_lsm(torch.stack(logits, 1), ys_out, dec.lsm_prob,
                                ignore_index=PAD)
    return loss, torch.stack(fed, 1)


def test_two_passes_match_a_single_pass_loop(monkeypatch):
    rng, eouts, elens, ys, ylens = _inputs(4)
    dec = _seeded(RNNDecoder(ss_prob=0.4, dropout=0.2, dropout_emb=0.3,
                             **KW), 0)
    dec.train()
    seen = _spy_fed(monkeypatch)
    args = [torch.from_numpy(x) for x in (eouts, elens, ys, ylens)]
    e_a = args[0].clone().requires_grad_(True)
    loss, _ = dec(e_a, *args[1:], torch.Generator().manual_seed(7))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in dec.named_parameters()}
    dec.zero_grad()
    # the same masks: the same seed through the same draws
    masks = dec.sampling_masks(torch.Generator().manual_seed(7), 3,
                               ys.shape[1] + 1, torch.float32, "cpu")
    assert masks.sample.any() and not masks.sample.all()
    e_b = args[0].clone().requires_grad_(True)
    want, fed = _single_pass(dec, e_b, args[1], args[2].long(),
                             args[3].long(), masks)
    want.backward()
    np.testing.assert_array_equal(seen[0].numpy(), fed.numpy())
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    for name, p in dec.named_parameters():
        w = p.grad.numpy()
        np.testing.assert_allclose(grads[name].numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()) + 1e-9,
                                   err_msg=name)
    w = e_b.grad.numpy()
    np.testing.assert_allclose(e_a.grad.numpy(), w, rtol=0,
                               atol=1e-5 * float(np.abs(w).max()))


@pytest.mark.parametrize("mode", ["eval", "ss_prob_0"])
def test_teacher_forced_without_sampling(monkeypatch, mode):
    """``eval()`` at ss_prob 0.5, and ``train()`` at ss_prob 0 (where it
    draws what it drew before sampling was ported), feed the labels: no
    pass 1, and the loss of the teacher-forced decoder."""
    _, eouts, elens, ys, ylens = _inputs(5)
    args = [torch.from_numpy(x) for x in (eouts, elens, ys, ylens)]
    ss = 0.5 if mode == "eval" else 0.0
    dec = _seeded(RNNDecoder(ss_prob=ss, dropout=0.2, **KW), 1)
    ref = RNNDecoder(dropout=0.2, **KW)
    ref.load_state_dict(dec.state_dict())
    seen = _spy_fed(monkeypatch)
    for m in (dec, ref):
        m.train(mode != "eval")
    with torch.no_grad():
        got = dec(*args, torch.Generator().manual_seed(2))[0]
        want = ref(*args, torch.Generator().manual_seed(2))[0]
    assert not seen
    assert float(got) == float(want)
