"""Port parity: the teacher-forced LAS scan (kernels K3 / K3b, plain
versions) and the decoder's training loss.

* ``las_scan_bwd_ref`` (the reverse-step adjoint written out) against
  torch autograd through ``las_scan_ref``, in float64, with a dropout
  keep-mask, ragged key lengths and conv widths odd and even.
* ``las_scan_bwd_finish`` (what the CUDA wrapper computes after K3b's
  loop: dvalues from each step's saved context gradient, the partial sums,
  the weight gradients) against ``las_scan_bwd_ref``, the same way.
* ``attend_parts_ref`` and ``attend_combine_ref`` (the plain versions of
  the two kernels K2 / K3 split the softmax and context into: per block of
  16 frames its max, exponentials, their sum and partial context, then the
  row's softmax combined once) against ``attend_ref``, with rows of klen 0
  (uniform weights over all T frames) and klen 1.
* The teacher-forced attention weights and loss of the port's decoder
  (through ``las_scan_ref``) against the JAX decoder's scan with an
  utterance of encoder length 0 in the batch.
* The port's ``RNNDecoder.forward`` (loss, accuracy, perplexity, and the
  gradient of every weight and of the encoder outputs, through
  ``LASScan`` whose backward on CPU is ``las_scan_bwd_ref``) against
  ``jax.grad`` of the JAX ``RNNDecoder`` with dropout on. Both packages'
  masks are pinned for the test: the JAX ``fast_bernoulli`` and the port's
  ``fast_uniform`` are replaced by one fixed keep pattern on the LSTM
  output (the JAX scan traces its step once, so the pattern is the same at
  every step) and keep-all elsewhere, which still scales by 1 / (1 - p).

Tolerance: float32, atol = rtol = 2e-4 (the repo's); gradients relative
to each leaf's largest magnitude, with an absolute floor of 1e-6 for
leaves that are zero up to rounding.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import neural_sp_tpu.ops.dropout as jax_dropout
import neural_sp_tpu_torch.ops.dropout as port_dropout
from neural_sp_tpu.models.decoders.las import RNNDecoder as JaxRNNDecoder
from neural_sp_tpu_torch.models.decoders.las import RNNDecoder
from neural_sp_tpu_torch.models.decoders import las as port_las
from neural_sp_tpu_torch.ops.kernels.las_scan import (
    las_scan_bwd_finish, las_scan_bwd_ref, las_scan_bwd_steps_ref,
    las_scan_ref)
from neural_sp_tpu_torch.ops.kernels.las_step import (
    attend_combine_ref, attend_parts_ref, attend_ref, location_features)
from neural_sp_tpu_torch.utils.convert_params import convert_params

ATOL = RTOL = 2e-4
FLOOR = 1e-6
VOCAB, ENC, UNITS, EMB, BOTTLE, ADIM = 30, 24, 20, 12, 16, 10
RATE = 0.25


@pytest.mark.parametrize("conv_k", [7, 6])
def test_bwd_ref_matches_autograd(conv_k):
    b, u, hd, d, a, ch, t = 3, 5, 6, 5, 4, 3, 9
    rng = np.random.RandomState(conv_k)

    def r(*shape):
        return torch.from_numpy(rng.randn(*shape) * 0.5)

    ins = [r(u, b, 4 * hd), r(d, 4 * hd), r(hd, 4 * hd), r(4 * hd),
           r(a, hd), r(ch, conv_k), r(a, ch), r(a), r(b, t, a), r(b, t, d)]
    for x in ins:
        x.requires_grad_(True)
    klens = torch.tensor([9, 4, 1])
    keep = torch.from_numpy((rng.rand(u, b, hd) >= RATE) / (1 - RATE))
    h, c, gates, q, aw, ctx = las_scan_ref(*ins, klens, keep)
    dh, dctx = r(u, b, hd), r(u, b, d)
    want = torch.autograd.grad((h * dh).sum() + (ctx * dctx).sum(), ins)
    w_ctx, w_h, _, w_q, conv_w, w_f, v, kc, values = ins[1:]
    with torch.no_grad():
        got = las_scan_bwd_ref(w_ctx, w_h, w_q, conv_w, w_f, v, kc, values,
                               klens, keep, h, c, gates, q, aw, ctx, dh,
                               dctx)
    names = ("d_eg", "dW_ctx", "dW_h", "db", "dW_q", "dconv", "dW_f", "dv",
             "dkc", "dvalues")
    for name, x, y in zip(names, got, want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-10,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("conv_k", [7, 6])
def test_bwd_finish_matches_accumulated_ref(conv_k):
    """``las_scan_bwd_finish``, the CUDA wrapper's work after K3b's loop, on
    the plain per-step quantities: dvalues as one product of the weights
    and each step's total dctx, the sums of per-block partials, and the
    weight gradients, against ``las_scan_bwd_ref``'s accumulated form."""
    b, u, hd, d, a, ch, t = 3, 5, 6, 5, 4, 3, 9
    rng = np.random.RandomState(conv_k + 10)

    def r(*shape):
        return torch.from_numpy(rng.randn(*shape) * 0.5)

    eg, w_ctx, w_h, bias, w_q, conv_w, w_f, v, kc, values = (
        r(u, b, 4 * hd), r(d, 4 * hd), r(hd, 4 * hd), r(4 * hd), r(a, hd),
        r(ch, conv_k), r(a, ch), r(a), r(b, t, a), r(b, t, d))
    klens = torch.tensor([9, 4, 1])
    keep = torch.from_numpy((rng.rand(u, b, hd) >= RATE) / (1 - RATE))
    h, c, gates, q, aw, ctx = las_scan_ref(eg, w_ctx, w_h, bias, w_q, conv_w,
                                           w_f, v, kc, values, klens, keep)
    saved = (w_ctx, w_h, w_q, conv_w, w_f, v, kc, values, klens, keep, h, c,
             gates, q, aw, ctx, r(u, b, hd), r(u, b, d))
    want = las_scan_bwd_ref(*saved)
    dy, dq, dctx, d_conv, d_w_f, d_v, dkc, _ = las_scan_bwd_steps_ref(*saved)

    def slots(total, n=4):
        """total split into n slots [n, ...] that sum to it."""
        parts = torch.from_numpy(rng.randn(n - 1, *total.shape))
        return torch.cat([parts, (total - parts.sum(0))[None]])

    got = las_scan_bwd_finish(h, ctx, keep, aw, dy, dq, dctx, dkc,
                              slots(d_conv), slots(d_w_f.t()), slots(d_v))
    names = ("d_eg", "dW_ctx", "dW_h", "db", "dW_q", "dconv", "dW_f", "dv",
             "dkc", "dvalues")
    for name, x, y in zip(names, got, want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-10,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("t,klens", [
    (37, [37, 0, 1, 16, 33]),     # klen 0, klen 1, a block boundary
    (33, [33, 32, 0, 17, 1]),     # one frame past two blocks
    (9, [9, 0, 4, 1, 8]),         # shorter than one block
])
def test_attend_parts_and_combine_match_attend_ref(t, klens):
    """The softmax and context as the kernel splits them (per block of 16
    frames: max, exponentials, sum, partial context; then one combine per
    row, over the row's frames only) give ``attend_ref``'s weights and
    context: uniform 1 / T over all T frames for klen 0, weight 1 on frame
    0 for klen 1, exact zeros past klen otherwise."""
    n, hd, d, a, ch, k = len(klens), 6, 5, 4, 3, 7
    rng = np.random.RandomState(t)

    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    query, aw_prev = r(n, hd), torch.softmax(r(n, t, scale=2.0), -1)
    w_q, conv_w, w_f, v = r(a, hd), r(ch, k), r(a, ch), r(a, scale=3.0)
    kc, values = r(n, t, a), r(n, t, d)
    kl = torch.tensor(klens, dtype=torch.int32)
    q, aw, ctx = attend_ref(query, aw_prev, w_q, conv_w, w_f, v, kc, values,
                            kl)
    # the energies as the kernel forms them, before any mask
    loc = location_features(aw_prev, conv_w)
    e = torch.tanh(kc + q[:, None] + loc @ w_f.t()) @ v
    p, ms, part_ctx = attend_parts_ref(e, values, kl)
    got_aw, got_ctx = attend_combine_ref(p, ms, part_ctx, kl)
    np.testing.assert_allclose(got_aw.numpy(), aw.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_ctx.numpy(), ctx.numpy(), rtol=RTOL,
                               atol=ATOL)
    for i, n_valid in enumerate(klens):
        if n_valid == 0:
            np.testing.assert_allclose(got_aw[i].numpy(), 1.0 / t, rtol=1e-6)
            np.testing.assert_allclose(got_ctx[i].numpy(),
                                       values[i].mean(0).numpy(), rtol=RTOL,
                                       atol=ATOL)
        else:
            assert float(got_aw[i, n_valid:].abs().sum()) == 0.0
        if n_valid == 1:
            assert float(got_aw[i, 0]) == 1.0


def _pinned_masks(monkeypatch, keep_bh):
    """Replace both packages' dropout draws: shape [B, H] (JAX, per step)
    or [B, U, H] (port) gets ``keep_bh``; every other site keeps all."""
    bs, hd = keep_bh.shape

    def fake_bernoulli(rng, p, shape):
        if tuple(shape) == (bs, hd):
            return jnp.asarray(keep_bh)
        return jnp.ones(shape, bool)

    def fake_uniform(key, shape, device=None):
        if len(shape) == 3 and tuple(shape[::2]) == (bs, hd):
            u = np.where(keep_bh, 0.0, 0.999)[:, None, :]
            return torch.from_numpy(np.broadcast_to(
                u, tuple(shape)).astype(np.float32).copy())
        return torch.zeros(tuple(shape))

    monkeypatch.setattr(jax_dropout, "fast_bernoulli", fake_bernoulli)
    monkeypatch.setattr(port_dropout, "fast_uniform", fake_uniform)


def _leaf_close(got, want, name):
    scale = max(float(np.abs(want).max()), FLOOR)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * scale + FLOOR, err_msg=name)


@pytest.mark.parametrize("conv_k", [9, 8])
def test_decoder_loss_and_grads_match_jax(monkeypatch, conv_k):
    rng = np.random.RandomState(conv_k)
    bs, t = 3, 11
    eouts = rng.randn(bs, t, ENC).astype(np.float32)
    elens = np.array([11, 7, 4], np.int32)
    ylens = np.array([5, 3, 1], np.int32)
    ys = np.full((bs, 5), 3, np.int32)
    for i, n in enumerate(ylens):
        ys[i, :n] = rng.randint(4, VOCAB, n)
    keep_bh = rng.rand(bs, UNITS) >= RATE
    _pinned_masks(monkeypatch, keep_bh)

    kw = dict(vocab=VOCAB, enc_n_units=ENC, n_units=UNITS, emb_dim=EMB,
              bottleneck_dim=BOTTLE, attn_dim=ADIM,
              attn_conv_kernel_size=conv_k, lsm_prob=0.1)
    jdec = JaxRNNDecoder(dropout=RATE, **kw)
    jargs = tuple(map(jnp.asarray, (eouts, elens, ys, ylens)))
    v = jdec.init(jax.random.PRNGKey(0), *jargs)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.randn(
        *x.shape).astype(np.float32), jax.tree.map(np.asarray, v["params"]))

    def jloss(p, e):
        loss, obs = jdec.apply({"params": p}, e, *jargs[1:],
                               deterministic=False,
                               rngs={"dropout": jax.random.PRNGKey(1)})
        return loss, obs

    (want, jobs), (g_p, g_e) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jargs[0])

    port = RNNDecoder(dropout=RATE, **kw)
    port.load_state_dict(convert_params(params), strict=True)
    port.train()
    e_t = torch.from_numpy(eouts).requires_grad_(True)
    loss, obs = port(e_t, torch.from_numpy(elens), torch.from_numpy(ys),
                     torch.from_numpy(ylens), torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=RTOL,
                               atol=ATOL)
    for name in ("acc_att", "ppl_att"):
        np.testing.assert_allclose(float(obs[name]), float(jobs[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    _leaf_close(e_t.grad.numpy(), np.asarray(g_e), "eouts")
    grads = convert_params(jax.tree.map(np.asarray, g_p))
    for name, p in port.named_parameters():
        _leaf_close(p.grad.numpy(), grads[name].numpy(), name)


def test_scan_matches_jax_with_an_empty_utterance(monkeypatch):
    """The teacher-forced scan with an utterance of encoder length 0 in the
    batch: the port's attention weights at every step (``las_scan_ref``
    through ``LASScan`` on CPU) and its loss against the JAX decoder's scan,
    the same inputs and converted weights through both, no dropout. The
    empty utterance's weights are uniform over all T frames in both."""
    rng = np.random.RandomState(5)
    bs, t = 3, 11
    eouts = rng.randn(bs, t, ENC).astype(np.float32)
    elens = np.array([11, 0, 4], np.int32)
    ylens = np.array([5, 3, 1], np.int32)
    ys = np.full((bs, 5), 3, np.int32)
    for i, n in enumerate(ylens):
        ys[i, :n] = rng.randint(4, VOCAB, n)
    kw = dict(vocab=VOCAB, enc_n_units=ENC, n_units=UNITS, emb_dim=EMB,
              bottleneck_dim=BOTTLE, attn_dim=ADIM, attn_conv_kernel_size=9,
              lsm_prob=0.1)
    jdec = JaxRNNDecoder(dropout=0.0, **kw)
    jargs = tuple(map(jnp.asarray, (eouts, elens, ys, ylens)))
    v = jdec.init(jax.random.PRNGKey(0), *jargs)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.randn(
        *x.shape).astype(np.float32), jax.tree.map(np.asarray, v["params"]))
    want, jobs = jdec.apply({"params": params}, *jargs, deterministic=True,
                            return_logits=True)
    want_aw = np.asarray(jobs["aws"]).reshape(bs, ys.shape[1] + 1, t)

    seen = {}
    real = port_las.LASScan

    class Spy:
        """``LASScan`` that keeps what it returned: (h, ctx, aw)."""

        @staticmethod
        def apply(*args):
            seen["out"] = real.apply(*args)
            return seen["out"]

    monkeypatch.setattr(port_las, "LASScan", Spy)
    port = RNNDecoder(dropout=0.0, **kw)
    port.load_state_dict(convert_params(params), strict=True)
    port.eval()
    with torch.no_grad():
        loss, _ = port(torch.from_numpy(eouts), torch.from_numpy(elens),
                       torch.from_numpy(ys), torch.from_numpy(ylens))
    got_aw = seen["out"][2].numpy()
    np.testing.assert_allclose(float(loss), float(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_aw, want_aw, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_aw[1], 1.0 / t, rtol=1e-6)
    assert float(np.abs(got_aw[2, :, 4:]).sum()) == 0.0
