"""Port parity: the CTC loss (kernel K4's plain versions and its module).

The same numpy log-probs go through the JAX package's ``ops.ctc.ctc_loss``
(its custom VJP: alphas forward, betas backward) and the port's, whose
``autograd.Function`` runs the plain forward ``ctc_forward_alphas`` and the
written-out backward ``ctc_loss_bwd_ref`` on CPU tensors; values and
gradients w.r.t. the log-probs are compared. ``torch.nn.functional.
ctc_loss`` is a second oracle (values, and gradients w.r.t. the logits,
where both conventions agree). The batch covers U = 0, an infeasible
utterance (zeroed by ``zero_infinity``), repeated labels and T_b < T.
Tolerance: float32, atol = rtol = 2e-4 (the repo's).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from neural_sp_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from neural_sp_tpu.ops.ctc import ctc_forward_alphas as jax_alphas
from neural_sp_tpu_torch.models.decoders.ctc import CTC
from neural_sp_tpu_torch.ops.ctc import ctc_loss
from neural_sp_tpu_torch.ops.kernels import ctc_loss as k4
from neural_sp_tpu_torch.ops.kernels.ctc_loss import (
    ctc_backward_betas, ctc_forward_alphas, ctc_loss_bwd_ref)

ATOL = RTOL = 2e-4
B, T, V, U = 5, 12, 9, 4
LABELS = np.array([[1, 2, 2, 3],     # repeat: needs a blank between
                   [4, 5, 3, 3],     # ragged: U_b = 2
                   [6, 3, 3, 3],     # U_b = 0
                   [7, 7, 7, 7],     # infeasible: U + repeats = 7 > T_b = 5
                   [8, 1, 8, 2]], np.int32)
TLENS = np.array([12, 9, 7, 5, 12], np.int32)
ULENS = np.array([4, 2, 0, 4, 4], np.int32)


def _logits(seed=0):
    return np.random.RandomState(seed).randn(B, T, V).astype(np.float32) * 2


def _t(x):
    return torch.from_numpy(np.array(x))


def test_alphas_match_jax():
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(_logits()), -1))
    nll_j, alphas_j = jax_alphas(jnp.asarray(lp), jnp.asarray(LABELS),
                                 jnp.asarray(TLENS), jnp.asarray(ULENS))
    nll, alphas = ctc_forward_alphas(_t(lp), _t(LABELS), _t(TLENS), _t(ULENS))
    np.testing.assert_allclose(nll.numpy(), np.asarray(nll_j), rtol=RTOL,
                               atol=ATOL)
    # JAX keeps alphas [T, B, S]; the port [B, T, S]
    np.testing.assert_allclose(alphas.numpy(),
                               np.asarray(alphas_j).transpose(1, 0, 2),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("reduction", ["sum_over_batch", "none"])
def test_ctc_loss_value_and_grad_match_jax(reduction):
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(_logits(1)), -1))
    w = np.linspace(0.5, 1.5, B).astype(np.float32)

    def jloss(x):
        out = jax_ctc_loss(x, jnp.asarray(LABELS), jnp.asarray(TLENS),
                           jnp.asarray(ULENS), reduction=reduction)
        return jnp.sum(out * w) if reduction == "none" else out

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(lp))
    x = _t(lp).clone().requires_grad_(True)
    nll = ctc_loss(x, _t(LABELS), _t(TLENS), _t(ULENS))
    got = (nll * _t(w)).sum() if reduction == "none" else nll.sum() / B
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                               rtol=RTOL, atol=ATOL)
    # the infeasible utterance and the U = 0 one carry no gradient
    assert float(x.grad[2:4].abs().max()) == 0.0


def test_ctc_loss_matches_torch_builtin():
    logits = _t(_logits(2)).requires_grad_(True)
    lp = torch.log_softmax(logits, -1)
    nll = ctc_loss(lp, _t(LABELS), _t(TLENS), _t(ULENS))
    ref = torch.nn.functional.ctc_loss(
        lp.transpose(0, 1), _t(LABELS).long(), _t(TLENS).long(),
        _t(ULENS).long(), reduction="none", zero_infinity=True)
    # torch gives the U = 0 utterance its all-blank path; the JAX package
    # (and so the port) zeroes it as infeasible
    keep = torch.from_numpy(ULENS > 0)
    np.testing.assert_allclose(nll[keep].detach().numpy(),
                               ref[keep].detach().numpy(), rtol=RTOL,
                               atol=ATOL)
    g_port, = torch.autograd.grad(nll[keep].sum(), logits,
                                 retain_graph=True)
    g_torch, = torch.autograd.grad(ref[keep].sum(), logits)
    np.testing.assert_allclose(g_port.numpy(), g_torch.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_betas_complete_the_alphas():
    """alpha + beta at any valid frame sums to the same total: log Z."""
    lp = torch.log_softmax(_t(_logits(3)), -1)
    nll, alphas = ctc_forward_alphas(lp, _t(LABELS), _t(TLENS), _t(ULENS))
    betas = ctc_backward_betas(lp, _t(LABELS), _t(TLENS), _t(ULENS))
    for b in (0, 1, 4):
        s = 2 * int(ULENS[b]) + 1
        tot = torch.logsumexp(alphas[b, :TLENS[b], :s]
                              + betas[b, :TLENS[b], :s], -1)
        np.testing.assert_allclose(tot.numpy(), -float(nll[b]), rtol=RTOL,
                                   atol=ATOL)


def test_ctc_backward_is_the_plain_version_on_cpu():
    lp = torch.log_softmax(_t(_logits(4)), -1)
    args = (lp, _t(LABELS), _t(TLENS), _t(ULENS))
    before = (k4.ctc_loss_fwd.launches, k4.ctc_loss_bwd.launches)
    nll, alphas = k4.ctc_loss_fwd(*args)
    assert alphas.dtype == torch.float64
    g = torch.ones(B)
    assert torch.equal(k4.ctc_loss_bwd(*args, alphas, g),
                       ctc_loss_bwd_ref(*args, alphas, g))
    assert (k4.ctc_loss_fwd.launches, k4.ctc_loss_bwd.launches) == before


def test_ctc_head_forward_matches_jax():
    from neural_sp_tpu.models.decoders.ctc import CTC as JaxCTC
    rng = np.random.RandomState(5)
    eouts = rng.randn(B, T, 16).astype(np.float32)
    jm = JaxCTC(vocab=V, enc_n_units=16)
    args = tuple(map(jnp.asarray, (eouts, TLENS, LABELS, ULENS)))
    params = jm.init(jax.random.PRNGKey(0), *args)
    want, want_logits = jm.apply(params, *args)
    head = CTC(vocab=V, enc_n_units=16)
    head.load_state_dict({"output.weight": _t(np.asarray(
        params["params"]["output"]["kernel"]).T.copy()),
        "output.bias": _t(np.asarray(params["params"]["output"]["bias"]))})
    got, logits = head(_t(eouts), _t(TLENS), _t(LABELS), _t(ULENS))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=RTOL, atol=ATOL)


def test_alphas_are_kept_in_float64_on_long_inputs():
    """At T = 500, V = 10,000 a log alpha falls to about -4700, where
    float32 spaces its values 4.9e-4 apart: the same alphas rounded to
    float32 would move the gradient by over 5e-5 of its largest value (a
    float32 recurrence, rounding at every frame, by 1.8e-3 there), so the
    forward returns them in float64 and the backward takes them so."""
    rng = np.random.RandomState(6)
    t, v, u = 500, 10000, 100
    lp = torch.log_softmax(_t(rng.randn(1, t, v).astype(np.float32) * 2), -1)
    args = (lp, _t(rng.randint(4, v, (1, u)).astype(np.int32)),
            _t(np.array([t], np.int32)), _t(np.array([u], np.int32)))
    g = torch.ones(1)
    _, alphas = ctc_forward_alphas(*args)
    assert alphas.dtype == torch.float64
    assert float(alphas[0, -1].max()) < -4000
    want = ctc_loss_bwd_ref(*args, alphas, g)
    rounded = ctc_loss_bwd_ref(*args, alphas.float(), g)
    assert float((rounded - want).abs().max() / want.abs().max()) > 5e-5
