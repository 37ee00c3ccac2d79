"""Port parity: relative-position self-attention (kernel K1's module).

The same numpy inputs go through the JAX ``RelativeMultiheadAttention``
(pe_type 'relative', clamp 10) and the port's module, whose kernel wrapper
takes the plain PyTorch twin on CPU tensors. T=7 (<= clamp+1) runs the JAX
module's skew branch, T=40 its clamped one-hot branch; the port uses the
same (clamp+1)-row table for both. Tolerance: float32, atol = rtol = 2e-4
(the repo's, tests/test_parity_reference.py).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from neural_sp_tpu.models.modules.relative_multihead_attention import (
    RelativeMultiheadAttention as JaxRelMHA)
from neural_sp_tpu.ops.masks import make_pad_mask as jax_pad_mask, \
    make_san_mask as jax_san_mask
from neural_sp_tpu_torch.models.modules.relative_multihead_attention import (
    RelativeMultiheadAttention)
from neural_sp_tpu_torch.ops.kernels import rel_attention, rel_attention_ref
from neural_sp_tpu_torch.utils.convert_params import convert_params

ATOL = RTOL = 2e-4


def _dense_reference(q, k, v, p, klens):
    """Direct numpy loops over (b, h, i): the K1 formula written out."""
    b_, h_, t, _ = q.shape
    r = p.shape[-1]
    o = np.zeros_like(q, dtype=np.float64)
    neg = np.finfo(np.float32).min / 2
    for b in range(b_):
        for h in range(h_):
            for i in range(t):
                s = np.array([q[b, h, i] @ k[b, h, j]
                              + p[b, h, i, min(abs(i - j), r - 1)]
                              for j in range(t)], np.float64)
                s[np.arange(t) >= klens[b]] = neg
                w = np.exp(s - s.max())
                o[b, h, i] = (w / w.sum()) @ v[b, h]
    return o


@pytest.mark.parametrize("t,r,klens", [
    (9, 4, [9, 5, 1]),      # clamped table, ragged keys
    (6, 6, [6, 3, 2]),      # unclamped: R = T
    (5, 3, [5, 0, 2]),      # a row with every key masked -> uniform
])
def test_rel_attention_ref_matches_dense_formula(t, r, klens):
    rng = np.random.RandomState(t)
    q, k, v = (rng.randn(3, 2, t, 8).astype(np.float32) for _ in range(3))
    p = rng.randn(3, 2, t, r).astype(np.float32)
    kl = np.asarray(klens, np.int32)
    want = _dense_reference(q, k, v, p, kl)
    got = rel_attention_ref(*map(torch.from_numpy, (q, k, v, p, kl)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    if 0 in klens:   # all-masked row: uniform weights, finite
        b = klens.index(0)
        np.testing.assert_allclose(got[b].numpy(),
                                   np.broadcast_to(v[b].mean(1, keepdims=True),
                                                   v[b].shape), atol=1e-5)


def test_rel_attention_cpu_dispatch_is_the_twin():
    rng = np.random.RandomState(0)
    args = [torch.from_numpy(rng.randn(2, 2, 5, 16).astype(np.float32))
            for _ in range(3)]
    args += [torch.from_numpy(rng.randn(2, 2, 5, 3).astype(np.float32)),
             torch.tensor([5, 2], dtype=torch.int32)]
    before = rel_attention.launches
    assert torch.equal(rel_attention(*args), rel_attention_ref(*args))
    assert rel_attention.launches == before   # the twin is not a launch


def test_rel_attention_refuses_other_devices():
    """Neither the CPU twin nor a silent copy: a tensor that lies on no CPU
    and no CUDA device is refused."""
    args = [torch.empty(1, 1, 4, 16, device="meta") for _ in range(3)]
    args += [torch.empty(1, 1, 4, 3, device="meta"),
             torch.empty(1, dtype=torch.int32, device="meta")]
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        rel_attention(*args)


@pytest.mark.parametrize("t", [7, 40])
def test_relative_mha_parity(t):
    d, h, clamp = 64, 4, 10
    rng = np.random.RandomState(t)
    xs = rng.randn(3, t, d).astype(np.float32)
    xlens = np.array([t, t - 3, 2], np.int32)
    jm = JaxRelMHA(d_model=d, n_heads=h, clamp_len=clamp, xl_like=False)
    mask = jax_san_mask(jax_pad_mask(jnp.asarray(xlens), t))
    params = jm.init(jax.random.PRNGKey(t), jnp.asarray(xs), mask=mask)
    # non-zero biases, so w_value's bias on the position table is tested
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.randn(*x.shape).astype(
            np.float32), jax.tree.map(np.asarray, params))
    want, _, _ = jm.apply(params, jnp.asarray(xs), mask=mask)

    tm = RelativeMultiheadAttention(d, h, clamp_len=clamp)
    tm.load_state_dict(convert_params(params["params"]), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(xs), torch.from_numpy(xlens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


# ---- backward (K1b's plain version) -------------------------------------

@pytest.mark.parametrize("t,r,klens", [
    (9, 4, [9, 5, 1]),      # clamped table, ragged keys
    (6, 6, [6, 3, 2]),      # unclamped: R = T
    (5, 3, [5, 0, 2]),      # a row with every key masked: only dv flows
])
def test_rel_attention_bwd_ref_matches_autograd(t, r, klens):
    """The written-out adjoint against torch autograd through the plain
    forward, float64 (so the bound is rounding, 1e-10)."""
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_bwd_ref, rel_attention_fwd)
    rng = np.random.RandomState(t)
    q, k, v = (torch.from_numpy(rng.randn(3, 2, t, 8)).requires_grad_(True)
               for _ in range(3))
    p = torch.from_numpy(rng.randn(3, 2, t, r)).requires_grad_(True)
    kl = torch.tensor(klens, dtype=torch.int32)
    o = rel_attention_ref(q, k, v, p, kl)
    do = torch.from_numpy(rng.randn(*o.shape))
    want = torch.autograd.grad(o, (q, k, v, p), do)
    with torch.no_grad():
        o2, m, l = rel_attention_fwd(q, k, v, p, kl)
        got = rel_attention_bwd_ref(q, k, v, p, kl, o2, m, l, do)
    for name, x, y in zip(("dq", "dk", "dv", "dp"), got, want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-10,
                                   atol=1e-10, err_msg=name)


@pytest.mark.parametrize("t", [7, 40])
def test_relative_mha_grads_match_jax(t):
    """Gradients of the module (its backward on CPU is
    ``rel_attention_bwd_ref``) against ``jax.grad`` of the JAX module, for
    the input and every weight; tolerance relative to each leaf's largest
    magnitude (atol = 2e-4 of it, plus 1e-5 for w_key's bias, whose
    gradient is zero under the softmax's shift invariance, so what both
    sides give is the rounding left over from cancelling O(1) terms)."""
    d, h, clamp = 64, 4, 10
    rng = np.random.RandomState(t + 1)
    xs = rng.randn(3, t, d).astype(np.float32)
    xlens = np.array([t, t - 3, 2], np.int32)
    dout = rng.randn(3, t, d).astype(np.float32)
    jm = JaxRelMHA(d_model=d, n_heads=h, clamp_len=clamp, xl_like=False)
    mask = jax_san_mask(jax_pad_mask(jnp.asarray(xlens), t))
    params = jm.init(jax.random.PRNGKey(t), jnp.asarray(xs), mask=mask)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.randn(*x.shape).astype(
            np.float32), jax.tree.map(np.asarray, params))

    def jloss(p, x):
        out, _, _ = jm.apply(p, x, mask=mask)
        return jnp.sum(out * dout)

    g_p, g_x = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(xs))
    tm = RelativeMultiheadAttention(d, h, clamp_len=clamp)
    tm.load_state_dict(convert_params(params["params"]), strict=True)
    x = torch.from_numpy(xs).requires_grad_(True)
    (tm(x, torch.from_numpy(xlens)) * torch.from_numpy(dout)).sum().backward()
    want = convert_params(jax.tree.map(np.asarray, g_p["params"]))
    pairs = [("input", x.grad, np.asarray(g_x))] + [
        (n, p_.grad, want[n].numpy()) for n, p_ in tm.named_parameters()]
    for name, got, w in pairs:
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=ATOL * scale + 1e-5, err_msg=name)
