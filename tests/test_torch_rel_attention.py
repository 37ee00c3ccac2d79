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


# ------------------------- K1 / K1b plain: memory keys and dropout (XL)
@pytest.mark.parametrize("tq,tk,r,rate", [
    (5, 9, 9, 0.0),         # a segment against memory, unclamped (R = Tk)
    (5, 9, 9, 0.3),         # ... with dropout of the probabilities
    (4, 11, 3, 0.5),        # clamped table
    (1, 7, 7, 0.2),         # one query: a decode step against memory
    (6, 6, 6, 0.4),         # no memory yet
])
def test_rel_attention_memory_plain_backward_matches_autograd(tq, tk, r,
                                                              rate):
    """Tq < Tk under the causal window (query i at key i + Tk - Tq), with
    and without dropout: the written-out adjoint against autograd through
    the plain forward, float64; the autograd function takes both on CPU
    tensors."""
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_bwd_ref, rel_attention_stats_ref)
    from neural_sp_tpu_torch.ops.masks import CAUSAL
    rng = np.random.RandomState(tq * tk)

    def f(*shape):
        return torch.from_numpy(rng.randn(*shape)).requires_grad_()
    b, h, dk = 2, 3, 8
    q, p = f(b, h, tq, dk), f(b, h, tq, r)
    k, v = f(b, h, tk, dk), f(b, h, tk, dk)
    kl = torch.full((b,), tk, dtype=torch.int32)
    drop = (rate, (0x9E3779B9, 12345 + tq)) if rate else None
    o = rel_attention_ref(q, k, v, p, kl, CAUSAL, dropout=drop)
    do = torch.from_numpy(rng.randn(b, h, tq, dk))
    want = torch.autograd.grad(o, (q, k, v, p), do)
    with torch.no_grad():
        m, l = rel_attention_stats_ref(q, k, p, kl, CAUSAL)
        got = rel_attention_bwd_ref(q, k, v, p, kl, o, m, l, do, CAUSAL,
                                    drop)
    for name, x, y in zip(("dq", "dk", "dv", "dp"), got, want):
        torch.testing.assert_close(x, y, rtol=1e-9, atol=1e-10, msg=name)
    o2 = rel_attention(q, k, v, p, kl, CAUSAL, 0, drop)
    got2 = torch.autograd.grad(o2, (q, k, v, p), do)
    torch.testing.assert_close(o2, o)
    for x, y in zip(got2, want):
        torch.testing.assert_close(x, y, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("key", [(0x12345678, 0x9ABCDEF0), (7, 0xFFFFFFFF)])
def test_attention_dropout_is_jax_fast_uniform(key):
    """The keep mask is JAX's ``fast_bernoulli(key, 1 - rate)`` bit for
    bit over the row-major [B, H, Tq, Tk] index, and the plain K1 with
    dropout is where(mask, P / keep, 0) v, as the JAX module's Dropout on
    its attention weights."""
    from neural_sp_tpu.ops.dropout import fast_uniform as jax_fast_uniform
    from neural_sp_tpu_torch.ops.dropout import fast_uniform
    from neural_sp_tpu_torch.ops.kernels.rel_attention import attention_keep
    from neural_sp_tpu_torch.ops.masks import CAUSAL
    shape, rate = (2, 3, 5, 9), 0.3
    jkey = jnp.asarray(key, jnp.uint32)
    np.testing.assert_array_equal(
        fast_uniform(key, shape).numpy(),
        np.asarray(jax_fast_uniform(jkey, shape)))
    keep = np.asarray(jax_fast_uniform(jkey, shape)) < 1.0 - rate
    np.testing.assert_array_equal(
        attention_keep((rate, key), shape).numpy(), keep)
    rng = np.random.RandomState(9)
    q, p = rng.randn(2, 3, 5, 8), rng.randn(2, 3, 5, 9)
    k, v = rng.randn(2, 3, 9, 8), rng.randn(2, 3, 9, 8)
    kl = torch.full((2,), 9, dtype=torch.int32)
    t = [torch.from_numpy(x) for x in (q, k, v, p)]
    # P from the dense formula: s = q k^T + p[|i + 4 - j|], causal
    s = np.einsum("bhid,bhjd->bhij", q, k)
    i, j = np.arange(5)[:, None] + 4, np.arange(9)[None]
    s = s + np.take_along_axis(p, np.broadcast_to(np.abs(i - j),
                                                  (2, 3, 5, 9)), -1)
    s = np.where(j <= i, s, -np.inf)
    prob = np.exp(s - s.max(-1, keepdims=True))
    prob /= prob.sum(-1, keepdims=True)
    want = np.where(keep, prob / (1 - rate), 0.0) @ v
    got = rel_attention_ref(*t, kl, CAUSAL, dropout=(rate, key))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
