"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device: a CUDA
kernel has no CPU mode (the CPU tests hold the twins to the JAX package).
This file imports neither jax nor the JAX package, so it also runs on a
machine with only PyTorch; there, run it without the suite's conftest
(which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels_gpu.py

Tolerance 1e-4: float32 on both sides, the sums taken in other orders.
"""
import numpy as np
import pytest
import torch

from neural_sp_tpu_torch.ops.kernels import (
    las_step, las_step_ref, rel_attention, rel_attention_ref)

pytestmark = pytest.mark.gpu
TOL = 1e-4


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# Edge shapes of K1 / K1b's 64-row tiles: T not a multiple of 64, klens of
# 0, 1 and T, R = T (unclamped), every head width, and a grid (B x H x
# tiles) that leaves a partial last wave on 132 SMs at two blocks each.
REL_ATTENTION_SHAPES = [
    (2, 4, 70, 64, 11, [70, 33]),        # clamped, ragged, partial tiles
    (3, 2, 45, 32, 45, [45, 0, 17]),     # unclamped R = T, all-masked row
    (1, 8, 9, 16, 11, [9]),              # shorter than one tile
    (2, 3, 129, 64, 11, [129, 0]),       # one row past two tiles, klen 0
    (3, 2, 200, 32, 11, [1, 200, 77]),   # klen 1
    (2, 2, 200, 64, 200, [200, 150]),    # R = T at a multi-tile T
    (1, 2, 375, 16, 11, [375]),          # dk 16, the training T = 375
    (5, 11, 375, 64, 11, [375, 300, 64, 65, 1]),  # 330 blocks: partial wave
]


@pytest.mark.parametrize("b,h,t,dk,r,klens", REL_ATTENTION_SHAPES)
def test_rel_attention_kernel(cuda, b, h, t, dk, r, klens):
    rng = np.random.RandomState(t)

    def f(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).to(cuda)

    args = (f(b, h, t, dk, scale=dk ** -0.5), f(b, h, t, dk), f(b, h, t, dk),
            f(b, h, t, r, scale=dk ** -0.5),
            torch.tensor(klens, dtype=torch.int32, device=cuda))
    before = rel_attention.launches
    got = rel_attention(*args)
    torch.cuda.synchronize()
    assert rel_attention.launches == before + 1
    torch.testing.assert_close(got, rel_attention_ref(*args),
                               atol=TOL, rtol=TOL)


def test_rel_attention_kernel_refuses_bad_arguments(cuda):
    q = torch.zeros(1, 1, 8, 64, device=cuda)
    p = torch.zeros(1, 1, 8, 11, device=cuda)
    kl = torch.tensor([8], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        rel_attention(q.double(), q.double(), q.double(), p.double(), kl)
    with pytest.raises(ValueError, match="contiguous"):
        rel_attention(q.transpose(2, 3).contiguous().transpose(2, 3), q, q,
                      p, kl)
    with pytest.raises(ValueError, match="lie on the CPU or all on one"):
        rel_attention(q, q, q, p, kl.cpu())


@pytest.mark.parametrize("n,t,hd,d,a,ch,k", [
    (10, 200, 1024, 512, 512, 10, 201),   # flagship beam 10
    (17, 57, 64, 48, 40, 10, 201),        # > 16 rows, odd T, small widths
    (3, 30, 32, 24, 16, 4, 6),            # even conv width
])
def test_las_step_kernel(cuda, n, t, hd, d, a, ch, k):
    rng = np.random.RandomState(n)

    def f(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).to(cuda)

    aw = torch.softmax(f(n, t, scale=2.0), -1)
    klens = torch.from_numpy(np.maximum(t - 4 * np.arange(n), 0).astype(
        np.int32)).to(cuda)
    args = (f(n, 4 * hd), f(n, d), f(n, hd), f(n, hd), aw,
            f(d, 4 * hd, scale=(d + hd) ** -0.5),
            f(hd, 4 * hd, scale=(d + hd) ** -0.5), f(4 * hd, scale=0.1),
            f(a, hd, scale=hd ** -0.5), f(ch, k, scale=k ** -0.5),
            f(a, ch, scale=ch ** -0.5), f(a, scale=a ** -0.5),
            f(n, t, a), f(n, t, d), klens)
    before = las_step.launches
    outs = las_step(*args)
    torch.cuda.synchronize()
    assert las_step.launches == before + 1
    for name, got, want in zip(("h", "c", "aw", "ctx"), outs,
                               las_step_ref(*args)):
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL, msg=name)


# ---- training kernels: K1b, K3 / K3b, K4 -------------------------------
# Their outputs are sums over T (or over U reverse steps), so the error is
# held relative to the reference's largest magnitude: max|got - want| <=
# REL_TOL * max|want| (float32, sums in other orders).
REL_TOL = 1e-4


def _close(got, want, what=""):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max()) / scale
    assert err <= REL_TOL, f"{what}: relative error {err:.3e}"


def _randn(rng, dev, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)


@pytest.mark.parametrize("b,h,t,dk,r,klens", REL_ATTENTION_SHAPES)
def test_rel_attention_bwd_kernel(cuda, b, h, t, dk, r, klens):
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_bwd, rel_attention_bwd_ref, rel_attention_fwd,
        rel_attention_stats_ref)
    rng = np.random.RandomState(t)
    q, k, v = (_randn(rng, cuda, b, h, t, dk, scale=s)
               for s in (dk ** -0.5, 1.0, 1.0))
    p = _randn(rng, cuda, b, h, t, r, scale=dk ** -0.5)
    kl = torch.tensor(klens, dtype=torch.int32, device=cuda)
    do = _randn(rng, cuda, b, h, t, dk)
    o, m, l = rel_attention_fwd(q, k, v, p, kl)
    m_ref, l_ref = rel_attention_stats_ref(q, k, p, kl)
    _close(m, m_ref, "m")
    _close(l, l_ref, "l")
    before = rel_attention_bwd.launches
    got = rel_attention_bwd(q, k, v, p, kl, o, m, l, do)
    torch.cuda.synchronize()
    assert rel_attention_bwd.launches == before + 1
    want = rel_attention_bwd_ref(q, k, v, p, kl, o, m, l, do)
    for name, x, y in zip(("dq", "dk", "dv", "dp"), got, want):
        _close(x, y, name)


def test_sdpa_yardstick_bias_reproduces_rel_attention(cuda):
    """chip_smoke.py's library yardstick for K1: efficient SDPA with the
    rel-PE bias and key mask built as one [B, H, T, T] additive mask
    computes the plain version's function."""
    from chip_smoke import efficient_sdpa, rel_bias
    rng = np.random.RandomState(3)
    b, h, t, dk, r = 3, 4, 150, 64, 11
    q = _randn(rng, cuda, b, h, t, dk, scale=dk ** -0.5)
    k, v = _randn(rng, cuda, b, h, t, dk), _randn(rng, cuda, b, h, t, dk)
    p = _randn(rng, cuda, b, h, t, r, scale=dk ** -0.5)
    kl = torch.tensor([150, 97, 1], dtype=torch.int32, device=cuda)
    with efficient_sdpa():
        got = torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=rel_bias(torch, p, kl), scale=1.0)
    _close(got, rel_attention_ref(q, k, v, p, kl), "sdpa")


def test_rel_attention_bwd_refuses_bad_arguments(cuda):
    from neural_sp_tpu_torch.ops.kernels.rel_attention import rel_attention_bwd
    q = torch.zeros(1, 1, 8, 64, device=cuda)
    p = torch.zeros(1, 1, 8, 11, device=cuda)
    kl = torch.tensor([8], dtype=torch.int32, device=cuda)
    m = torch.zeros(1, 1, 8, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        rel_attention_bwd(q, q, q, p, kl, q, m[..., :4], m, q)
    with pytest.raises(ValueError, match="lie on the CPU or all on one"):
        rel_attention_bwd(q, q, q, p, kl, q, m, m, q.cpu())


def _las_args(rng, dev, b, u, t, hd, d, a, ch, k, klens, rate=0.1):
    keep = (torch.from_numpy((rng.rand(u, b, hd) >= rate).astype(np.float32))
            / (1 - rate)).to(dev)
    return (_randn(rng, dev, u, b, 4 * hd, scale=0.5),
            _randn(rng, dev, d, 4 * hd, scale=(d + hd) ** -0.5),
            _randn(rng, dev, hd, 4 * hd, scale=(d + hd) ** -0.5),
            _randn(rng, dev, 4 * hd, scale=0.1),
            _randn(rng, dev, a, hd, scale=hd ** -0.5),
            _randn(rng, dev, ch, k, scale=k ** -0.5),
            _randn(rng, dev, a, ch, scale=ch ** -0.5),
            _randn(rng, dev, a, scale=a ** -0.5),
            _randn(rng, dev, b, t, a), _randn(rng, dev, b, t, d),
            torch.tensor(klens, dtype=torch.int32, device=dev), keep)


# K3's tiles: 32 rows x 64 gate columns x 256 reduction rows per block of
# the gate product, 8 rows per query block, 16 frames per attention block
# (blocks past a row's length stop; a row with klen 0 runs over all T
# frames with uniform weights). K3b's: 16 frames per attention block, 8
# rows x 16 units per cell block, 32 rows x 64 weight rows x 256 gate
# columns per recurrent block; location-conv channels 10 at a time.
@pytest.mark.parametrize("b,u,t,hd,d,a,ch,k,klens", [
    (32, 12, 188, 1024, 512, 512, 10, 201, None),   # flagship widths
    (5, 7, 37, 64, 48, 40, 4, 6, [37, 30, 12, 1, 20]),  # small, even conv
    (33, 4, 189, 1024, 512, 512, 10, 201,           # B = 33, T = 189,
     [189 - 5 * i for i in range(32)] + [1]),       # a row with klen 1
    (32, 1, 188, 1024, 512, 512, 10, 201, None),    # U = 1: no recurrent step
    (3, 5, 177, 64, 48, 40, 4, 6, [177, 1, 100]),   # one frame past 11 tiles
    (4, 3, 40, 64, 48, 40, 12, 7, [40, 17, 1, 33]),  # C past one group of 10
    (3, 2, 50, 64, 48, 40, 23, 9, [50, 1, 31]),     # three groups, the last short
    (4, 3, 40, 64, 48, 40, 4, 6, [40, 0, 1, 35]),   # a row with klen 0
    (4, 3, 188, 1024, 512, 512, 10, 201,            # the same at flagship
     [188, 0, 1, 183]),                             # widths
    (5, 2, 33, 64, 48, 40, 4, 6,                    # one frame past 2 blocks:
     [33, 32, 0, 17, 16]),                          # the last block all masked
    (33, 2, 49, 30, 22, 18, 3, 5,                   # widths no multiple of 4,
     [49 - i for i in range(32)] + [0]),            # B = 33 with a klen 0
])
def test_las_scan_kernels(cuda, b, u, t, hd, d, a, ch, k, klens):
    from neural_sp_tpu_torch.ops.kernels.las_scan import (
        las_scan, las_scan_bwd, las_scan_bwd_ref, las_scan_ref)
    rng = np.random.RandomState(u)
    if klens is None:
        klens = [t - 3 * i for i in range(b)]
    args = _las_args(rng, cuda, b, u, t, hd, d, a, ch, k, klens)
    before = (las_scan.launches, las_scan_bwd.launches)
    outs = las_scan(*args)
    refs = las_scan_ref(*args)
    for name, x, y in zip(("h", "c", "gates", "q", "aw", "ctx"), outs, refs):
        _close(x, y, name)
    dh, dctx = _randn(rng, cuda, u, b, hd), _randn(rng, cuda, u, b, d)
    w_ctx, w_h, _, w_q, conv_w, w_f, v, kc, values, kl, keep = args[1:]
    saved = (w_ctx, w_h, w_q, conv_w, w_f, v, kc, values, kl, keep, *refs)
    got = las_scan_bwd(*saved, dh, dctx)
    torch.cuda.synchronize()
    assert (las_scan.launches, las_scan_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    # per step: gates, cell, query, attention per frame block, its combine
    assert las_scan.kernel_launches_per_call == 5 * u
    # per step: attention, conv, cell, and the recurrent product but at step 0
    assert las_scan_bwd.kernel_launches_per_call == 4 * u - 1
    want = las_scan_bwd_ref(*saved, dh, dctx)
    names = ("d_eg", "dW_ctx", "dW_h", "db", "dW_q", "dconv", "dW_f", "dv",
             "dkc", "dvalues")
    for name, x, y in zip(names, got, want):
        _close(x, y, name)


def test_las_scan_refuses_bad_arguments(cuda):
    from neural_sp_tpu_torch.ops.kernels.las_scan import las_scan
    rng = np.random.RandomState(0)
    args = list(_las_args(rng, cuda, 2, 3, 9, 8, 6, 4, 2, 3, [9, 4]))
    bad = list(args)
    bad[-2] = bad[-2].long()                      # klens must be int32
    with pytest.raises(TypeError):
        las_scan(*bad)
    bad = list(args)
    bad[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        las_scan(*bad)
    bad = list(args)
    bad[-1] = args[-1].cpu()
    with pytest.raises(ValueError, match="lie on the CPU or all on one"):
        las_scan(*bad)


@pytest.mark.parametrize("b,t,u,v,tl,ul", [
    (32, 188, 100, 10000, None, None),          # flagship training shape
    (4, 20, 6, 30, [20, 15, 9, 3], [6, 0, 5, 4]),  # U = 0, infeasible rows
])
def test_ctc_loss_kernel(cuda, b, t, u, v, tl, ul):
    from neural_sp_tpu_torch.ops.kernels.ctc_loss import (
        ctc_forward_alphas, ctc_loss_bwd, ctc_loss_bwd_ref, ctc_loss_fwd)
    rng = np.random.RandomState(t)
    lp = torch.log_softmax(_randn(rng, cuda, b, t, v, scale=2.0), -1)
    labels = rng.randint(4, v, (b, u))
    labels[0, 1] = labels[0, 0]                   # a repeated label
    if tl is None:
        tl = [t - i for i in range(b)]
        ul = [u - (i % 7) for i in range(b)]
    args = (lp, torch.tensor(labels, dtype=torch.int32, device=cuda),
            torch.tensor(tl, dtype=torch.int32, device=cuda),
            torch.tensor(ul, dtype=torch.int32, device=cuda))
    nll, alphas = ctc_loss_fwd(*args)
    nll_ref, alphas_ref = ctc_forward_alphas(*args)
    feasible = nll_ref < 1e29
    _close(nll[feasible], nll_ref[feasible], "nll")
    assert bool((nll[~feasible] >= 1e29).all())
    _close(alphas.clamp(min=-1e4), alphas_ref.clamp(min=-1e4), "alphas")
    g = feasible.float() * torch.linspace(0.5, 1.5, b, device=cuda)
    before = ctc_loss_bwd.launches
    grad = ctc_loss_bwd(*args, nll_ref, alphas_ref, g)
    torch.cuda.synchronize()
    assert ctc_loss_bwd.launches == before + 1
    _close(grad, ctc_loss_bwd_ref(*args, nll_ref, alphas_ref, g), "grad")


def test_ctc_loss_refuses_bad_arguments(cuda):
    from neural_sp_tpu_torch.ops.kernels.ctc_loss import ctc_loss_fwd
    lp = torch.zeros(2, 5, 7, device=cuda)
    lab = torch.ones(2, 3, dtype=torch.int32, device=cuda)
    lens = torch.tensor([5, 5], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ctc_loss_fwd(lp, lab.long(), lens, lens)
    with pytest.raises(ValueError, match="lie on the CPU or all on one"):
        ctc_loss_fwd(lp, lab, lens.cpu(), lens)
    with pytest.raises(ValueError, match="shared memory"):
        ctc_loss_fwd(lp, torch.ones(2, 40000, dtype=torch.int32,
                                    device=cuda), lens, lens)
