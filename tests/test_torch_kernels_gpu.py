"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device: a CUDA
kernel has no CPU mode (the CPU tests hold the twins to the JAX package).
This file imports neither jax nor the JAX package, so it also runs on a
machine with only PyTorch; there, run it without the suite's conftest
(which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels_gpu.py

Tolerance 1e-4: float32 on both sides, the sums taken in other orders;
1e-2 for the bf16 entries of K1 / K1b against their plain bf16 versions.
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
    (10, 400, 1024, 1024, 512, 10, 201),  # BLSTM-LAS beam 10: D = 1024
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


def _randn(rng, dev, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)


def _step_inputs(rng, dev, n, t, hd, d, a, ch, k, klens):
    def f(*shape, scale=1.0):
        return _randn(rng, dev, *shape, scale=scale)

    state = (f(n, 4 * hd), f(n, d), f(n, hd), f(n, hd),
             torch.softmax(f(n, t, scale=2.0), -1))
    fixed = (f(d, 4 * hd, scale=(d + hd) ** -0.5),
             f(hd, 4 * hd, scale=(d + hd) ** -0.5), f(4 * hd, scale=0.1),
             f(a, hd, scale=hd ** -0.5), f(ch, k, scale=k ** -0.5),
             f(a, ch, scale=ch ** -0.5), f(a, scale=a ** -0.5),
             f(n, t, a), f(n, t, d),
             torch.tensor(klens, dtype=torch.int32, device=dev))
    return state, fixed


def _parents(n):
    perm = np.random.RandomState(n).permutation(n)
    return {"none": None, "identity": list(range(n)),
            "permutation": perm.tolist(), "all-equal": [n - 1] * n}


# K2's tiles: the gate product for up to 16 rows in registers (4, 8, 12 or
# 16 rows), more rows 32 at a time; one query row group per 16 rows; a
# block per 16 frames of a row, the last of a row's blocks to finish doing
# the row's softmax (two kernels where a row has more blocks than its block
# has room for). klens None: ragged from T down; a row with klen 0 gets
# uniform weights over all T frames.
@pytest.mark.parametrize("n,t,hd,d,a,ch,k,klens", [
    (10, 200, 1024, 512, 512, 10, 201, None),     # flagship beam 10
    (1, 200, 1024, 512, 512, 10, 201, None),      # greedy, one utterance
    (4, 200, 1024, 512, 512, 10, 201, [200, 163, 125, 88]),  # greedy batch
    (16, 256, 64, 48, 40, 10, 201, None),         # the largest cluster
    (17, 257, 64, 48, 40, 4, 6, None),            # one past both limits
    (33, 15, 64, 48, 40, 4, 6, None),             # 32-row gates, one block
    (40, 200, 1024, 512, 512, 10, 201, None),     # 4 utterances x beam 10
    (3, 1, 32, 24, 16, 4, 6, [1, 1, 0]),          # T = 1
    (5, 16, 32, 24, 16, 4, 6, [16, 15, 1, 0, 8]),  # exactly one block
    (5, 17, 32, 24, 16, 4, 6, [17, 16, 1, 0, 9]),  # one frame past a block
    (6, 600, 64, 48, 40, 4, 6, [600, 0, 1, 300, 16, 599]),  # 38 blocks a row
    (3, 15000, 32, 24, 16, 4, 6, [15000, 0, 7001]),  # attention in two kernels
    (5, 33, 64, 48, 40, 4, 6, [33, 32, 0, 17, 16]),  # last block all masked
    (10, 49, 30, 22, 18, 3, 5, None),             # widths no multiple of 4
    (12, 40, 64, 48, 40, 12, 7, None),            # C past one group of 10
    (9, 50, 64, 48, 40, 23, 9, None),             # three groups of channels
])
def test_las_step_beam_shapes(cuda, n, t, hd, d, a, ch, k, klens):
    from neural_sp_tpu_torch.ops.kernels.las_step import LasStepWorkspace
    rng = np.random.RandomState(n + t)
    if klens is None:
        klens = [max(t - 3 * i, 0) for i in range(n)]
    state, fixed = _step_inputs(rng, cuda, n, t, hd, d, a, ch, k, klens)
    for what, parent in _parents(n).items():
        par = None if parent is None else torch.tensor(
            parent, dtype=torch.int32, device=cuda)
        before = las_step.launches
        outs = las_step(*state, *fixed, parent=par)
        ws = LasStepWorkspace(*fixed)
        ws.load_carry(*state[1:])
        ws.eg.copy_(state[0])
        if par is not None:
            ws.parent.copy_(par)
        twice = [ws.step(use_parent=par is not None)]
        # a second step from the same carry into the other set
        ws.cur ^= 1
        ws.load_carry(*state[1:])
        twice.append(ws.step(use_parent=par is not None))
        torch.cuda.synchronize()
        assert las_step.launches == before + 3
        # the attention's blocks of 16 frames per row against the floats of
        # shared memory its block has for their scales
        room = 16 * (a + d) + ch * k + 16 + k - 1 + 16 * ch + 16 + 8 * 16
        assert las_step.kernels_per_step == (4 if -(-t // 16) <= room else 5)
        refs = las_step_ref(*state, *fixed, parent=par)
        for name, got, want, w0, w1 in zip(("h", "c", "aw", "ctx"), outs,
                                           refs, *twice):
            torch.testing.assert_close(got, want, atol=TOL, rtol=TOL,
                                       msg=f"{what}: {name}")
            assert torch.equal(w0, got) and torch.equal(w1, got), \
                f"{what}: the workspace's {name} differs from the plain call"


def test_las_step_workspace_threads_its_carry(cuda):
    """Five steps through the workspace, reordered between steps, against
    the plain version threaded the same way."""
    from neural_sp_tpu_torch.ops.kernels.las_step import LasStepWorkspace
    rng = np.random.RandomState(11)
    n, t, hd, d, a, ch, k = 10, 200, 1024, 512, 512, 10, 201
    state, fixed = _step_inputs(rng, cuda, n, t, hd, d, a, ch, k,
                                [t - 7 * i for i in range(n)])
    ws = LasStepWorkspace(*fixed)
    zero = [torch.zeros_like(x) for x in state[1:]]
    ctx, h, c, aw = zero
    for step in range(5):
        eg = _randn(rng, cuda, n, 4 * hd, scale=0.5)
        par = None if step == 0 else torch.from_numpy(
            rng.randint(0, n, n).astype(np.int32)).to(cuda)
        ws.eg.copy_(eg)
        if par is not None:
            ws.parent.copy_(par)
        got = ws.step(use_parent=par is not None)
        h, c, aw, ctx = las_step_ref(eg, ctx, h, c, aw, *fixed, parent=par)
        for name, x, y in zip(("h", "c", "aw", "ctx"), got, (h, c, aw, ctx)):
            torch.testing.assert_close(x, y, atol=TOL, rtol=TOL,
                                       msg=f"step {step}: {name}")
    assert las_step.kernels_per_step == 4


@pytest.mark.parametrize("n,t,d", [(32, 188, 512), (10, 200, 512),
                                   (17, 57, 512), (32, 500, 1024)])
def test_las_step_keep(cuda, n, t, d):
    """K2 with a dropout scale ``keep`` (the query reads h keep, the carry
    keeps h), the checked call and the workspace, against ``las_step_ref``
    with the same keep over three threaded steps; all-ones keep gives the
    same bits as none. N = 32 is the scheduled-sampling pass of a training
    microbatch (more than 16 rows: K3's gate kernel)."""
    from neural_sp_tpu_torch.ops.kernels.las_step import LasStepWorkspace
    rng = np.random.RandomState(n + t)
    hd, a, ch, k = 1024, 512, 10, 201
    state, fixed = _step_inputs(rng, cuda, n, t, hd, d, a, ch, k,
                                [max(t - 5 * i, 1) for i in range(n)])
    ws = LasStepWorkspace(*fixed)
    ctx, h, c, aw = (torch.zeros_like(x) for x in state[1:])
    for step in range(3):
        eg = _randn(rng, cuda, n, 4 * hd, scale=0.5)
        keep = (torch.from_numpy((rng.rand(n, hd) >= 0.1).astype(np.float32))
                / 0.9).to(cuda)
        checked = las_step(eg, ctx, h, c, aw, *fixed, keep=keep)
        ws.eg.copy_(eg)
        ws.load_carry(ctx, h, c, aw)
        got = ws.step(keep=keep)
        want = las_step_ref(eg, ctx, h, c, aw, *fixed, keep=keep)
        for name, x, y, z in zip(("h", "c", "aw", "ctx"), got, checked,
                                 want):
            torch.testing.assert_close(x, z, atol=TOL, rtol=TOL,
                                       msg=f"step {step}: {name}")
            assert torch.equal(x, y), f"step {step}: {name}, the two forms"
        h, c, aw, ctx = want
    ones = torch.ones_like(h)
    for x, y in zip(las_step(eg, ctx, h, c, aw, *fixed, keep=ones),
                    las_step(eg, ctx, h, c, aw, *fixed)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        las_step(eg, ctx, h, c, aw, *fixed, keep=ones[:, :-1])
    with pytest.raises(TypeError):
        ws.step(keep=ones.double())


@pytest.mark.parametrize("n,reorder", [(40, True), (10, True), (4, True),
                                       (4, False), (17, True)])
def test_decode_loop_against_the_plain_chain(cuda, n, reorder):
    """A ``DecodeLoop`` on the card (the carry in K2's workspace, random
    ``parent`` rows) against the chain of plain decode steps on the same
    tokens and parents, for six steps: logits and attention weights at
    every step, and one K2 launch counted per step."""
    from unittest import mock
    from neural_sp_tpu_torch.models.decoders import las
    from neural_sp_tpu_torch.utils.init_params import init_params
    dec = las.RNNDecoder(vocab=50, enc_n_units=48, n_units=64, emb_dim=32,
                         bottleneck_dim=64, attn_dim=40).to(cuda)
    init_params(dec, n).eval()
    rng = np.random.RandomState(n)
    t = 70
    e = _randn(rng, cuda, n, t, 48)
    klens = torch.tensor([max(t - 5 * i, 0) for i in range(n)],
                         dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        kc = dec.precompute_keys(e)
        loop = dec.decode_loop(kc, e, klens)
        carry = dec.init_carry(n, t, cuda)
        before, steps = las_step.launches, las.DecodeLoop.steps
        par = None
        for i in range(6):
            y = torch.from_numpy(rng.randint(0, 50, n)).to(cuda)
            if reorder and i > 0:
                par = torch.from_numpy(
                    rng.randint(0, n, n).astype(np.int32)).to(cuda)
            logits, aw = loop.step(y, par)
            with mock.patch.object(las, "las_step", las_step_ref):
                carry, logits_ref, aw_ref = dec.decode_step(
                    carry, y, kc, e, klens, parent=par)
            torch.testing.assert_close(logits, logits_ref, atol=TOL, rtol=TOL,
                                       msg=f"step {i}: logits")
            torch.testing.assert_close(aw, aw_ref, atol=TOL, rtol=TOL,
                                       msg=f"step {i}: aw")
    assert las_step.launches == before + 6
    assert las.DecodeLoop.steps == steps + 6


def test_las_step_refuses_bad_arguments(cuda):
    rng = np.random.RandomState(0)
    state, fixed = _step_inputs(rng, cuda, 2, 9, 8, 6, 4, 2, 3, [9, 4])
    par = torch.tensor([1, 0], device=cuda)          # int64
    with pytest.raises(TypeError):
        las_step(*state, *fixed, parent=par)
    with pytest.raises(ValueError, match="lie on the CPU or all on one"):
        las_step(*state, *fixed, parent=par.int().cpu())
    with pytest.raises(ValueError, match="shape"):
        las_step(*state, *fixed, parent=par.int()[:1])


# ---- training kernels: K1b, K3 / K3b, K4 -------------------------------
# Their outputs are sums over T (or over U reverse steps), so the error is
# held relative to the reference's largest magnitude: max|got - want| <=
# REL_TOL * max|want| (float32, sums in other orders).
REL_TOL = 1e-4


def _close(got, want, what=""):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max()) / scale
    assert err <= REL_TOL, f"{what}: relative error {err:.3e}"


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


# ---- K1 / K1b bf16 entries ------------------------------------------------
# Against the plain versions at bf16, which round P and ds at the kernels'
# points: max|got - want| <= BF16_TOL * max|want| (bf16 outputs, 8
# significant bits; the sums in other orders). m and l are float32 sums of
# the float32 scores, held as the float32 kernel's (REL_TOL). Shapes: klen
# 0, 1 and ragged; dk 16, 32, 64; odd T; B = 33; R > 16 (dp's bucket sums
# outside shared memory); a partial last wave.
BF16_TOL = 1e-2
BF16_SHAPES = [
    (2, 4, 70, 64, 11, [70, 33]),        # ragged, partial tiles
    (3, 2, 45, 32, 45, [45, 0, 17]),     # R = T > 16, klen 0, odd T
    (1, 8, 9, 16, 11, [9]),              # shorter than one tile
    (2, 3, 129, 64, 11, [129, 0]),       # one row past two tiles, klen 0
    (3, 2, 201, 32, 11, [1, 201, 77]),   # klen 1, odd T
    (33, 2, 75, 64, 11, [75 - (i * 2) % 70 for i in range(33)]),  # B = 33
    (2, 2, 200, 64, 200, [200, 150]),    # R = T at a multi-tile T
    (1, 2, 375, 16, 11, [375]),          # dk 16, the training T = 375
    (5, 11, 375, 64, 11, [375, 300, 64, 65, 1]),  # partial wave
]


def _bf16_args(cuda, b, h, t, dk, r, klens):
    rng = np.random.RandomState(t + b)
    q, k, v = (_randn(rng, cuda, b, h, t, dk, scale=s).to(torch.bfloat16)
               for s in (dk ** -0.5, 1.0, 1.0))
    p = _randn(rng, cuda, b, h, t, r, scale=dk ** -0.5).to(torch.bfloat16)
    do = _randn(rng, cuda, b, h, t, dk).to(torch.bfloat16)
    return (q, k, v, p, torch.tensor(klens, dtype=torch.int32, device=cuda),
            do)


def _close_bf16(got, want, what):
    assert got.dtype == want.dtype
    scale = max(float(want.float().abs().max()), 1e-30)
    err = float((got.float() - want.float()).abs().max()) / scale
    assert err <= BF16_TOL, f"{what}: relative error {err:.3e}"


@pytest.mark.parametrize("b,h,t,dk,r,klens", BF16_SHAPES)
def test_rel_attention_bf16_kernel(cuda, b, h, t, dk, r, klens):
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_fwd, rel_attention_stats_ref)
    q, k, v, p, kl, _ = _bf16_args(cuda, b, h, t, dk, r, klens)
    before = (rel_attention.launches, rel_attention.launches_bf16)
    o, m, l = rel_attention_fwd(q, k, v, p, kl)
    torch.cuda.synchronize()
    assert (rel_attention.launches, rel_attention.launches_bf16) == \
        (before[0], before[1] + 1)
    assert (o.dtype, m.dtype, l.dtype) == (torch.bfloat16, torch.float32,
                                           torch.float32)
    _close_bf16(o, rel_attention_ref(q, k, v, p, kl), "o")
    m_ref, l_ref = rel_attention_stats_ref(q, k, p, kl)
    _close(m, m_ref, "m")
    _close(l, l_ref, "l")


@pytest.mark.parametrize("b,h,t,dk,r,klens", BF16_SHAPES)
def test_rel_attention_bwd_bf16_kernel(cuda, b, h, t, dk, r, klens):
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_bwd, rel_attention_bwd_ref, rel_attention_fwd)
    q, k, v, p, kl, do = _bf16_args(cuda, b, h, t, dk, r, klens)
    o, m, l = rel_attention_fwd(q, k, v, p, kl)
    before = (rel_attention_bwd.launches, rel_attention_bwd.launches_bf16)
    got = rel_attention_bwd(q, k, v, p, kl, o, m, l, do)
    torch.cuda.synchronize()
    assert (rel_attention_bwd.launches, rel_attention_bwd.launches_bf16) == \
        (before[0], before[1] + 1)
    want = rel_attention_bwd_ref(q, k, v, p, kl, o, m, l, do)
    for name, x, y in zip(("dq", "dk", "dv", "dp"), got, want):
        _close_bf16(x, y, name)
    # deterministic: no atomics whose order changes between runs
    again = rel_attention_bwd(q, k, v, p, kl, o, m, l, do)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("t", [188, 750])
def test_rel_attention_bf16_rounds_p_where_the_plain_version_does(cuda, t):
    """With near-uniform attention every P of a row rounds the same way, so
    where P is rounded (after the 1 / l, as the TPU kernel) sets a coherent
    error in o. The kernel and the plain version round at the same point:
    their outputs differ by sum order alone, far less than either differs
    from the float32 output (L2)."""
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_fwd)
    rng = np.random.RandomState(t)
    b, h, dk, r = 4, 8, 64, 11
    q, p = (_randn(rng, cuda, b, h, t, n, scale=1e-2).to(torch.bfloat16)
            for n in (dk, r))
    k, v = (_randn(rng, cuda, b, h, t, dk).to(torch.bfloat16)
            for _ in range(2))
    kl = torch.full((b,), t, dtype=torch.int32, device=cuda)
    got = rel_attention_fwd(q, k, v, p, kl)[0].float()
    plain = rel_attention_ref(q, k, v, p, kl).float()
    f32 = rel_attention_ref(*(x.float() for x in (q, k, v, p)), kl)
    norm = torch.linalg.vector_norm
    assert float(norm(got - plain)) <= 0.1 * float(norm(plain - f32))


def test_rel_attention_bf16_refuses_bad_arguments(cuda):
    """Mixed types, other types and a misaligned bf16 tensor raise: a bf16
    tensor is never cast to float32 around the kernels."""
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_bwd, rel_attention_fwd)
    bf = torch.bfloat16
    q = torch.zeros(1, 1, 8, 64, device=cuda, dtype=bf)
    p = torch.zeros(1, 1, 8, 11, device=cuda, dtype=bf)
    kl = torch.tensor([8], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        rel_attention(q, q.float(), q, p, kl)
    with pytest.raises(TypeError):
        rel_attention(q, q, q, p.float(), kl)
    with pytest.raises(TypeError):
        rel_attention(*(x.half() for x in (q, q, q, p)), kl)
    shifted = torch.zeros(q.numel() + 1, device=cuda, dtype=bf)[1:].view(
        q.shape)
    with pytest.raises(ValueError, match="aligned"):
        rel_attention(shifted, q, q, p, kl)
    o, m, l = rel_attention_fwd(q, q, q, p, kl)
    with pytest.raises(TypeError):
        rel_attention_bwd(q, q, q, p, kl, o, m, l, q.float())
    with pytest.raises(ValueError, match="aligned"):
        rel_attention_bwd(q, q, q, p, kl, o, m, l, shifted)


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
    (32, 101, 500, 1024, 1024, 512, 10, 201,        # BLSTM-LAS: D = 1024,
     [500 - 9 * i for i in range(32)]),             # T up to 500
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
    (32, 500, 100, 10000, None, None),          # BLSTM-LAS: T = 500
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
    grad = ctc_loss_bwd(*args, alphas_ref, g)
    torch.cuda.synchronize()
    assert ctc_loss_bwd.launches == before + 1
    _close(grad, ctc_loss_bwd_ref(*args, alphas_ref, g), "grad")
    # from the kernel's own alphas too
    _close(ctc_loss_bwd(*args, alphas, g), grad, "grad from K4's alphas")


def _ctc_case(name):
    """(T, U, V, labels [B, U], frame lengths, label lengths) of an edge
    case of K4; its kernels hold 2U + 1 <= 4096 states, 1, 2, 4, 8 or 16
    per thread of a block of 256."""
    rng = np.random.RandomState(len(name))
    if name == "no labels":                        # U_b = 0: blanks only
        return 9, 2, 7, rng.randint(1, 7, (3, 2)), [9, 1, 5], [0, 0, 1]
    if name == "one frame":                        # T_b = 1 and T_b = 0
        return 6, 3, 11, rng.randint(1, 11, (4, 3)), [1, 6, 0, 2], [1, 3, 0, 1]
    if name == "repeated labels":                  # no skip between equals
        lab = np.repeat(rng.randint(1, 9, (3, 6)), 2, axis=1)
        return 40, 12, 9, lab, [40, 31, 25], [12, 12, 9]
    if name == "few symbols":                      # V = 5: blanks weigh much
        return 50, 14, 5, rng.randint(1, 5, (5, 14)), [50, 44, 29, 50, 15], \
            [14, 10, 14, 1, 7]
    if name == "ids outside the vocabulary":       # emit 0, no gradient
        lab = rng.randint(1, 20, (3, 8))
        lab[0, 2], lab[1, 0], lab[2, 7] = 20, -3, 1000
        return 30, 8, 20, lab, [30, 30, 22], [8, 8, 8]
    if name == "label 0":                          # a label with the blank's id
        lab = rng.randint(0, 6, (3, 10))
        lab[:, 3] = 0
        return 40, 10, 6, lab, [40, 35, 28], [10, 7, 10]
    if name == "256 states":                       # the last one a thread
        return 140, 127, 50, rng.randint(1, 50, (4, 127)), \
            [140, 135, 140, 40], [127, 126, 17, 127]
    if name == "511 states":                       # two a thread
        return 300, 255, 300, rng.randint(1, 300, (2, 255)), [300, 290], \
            [255, 254]
    if name == "601 states":                       # four a thread
        return 320, 300, 400, rng.randint(1, 400, (2, 300)), [320, 310], \
            [300, 250]
    if name == "1041 states":                      # eight a thread
        return 560, 520, 300, rng.randint(1, 300, (2, 520)), [560, 541], \
            [520, 400]
    if name == "2499 states":                      # sixteen a thread
        return 1300, 1249, 40, rng.randint(1, 40, (2, 1249)), [1300, 1290], \
            [1249, 1100]
    if name == "many utterances":                  # more blocks than SMs
        return 25, 6, 30, rng.randint(1, 30, (300, 6)), \
            [25 - i % 20 for i in range(300)], [6 - i % 7 for i in range(300)]
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "no labels", "one frame", "repeated labels", "few symbols",
    "ids outside the vocabulary", "label 0", "256 states", "511 states",
    "601 states", "1041 states", "2499 states", "many utterances"])
def test_ctc_loss_kernel_edges(cuda, name):
    from neural_sp_tpu_torch.ops.kernels.ctc_loss import (
        ctc_forward_alphas, ctc_loss_bwd, ctc_loss_bwd_ref, ctc_loss_fwd)
    t, u, v, labels, tl, ul = _ctc_case(name)
    b = len(tl)
    rng = np.random.RandomState(t)
    lp = torch.log_softmax(_randn(rng, cuda, b, t, v, scale=2.0), -1)
    args = (lp, torch.tensor(labels, dtype=torch.int32, device=cuda).view(b, u),
            torch.tensor(tl, dtype=torch.int32, device=cuda),
            torch.tensor(ul, dtype=torch.int32, device=cuda))
    nll, alphas = ctc_loss_fwd(*args)
    ref_args = args
    if name == "ids outside the vocabulary":
        # the plain version gathers, so it is given what "emits 0" means: a
        # column of zeros past the vocabulary that every such id points to
        bad = (args[1] < 0) | (args[1] >= v)
        ref_args = (torch.cat([lp, torch.zeros_like(lp[..., :1])], -1),
                    torch.where(bad, torch.full_like(args[1], v), args[1]),
                    *args[2:])
    nll_ref, alphas_ref = ctc_forward_alphas(*ref_args)
    feasible = nll_ref < 1e29
    if bool(feasible.any()):
        _close(nll[feasible], nll_ref[feasible], "nll")
    assert bool((nll[~feasible] >= 1e29).all())
    _close(alphas.clamp(min=-1e4), alphas_ref.clamp(min=-1e4), "alphas")
    g = feasible.float() * torch.linspace(0.5, 1.5, b, device=cuda)
    grad = ctc_loss_bwd(*args, alphas_ref, g)
    torch.cuda.synchronize()
    grad_ref = ctc_loss_bwd_ref(*ref_args, alphas_ref, g)
    _close(grad, grad_ref[..., :v], "grad")


@pytest.mark.parametrize("name", ["flagship", "repeated labels", "label 0",
                                  "few symbols", "2499 states"])
def test_ctc_loss_bwd_is_deterministic(cuda, name):
    """K4's gradient is the same bits in every call: the states that share
    an id (the blanks, repeated labels, a label of id 0) are summed in a
    fixed order, with no float atomics."""
    from neural_sp_tpu_torch.ops.kernels.ctc_loss import (
        ctc_loss_bwd, ctc_loss_fwd)
    if name == "flagship":
        b, t, u, v = 32, 188, 100, 10000
        rng = np.random.RandomState(0)
        labels = rng.randint(4, v, (b, u))
        labels[:, 10:13] = labels[:, 40:41]       # an id three times a row
        tl, ul = [t - i for i in range(b)], [u - (i % 7) for i in range(b)]
    else:
        t, u, v, labels, tl, ul = _ctc_case(name)
        b = len(tl)
        rng = np.random.RandomState(t)
    lp = torch.log_softmax(_randn(rng, cuda, b, t, v, scale=2.0), -1)
    args = (lp, torch.tensor(labels, dtype=torch.int32, device=cuda).view(b, u),
            torch.tensor(tl, dtype=torch.int32, device=cuda),
            torch.tensor(ul, dtype=torch.int32, device=cuda))
    nll, alphas = ctc_loss_fwd(*args)
    g = torch.linspace(0.5, 1.5, b, device=cuda) * (nll < 1e29).float()
    first = ctc_loss_bwd(*args, alphas, g)
    for _ in range(3):
        assert torch.equal(ctc_loss_bwd(*args, alphas, g), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_kernels_are_deterministic(cuda, dtype):
    """K1b (both entries) and K3b at the flagship's training shapes give the
    same bits twice on the same inputs (no float atomics whose order could
    change: K1b's near dp buckets take two addends onto zero, K3b adds once
    per element per launch, in launch order)."""
    from neural_sp_tpu_torch.ops.kernels.las_scan import (
        las_scan, las_scan_bwd)
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_bwd, rel_attention_fwd)
    rng = np.random.RandomState(5)
    b, h, t, dk, r = 32, 8, 375, 64, 11
    q, k, v, do = (_randn(rng, cuda, b, h, t, dk, scale=dk ** -0.5).to(dtype)
                   for _ in range(4))
    p = _randn(rng, cuda, b, h, t, r, scale=dk ** -0.5).to(dtype)
    kl = torch.tensor([t - 7 * i for i in range(b)], dtype=torch.int32,
                      device=cuda)
    o, m, l = rel_attention_fwd(q, k, v, p, kl)
    first = rel_attention_bwd(q, k, v, p, kl, o, m, l, do)
    for x, y in zip(rel_attention_bwd(q, k, v, p, kl, o, m, l, do), first):
        assert torch.equal(x, y)
    if dtype != torch.float32:
        return
    args = _las_args(rng, cuda, 32, 12, 188, 1024, 512, 512, 10, 201,
                     [188 - 3 * i for i in range(32)])
    outs = las_scan(*args)
    w_ctx, w_h, _, w_q, conv_w, w_f, vv, kc, values, kl, keep = args[1:]
    saved = (w_ctx, w_h, w_q, conv_w, w_f, vv, kc, values, kl, keep, *outs)
    dh, dctx = _randn(rng, cuda, 12, 32, 1024), _randn(rng, cuda, 12, 32, 512)
    first = las_scan_bwd(*saved, dh, dctx)
    for x, y in zip(las_scan_bwd(*saved, dh, dctx), first):
        assert torch.equal(x, y)


def test_ctc_loss_refuses_bad_arguments(cuda):
    from neural_sp_tpu_torch.ops.kernels.ctc_loss import ctc_loss_fwd
    lp = torch.zeros(2, 5, 7, device=cuda)
    lab = torch.ones(2, 3, dtype=torch.int32, device=cuda)
    lens = torch.tensor([5, 5], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ctc_loss_fwd(lp, lab.long(), lens, lens)
    with pytest.raises(ValueError, match="lie on the CPU or all on one"):
        ctc_loss_fwd(lp, lab, lens.cpu(), lens)
    with pytest.raises(ValueError, match="more than the 2047"):
        ctc_loss_fwd(lp, torch.ones(2, 2048, dtype=torch.int32,
                                    device=cuda), lens, lens)


# --------------------------------------------------------------------------
# Serving with an RNNLM: the LM on the card against the same LM on the CPU,
# and the small LM-fused decode (LM, ILM, rescoring) on both.

def _small_lm(device, seed):
    from types import SimpleNamespace
    from neural_sp_tpu_torch.models.lm.build import build_lm
    from neural_sp_tpu_torch.utils.init_params import init_params
    args = SimpleNamespace(lm_type="lstm", vocab=40, n_units=48, n_layers=3,
                           emb_dim=48, tie_embedding=True, residual=True,
                           use_glu=True)
    cpu = init_params(build_lm(args, device="cpu"), seed).eval()
    card = build_lm(args, device=device).eval()
    card.load_state_dict(cpu.state_dict(), strict=True)
    return cpu, card


def test_lm_predict_chain_on_the_card_matches_the_cpu(cuda):
    """LMSession.predict chained over 12 steps at N = 10 with random tokens
    and random beam reorders: the card's log-probs against the CPU's."""
    from neural_sp_tpu_torch.models.lm.session import LMSession
    cpu, card = _small_lm(cuda, 3)
    s_cpu, s_card = LMSession(cpu), LMSession(card)
    assert s_card.device.type == "cuda"
    rng = np.random.RandomState(3)
    st_cpu = st_card = None
    for step in range(12):
        y = rng.randint(0, 40, 10)
        lp_cpu, st_cpu = s_cpu.predict(y, st_cpu)
        lp_card, st_card = s_card.predict(y, st_card)
        assert st_card[0][0].is_cuda
        np.testing.assert_allclose(lp_card, lp_cpu, atol=TOL, rtol=TOL,
                                   err_msg=f"step {step}")
        par = rng.randint(0, 10, 10)
        st_cpu, st_card = s_cpu.select(st_cpu, par), s_card.select(st_card,
                                                                  par)


def test_lm_fused_decode_on_the_card_matches_the_cpu(cuda):
    """The small flagship-shaped model with an LM (0.5), ILM (0.2), joint
    CTC (0.3), and second-pass and backward-LM rescoring of a 3-best, on
    the card and on the CPU: the same tokens, the n-best's scores within
    TOL, and K1 and K2 launched on the card."""
    from types import SimpleNamespace
    from neural_sp_tpu_torch.configs import flagship_args
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
    from neural_sp_tpu_torch.models.lm.session import LMSession
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.utils.init_params import init_params
    args = vars(flagship_args(faithful=True))
    args.update(enc_n_layers=2, transformer_d_model=64,
                transformer_d_ff=128, transformer_n_heads=4, dec_n_units=64,
                emb_dim=32, dec_bottleneck_dim=64, attn_dim=32, vocab=40,
                subsample="1_2")
    args = SimpleNamespace(**args)
    cpu = init_params(build_speech2text(args, device="cpu"), 0).eval()
    card = build_speech2text(args, device=cuda).eval()
    card.load_state_dict(cpu.state_dict(), strict=True)
    lms = [_small_lm(cuda, seed) for seed in (1, 2, 4)]
    conf = DecodeConfig(beam_width=3, ctc_weight=0.3, lm_weight=0.5,
                        ilm_weight=0.2, lm_second_weight=0.5,
                        lm_bwd_weight=0.3, n_best=3)
    xs = np.random.RandomState(0).randn(1, 120, 80).astype(np.float32)
    xlens = np.array([120])
    out = []
    for side, model in ((0, cpu), (1, card)):
        sess = Speech2TextSession(model, conf,
                                  lm_session=LMSession(lms[0][side]))
        sess.attach_second_pass_lms(LMSession(lms[1][side]),
                                    LMSession(lms[2][side]))
        before = (rel_attention.launches, las_step.launches)
        hyps = sess.decode(xs, xlens)
        launched = (rel_attention.launches - before[0],
                    las_step.launches - before[1])
        out.append((hyps, sess._last_nbest_scores, launched))
    (hyps_cpu, sc_cpu, none), (hyps_card, sc_card, launched) = out
    assert none == (0, 0) and min(launched) > 0
    assert hyps_card == hyps_cpu and len(hyps_card[0]) > 0
    np.testing.assert_allclose(sc_card, sc_cpu, atol=TOL, rtol=TOL)


# cuDNN's LSTM (the RNN layer on the card) against the layer's written-out
# loop: float32 on both sides, TF32 off; the products sum in other orders
# and the recurrence carries the differences over T steps.
RNN_TOL = 1e-4


@pytest.mark.parametrize("bidirectional,merge", [(True, "concat"),
                                                 (True, "sum"),
                                                 (False, "sum")])
def test_rnn_layer_runs_cudnn_as_its_loop(cuda, bidirectional, merge):
    """The BLSTM-LAS's layer shape (in 1024, 512 units, T 250, ragged),
    outputs, carries and gradients; the layer raises without cuDNN."""
    from neural_sp_tpu_torch.models.modules.recurrent import RNNLayer
    from neural_sp_tpu_torch.utils.init_params import init_params
    layer = init_params(RNNLayer(1024, 512, "lstm", bidirectional, merge),
                        0).to(cuda)
    rng = np.random.RandomState(0)
    xs = _randn(rng, cuda, 8, 250, 1024)
    lens = torch.tensor([250 - 31 * i for i in range(8)])
    outs, grads = [], []
    for fn in (layer, layer.forward_ref):
        x = xs.clone().requires_grad_()
        layer.zero_grad()
        ys, carry = fn(x, lens)
        (ys * torch.linspace(-1, 1, ys.shape[-1], device=cuda)).sum() \
            .backward()
        outs.append([ys.detach()] + [t.detach() for t in
                                     torch.utils._pytree.tree_leaves(carry)])
        grads.append([x.grad] + [p.grad.clone() for p in layer.parameters()])
    for x, y in zip(outs[0] + grads[0], outs[1] + grads[1]):
        scale = float(y.abs().max())
        assert float((x - y).abs().max()) <= RNN_TOL * max(scale, 1.0)
    old = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        with pytest.raises(RuntimeError, match="cuDNN"):
            layer(xs, lens)
    finally:
        torch.backends.cudnn.enabled = old


def test_lc_blstm_layer_keeps_a_buffer_per_direction(cuda):
    """The LibriSpeech LC-BLSTM's layer (512 units, chunk 40 / 40, ragged
    T 230): on the card each direction's weights begin a cuDNN buffer of
    their own, so neither of its two calls copies them; its outputs,
    carry and gradients are its written-out loops'."""
    from neural_sp_tpu_torch.models.encoders.rnn import LCBLSTMLayer
    from neural_sp_tpu_torch.utils.init_params import init_params
    layer = init_params(LCBLSTMLayer(512, 512, 40, 40), 0).to(cuda)
    for d in (0, 4):
        ws = layer.lstm._flat_weights[d:d + 4]
        base = ws[0].untyped_storage().data_ptr()
        assert ws[0].data_ptr() == base
        assert all(w.untyped_storage().data_ptr() == base for w in ws)
    rng = np.random.RandomState(0)
    xs = _randn(rng, cuda, 4, 230, 512)
    lens = torch.tensor([230, 200, 121, 1])
    outs, grads = [], []
    for fn in (layer, layer.forward_ref):
        x = xs.clone().requires_grad_()
        layer.zero_grad()
        ys, carry = fn(x, lens)
        (ys * torch.linspace(-1, 1, ys.shape[-1], device=cuda)).sum() \
            .backward()
        outs.append([ys.detach()] + [t.detach() for t in carry])
        grads.append([x.grad] + [p.grad.clone() for p in layer.parameters()])
    for x, y in zip(outs[0] + grads[0], outs[1] + grads[1]):
        scale = float(y.abs().max())
        assert float((x - y).abs().max()) <= RNN_TOL * max(scale, 1.0)


def test_blstm_microstep_is_the_same_bits_twice(cuda):
    """One train() microstep of a BLSTM-LAS (the LibriSpeech conf's widths,
    2 encoder layers, vocab 500; dropout and sampling on) run twice from one
    generator seed: the loss and every gradient leaf the same bits."""
    from types import SimpleNamespace
    from neural_sp_tpu_torch.configs import librispeech_blstm_las_args
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.parallel.mesh import (compute_loss,
                                                   deterministic_cudnn)
    from neural_sp_tpu_torch.utils.init_params import init_params
    args = vars(librispeech_blstm_las_args())
    args.update(enc_n_layers=2, vocab=500)
    model = init_params(build_speech2text(SimpleNamespace(**args)), 0)
    model.train()
    rng = np.random.RandomState(1)
    xs = _randn(rng, cuda, 8, 800, 80)
    xlens = torch.tensor([800 - 60 * i for i in range(8)], device=cuda)
    ys = torch.from_numpy(rng.randint(4, 500, (8, 30))).to(cuda)
    ylens = torch.tensor([30 - 2 * i for i in range(8)], device=cuda)
    runs = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        with deterministic_cudnn():
            loss, _ = compute_loss(model, None, xs, xlens, ys, ylens,
                                   torch.Generator().manual_seed(0))
            loss.backward()
        runs.append([loss.detach()] + [p.grad.clone()
                                       for p in model.parameters()])
    for x, y in zip(*runs):
        assert torch.equal(x, y)


# ---- K1 / K1b with a window on the keys, and K1 against cached keys ------
# The streaming encoders' masks as K1 / K1b's window (n_l, n_c, n_r):
# causal (-1, 1, 0), the streaming conf's chunk window (16, 8, 0) with
# pad queries whose window lies wholly past klens (uniform rows over all
# T keys), lookahead, unlimited and zero left context, klen 0 and 1; then
# a streaming block's queries against cached keys (Tq < Tk, the cache's
# empty slots below key_start masked), clamped and unclamped.
WINDOW_SHAPES = [
    (2, 4, 70, 64, 11, [70, 33], (-1, 1, 0)),
    (3, 2, 200, 32, 200, [200, 0, 77], (-1, 1, 0)),
    (1, 2, 375, 16, 11, [375], (-1, 1, 0)),
    (2, 4, 100, 64, 100, [100, 10], (16, 8, 0)),
    (3, 2, 129, 32, 11, [129, 64, 1], (8, 16, 8)),
    (2, 2, 150, 64, 11, [150, 90], (-1, 32, 16)),
    (2, 2, 70, 64, 11, [70, 45], (0, 8, 4)),
]
OFFSET_SHAPES = [   # b, h, tq, tk, dk, r, key_start
    (1, 4, 8, 24, 64, 24, 16), (1, 4, 8, 24, 64, 24, 0),
    (2, 4, 24, 56, 64, 56, 8), (4, 8, 32, 96, 32, 11, 40),
]


def _window_args(cuda, b, h, t, dk, r, klens, dtype=torch.float32):
    rng = np.random.RandomState(t + r)
    q, k, v = (_randn(rng, cuda, b, h, t, dk, scale=s).to(dtype)
               for s in (dk ** -0.5, 1.0, 1.0))
    p = _randn(rng, cuda, b, h, t, r, scale=dk ** -0.5).to(dtype)
    do = _randn(rng, cuda, b, h, t, dk).to(dtype)
    return q, k, v, p, torch.tensor(klens, dtype=torch.int32,
                                    device=cuda), do


@pytest.mark.parametrize("b,h,t,dk,r,klens,window", WINDOW_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rel_attention_window_kernels(cuda, b, h, t, dk, r, klens, window,
                                      dtype):
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_bwd, rel_attention_bwd_ref, rel_attention_fwd,
        rel_attention_stats_ref)
    close = _close if dtype == torch.float32 else _close_bf16
    q, k, v, p, kl, do = _window_args(cuda, b, h, t, dk, r, klens, dtype)
    before = (rel_attention.launches_window, rel_attention_bwd.launches_window)
    o, m, l = rel_attention_fwd(q, k, v, p, kl, window)
    close(o, rel_attention_ref(q, k, v, p, kl, window), "o")
    m_ref, l_ref = rel_attention_stats_ref(q, k, p, kl, window)
    _close(m, m_ref, "m")
    _close(l, l_ref, "l")
    got = rel_attention_bwd(q, k, v, p, kl, o, m, l, do, window)
    torch.cuda.synchronize()
    assert (rel_attention.launches_window,
            rel_attention_bwd.launches_window) == (before[0] + 1,
                                                   before[1] + 1)
    want = rel_attention_bwd_ref(q, k, v, p, kl, o, m, l, do, window)
    for name, x, y in zip(("dq", "dk", "dv", "dp"), got, want):
        close(x, y, name)
    again = rel_attention_bwd(q, k, v, p, kl, o, m, l, do, window)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("b,h,tq,tk,dk,r,key_start", OFFSET_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rel_attention_offset_kernel(cuda, b, h, tq, tk, dk, r, key_start,
                                     dtype):
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_fwd, rel_attention_stats_ref)
    close = _close if dtype == torch.float32 else _close_bf16
    rng = np.random.RandomState(tq + tk)
    q = _randn(rng, cuda, b, h, tq, dk, scale=dk ** -0.5).to(dtype)
    k, v = (_randn(rng, cuda, b, h, tk, dk).to(dtype) for _ in range(2))
    p = _randn(rng, cuda, b, h, tq, r, scale=dk ** -0.5).to(dtype)
    kl = torch.full((b,), tk, dtype=torch.int32, device=cuda)
    before = rel_attention.launches_offset
    o, m, l = rel_attention_fwd(q, k, v, p, kl, key_start=key_start)
    torch.cuda.synchronize()
    assert rel_attention.launches_offset == before + 1
    close(o, rel_attention_ref(q, k, v, p, kl, key_start=key_start), "o")
    m_ref, l_ref = rel_attention_stats_ref(q, k, p, kl, key_start=key_start)
    _close(m, m_ref, "m")
    _close(l, l_ref, "l")


# The Transformer-XL's attention over its memory: Tq queries of a segment
# against Tk = mem + Tq keys under the causal window (query i at key
# position i + Tk - Tq), unclamped (R = Tk > 16: p read through L1) or
# clamped (R 11), Tq and Tk not multiples of the tiles; with and without
# dropout of the attention probabilities; and Tq = Tk with dropout.
MEMORY_SHAPES = [
    # b, h, tq, tk, dk, r, rate
    (2, 4, 70, 140, 64, 140, 0.0),
    (2, 4, 70, 140, 64, 140, 0.1),
    (3, 2, 45, 93, 32, 11, 0.3),
    (1, 8, 1, 201, 64, 201, 0.0),        # one decode step against memory
    (2, 3, 129, 129, 16, 129, 0.1),      # no memory yet
    (4, 8, 200, 400, 64, 400, 0.1),      # the swbd recipe's segment
]


@pytest.mark.parametrize("b,h,tq,tk,dk,r,rate", MEMORY_SHAPES)
def test_rel_attention_memory_kernels(cuda, b, h, tq, tk, dk, r, rate):
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_bwd, rel_attention_bwd_ref, rel_attention_fwd,
        rel_attention_stats_ref)
    from neural_sp_tpu_torch.ops.masks import CAUSAL
    rng = np.random.RandomState(tq + tk)
    q = _randn(rng, cuda, b, h, tq, dk, scale=dk ** -0.5)
    k, v = (_randn(rng, cuda, b, h, tk, dk) for _ in range(2))
    p = _randn(rng, cuda, b, h, tq, r, scale=dk ** -0.5)
    do = _randn(rng, cuda, b, h, tq, dk)
    kl = torch.full((b,), tk, dtype=torch.int32, device=cuda)
    drop = (rate, (0x9E3779B9 + tq, 12345 + tk)) if rate else None
    before = (rel_attention.launches_dropout,
              rel_attention_bwd.launches_offset)
    o, m, l = rel_attention_fwd(q, k, v, p, kl, CAUSAL, dropout=drop)
    _close(o, rel_attention_ref(q, k, v, p, kl, CAUSAL, dropout=drop), "o")
    m_ref, l_ref = rel_attention_stats_ref(q, k, p, kl, CAUSAL)
    _close(m, m_ref, "m")
    _close(l, l_ref, "l")
    got = rel_attention_bwd(q, k, v, p, kl, o, m, l, do, CAUSAL, drop)
    torch.cuda.synchronize()
    assert rel_attention.launches_dropout == before[0] + bool(rate)
    assert rel_attention_bwd.launches_offset == before[1] + (
        tq < tk and not rate)
    want = rel_attention_bwd_ref(q, k, v, p, kl, o, m, l, do, CAUSAL, drop)
    for name, x, y in zip(("dq", "dk", "dv", "dp"), got, want):
        _close(x, y, name)
    again = rel_attention_bwd(q, k, v, p, kl, o, m, l, do, CAUSAL, drop)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("tq,tk", [(70, 140), (33, 33)])
def test_rel_attention_bf16_memory_kernels(cuda, tq, tk):
    """The bf16 entries take fewer queries than keys (K1b too), and raise
    for dropout."""
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_bwd, rel_attention_bwd_ref, rel_attention_fwd)
    from neural_sp_tpu_torch.ops.masks import CAUSAL
    rng = np.random.RandomState(tq)
    b, h, dk = 2, 4, 64
    q = _randn(rng, cuda, b, h, tq, dk, scale=dk ** -0.5).bfloat16()
    k, v = (_randn(rng, cuda, b, h, tk, dk).bfloat16() for _ in range(2))
    p = _randn(rng, cuda, b, h, tq, tk, scale=dk ** -0.5).bfloat16()
    do = _randn(rng, cuda, b, h, tq, dk).bfloat16()
    kl = torch.full((b,), tk, dtype=torch.int32, device=cuda)
    o, m, l = rel_attention_fwd(q, k, v, p, kl, CAUSAL)
    _close_bf16(o, rel_attention_ref(q, k, v, p, kl, CAUSAL), "o")
    got = rel_attention_bwd(q, k, v, p, kl, o, m, l, do, CAUSAL)
    want = rel_attention_bwd_ref(q, k, v, p, kl, o, m, l, do, CAUSAL)
    for name, x, y in zip(("dq", "dk", "dv", "dp"), got, want):
        _close_bf16(x, y, name)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rel_attention_fwd(q, k, v, p, kl, CAUSAL, dropout=(0.1, (1, 2)))


# K5: the transducer's lattice, a block per utterance and a thread per
# label position (U + 1 <= 1024): the recipe's shape, ragged lengths with a
# row of U 0 and a row of T 1, U > T, the widest block, more blocks than
# SMs.
@pytest.mark.parametrize("b,t,u,tl,ul", [
    (32, 400, 200, None, None),                     # the recipe's shape
    (8, 120, 60, [120, 1, 77, 30, 5, 120, 64, 2],
     [60, 0, 33, 59, 0, 1, 60, 2]),                 # U_b 0, T_b 1
    (3, 10, 40, [10, 4, 1], [40, 13, 7]),           # U > T
    (2, 30, 1023, [30, 17], [1023, 500]),           # 1024 threads
    (300, 12, 5, None, None),                       # more blocks than SMs
])
def test_rnnt_loss_kernel(cuda, b, t, u, tl, ul):
    from neural_sp_tpu_torch.ops.kernels.rnnt_loss import (
        NEG_INF, rnnt_forward_alphas, rnnt_loss_bwd, rnnt_loss_bwd_ref,
        rnnt_loss_fwd)
    rng = np.random.RandomState(t + u)
    if tl is None:
        tl = [t - i % 5 for i in range(b)]
        ul = [u - i % 4 for i in range(b)]
    tlen = torch.tensor(tl, dtype=torch.int32, device=cuda)
    ulen = torch.tensor(ul, dtype=torch.int32, device=cuda)
    blank = _randn(rng, cuda, b, t, u + 1) - 6.9
    emit = _randn(rng, cuda, b, t, u) - 6.9
    emit = torch.where(torch.arange(u, device=cuda)[None, None] <
                       ulen[:, None, None], emit,
                       torch.full_like(emit, NEG_INF))
    args = (blank, emit, tlen, ulen)
    before = (rnnt_loss_fwd.launches, rnnt_loss_bwd.launches)
    nll, alphas = rnnt_loss_fwd(*args)
    nll_ref, alphas_ref = rnnt_forward_alphas(*args)
    _close(nll, nll_ref, "nll")
    g = torch.linspace(0.5, 1.5, b, device=cuda)
    grads = rnnt_loss_bwd(*args, alphas, g)
    torch.cuda.synchronize()
    assert (rnnt_loss_fwd.launches, rnnt_loss_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    for got, want, what in zip(grads, rnnt_loss_bwd_ref(*args, alphas_ref, g),
                               ("grad_blank", "grad_emit")):
        _close(got, want, what)


def test_rnnt_loss_refuses_bad_arguments(cuda):
    from neural_sp_tpu_torch.ops.kernels.rnnt_loss import rnnt_loss_fwd
    blank = torch.zeros(2, 5, 4, device=cuda)
    emit = torch.zeros(2, 5, 3, device=cuda)
    lens = torch.tensor([5, 3], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        rnnt_loss_fwd(blank, emit.cpu(), lens, lens)
    with pytest.raises(TypeError):
        rnnt_loss_fwd(blank.double(), emit, lens, lens)
    with pytest.raises(ValueError, match="shape"):
        rnnt_loss_fwd(blank, emit[:, :, :2], lens, lens)
    with pytest.raises(ValueError, match="labels"):
        rnnt_loss_fwd(torch.zeros(1, 2, 1025, device=cuda),
                      torch.zeros(1, 2, 1024, device=cuda), lens[:1],
                      lens[:1])
