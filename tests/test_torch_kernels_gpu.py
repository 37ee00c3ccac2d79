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


@pytest.mark.parametrize("b,h,t,dk,r,klens", [
    (2, 4, 70, 64, 11, [70, 33]),        # clamped, ragged, partial tiles
    (3, 2, 45, 32, 45, [45, 0, 17]),     # unclamped R = T, all-masked row
    (1, 8, 9, 16, 11, [9]),              # shorter than one tile
])
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
