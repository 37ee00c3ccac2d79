"""The kernels' work counts (``*_cost``: flops and bytes the algorithm
needs at given shapes, which ``chip_smoke.py`` turns into each kernel's
bound on the H100) against counts made by hand, at two small shapes each,
with ragged lengths, a length of 0 and one past T; and ``chip_smoke.py``'s
library yardsticks for K1 / K1b (efficient SDPA with the rel-PE bias as an
additive mask), which must compute the plain versions' function."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_sp_tpu_torch.ops.kernels.ctc_loss import (
    ctc_loss_bwd_cost, ctc_loss_cost)
from neural_sp_tpu_torch.ops.kernels.las_scan import (
    las_scan_bwd_cost, las_scan_cost)
from neural_sp_tpu_torch.ops.kernels.las_step import las_step_cost
from neural_sp_tpu_torch.ops.kernels.rel_attention import (
    rel_attention_bwd_cost, rel_attention_bwd_ref, rel_attention_cost,
    rel_attention_ref, rel_attention_stats_ref)
from neural_sp_tpu_torch.ops.kernels.roofline import bound_ms

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bound_is_the_larger_of_the_two_times():
    assert bound_ms(165e9, 0) == pytest.approx((1.0, "operations"))
    assert bound_ms(0, 3.35e9) == pytest.approx((1.0, "bytes"))
    assert bound_ms(165e9, 6.7e9)[1] == "bytes"
    assert bound_ms(67e9, 0, peak=67e12)[0] == pytest.approx(1.0)


# (b, h, t, dk, r, klens): ragged; then a row with no valid key (P v over
# all T) and a length past T (clipped)
@pytest.mark.parametrize("shape,fwd,bwd", [
    ((2, 3, 10, 16, 4, [10, 6]),
     # q k^T and P v: 4 dk flops per pair, keys 10 and 6 of T = 10, H = 3
     (4 * 16 * 10 * 3 * (10 + 6),
      # q, o: 2 x 2x3x10x16; k, v rows: 3 x 16 x (20 + 12); p 2x3x10x4;
      # m, l 2 x 2x3x10; klens 2
      4 * (1920 + 1536 + 240 + 120 + 2)),
     # five products: 10 dk flops per pair
     (10 * 16 * 10 * 3 * (10 + 6),
      # q, o, dO; k, v; p; m, l; klens; dq, dk, dv; dp
      4 * (2880 + 1536 + 240 + 120 + 2 + 2880 + 240))),
    ((2, 1, 8, 32, 8, [0, 9]),
     # no key: P v alone over T = 8 keys (2 dk); klen 9 -> 8 keys (4 dk)
     (2 * 32 * 8 * 8 + 4 * 32 * 8 * 8,
      # v read for all 8 keys of row 0, k and v for 8 keys of row 1
      4 * (1024 + 32 * (8 + 16) + 128 + 32 + 2)),
     # no key: dv = P^T dO alone, reading no k or v
     (2 * 32 * 8 * 8 + 10 * 32 * 8 * 8,
      4 * (1536 + 32 * 16 + 128 + 32 + 2 + 1536 + 128))),
])
def test_rel_attention_costs(shape, fwd, bwd):
    assert rel_attention_cost(*shape) == fwd
    assert rel_attention_bwd_cost(*shape) == bwd


# the bf16 entries: q, k, v, p, o (and dO, dq, dk, dv, dp) at 2 bytes, the
# row statistics m, l (float32) and klens (int32) at 4; the same flops
@pytest.mark.parametrize("shape,fwd,bwd", [
    ((2, 3, 10, 16, 4, [10, 6]),
     (4 * 16 * 10 * 3 * (10 + 6), 2 * (1920 + 1536 + 240) + 4 * (120 + 2)),
     (10 * 16 * 10 * 3 * (10 + 6),
      2 * (2880 + 1536 + 240 + 2880 + 240) + 4 * (120 + 2))),
    ((2, 1, 8, 32, 8, [0, 9]),
     (2 * 32 * 8 * 8 + 4 * 32 * 8 * 8,
      2 * (1024 + 32 * (8 + 16) + 128) + 4 * (32 + 2)),
     (2 * 32 * 8 * 8 + 10 * 32 * 8 * 8,
      2 * (1536 + 32 * 16 + 128 + 1536 + 128) + 4 * (32 + 2))),
])
def test_rel_attention_costs_bf16(shape, fwd, bwd):
    assert rel_attention_cost(*shape, elem=2) == fwd
    assert rel_attention_bwd_cost(*shape, elem=2) == bwd
    # halving the 2-byte tensors leaves m, l and klens at 4 bytes
    f32 = rel_attention_cost(*shape)[1], rel_attention_bwd_cost(*shape)[1]
    b, h, t = shape[:3]
    stats = 4 * (2 * b * h * t + b)
    assert (fwd[1] - stats, bwd[1] - stats) == \
        ((f32[0] - stats) // 2, (f32[1] - stats) // 2)


def test_bf16_bound_uses_the_bf16_tensor_peak():
    from neural_sp_tpu_torch.ops.kernels.roofline import BF16_TENSOR_FLOPS
    assert BF16_TENSOR_FLOPS == 989e12
    assert bound_ms(989e9, 0, peak=BF16_TENSOR_FLOPS) == \
        pytest.approx((1.0, "operations"))


# (n or b, t, hd, d, a, ch, k) with ragged frame lengths
LAS = (5, 4, 3, 2, 2, 3)                    # t, hd, d, a, ch, k


@pytest.mark.parametrize("klens,step,scan,scan_bwd", [
    ([5, 2],                                # 7 valid frames
     # gates 2 x 2 x (3 + 4) x 16, query 2 x 2 x 4 x 2; attention over 7
     # frames: 2 x 7 x (conv 2x3 + W_f 2x2 + v 2 + ctx 3)
     (480 + 210,
      # weights 112 + 16 + 8 + 6 + 4 + 2; rows 2 x (16 + 3 + 8 + 5 + 1)
      # + kc, values 7 x (2 + 3); out 2 x (8 + 5 + 3)
      4 * (148 + 66 + 35 + 32)),
     (3 * (480 + 210),
      # weights, kc / values, klens, eg + keep 3x2x(16 + 4); out 3x2x34
      4 * (148 + 35 + 2 + 120 + 204)),
     # per step: recurrent 2x2x(16x7 + 8), attention 2x7x(3x6 + 3x4 + 4
     # + 6); outside: 2x3x2x(64 + 48 + 8)
     (3 * (480 + 560) + 1440,
      # weights without bias 132, kc / values 35, klens 2, saved and
      # output gradients 3x2x45; out: d_eg 96, weights 132, db 16, dkc /
      # dvalues 2x5x5
      4 * (132 + 35 + 2 + 270 + 96 + 132 + 16 + 50))),
    ([0, 9],                                # 0 + 5 valid frames
     (480 + 150, 4 * (148 + 66 + 25 + 32)),
     (3 * (480 + 150), 4 * (148 + 25 + 2 + 120 + 204)),
     (3 * (480 + 400) + 1440,
      4 * (132 + 25 + 2 + 270 + 96 + 132 + 16 + 50))),
])
def test_las_costs(klens, step, scan, scan_bwd):
    assert las_step_cost(2, *LAS, klens) == step
    assert las_scan_cost(3, 2, *LAS, klens) == scan
    assert las_scan_bwd_cost(3, 2, *LAS, klens) == scan_bwd


# b 2, t 6, u 3, v 7
@pytest.mark.parametrize("tl,ul,fwd,bwd", [
    # states x frames 6x7 + 4x3 = 54; emission columns 6x4 + 4x2 = 32
    ([6, 4], [3, 1],
     # 13 flops per state and frame; emissions, labels 6, lengths 4, nll 2;
     # the float64 alphas 2x6x7
     (13 * 54, 4 * (32 + 6 + 4 + 2) + 8 * 84),
     # 17 flops; emissions, labels, lengths and g, dense gradient 2x6x7;
     # the valid float64 alphas 54
     (17 * 54, 4 * (32 + 6 + 4 + 2 + 84) + 8 * 54)),
    # a length past T (clipped to 6) with no label, and no frame at all
    ([9, 0], [0, 3],
     (13 * 6, 4 * (6 + 6 + 4 + 2) + 8 * 84),
     (17 * 6, 4 * (6 + 6 + 4 + 2 + 84) + 8 * 6)),
])
def test_ctc_costs(tl, ul, fwd, bwd):
    assert ctc_loss_cost(2, 6, 3, 7, tl, ul) == fwd
    assert ctc_loss_bwd_cost(2, 6, 3, 7, tl, ul) == bwd


def test_sdpa_yardstick_computes_rel_attention():
    """The K1 / K1b yardsticks of chip_smoke.py on the CPU (the math
    backend here, the efficient one on the card): SDPA with rel_bias gives
    the plain forward, and its autograd gradients, the bias's summed into
    R buckets, give the plain backward."""
    smoke = _chip_smoke()
    rng = np.random.RandomState(0)
    b, h, t, dk, r = 3, 2, 37, 16, 5

    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32))

    q, k, v = f(b, h, t, dk, scale=dk ** -0.5), f(b, h, t, dk), \
        f(b, h, t, dk)
    p, do = f(b, h, t, r, scale=dk ** -0.5), f(b, h, t, dk)
    klens = torch.tensor([37, 20, 1], dtype=torch.int32)
    bias = smoke.rel_bias(torch, p, klens).requires_grad_()
    assert bias.stride(-2) == 48           # rows padded to 16 floats
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = torch.nn.functional.scaled_dot_product_attention(
        *leaves, attn_mask=bias, scale=1.0)
    want = rel_attention_ref(q, k, v, p, klens)
    torch.testing.assert_close(o, want, atol=1e-5, rtol=1e-5)
    *dqkv, dbias = torch.autograd.grad(o, (*leaves, bias), do)
    m, l = rel_attention_stats_ref(q, k, p, klens)
    ref = rel_attention_bwd_ref(q, k, v, p, klens, want, m, l, do)
    got = (*dqkv, smoke.bias_grad_to_buckets(torch, dbias, r))
    for name, x, y in zip(("dq", "dk", "dv", "dp"), got, ref):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-5, msg=name)
