"""Port parity: the LAS decode step (kernel K2's modules).

The JAX ``RNNDecoder.decode_step`` and the port's, fed the same tokens,
keys and ragged masks, threaded for 5 steps with the carry of each side
fed back to itself; carry, attention weights, context and logits are
compared at every step. The kernel wrapper takes its plain PyTorch twin on
CPU tensors. Tolerance: float32, atol = rtol = 2e-4 (the repo's).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from neural_sp_tpu import EOS
from neural_sp_tpu.models.decoders.las import RNNDecoder as JaxRNNDecoder
from neural_sp_tpu.ops.masks import make_pad_mask as jax_pad_mask
from neural_sp_tpu_torch.models.decoders.las import RNNDecoder
from neural_sp_tpu_torch.ops.kernels import las_step, las_step_ref
from neural_sp_tpu_torch.ops.kernels.las_step import LasStepWorkspace
from neural_sp_tpu_torch.utils.convert_params import convert_params

ATOL = RTOL = 2e-4
VOCAB, ENC, UNITS, EMB, BOTTLE, ADIM, CONV_K = 40, 64, 64, 32, 64, 32, 201


def _jax_decoder(seed):
    dec = JaxRNNDecoder(vocab=VOCAB, enc_n_units=ENC, n_units=UNITS,
                        emb_dim=EMB, bottleneck_dim=BOTTLE, attn_dim=ADIM,
                        attn_conv_kernel_size=CONV_K)
    rng = np.random.RandomState(seed)
    eouts = jnp.asarray(rng.randn(2, 12, ENC).astype(np.float32))
    v = dec.init(jax.random.PRNGKey(seed), eouts, jnp.array([12, 7]),
                 jnp.ones((2, 4), jnp.int32), jnp.array([4, 2]))
    # non-zero biases everywhere, so no bias can go missing unnoticed
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.randn(*x.shape).astype(
            np.float32), jax.tree.map(np.asarray, v["params"]))
    return dec, {"params": params}


def test_decode_step_parity_threaded():
    dec, v = _jax_decoder(0)
    port = RNNDecoder(vocab=VOCAB, enc_n_units=ENC, n_units=UNITS,
                      emb_dim=EMB, bottleneck_dim=BOTTLE, attn_dim=ADIM,
                      attn_conv_kernel_size=CONV_K)
    port.load_state_dict(convert_params(v["params"]), strict=True)

    rng = np.random.RandomState(1)
    bs, t = 3, 30
    eouts = rng.randn(bs, t, ENC).astype(np.float32)
    elens = np.array([30, 17, 5], np.int32)
    toks = np.concatenate([np.full((1, bs), EOS),
                           rng.randint(3, VOCAB, (4, bs))]).astype(np.int32)

    mask = jax_pad_mask(jnp.asarray(elens), t)
    kc = dec.apply(v, jnp.asarray(eouts), method=dec.precompute_keys)
    carry = dec.init_carry(bs, t)
    e_t = torch.from_numpy(eouts)
    with torch.no_grad():
        kc_t = port.precompute_keys(e_t)
        np.testing.assert_allclose(kc_t.numpy(), np.asarray(kc),
                                   atol=ATOL, rtol=RTOL)
        carry_t = port.init_carry(bs, t, "cpu")
        for step, y in enumerate(toks):
            carry, logits, aw = dec.apply(
                v, carry, jnp.asarray(y), kc, jnp.asarray(eouts), mask,
                method=dec.decode_step)
            carry_t, logits_t, aw_t = port.decode_step(
                carry_t, torch.from_numpy(y).long(), kc_t, e_t,
                torch.from_numpy(elens))
            ((c, h),), aw_c, ctx = carry[:3]
            ((c_t, h_t),), aw_ct, ctx_t = carry_t
            for name, want, got in (("c", c, c_t), ("h", h, h_t),
                                    ("aw", aw, aw_t), ("carry aw", aw_c, aw_ct),
                                    ("ctx", ctx, ctx_t),
                                    ("logits", logits, logits_t)):
                np.testing.assert_allclose(
                    got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL,
                    err_msg=f"step {step}: {name}")
            # ragged mask: no weight on frames past each row's length
            assert float(aw_t[2, 5:].abs().max()) == 0.0


def _np_step(eg, ctx_prev, h_prev, c_prev, aw_prev, w_ctx, w_h, bias, w_q,
             conv_w, w_f, v, kc, values, klens):
    """The K2 formula in float64 numpy, the location conv as explicit
    cross-correlation loops (left pad (K-1)//2)."""
    sig = lambda x: 1 / (1 + np.exp(-x))   # noqa: E731
    y = eg + ctx_prev @ w_ctx + h_prev @ w_h + bias
    i, f, g, o = np.split(y, 4, axis=-1)
    c = sig(f) * c_prev + sig(i) * np.tanh(g)
    h = sig(o) * np.tanh(c)
    n, t = aw_prev.shape
    ch, k = conv_w.shape
    left = (k - 1) // 2
    pad = np.concatenate([np.zeros((n, left)), aw_prev,
                          np.zeros((n, k - 1 - left))], 1)
    loc = np.zeros((n, t, ch))
    for tt in range(t):
        for cc in range(ch):
            loc[:, tt, cc] = pad[:, tt:tt + k] @ conv_w[cc]
    e = np.tanh(kc + (h @ w_q.T)[:, None] + loc @ w_f.T) @ v
    e[np.arange(t)[None] >= klens[:, None]] = np.finfo(np.float32).min / 2
    aw = np.exp(e - e.max(1, keepdims=True))
    aw /= aw.sum(1, keepdims=True)
    return h, c, aw, np.einsum("nt,ntd->nd", aw, values)


def _step_args(rng, n, t, hd, d, a, ch, k):
    f = lambda *s: rng.randn(*s).astype(np.float32)   # noqa: E731
    aw = np.exp(f(n, t))
    return (f(n, 4 * hd), f(n, d), f(n, hd), f(n, hd),
            aw / aw.sum(1, keepdims=True), f(d, 4 * hd) * 0.2,
            f(hd, 4 * hd) * 0.2, f(4 * hd), f(a, hd) * 0.3, f(ch, k),
            f(a, ch) * 0.3, f(a), f(n, t, a), f(n, t, d),
            np.array([t, 4, 1], np.int32)[:n])


def test_las_step_ref_matches_formula():
    """Asymmetric conv taps and an even width catch a flipped or shifted
    conv (convolution instead of cross-correlation, wrong padding side)."""
    rng = np.random.RandomState(2)
    for k in (7, 6):
        args = _step_args(rng, 3, 9, 8, 6, 5, 3, k)
        want = _np_step(*(x.astype(np.float64) if x.dtype == np.float32
                          else x for x in args))
        got = las_step_ref(*map(torch.from_numpy, args))
        for name, w, g in zip(("h", "c", "aw", "ctx"), want, got):
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5,
                                       err_msg=f"K={k}: {name}")


def test_las_step_cpu_dispatch_is_the_twin():
    rng = np.random.RandomState(3)
    args = [torch.from_numpy(x) for x in _step_args(rng, 2, 5, 4, 3, 3, 2, 5)]
    before = las_step.launches
    for got, want in zip(las_step(*args), las_step_ref(*args)):
        assert torch.equal(got, want)
    assert las_step.launches == before


def test_las_step_ref_parent_is_a_gather_of_the_carry():
    """Row n of a step with ``parent`` is row n of a step on the carry
    gathered beforehand (a beam's reorder), exactly."""
    rng = np.random.RandomState(4)
    args = [torch.from_numpy(x) for x in _step_args(rng, 3, 9, 8, 6, 5, 3, 7)]
    for parent in ([2, 0, 0], [1, 1, 1], [0, 1, 2]):
        par = torch.tensor(parent, dtype=torch.int32)
        gathered = list(args)
        for i in (1, 2, 3, 4):
            gathered[i] = args[i][par.long()]
        for got, want in zip(las_step_ref(*args, parent=par),
                             las_step_ref(*gathered)):
            assert torch.equal(got, want)
        for got, want in zip(las_step(*args, parent=par),
                             las_step_ref(*gathered)):
            assert torch.equal(got, want)


def test_workspace_equals_plain_call_over_three_steps():
    """The workspace form against the plain call, threaded for three steps
    (the two carry sets written in turns), the second and third with a
    reorder: every output equal, exactly."""
    rng = np.random.RandomState(5)
    n, t, hd, d, a, ch, k = 3, 9, 8, 6, 5, 3, 7
    args = [torch.from_numpy(x)
            for x in _step_args(rng, n, t, hd, d, a, ch, k)]
    fixed = args[5:]
    ws = LasStepWorkspace(*fixed)
    assert all(float(x.abs().max()) == 0.0 for x in ws.carry)
    ws.load_carry(*args[1:5])
    ctx, h, c, aw = args[1:5]
    before = las_step.launches
    seen = []
    for step, parent in enumerate((None, [2, 2, 0], [1, 0, 1])):
        eg = torch.from_numpy(rng.randn(n, 4 * hd).astype(np.float32))
        par = None if parent is None else torch.tensor(parent,
                                                       dtype=torch.int32)
        ws.eg.copy_(eg)
        if par is not None:
            ws.parent.copy_(par)
        got = ws.step(use_parent=par is not None)
        h, c, aw, ctx = las_step(eg, ctx, h, c, aw, *fixed, parent=par)
        for name, x, y in zip(("h", "c", "aw", "ctx"), got, (h, c, aw, ctx)):
            assert torch.equal(x, y), f"step {step}: {name}"
        assert got is ws.carry
        seen.append(got[0].data_ptr())
    assert seen[0] == seen[2] != seen[1]      # two sets, in turns
    assert las_step.launches == before        # CPU: the plain version


# Tokens of the decode loops on a small seeded model, pinned from the
# version that reordered the beam's carry with indexed copies outside K2:
# the reorder inside the step (``parent``) and the workspace must not move
# a token. Beam widths 1 (greedy), 3 and 10; "device": the batched
# on-device beam; "host": the label-synchronous beam with joint CTC 0.3
# and a coverage penalty, one utterance at a time.
PINNED_TOKENS = \
    {'device_1': [[22, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21,
                   21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21,
                   21],
                  [22, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21,
                   21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21,
                   21],
                  [11, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21,
                   21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21,
                   21]],
     'device_10': [[22, 21, 21], [22, 21], [11]],
     'device_3': [[22, 21, 21], [22, 21], [11]],
     'host_10': [[22, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 22, 21, 21,
                  21, 22, 21, 21, 21, 21, 22, 22, 21, 22, 21, 21, 22, 22, 21],
                 [22, 22, 21, 21, 21, 21, 11, 11, 21, 21, 21, 21, 21, 21, 21,
                  21, 21, 22, 21, 21, 21, 21, 21],
                 [21, 21, 21, 21, 21, 21, 21, 21, 21, 11, 21, 21, 21, 21, 21,
                  21]],
     'host_3': [[11, 22, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21,
                 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21],
                [22, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21,
                 21, 21, 21, 21, 21, 21, 21, 21],
                [11, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21, 21,
                 21]]}


@pytest.fixture(scope="module")
def small_model():
    from types import SimpleNamespace
    from neural_sp_tpu_torch.configs import flagship_args
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.utils.init_params import init_params
    args = vars(flagship_args(faithful=True))
    args.update(enc_n_layers=2, transformer_d_model=64,
                transformer_d_ff=128, transformer_n_heads=4, dec_n_units=64,
                emb_dim=32, dec_bottleneck_dim=64, attn_dim=32, vocab=40,
                subsample="1_2")
    model = build_speech2text(SimpleNamespace(**args), device="cpu")
    init_params(model, 3)
    rng = np.random.RandomState(3)
    xs = rng.randn(3, 120, 80).astype(np.float32)
    return model.eval(), xs, np.array([120, 90, 61], np.int32)


@pytest.mark.parametrize("name", sorted(PINNED_TOKENS))
def test_decode_loops_keep_their_tokens(small_model, name):
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
    model, xs, xlens = small_model
    kind, width = name.split("_")
    if int(width) == 1:
        conf = DecodeConfig(beam_width=1)
    elif kind == "device":
        conf = DecodeConfig(beam_width=int(width), device_beam=True,
                            min_len_ratio=0.1)
    else:
        conf = DecodeConfig(beam_width=int(width), ctc_weight=0.3,
                            coverage_penalty=0.2)
    assert Speech2TextSession(model, conf).decode(xs, xlens) == \
        PINNED_TOKENS[name]


@pytest.mark.parametrize("reorder", [False, True])
def test_decode_loop_steps_equal_the_plain_chain(small_model, reorder):
    """A ``DecodeLoop`` (the carry in K2's workspace, a beam's reorder as
    ``parent``) against ``decode_step`` threaded by hand with the carry
    reordered the same way: logits and attention weights equal at every
    step, exactly, and ``DecodeLoop.steps`` counts the steps."""
    from neural_sp_tpu_torch.models.decoders.las import DecodeLoop
    dec = small_model[0].dec_fwd
    rng = np.random.RandomState(6)
    n, t = 5, 12
    e = torch.from_numpy(rng.randn(n, t, dec.enc_n_units).astype(np.float32))
    klens = torch.tensor([12, 9, 1, 0, 7], dtype=torch.int32)
    with torch.inference_mode():
        kc = dec.precompute_keys(e)
        loop = dec.decode_loop(kc, e, klens)
        carry = dec.init_carry(n, t, e.device)
        before = DecodeLoop.steps
        par = None
        for i in range(4):
            y = torch.from_numpy(rng.randint(0, dec.vocab, n))
            if reorder and i > 0:
                par = torch.from_numpy(rng.randint(0, n, n).astype(np.int32))
            logits, aw = loop.step(y, par)
            carry, logits_ref, aw_ref = dec.decode_step(carry, y, kc, e,
                                                        klens, parent=par)
            assert torch.equal(logits, logits_ref), f"step {i}"
            assert torch.equal(aw, aw_ref), f"step {i}"
    assert DecodeLoop.steps == before + 4
