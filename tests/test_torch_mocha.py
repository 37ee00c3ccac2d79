"""Port parity: MoChA (``models/modules/mocha.py``), the LAS decoder's MoChA
path (``models/decoders/las.py``), the CTC forced alignment
(``ops/ctc.py::ctc_forced_align``, ``CTC.trigger_points``) and the
LSTM-MoChA recipe confs, against the JAX package on the same numpy inputs
with the JAX weights converted (``convert_params``), float32, atol = rtol
= 2e-4 (the repo's) unless a test says otherwise.

* The functions of the module: ``safe_cumprod`` / ``exclusive_cumprod``
  with x at 0 and 1, ``moving_sum``, ``parallel_monotonic_attention`` and
  ``soft_chunkwise_attention`` (chunk 1, 3 and -1; masked frames) with
  their gradients against ``jax.grad``, ``hard_monotonic_attention``
  (boundaries at frame 0 and at the last frame, rows where nothing fires,
  ``eps_wait`` -1 / 0 / 2) and ``hard_chunkwise_attention`` (chunk 4 and
  -1). Alphas are compared relative to their largest value: where the
  cumulative product hits its clip, alpha_prev / cp is amplified up to
  1e10.
* ``MoChA`` with its own key projections in parallel mode (three chained
  steps: ctx, alpha, beta and the gradient of every weight and of the keys,
  against the JAX module evaluated in float64: JAX's float32 moving sums
  lose up to 3e-4 of beta to cancellation at these inputs, ROADMAP C18;
  ``jax.enable_x64``)
  and in hard mode (four chained steps, alphas identical) over chunk {1, 4,
  -1} x heads {(1, 1), (2, 2), (2, 2) with ``share_ca``}, and with
  ``conv1d``, ``no_denominator``, StableEmit and the DeCoT trigger mask.
  Hard mode asserts a margin: every monotonic energy the boundary search
  reads is at least 1e-3 from 0.
* After a step where no head fires, JAX's hard mode searches from frame 0
  again (ROADMAP C15), and so does the port.
* ROADMAP C18 at the LibriSpeech recipe's widths and T = 400: the port's
  float32 within 2e-5 of the JAX module in float64, where JAX's float32
  loses beta and the context.
* A small LSTM-MoChA ``Speech2Text`` (the LibriSpeech conf's shape, its
  widths cut) in ``train()`` with dropout 0: the loss, its parts and every
  gradient leaf against ``jax.grad``, with the quantity loss, with
  StableEmit, with ``ctc_sync`` (the trigger points the port computes are
  JAX's), and with the noise on, pinned: ``jax.random.normal`` (its scan
  traces the step once, so every step draws the same noise) and the port's
  ``mocha_noise`` give one fixed draw. In ``eval()`` the loss is JAX's
  ``deterministic=True`` loss, MoChA in hard mode (the dev loss).
* Decoding on perturbed weights: greedy tokens over a batch and beam 4 +
  CTC 0.3 tokens on one utterance identical to the JAX session's, with a
  margin: every monotonic energy the search read at least 1e-3 from 0,
  and a top-2 logit gap of at least 1e-3 at every greedy choice;
  ``RNNDecoder.decode_step`` on a carry gives the decode loop's logits.
* ``ctc_forced_align``: trigger points and best paths identical to JAX's
  on ragged lengths with a repeated label and a row of no labels, on
  uniform log-probs (every transition ties), and with U = 0.
* One clipped Adam update with accumulation against JAX's
  ``make_train_step``, by ``test_torch_train_step.py``'s rule.
* The 8 LSTM-MoChA recipe confs, the 6 full-context BLSTM-MoChA confs,
  the 4 uni-Conformer-MoChA confs and the 15 LC-BLSTM-MoChA confs (their
  chunk read from ``lc_chunk_size_left``, ROADMAP C13; they raised until
  the LC-BLSTM was ported), and the 7 DeCoT / MinLT confs and the random
  state passing one (they raised until the trigger points were ported)
  build on the meta device with JAX's parameter counts; the other MoChA
  conf (MBR) raises ``NotImplementedError`` naming ROADMAP; bf16 compute raises;
  ``configs.librispeech_lstm_mocha_args`` equals the conf; ``init_params``
  fills ``v`` and ``r``; the train CLI's curriculum gates the MoChA losses.
* ``mocha_noise``: a standard normal on dropout's counter hash, the same
  bits from the same generator seed.
"""
import math
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from neural_sp_tpu.models.decoders.decoding import (
    DecodeConfig as JaxDecodeConfig, Speech2TextSession as JaxSession)
from neural_sp_tpu.models.modules import mocha as jmocha
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu.ops.ctc import ctc_forced_align as jax_forced_align
from neural_sp_tpu.parallel.mesh import make_train_step as jax_make_step
from neural_sp_tpu.trainers.optimizer import (
    build_optimizer as jax_build_optimizer)
from neural_sp_tpu_torch.bin.args import parse_args_train
from neural_sp_tpu_torch.bin.asr.train import set_mocha_curriculum
from neural_sp_tpu_torch.configs import librispeech_lstm_mocha_args
from neural_sp_tpu_torch.models.decoders import las
from neural_sp_tpu_torch.models.decoders.decoding import (
    DecodeConfig, Speech2TextSession)
from neural_sp_tpu_torch.models.modules import mocha
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.ops.ctc import ctc_forced_align
from neural_sp_tpu_torch.parallel.mesh import make_train_step
from neural_sp_tpu_torch.trainers.optimizer import build_optimizer
from neural_sp_tpu_torch.utils.convert_params import convert_params
from neural_sp_tpu_torch.utils.init_params import init_params

from test_torch_train_step import _moments

ATOL = RTOL = 2e-4
MARGIN = 1e-3
ROOT = Path(__file__).resolve().parents[1]
LIBRISPEECH = "librispeech/conf/asr/mocha/lstm_mocha.yaml"
# the confs this slice builds: UniLSTM-MoChA ...
LSTM_CONFS = ("csj/conf/asr/mocha/lstm_mocha.yaml", LIBRISPEECH,
              "tedlium/conf/asr/mocha/lstm_mocha.yaml",
              "tedlium/conf/lstm_mocha.yaml",
              "tedlium/conf/asr/mocha/lstm_mocha_stableemit0.1.yaml",
              "csj/conf/asr/mocha/lstm_mocha_ctc_sync.yaml",
              "librispeech/conf/asr/mocha/lstm_mocha_ctc_sync.yaml",
              "tedlium/conf/asr/mocha/lstm_mocha_ctc_sync.yaml")
# ... and the full-context BLSTM-MoChA (lc_chunk_size_left -1: no chunk,
# as the blstm_las confs that build since the RNN encoder landed)
BLSTM_CONFS = ("aishell/conf/asr/mocha/blstm_mocha.yaml",
               "ami/conf/asr/blstm_mocha.yaml",
               "csj/conf/asr/mocha/blstm_mocha.yaml",
               "librispeech/conf/asr/mocha/blstm_mocha.yaml",
               "swbd/conf/asr/blstm_mocha.yaml",
               "tedlium/conf/asr/mocha/blstm_mocha.yaml")
# ... and the unidirectional Conformer-MoChA (the recipes' three and the
# repo's streaming conf, whose encoder is chunked in mask mode)
UNI_CONFORMER_CONFS = (
    "librispeech/conf/asr/mocha/uni_conformer_kernel7_clamp10_hie_"
    "subsample8_mocha_ln_stableemit0.2_qua0.2.yaml",
    "librispeech/conf/asr/uni_conformer_mocha_streaming.yaml",
    "tedlium/conf/asr/mocha/uni_conformer_kernel7_clamp10_hie_subsample8_"
    "mocha_long_ln.yaml",
    "tedlium/conf/asr/mocha/uni_conformer_kernel7_clamp10_hie_subsample8_"
    "mocha_long_ln_stableemit0.1.yaml")
# ... and the LC-BLSTM-MoChA (the latency-controlled BLSTM, its chunk read
# from lc_chunk_size_left: ROADMAP C13)
LCBLSTM_CONFS = (
    "aishell/conf/asr/mocha/lcblstm_mocha_chunk4040.yaml",
    "aishell/conf/asr/mocha/lcblstm_mocha_chunk4040_ctc_sync.yaml",
    "ami/conf/asr/lcblstm_mocha_chunk4040.yaml",
    "ami/conf/asr/lcblstm_mocha_chunk4040_ctc_sync.yaml",
    "csj/conf/asr/mocha/lcblstm_mocha_chunk4040.yaml",
    "csj/conf/asr/mocha/lcblstm_mocha_chunk4040_ctc_sync.yaml",
    "librispeech/conf/asr/mocha/lcblstm_mocha_chunk4040.yaml",
    "librispeech/conf/asr/mocha/lcblstm_mocha_chunk4040_ctc_sync.yaml",
    "swbd/conf/asr/lcblstm_mocha_chunk4040.yaml",
    "swbd/conf/asr/lcblstm_mocha_chunk4040_ctc_sync.yaml",
    "tedlium/conf/asr/mocha/lcblstm_mocha_chunk4020.yaml",
    "tedlium/conf/asr/mocha/lcblstm_mocha_chunk4020_ctc_sync.yaml",
    "tedlium/conf/asr/mocha/lcblstm_mocha_chunk4040.yaml",
    "tedlium/conf/asr/mocha/lcblstm_mocha_chunk4040_ctc_sync.yaml",
    "tedlium/conf/lcblstm_mocha_chunk4040.yaml")
# ... and MoChA's latency training from word alignments (DeCoT, MinLT)
# and random state passing (they raised until the trigger points were
# ported)
LATENCY_CONFS = (
    "csj/conf/asr/mocha/lcblstm_mocha_chunk4040_decot16.yaml",
    "csj/conf/asr/mocha/lcblstm_mocha_chunk4040_minlt.yaml",
    "librispeech/conf/asr/mocha/lstm_mocha_decot12.yaml",
    "librispeech/conf/asr/mocha/lstm_mocha_decot16.yaml",
    "librispeech/conf/asr/mocha/lstm_mocha_minlt.yaml",
    "tedlium/conf/asr/mocha/lstm_mocha_decot16.yaml",
    "tedlium/conf/asr/mocha/lstm_mocha_minlt.yaml",
    "tedlium/conf/asr/mocha/lstm_mocha_rsp_enc.yaml")
# every other MoChA conf raises, with the reason it names
# the MoChA conf outside BUILDING: MBR training
MBR = "_mbr"


def _tree(params):
    return jax.tree.map(np.asarray, params)


def _close(got, want, err_msg="", rel=RTOL, floor=0.0):
    """|got - want| <= rel * max|want| + floor (and at least rel * 1e-6)."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0,
        atol=rel * max(float(np.abs(want).max()), 1e-6) + floor,
        err_msg=err_msg)


# ------------------------------------------------------------ the functions
def test_cumprods_and_moving_sum_match_jax():
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 1, (3, 2, 11)).astype(np.float32)
    x[0, 0, 3], x[1, 1, 0], x[2, 0, 5] = 0.0, 1.0, 1.0
    for fn in ("safe_cumprod", "exclusive_cumprod"):
        _close(getattr(mocha, fn)(torch.from_numpy(x)).numpy(),
               getattr(jmocha, fn)(jnp.asarray(x)), fn)
    y = rng.randn(2, 3, 9).astype(np.float32)
    for back, fwd in ((0, 0), (3, 0), (0, 3), (2, 1), (9, 0)):
        np.testing.assert_allclose(
            mocha.moving_sum(torch.from_numpy(y), back, fwd).numpy(),
            np.asarray(jmocha.moving_sum(jnp.asarray(y), back, fwd)),
            atol=1e-5, err_msg=f"{back} {fwd}")


@pytest.mark.parametrize("chunk", [1, 3, -1])
def test_parallel_and_soft_chunkwise_match_jax(chunk):
    """alpha and beta of one training step and their gradients; p with
    entries at 0 and 1 (the clips), masked chunk energies."""
    rng = np.random.RandomState(1)
    shape = (2, 2, 12)
    p = 1 / (1 + np.exp(-3 * rng.randn(*shape)))
    p[0, 0, 4], p[1, 1, 2], p[1, 0, 9:] = 1.0, 0.0, 0.0
    prev = rng.uniform(0, 1, shape)
    prev /= prev.sum(-1, keepdims=True)
    u = rng.randn(*shape)
    u[1, :, 9:] = np.finfo(np.float32).min / 2
    w_a, w_b = rng.randn(*shape), rng.randn(*shape)
    p, prev, u, w_a, w_b = (z.astype(np.float32)
                            for z in (p, prev, u, w_a, w_b))

    def objective(m, conv, p_, prev_, u_):
        alpha = m.parallel_monotonic_attention(p_, prev_)
        beta = m.soft_chunkwise_attention(alpha, u_, chunk)
        return (alpha * conv(w_a)).sum() + (beta * conv(w_b)).sum(), \
            (alpha, beta)

    (_, (ja, jb)), jg = jax.value_and_grad(
        lambda *a: objective(jmocha, jnp.asarray, *a), argnums=(0, 1, 2),
        has_aux=True)(*map(jnp.asarray, (p, prev, u)))
    ins = [torch.from_numpy(z).requires_grad_() for z in (p, prev, u)]
    total, (ta, tb) = objective(mocha, torch.from_numpy, *ins)
    total.backward()
    _close(ta.detach().numpy(), ja, "alpha")
    _close(tb.detach().numpy(), jb, "beta")
    # du is zero in exact arithmetic at chunk 1 (beta = alpha): rounding
    # on both sides, held to 1e-5 of the largest gradient
    floor = 1e-5 * max(float(np.abs(np.asarray(g)).max()) for g in jg)
    for t, j, name in zip(ins, jg, ("p", "alpha_prev", "u")):
        _close(t.grad.numpy(), j, f"d{name}", floor=floor)


def _onehot(idx, t):
    out = np.zeros(idx.shape + (t,), np.float32)
    for pos in np.ndindex(idx.shape):
        if idx[pos] >= 0:
            out[pos + (idx[pos],)] = 1.0
    return out


@pytest.mark.parametrize("eps_wait", [-1, 0, 2])
def test_hard_monotonic_attention_matches_jax(eps_wait):
    """Rows that fire at frame 0, at the last frame, past the previous
    boundary only, and not at all; previous boundaries one-hot or all
    zero; three heads."""
    t = 10
    e = np.full((4, 3, t), -2.0, np.float32)
    e[0, 0, 0] = e[0, 1, 4] = e[0, 2, 9] = 1.5        # 0 / middle / last
    e[1, 0, 2] = e[1, 0, 7] = 0.7                     # before, after prev
    e[1, 1, 9] = 0.3
    e[2, :, 3] = 2.0                                  # all heads, frame 3
    e[3, 1, 6] = 1.0                                  # heads 0, 2 silent
    prev = _onehot(np.array([[0, 0, 0], [5, 9, -1], [3, 4, 0],
                             [-1, 2, 8]]), t)
    got = mocha.hard_monotonic_attention(torch.from_numpy(e),
                                         torch.from_numpy(prev), eps_wait)
    want = jmocha.hard_monotonic_attention(jnp.asarray(e), jnp.asarray(prev),
                                           eps_wait)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the cases are there: a boundary at frame 0, at the last frame, and
    # a head that did not fire
    assert got[0, 0, 0] == 1 and got[0, 2, t - 1] == (eps_wait < 0)
    assert float(got[1, 0].sum()) == 1 and int(got[1, 0].argmax()) == 7


@pytest.mark.parametrize("chunk", [4, -1])
def test_hard_chunkwise_attention_matches_jax(chunk):
    rng = np.random.RandomState(2)
    t = 9
    alpha = _onehot(np.array([[0, 8], [4, -1], [2, 6]]), t)
    u = rng.randn(3, 2, t).astype(np.float32)
    u[2, :, 7:] = np.finfo(np.float32).min / 2
    got = mocha.hard_chunkwise_attention(torch.from_numpy(alpha),
                                         torch.from_numpy(u), chunk)
    want = jmocha.hard_chunkwise_attention(jnp.asarray(alpha), jnp.asarray(u),
                                           chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert float(got[1, 1].sum()) == 0.0


# ------------------------------------------------------------- the module
KDIM, QDIM, ADIM, BS, T = 12, 10, 8, 3, 16
KLENS = np.array([16, 11, 5])
MODULES = {
    "chunk1": dict(chunk_size=1),
    "chunk4": dict(chunk_size=4),
    "chunk-1": dict(chunk_size=-1),
    "mma_chunk1": dict(chunk_size=1, n_heads_mono=2, n_heads_chunk=2),
    "mma_chunk4": dict(chunk_size=4, n_heads_mono=2, n_heads_chunk=2),
    "mma_chunk-1": dict(chunk_size=-1, n_heads_mono=2, n_heads_chunk=2),
    "mma_share_ca_chunk4": dict(chunk_size=4, n_heads_mono=2,
                                n_heads_chunk=2, share_ca=True),
    "mma_share_ca_chunk-1": dict(chunk_size=-1, n_heads_mono=2,
                                 n_heads_chunk=2, share_ca=True,
                                 eps_wait=1),
    "conv1d": dict(chunk_size=4, conv1d=True),
    "no_denominator": dict(chunk_size=4, no_denominator=True),
    "stableemit_decot": dict(chunk_size=4, stableemit_weight=0.1,
                             decot=True),
}


def _module_pair(name, seed=0):
    kw = dict(MODULES[name])
    decot = kw.pop("decot", False)
    kw.update(init_r=0.5, noise_std=0.0)
    jm = jmocha.MoChA(kdim=KDIM, qdim=QDIM, adim=ADIM, **kw)

    def init(m, key, q, a):
        return m(m.precompute(key), q, a)

    params = _tree(jm.init(jax.random.PRNGKey(seed), jnp.zeros((BS, T, KDIM)),
                           jnp.zeros((BS, QDIM)), jnp.zeros((BS, 1, T)),
                           method=init)["params"])
    # offsets and biases away from their initial zeros
    rng = np.random.RandomState(seed + 10)
    params = jax.tree.map(lambda x: x + 0.3 * rng.randn(*x.shape).astype(
        np.float32), params)
    tm = mocha.MoChA(kdim=KDIM, qdim=QDIM, adim=ADIM, **kw)
    tm.load_state_dict(convert_params(params), strict=True)
    return jm, params, tm, decot


def _module_inputs(seed, steps):
    rng = np.random.RandomState(seed)
    key = rng.randn(BS, T, KDIM).astype(np.float32)
    qs = rng.randn(steps, BS, QDIM).astype(np.float32)
    mask = np.arange(T)[None] < KLENS[:, None]
    return rng, key, qs, mask


@pytest.mark.parametrize("name", list(MODULES))
def test_mocha_module_matches_jax(name):
    jm, params, tm, decot = _module_pair(name)
    rng, key, qs, mask = _module_inputs(3, 3)
    h_ma = tm.n_heads_mono
    trig = np.array([3, 9, 2]) if decot else None
    w_ctx = rng.randn(3, BS, KDIM).astype(np.float32)
    w_a = rng.randn(3, BS, h_ma, T).astype(np.float32)

    def run(apply_step, precompute, conv, key_, init):
        kc = precompute(key_)
        alpha, total, outs = init, 0.0, []
        for i in range(3):
            ctx, alpha, beta = apply_step(kc, conv(qs[i]), alpha)
            total = total + (ctx * conv(w_ctx[i])).sum() + \
                (alpha * conv(w_a[i])).sum()
            outs.append((ctx, alpha, beta))
        return total, outs

    a0 = np.zeros((BS, h_ma, T), np.float32)
    a0[:, :, 0] = 1.0

    def f64(x):
        return jnp.asarray(x, jnp.float64)

    def jloss(p, key_):
        def step(kc, q, a):
            return jm.apply({"params": p}, kc, q, a, mode="parallel",
                            mask=jnp.asarray(mask),
                            trigger_points=None if trig is None
                            else jnp.asarray(trig))
        pre = lambda k: jm.apply({"params": p}, k,  # noqa: E731
                                 method=jmocha.MoChA.precompute)
        return run(step, pre, f64, key_, f64(a0))

    # the JAX module in float64: its float32 moving sums subtract
    # cumulative sums and lose up to 3e-4 of beta at these inputs, where
    # the port's float32 does not (ROADMAP C18)
    with jax.enable_x64(True):
        (_, jouts), (gp, gk) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(
            jax.tree.map(f64, params), f64(key))
        jouts, gp, gk = _tree(jouts), _tree(gp), np.asarray(gk)
    key_t = torch.from_numpy(key).requires_grad_()
    tmask = torch.from_numpy(mask)
    ttrig = None if trig is None else torch.from_numpy(trig)
    total, touts = run(
        lambda kc, q, a: tm(kc, q, a, "parallel", tmask, ttrig),
        tm.precompute, torch.from_numpy, key_t, torch.from_numpy(a0))
    total.backward()
    for i, (got, want) in enumerate(zip(touts, jouts)):
        for g, w, what in zip(got, want, ("ctx", "alpha", "beta")):
            _close(g.detach().numpy(), w, f"step {i} {what}")
    _close(key_t.grad.numpy(), gk, "d key")
    want_g = convert_params(_tree(gp))
    assert set(want_g) == {n for n, _ in tm.named_parameters()}
    for pname, p in tm.named_parameters():
        _close(p.grad.numpy(), want_g[pname].numpy(), pname)

    # hard mode: four chained decode steps from alpha one-hot at frame 0
    rng, key, qs, mask = _module_inputs(4, 4)
    kc_j = jm.apply({"params": params}, jnp.asarray(key),
                    method=jmocha.MoChA.precompute)
    with torch.no_grad():
        kc_t = tm.precompute(torch.from_numpy(key))
        aj, at = jnp.asarray(a0), torch.from_numpy(a0)
        for i in range(4):
            e = tm.monotonic_energy(kc_t["mono"], torch.from_numpy(qs[i]))
            _assert_search_margin(e, at, torch.from_numpy(mask))
            cj, aj, bj = jm.apply({"params": params}, kc_j,
                                  jnp.asarray(qs[i]), aj, mode="hard",
                                  mask=jnp.asarray(mask))
            ct, at, bt = tm(kc_t, torch.from_numpy(qs[i]), at, "hard",
                            torch.from_numpy(mask))
            np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
            _close(bt.numpy(), bj, f"hard step {i} beta")
            _close(ct.numpy(), cj, f"hard step {i} ctx")


def test_mocha_float32_holds_to_float64_at_the_recipe_length():
    """ROADMAP C18 at the LibriSpeech LSTM-MoChA's widths (B 4, T 400 with
    ragged lengths, keys and query 1024 wide, attn_dim 512, chunk 4, init_r
    -4; JAX's initial weights; 30 chained parallel-mode steps, cut from a
    decoder's hundred): the port's float32 alpha, beta and context stay
    within 2e-5 of their largest value of the JAX module evaluated in
    float64, where the JAX module's own float32 loses beta and the
    context to cancellation (errors past their largest value)."""
    b, t, kdim, adim, steps = 4, 400, 1024, 512, 30
    rng = np.random.RandomState(0)
    key = (0.5 * np.tanh(rng.randn(b, t, kdim))).astype(np.float32)
    qs = (0.5 * np.tanh(rng.randn(steps, b, kdim))).astype(np.float32)
    mask = np.arange(t)[None] < np.array([400, 300, 250, 175])[:, None]
    a0 = np.zeros((b, 1, t), np.float32)
    a0[..., 0] = 1.0
    kw = dict(kdim=kdim, qdim=kdim, adim=adim, chunk_size=4, init_r=-4.0)
    jm = jmocha.MoChA(**kw)
    params = _tree(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, kdim)), jnp.zeros((1, kdim)),
        jnp.zeros((1, 1, 8)),
        method=lambda m, k, q, a: m(m.precompute(k), q, a))["params"])

    def jax_run(dt):
        p = jax.tree.map(lambda x: jnp.asarray(x, dt), params)
        kc = jm.apply({"params": p}, jnp.asarray(key, dt),
                      method=jmocha.MoChA.precompute)
        step = jax.jit(lambda kc, q, a: jm.apply(
            {"params": p}, kc, q, a, mode="parallel", mask=jnp.asarray(mask)))
        a, outs = jnp.asarray(a0, dt), []
        for i in range(steps):
            c, a, be = step(kc, jnp.asarray(qs[i], dt), a)
            outs.append([np.asarray(x, np.float64) for x in (a, be, c)])
        return outs

    with jax.enable_x64(True):
        want = jax_run(jnp.float64)
    jax32 = jax_run(jnp.float32)
    tm = mocha.MoChA(**kw)
    tm.load_state_dict(convert_params(params), strict=True)
    with torch.no_grad():
        kc = tm.precompute(torch.from_numpy(key))
        a, got = torch.from_numpy(a0), []
        for i in range(steps):
            c, a, be = tm(kc, torch.from_numpy(qs[i]), a, "parallel",
                          torch.from_numpy(mask))
            got.append([x.double().numpy() for x in (a, be, c)])

    def worst(outs):
        return [max(float(np.abs(o[j] - w[j]).max() / np.abs(w[j]).max())
                    for o, w in zip(outs, want)) for j in range(3)]

    port, ref = worst(got), worst(jax32)
    assert max(port) <= 2e-5, port
    assert min(ref[1:]) > 1.0, ref


def _assert_search_margin(e, alpha_prev, mask):
    """Every energy the hard boundary search reads (from the previous
    boundary, or frame 0, to the boundary it finds, or to the last valid
    frame) is at least MARGIN from 0, so that no rounding flips a
    decision."""
    e, alpha_prev = e.detach(), alpha_prev.detach()
    t = e.shape[-1]
    idx = torch.arange(t)
    start = torch.where(alpha_prev.sum(-1) > 0, alpha_prev.argmax(-1), 0)
    fire = (e >= 0) & (idx >= start[..., None]) & mask[:, None, :]
    first = torch.where(fire, idx, t).amin(-1)
    read = (idx >= start[..., None]) & (idx <= first[..., None]) & \
        mask[:, None, :]
    if bool(read.any()):
        assert float(e[read].abs().min()) >= MARGIN


def test_hard_mode_searches_from_frame_0_after_a_silent_step():
    """ROADMAP C15: after a step where no head fired (alpha all zero),
    JAX's hard mode searches from frame 0 again, not from the last
    boundary; the port mirrors it."""
    e_steps = ([-3, 2, -3, -3, -3, -3],      # fires at 1
               [-3, -3, -3, -3, -3, -3],     # silent
               [3, -3, -3, -3, -3, -3])      # fires at 0 (before 1)
    prev = np.zeros((1, 1, 6), np.float32)
    prev[..., 0] = 1.0
    seen = []
    for e in e_steps:
        e = np.asarray([[e]], np.float32)
        got = mocha.hard_monotonic_attention(torch.from_numpy(e),
                                             torch.from_numpy(prev))
        want = jmocha.hard_monotonic_attention(jnp.asarray(e),
                                               jnp.asarray(prev))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        prev = got.numpy()
        seen.append(int(prev.argmax()) if prev.sum() else None)
    assert seen == [1, None, 0]


# ------------------------------------------------------------ whole models
def small_mocha(**over):
    """The LibriSpeech LSTM-MoChA with its widths cut: one pooling block, 2
    LSTM-16 layers, decoder 32, attention 16, vocab 50, CTC fc 16; dropout
    and noise off; ``mocha_init_r`` a float (ROADMAP C17)."""
    args = vars(librispeech_lstm_mocha_args())
    args.update(input_dim=20, conv_channels="4", conv_kernel_sizes="(3,3)",
                conv_poolings="(2,2)", subsample="1_1", enc_n_units=16,
                enc_n_layers=2, dec_n_units=32, emb_dim=16,
                dec_bottleneck_dim=32, attn_dim=16, vocab=50,
                ctc_fc_list="16", dropout_enc=0.0, dropout_dec=0.0,
                dropout_emb=0.0, mocha_std=0.0, mocha_init_r=-4.0)
    args.update(over)
    return SimpleNamespace(**args)


def mocha_batch(seed=0, bs=3, t=40):
    rng = np.random.RandomState(seed)
    xs = rng.randn(bs, t, 20).astype(np.float32)
    xlens = np.array([t, t - 11, t - 23][:bs], np.int32)
    ylens = np.array([5, 3, 2][:bs], np.int32)
    ys = np.full((bs, 5), 3, np.int32)
    for b, u in enumerate(ylens):
        ys[b, :u] = rng.randint(4, 50, u)
    return xs, xlens, ys, ylens


_INIT = {}   # seed -> JAX params: the loss options change no shape


def _models(seed=0, **over):
    args = small_mocha(**over)
    jm = jax_build(args)
    if seed not in _INIT:
        _INIT[seed] = _tree(jax.jit(jm.init)(
            jax.random.PRNGKey(seed),
            *map(jnp.asarray, mocha_batch()))["params"])
    params = _INIT[seed]
    tm = build_speech2text(args, device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    return jm, params, tm


LOSS_CASES = {
    "quantity": dict(),
    "stableemit": dict(mocha_stableemit_weight=0.1),
    "ctc_sync": dict(mocha_quantity_loss_weight=0.0,
                     mocha_latency_metric="ctc_sync",
                     mocha_latency_loss_weight=1.0),
    "pinned_noise": dict(mocha_std=1.0),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_mocha_las_loss_and_grads_match_jax(case, monkeypatch):
    jm, params, tm = _models(**LOSS_CASES[case])
    b = mocha_batch(1)
    spied = []
    if case == "pinned_noise":
        noise = np.random.RandomState(7).randn(3, 1, 20).astype(np.float32)
        real = jax.random.normal

        def fake_normal(key, shape=(), dtype=jnp.float32):
            if tuple(shape) == noise.shape:
                return jnp.asarray(noise)
            return real(key, shape, dtype)

        def fake_noise(gen, shape, device, dtype=torch.float32):
            bs, u1, h, t = shape
            assert (bs, h, t) == noise.shape
            return torch.from_numpy(noise)[:, None].expand(shape).to(dtype)

        monkeypatch.setattr(jax.random, "normal", fake_normal)
        monkeypatch.setattr(las, "mocha_noise", fake_noise)
    if case == "ctc_sync":
        real_align = ctc_forced_align

        def spy(*a, **kw):
            spied.append(real_align(*a, **kw))
            return spied[-1]

        monkeypatch.setattr(
            "neural_sp_tpu_torch.models.decoders.ctc.ctc_forced_align", spy)

    def jloss(p):
        return jm.apply({"params": p}, *map(jnp.asarray, b),
                        deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(1),
                              "specaug": jax.random.PRNGKey(2)})

    (want, jobs), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    loss, obs = tm.train()(*map(torch.from_numpy, b),
                           torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=RTOL)
    extra = {"quantity": ["loss_quantity"], "stableemit": ["loss_quantity"],
             "ctc_sync": ["loss_latency"],
             "pinned_noise": ["loss_quantity"]}[case]
    for name in ["loss_ctc", "loss_att", "acc_att"] + extra:
        np.testing.assert_allclose(float(obs[name].detach()),
                                   float(jobs[name]), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    if case == "ctc_sync":
        ex = tm.encoder(*map(torch.from_numpy, b[:2]))["ys"]
        jtrig, _ = jax_forced_align(
            jm.apply({"params": params},
                     jnp.asarray(ex["xs"].detach().numpy()),
                     method=lambda m, e: m.ctc.log_probs(e)),
            jnp.asarray(b[2]), jnp.asarray(ex["xlens"].numpy()),
            jnp.asarray(b[3]))
        np.testing.assert_array_equal(spied[0][0].numpy(), np.asarray(jtrig))
        assert float(obs["loss_latency"].detach()) > 0
    want_g = convert_params(_tree(grads))
    assert set(want_g) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), want_g[name].numpy(), name)


def _perturbed(params, scale, seed=5):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: np.asarray(x) + scale * rng.randn(
        *x.shape).astype(np.float32), params)


@pytest.mark.parametrize("weights", ["init", "perturbed"])
def test_mocha_las_eval_loss_matches_jax_hard_mode(weights, monkeypatch):
    """The teacher-forced loss in ``eval()`` (the train CLI's dev loss)
    against JAX's ``deterministic=True`` loss, which runs MoChA in hard
    mode: at the initial weights (init_r -4: no boundary fires) and on
    perturbed weights, where boundaries fire and the search margin holds.
    The loss in parallel mode, on the same weights, is not it."""
    jm, params, tm = _models()
    if weights == "perturbed":
        params = _perturbed(params, 1.0, seed=7)
        tm.load_state_dict(convert_params(params), strict=True)
    b = mocha_batch(2)
    want, jobs = jax.jit(lambda p: jm.apply(
        {"params": p}, *map(jnp.asarray, b), deterministic=True))(params)
    seen = []
    real_hard = mocha.hard_monotonic_attention

    def spy_hard(e, alpha_prev, eps_wait=-1):
        seen.append((e, alpha_prev, real_hard(e, alpha_prev, eps_wait)))
        return seen[-1][2]

    monkeypatch.setattr(mocha, "hard_monotonic_attention", spy_hard)
    tb = tuple(map(torch.from_numpy, b))
    with torch.no_grad():
        loss, obs = tm.eval()(*tb)
    np.testing.assert_allclose(float(loss), float(want), rtol=RTOL)
    for name in ("loss_ctc", "loss_att", "acc_att"):
        np.testing.assert_allclose(float(obs[name]), float(jobs[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert len(seen) == b[3].max() + 1          # one search per step
    klens = tm.encoder(*tb[:2])["ys"]["xlens"]
    mask = torch.arange(seen[0][0].shape[-1])[None] < klens[:, None]
    for e, prev, _ in seen:
        _assert_search_margin(e, prev, mask)
    fired = sum(int(a.sum()) for _, _, a in seen)
    assert (fired > 0) == (weights == "perturbed"), fired
    if weights == "perturbed":
        # the expected alignment (train(); dropout and noise are off) gives
        # another loss on the same weights (at init_r -4 its mass is too
        # small to tell the two apart at this size)
        with torch.no_grad():
            _, soft = tm.train()(*tb)
        soft = float(soft["loss_att"])
        assert abs(soft - float(obs["loss_att"])) > 1e-3 * soft


def test_mocha_decode_matches_jax(monkeypatch):
    """Greedy over the batch and beam 4 + CTC 0.3 on one utterance, on
    perturbed weights (so that the hypotheses are not empty): the JAX
    session's tokens, with the search margin and, for greedy, the top-2
    logit gap asserted on the port's side."""
    jm, params, tm = _models()
    params = _perturbed(params, 1.0, seed=7)
    tm.load_state_dict(convert_params(params), strict=True)
    tm.eval()
    xs, xlens, _, _ = mocha_batch(6, t=60)
    energies, logits = [], []
    real_hard = mocha.hard_monotonic_attention
    real_step = las.MochaDecodeLoop.step

    def spy_hard(e, alpha_prev, eps_wait=-1):
        energies.append((e, alpha_prev))
        return real_hard(e, alpha_prev, eps_wait)

    def spy_step(self, y, parent=None):
        out = real_step(self, y, parent)
        logits.append(out[0])
        return out

    monkeypatch.setattr(mocha, "hard_monotonic_attention", spy_hard)
    monkeypatch.setattr(las.MochaDecodeLoop, "step", spy_step)
    for conf in (dict(beam_width=1), dict(beam_width=4, ctc_weight=0.3)):
        energies.clear()
        logits.clear()
        jsess = JaxSession(jm, params, JaxDecodeConfig(**conf))
        tsess = Speech2TextSession(tm, DecodeConfig(**conf))
        n = 3 if conf["beam_width"] == 1 else 1
        want = jsess.decode(xs[:n], xlens[:n])
        got = tsess.decode(xs[:n], xlens[:n])
        assert got == want, conf
        assert any(0 < len(h) < 30 for h in got), (conf, got)
        klens = tsess.encode(xs[:n], xlens[:n])["ys"]["xlens"]
        for e, prev in energies:
            mask = torch.arange(e.shape[-1])[None] < \
                klens.repeat_interleave(e.shape[0] // n)[:, None]
            _assert_search_margin(e, prev, mask)
        if conf["beam_width"] == 1:
            # RNNDecoder.decode_step on a carry: the loop's steps
            e = tsess.encode(xs[:n], xlens[:n])["ys"]
            carry = tm.dec_fwd.init_carry(n, e["xs"].shape[1], "cpu")
            y = torch.full((n,), 2, dtype=torch.long)
            with torch.inference_mode():
                kc = tm.dec_fwd.precompute_keys(e["xs"])
                for i in range(3):
                    carry, lg, _ = tm.dec_fwd.decode_step(
                        carry, y, kc, e["xs"], e["xlens"].int())
                    torch.testing.assert_close(lg, logits[i])
                    y = lg.argmax(-1)
            for i, lg in enumerate(logits):
                for b, hyp in enumerate(got):
                    if i <= len(hyp):          # up to and with its eos
                        top2 = lg[b].topk(2).values
                        assert float(top2[0] - top2[1]) >= MARGIN, (i, b)


def test_mocha_accumulated_clipped_update_matches_jax():
    """Two microbatches, Adam with k = 2 accumulation and clip 0.5 (active),
    dropout and noise off, the quantity loss on: the metrics of each
    microstep and the update, by test_torch_train_step.py's rule."""
    clip, k, lr = 0.5, 2, 1e-3
    jm, params, tm = _models()
    params0 = convert_params(params)
    tx = jax_build_optimizer("adam", lr=lr, clip_grad_norm=clip,
                             accum_grad_n_steps=k)
    jstep = jax_make_step(jm, tx, donate=False)
    opt_state = tx.init(params)
    step = make_train_step(tm.train(), build_optimizer(
        "adam", lr=lr, clip_grad_norm=clip, accum_grad_n_steps=k))
    for i, b in enumerate((mocha_batch(10), mocha_batch(11))):
        params, opt_state, jmet = jstep(params, opt_state,
                                        jax.random.PRNGKey(i),
                                        *map(jnp.asarray, b))
        met = step(*map(torch.from_numpy, b),
                   gen=torch.Generator().manual_seed(i))
        assert met["emitted"] == (i == k - 1)
        for name in ("loss", "loss_ctc", "loss_att", "loss_quantity",
                     "grad_norm"):
            np.testing.assert_allclose(float(met[name]), float(jmet[name]),
                                       rtol=RTOL, err_msg=name)
    assert float(met["grad_norm"]) > clip
    new = convert_params(_tree(params))
    mu = convert_params(_tree(_moments(opt_state).mu))
    mu_floor = 1e-6 * max(float(m.abs().max()) for m in mu.values())
    state = tm.state_dict()
    n_sure = n_all = 0
    for name, p0 in params0.items():
        want_u = (new[name] - p0).numpy()
        got_u = (state[name] - p0).numpy()
        m = np.abs(mu[name].numpy())
        sure = (m > 1e-3 * m.max()) & (m > mu_floor)
        np.testing.assert_allclose(got_u[sure], want_u[sure], rtol=0,
                                   atol=1e-3 * lr, err_msg=name)
        # one float32 spacing at the parameter (r is -4)
        assert np.abs(got_u).max() <= lr * (1 + 1e-5) + \
            float(np.spacing(np.abs(p0.numpy())).max())
        n_sure += int(sure.sum())
        n_all += sure.size
    # at init_r -4 the chunk energies' gradients (about 2e-7) sit below
    # the moments' floor, and most embedding rows see no label: 84% of the
    # elements are held here
    assert n_sure > 0.8 * n_all


# -------------------------------------------------------- forced alignment
def _align_case(kind):
    rng = np.random.RandomState(8)
    b, t, v, u = 4, 20, 7, 5
    if kind == "uniform":
        lp = np.full((b, t, v), -np.log(v), np.float32)
    else:
        lp = torch.log_softmax(torch.from_numpy(
            rng.randn(b, t, v).astype(np.float32)), -1).numpy()
    labels = rng.randint(1, v, (b, u)).astype(np.int32)
    labels[1, 1] = labels[1, 0]                       # a repeat
    tl = np.array([20, 15, 9, 3], np.int32)
    ll = np.array([5, 3, 0, 2], np.int32)              # a row of no labels
    if kind == "no_labels":
        labels, ll = labels[:, :0], np.zeros(b, np.int32)
    return lp, labels, tl, ll


@pytest.mark.parametrize("kind", ["random", "uniform", "no_labels"])
def test_ctc_forced_align_matches_jax(kind):
    lp, labels, tl, ll = _align_case(kind)
    jt, jp = jax_forced_align(*map(jnp.asarray, (lp, labels, tl, ll)))
    tt, tp = ctc_forced_align(*map(torch.from_numpy, (lp, labels, tl, ll)))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert tt.shape == labels.shape and tp.shape == lp.shape[:2]


# ---------------------------------------------------------------- the confs
_JAX_COUNTS = {}


def _jax_count(args):
    key = (args.enc_type, getattr(args, "enc_n_units", 0), args.enc_n_layers,
           getattr(args, "enc_n_projs", 0), args.dec_n_units,
           getattr(args, "attn_dim", 0),
           getattr(args, "lc_chunk_size_current", -1),
           getattr(args, "ctc_weight", 0.0) > 0)
    if key not in _JAX_COUNTS:
        factors = str(getattr(args, "subsample", "") or "1").split("_")
        if len(factors) < args.enc_n_layers:
            # the JAX encoder indexes a factor per layer (ROADMAP C19): its
            # count for the conf with the missing factors 1
            args = SimpleNamespace(**{**vars(args), "subsample": "_".join(
                factors + ["1"] * (args.enc_n_layers - len(factors)))})
        jm = jax_build(args)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 80)), jnp.array([64]),
            jnp.ones((1, 3), jnp.int32), jnp.array([3])))
        _JAX_COUNTS[key] = sum(math.prod(x.shape)
                               for x in jax.tree.leaves(shapes["params"]))
    return _JAX_COUNTS[key]


BUILDING = LSTM_CONFS + BLSTM_CONFS + UNI_CONFORMER_CONFS + LCBLSTM_CONFS + \
    LATENCY_CONFS


@pytest.mark.parametrize("conf", BUILDING)
def test_mocha_recipe_conf_builds(conf):
    args = parse_args_train(["--config", str(ROOT / "examples" / conf)])
    args.vocab = 10000
    model = build_speech2text(args, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert isinstance(model.dec_fwd.step.attn, mocha.MoChA)
    assert n == _jax_count(args)
    if conf == LIBRISPEECH:
        assert n == 76130753


def _raising_confs():
    out = subprocess.run(["grep", "-rl", "attn_type: mocha",
                          str(ROOT / "examples")], capture_output=True,
                         text=True, check=True).stdout.split()
    confs = sorted(str(Path(p).relative_to(ROOT / "examples")) for p in out)
    return [c for c in confs if c not in BUILDING]


def test_the_other_mocha_confs_raise():
    """Of the 42 MoChA confs, the MBR one was the last that raised: it
    builds now, at JAX's count (its MBR training: tests/test_torch_mbr.py),
    and none raises."""
    confs = _raising_confs()
    assert len(confs) + len(BUILDING) == 42 and len(confs) == 1
    for conf in confs:
        assert MBR in conf
        args = parse_args_train(["--config", str(ROOT / "examples" / conf)])
        args.vocab = 10000
        assert args.mbr_training
        model = build_speech2text(args, device="meta")
        assert sum(p.numel() for p in model.parameters()) == \
            _jax_count(args)


def test_librispeech_lstm_mocha_args_equal_the_conf():
    conf = vars(parse_args_train(["--config",
                                  str(ROOT / "examples" / LIBRISPEECH)]))
    args = vars(librispeech_lstm_mocha_args())
    assert args.pop("vocab") == 10000
    assert args == {k: conf[k] for k in args}
    assert conf.get("train_dtype") == "float32"


def test_bf16_and_sampling_raise_for_mocha():
    """Scheduled sampling with MoChA raises. bf16 compute is ported (it
    raised before): the decoder at bf16 gives a finite loss in float32
    (tests/test_torch_mocha_bf16.py holds it to JAX)."""
    tm = init_params(build_speech2text(small_mocha(), device="cpu"), 0)
    dec = tm.dec_fwd.train()
    e = torch.zeros(2, 8, 16, dtype=torch.bfloat16)
    loss, obs = torch.func.functional_call(
        dec, {n: p.to(torch.bfloat16) for n, p in dec.named_parameters()},
        (e, torch.tensor([8, 5]), torch.ones(2, 3, dtype=torch.long),
         torch.tensor([3, 2])))
    assert obs["loss_quantity"].dtype == torch.float32
    assert bool(torch.isfinite(loss))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_speech2text(small_mocha(ss_prob=0.2), device="cpu")


def test_init_params_fill_v_and_r():
    a = init_params(build_speech2text(small_mocha(dec_n_units=64),
                                      device="cpu"), 3).state_dict()
    b = init_params(build_speech2text(small_mocha(dec_n_units=64),
                                      device="cpu"), 3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    v = a["dec_fwd.step.attn.monotonic_energy.v"]
    assert v.shape == (1, 16)                  # lecun_normal: fan-in H = 1
    np.testing.assert_allclose(float(v.std()), 1.0, rtol=0.5)
    assert torch.equal(a["dec_fwd.step.attn.monotonic_energy.r"],
                       torch.tensor([-4.0]))


def test_train_cli_curriculum_gates_the_mocha_losses():
    tm = build_speech2text(small_mocha(mocha_stableemit_weight=0.1,
                                       mocha_latency_metric="ctc_sync",
                                       mocha_latency_loss_weight=1.0),
                           device="meta")
    args = SimpleNamespace(mocha_quantity_loss_weight=0.1,
                           mocha_quantity_loss_start_epoch=3,
                           mocha_latency_loss_weight=1.0,
                           mocha_latency_loss_start_epoch=0,
                           mocha_stableemit_weight=0.1,
                           mocha_stableemit_start_epoch=2)
    dec = tm.dec_fwd
    got = []
    for epoch in (1, 2, 3):
        set_mocha_curriculum(dec, args, epoch)
        got.append((dec.quantity_loss_weight, dec.latency_loss_weight,
                    dec.step.attn.stableemit_weight))
    assert got == [(0.0, 1.0, 0.0), (0.0, 1.0, 0.1), (0.1, 1.0, 0.1)]


def test_mocha_noise_is_a_standard_normal_on_the_counter_hash():
    """``mocha_noise``: the same bits from the same generator seed, drawn
    from two key words of it (dropout's counter hash, as ``keep_mask``),
    with a standard normal's moments and quantiles over a microstep's
    draw at the recipe's size."""
    shape = (8, 31, 1, 400)
    z = mocha.mocha_noise(torch.Generator().manual_seed(3), shape, "cpu")
    assert z.shape == shape and z.dtype == torch.float32
    assert torch.equal(z, mocha.mocha_noise(
        torch.Generator().manual_seed(3), shape, "cpu"))
    g = torch.Generator().manual_seed(3)
    mocha.mocha_noise(g, shape, "cpu")
    assert torch.equal(torch.randint(0, 1 << 32, (2,), generator=g,
                                     dtype=torch.int64),
                       torch.randint(0, 1 << 32, (4,), dtype=torch.int64,
                                     generator=torch.Generator().manual_seed(
                                         3))[2:])
    assert not torch.equal(z, mocha.mocha_noise(
        torch.Generator().manual_seed(4), shape, "cpu"))
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1) < 0.01
    for x, cdf in ((-1.0, 0.158655), (0.0, 0.5), (2.0, 0.977250)):
        assert abs(float((z < x).float().mean()) - cdf) < 0.005, x
    # the step's draws of several sites do not repeat one another
    g = torch.Generator().manual_seed(5)
    first, second = (mocha.mocha_noise(g, (4096,), "cpu") for _ in range(2))
    assert abs(float(np.corrcoef(first, second)[0, 1])) < 0.05
