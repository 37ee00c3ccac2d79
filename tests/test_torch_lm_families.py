"""Port parity: the Transformer, Transformer-XL and gated-conv LMs (the
RNNLM's are in ``test_torch_lm.py``), their sessions, ``LMDataset``, the
momentum optimizers and ``build_lm`` over every recipe LM conf.

Each JAX LM is initialised from a seed under ``jax.jit``, its params
perturbed by seeded noise (so biases, norms and the XL's u / v biases are
not at their initial values) and carried by ``convert_params`` into the
port's LM (``strict=True``). Three consecutive BPTT windows of seeded
token ids, the state carried (the XL's memories, at
``mem_len`` below and above ``bptt``, with the position table clamped and
unclamped): each window's loss, ppl, acc and every gradient against
``jax.grad``, in eval mode (the two packages draw different dropout masks,
ROADMAP C4). JAX runs the three windows in one ``jax.jit``.
``LMSession.predict`` over 8 steps with a beam reorder after step 3
against the JAX session's steps, unrolled in one ``jax.jit``. float32,
atol = rtol = 2e-4.

``LMDataset``'s matrices and windows equal the JAX dataset's (word and
char units, ``backward``, ``serialize``, a ``token_id`` column);
``build_optimizer("momentum" / "nesterov")`` equals the optax chain over
three updates; every ``examples/*/conf/lm/*.yaml`` builds on the meta
device with the JAX model's parameter count (``jax.eval_shape``).
"""
import csv
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import yaml

from neural_sp_tpu.datasets.lm import LMDataset as JaxLMDataset
from neural_sp_tpu.models.lm.build import build_lm as jax_build_lm
from neural_sp_tpu.trainers.optimizer import (
    build_optimizer as jax_build_optimizer)
from neural_sp_tpu_torch.bin.lm.train import detach
from neural_sp_tpu_torch.datasets.lm import LMDataset
from neural_sp_tpu_torch.models.lm.build import build_lm
from neural_sp_tpu_torch.models.lm.session import LMSession
from neural_sp_tpu_torch.trainers.optimizer import build_optimizer
from neural_sp_tpu_torch.utils.convert_params import convert_params

ATOL = RTOL = 2e-4
VOCAB = 30
B, BPTT = 3, 5
ROOT = Path(__file__).resolve().parents[1]

_XL = dict(lm_type="transformer_xl", n_layers=2, transformer_d_model=32,
           transformer_d_ff=48, transformer_n_heads=2, lsm_prob=0.1)
_TLM = dict(lm_type="transformer", n_layers=2, transformer_d_model=32,
            transformer_d_ff=48, transformer_n_heads=4, lsm_prob=0.1)
CASES = {
    "transformer": dict(_TLM),
    "transformer_tied": dict(_TLM, tie_embedding=True),
    # mem_len below bptt, unclamped (R = Tk)
    "xl_mem3": dict(_XL, mem_len=3),
    # mem_len above bptt (the memory fills over two windows), clamped
    "xl_mem8_clamp4_tied": dict(_XL, mem_len=8, clamp_len=4,
                                tie_embedding=True),
    "xl_mem8_tied": dict(_XL, mem_len=8, tie_embedding=True),
    "xl_mem3_clamp2": dict(_XL, mem_len=3, clamp_len=2),
    # a width change (resizes) and a bottleneck
    "gated_conv": dict(lm_type="gated_conv", emb_dim=16,
                       gated_conv_layers="16:3_24:2:8_24:1", lsm_prob=0.1),
}


def _models(name, seed=0):
    """(JAX LM, its perturbed params, the port's LM with them)."""
    args = SimpleNamespace(vocab=VOCAB, **CASES[name])
    jm = jax_build_lm(args)
    ys = jnp.zeros((B, BPTT), jnp.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), ys, ys)["params"]
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.1 * rng.randn(*x.shape).astype(
            np.float32), params)
    tm = build_lm(args, device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    return jm, params, tm.eval()


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_lm_windows_match_jax(name):
    jm, params, tm = _models(name)
    rng = np.random.RandomState(1)
    xi = rng.randint(4, VOCAB, (3, B, BPTT)).astype(np.int32)
    xo = rng.randint(2, VOCAB, (3, B, BPTT)).astype(np.int32)
    xo[1, 0, -2:] = 3                     # PAD targets are ignored

    @jax.jit
    def windows(p, xi, xo):
        state, out = None, []
        for w in range(3):
            def loss_fn(p_, st=state):
                loss, new_state, obs = jm.apply({"params": p_}, xi[w], xo[w],
                                                st)
                return loss, (new_state, obs)
            (loss, (state, obs)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(p)
            out.append((loss, obs, grads))
        return out, state

    want, jstate = windows(params, xi, xo)
    state = None
    for w, (loss_w, obs_w, grads_w) in enumerate(want):
        tm.zero_grad()
        loss, state, obs = tm(torch.from_numpy(xi[w]).long(),
                              torch.from_numpy(xo[w]).long(), state)
        loss.backward()
        state = detach(state)
        _close(float(loss.detach()), loss_w, f"window {w} loss")
        for k in ("ppl", "acc"):
            _close(float(obs[k]), obs_w[k], f"window {w} {k}")
        gw = convert_params(jax.tree.map(np.asarray, grads_w))
        for k, p in tm.named_parameters():
            _close(p.grad.numpy(), gw[k], f"window {w} grad {k}")
    if name.startswith("xl"):
        # n_layers + 1 memories of min(3 bptt, mem_len) steps
        m = min(3 * BPTT, CASES[name]["mem_len"])
        assert len(state) == CASES[name]["n_layers"] + 1
        for got, ref in zip(state, jstate):
            assert got.shape == (B, m, 32)
            _close(got.numpy(), ref, "memory")


@pytest.mark.parametrize("name", ["transformer_tied",
                                  "xl_mem3", "xl_mem8_clamp4_tied",
                                  "gated_conv"])
def test_session_chain_matches_jax(name):
    """8 ``LMSession.predict`` steps at B 2, rows reordered to [1, 1] after
    step 3 (a beam's reorder: ``select``), against JAX's."""
    from neural_sp_tpu.models.lm.session import LMSession as JaxLMSession
    jm, params, tm = _models(name, seed=2)
    ys = np.random.RandomState(3).randint(2, VOCAB, (8, 2)).astype(np.int32)
    jsess, sess = JaxLMSession(jm, params), LMSession(tm)
    reorder = np.array([1, 1])

    @jax.jit
    def chain(p, ys):
        state, out = jsess.initial_state(2), []
        for s in range(8):
            lp, state, _ = jm.apply({"params": p}, ys[s], state,
                                    method=jm.predict)
            out.append(lp)
            if s == 3:
                state = jax.tree.map(lambda x: x[reorder], state)
        return jnp.stack(out)

    want = np.asarray(chain(params, ys))
    state = sess.initial_state(2)
    for s in range(8):
        lp, state = sess.predict(ys[s], state)
        _close(lp, want[s], f"step {s}")
        if s == 3:
            state = sess.select(state, reorder)


def _write_tsv(path, rows, fields):
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(fields)
        w.writerows(rows)


@pytest.mark.parametrize("unit", ["word", "char"])
@pytest.mark.parametrize("backward,serialize", [(False, False), (True, False),
                                                (False, True)])
def test_lm_dataset_matches_jax(tmp_path, unit, backward, serialize):
    rng = np.random.RandomState(5)
    words = ["ab", "ba", "abc", "ca", "b"]
    (tmp_path / "dict_word.txt").write_text(
        "".join(f"{w} {i + 4}\n" for i, w in enumerate(words)))
    (tmp_path / "dict_char.txt").write_text(
        "<space> 4\na 5\nb 6\nc 7\n")
    rows = []
    for i in rng.permutation(23):
        text = " ".join(rng.choice(words, rng.randint(0, 5)))
        # a few rows give their ids (which take precedence over the text)
        tid = " ".join(str(t) for t in rng.randint(4, 8, 3)) \
            if i % 7 == 0 else ""
        rows.append((f"utt{i:02d}", "spk", text, tid))
    tsv = tmp_path / "set.tsv"
    _write_tsv(tsv, rows, ("utt_id", "speaker", "text", "token_id"))
    kw = dict(dict_path=str(tmp_path / f"dict_{unit}.txt"), unit=unit,
              batch_size=3, bptt=4, backward=backward, serialize=serialize)
    want, got = JaxLMDataset(str(tsv), **kw), LMDataset(str(tsv), **kw)
    assert got.vocab == want.vocab and got.n_tokens == want.n_tokens
    np.testing.assert_array_equal(got.xs, want.xs)
    np.testing.assert_array_equal(got.ys, want.ys)
    assert len(got) == len(want) >= 3
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


@pytest.mark.parametrize("name", ["momentum", "nesterov"])
def test_momentum_matches_optax(name):
    """Clip, optax's sgd with momentum 0.9 (nesterov or not), then the
    weight decay unscaled by lr, as the JAX chain; three updates, the
    second below the clip norm."""
    rng = np.random.RandomState(6)
    shapes = [(5, 3), (7,), (2, 2, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    tx = jax_build_optimizer(name, lr=0.3, weight_decay=1e-2,
                             clip_grad_norm=5.0)
    state = tx.init([jnp.asarray(p) for p in params])
    opt = build_optimizer(name, lr=0.3, weight_decay=1e-2,
                          clip_grad_norm=5.0)
    opt.init([torch.from_numpy(p) for p in params])
    for scale in (3.0, 0.1, 10.0):
        grads = [scale * rng.randn(*s).astype(np.float32) for s in shapes]
        want, state = tx.update([jnp.asarray(g) for g in grads], state,
                                [jnp.asarray(p) for p in params])
        got = opt.update([torch.from_numpy(g) for g in grads])
        for g_, w in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
    sd = opt.state_dict([f"p{i}" for i in range(3)])
    assert sd["optimizer"] == name and sd["count"] == 3


LM_CONFS = sorted(str(p.relative_to(ROOT))
                  for p in ROOT.glob("examples/*/conf/lm/*.yaml"))


def test_every_lm_conf_is_listed():
    assert len(LM_CONFS) == 19


@pytest.mark.parametrize("conf", LM_CONFS)
def test_lm_conf_builds_with_jax_parameter_count(conf):
    args = SimpleNamespace(vocab=1000,
                           **yaml.safe_load((ROOT / conf).read_text()))
    jm = jax_build_lm(args)
    ys = jax.ShapeDtypeStruct((1, 4), jnp.int32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), ys, ys)
    want = sum(int(np.prod(x.shape))
               for x in jax.tree.leaves(shapes["params"]))
    lm = build_lm(args, device="meta")
    assert sum(p.numel() for p in lm.parameters()) == want
