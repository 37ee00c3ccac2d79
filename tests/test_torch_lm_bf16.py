"""Port parity: the four LM families trained at bf16 compute over float32
master weights (the JAX LM train CLI's ``--train_dtype bfloat16``: its
``step_fn`` casts the floating parameters, passes the carried state as it
is and takes the loss in float32), on the CPU, by
``tests/test_torch_bf16.py``'s rule: each quantity X (a loss, a gradient
leaf, a carried state) is held, per leaf in the L2 norm, to

    |X_port,bf16 - X_jax,bf16| <= 2 |X_jax,bf16 - X_jax,f32|
                                  + 1e-3 |X_jax,f32|

What JAX computes at bf16 differs by family, and the port's dtypes are
asserted to be JAX's:

* the Transformer LM and the GCNN: bf16 throughout (their state is None
  in training);
* the RNNLM: flax's LSTM starts from a float32 zero carry, so only layer
  0's input product is bf16 and the rest float32 over the bf16-rounded
  weights; the state (c, h) is float32;
* the Transformer-XL: float32 throughout over the bf16-rounded weights,
  since its embedding is scaled by a float32 array, which promotes it
  (ROADMAP C50); its memories are float32, and its attention runs K1 /
  K1b's float32 entries (with dropout in training), not the bf16 ones.

* One training window of each family after a first one (the state
  carried, dropout off), through ``bin/lm/train.py::window_loss``: the
  loss and every gradient leaf, and the carried state and its dtype.
* The LM train CLI at ``--train_dtype bfloat16``: one epoch of a tiny XL
  (dropout off) from the JAX CLI's initial weights, its train loss in
  ``history.csv`` by the rule against the JAX CLI's at bf16 and float32.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import yaml
import jax
import jax.numpy as jnp
import torch

from neural_sp_tpu.bin.lm import train as jax_lm_train
from neural_sp_tpu.models.lm.build import build_lm as jax_build_lm
from neural_sp_tpu.parallel.mesh import cast_floating
from neural_sp_tpu.utils.ci_corpus import make_ci_corpus
from neural_sp_tpu_torch.bin.lm import train as port_lm_train
from neural_sp_tpu_torch.bin.lm.train import detach, window_loss
from neural_sp_tpu_torch.models.lm.build import build_lm
from neural_sp_tpu_torch.utils.convert_params import convert_params

from test_torch_bf16 import _converted, assert_leaves, assert_rule
from test_torch_rnn_bf16 import in_threads, random_params

BF16 = jnp.bfloat16
VOCAB, B, BPTT = 30, 3, 5
OFF = dict(dropout_in=0.0, dropout_hidden=0.0, dropout_att=0.0)
FAMILIES = {
    "rnnlm": dict(lm_type="lstm", n_units=16, n_projs=8, n_layers=2,
                  emb_dim=8, residual=True, use_glu=True, tie_embedding=True),
    "transformer": dict(lm_type="transformer", n_layers=2,
                        transformer_d_model=32, transformer_d_ff=48,
                        transformer_n_heads=4),
    "transformer_xl": dict(lm_type="transformer_xl", n_layers=2,
                           transformer_d_model=32, transformer_d_ff=48,
                           transformer_n_heads=2, mem_len=8,
                           tie_embedding=True),
    "gated_conv": dict(lm_type="gated_conv", emb_dim=16,
                       gated_conv_layers="16:3_24:2:8_24:1"),
}
# the state's dtype JAX's step carries at bf16 (None: no state)
STATE_DTYPE = {"rnnlm": torch.float32, "transformer": None,
               "transformer_xl": torch.float32, "gated_conv": None}


def _flat(state):
    if state is None:
        return []
    if torch.is_tensor(state) or hasattr(state, "shape"):
        return [state]
    return [x for s in state for x in _flat(s)]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_lm_window_bf16_matches_jax(name):
    args = SimpleNamespace(vocab=VOCAB, lsm_prob=0.1, **OFF,
                           **FAMILIES[name])
    jm = jax_build_lm(args)
    ys = jnp.zeros((B, BPTT), jnp.int32)
    params = random_params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), ys, ys)["params"], 1)
    rng = np.random.RandomState(1)
    xi = rng.randint(4, VOCAB, (2, B, BPTT)).astype(np.int32)
    xo = rng.randint(2, VOCAB, (2, B, BPTT)).astype(np.int32)

    def windows(p, dt):
        """JAX's step_fn's loss over two windows, the state carried; the
        second window's loss, its gradients and the state it returns."""
        def loss_fn(p_, st):
            if dt is not None:
                p_ = cast_floating(p_, dt)
            loss, new_state, _ = jm.apply({"params": p_}, xi[w], xo[w], st,
                                          False)
            return loss.astype(jnp.float32), new_state
        state = None
        for w in range(2):
            (loss, state), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(p, state)
        return loss, grads, state

    (lb, gb, sb), (lf, gf, sf) = in_threads(*(
        lambda dt=dt: jax.jit(windows, static_argnums=1)(params, dt)
        for dt in (BF16, None)))
    tm = build_lm(args, device="cpu").train()
    tm.load_state_dict(convert_params(params), strict=True)
    state = None
    for w in range(2):
        tm.zero_grad()
        loss, state, obs = window_loss(
            tm, torch.bfloat16, torch.from_numpy(xi[w]).long(),
            torch.from_numpy(xo[w]).long(), state,
            torch.Generator().manual_seed(w))
        loss.backward()
        state = detach(state)
    assert loss.dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in obs.values())
    assert_rule(float(loss.detach()), float(lb), float(lf), f"{name} loss")
    assert_leaves({n: p.grad.numpy() for n, p in tm.named_parameters()},
                  _converted(gb), _converted(gf), f"{name} grad")
    got, want_b, want_f = _flat(state), _flat(sb), _flat(sf)
    assert len(got) == len(want_b)
    for i, (g, wb, wf) in enumerate(zip(got, want_b, want_f)):
        assert g.dtype == STATE_DTYPE[name], (name, i, g.dtype)
        assert str(wb.dtype) == str(g.dtype).replace("torch.", "")
        assert_rule(g.double(), np.asarray(wb, np.float64), wf,
                    f"{name} state {i}")


XL_CONF = dict(FAMILIES["transformer_xl"], **OFF, unit="word", batch_size=5,
               bptt=6, n_epochs=1, print_step=1, lsm_prob=0.1,
               optimizer="adam", lr=1e-3, clip_grad_norm=1.0)


def test_lm_train_cli_bf16_matches_jax(tmp_path, monkeypatch):
    """Both LM train CLIs for one epoch of the tiny XL from the same
    weights (the JAX CLI's initial ones, converted), JAX's at bf16 and at
    float32, the port's at bf16: the epoch's train loss by the rule, the
    port's dev PPL finite."""
    monkeypatch.setenv("NSP_COMPILE_CACHE", str(tmp_path / "xla_cache"))
    corpus = make_ci_corpus(str(tmp_path / "corpus"), n_train=20, n_dev=4,
                            n_test=2, max_words=5, seed=9)
    conf = tmp_path / "xl.yml"
    conf.write_text(yaml.safe_dump(XL_CONF))
    data = ["--config", str(conf), "--train_set", corpus["train_word"],
            "--dev_set", corpus["dev_word"], "--dict", corpus["dict_word"]]
    initial = {}
    build = jax_lm_train.build_lm

    def capture_init(args):
        lm = build(args)
        # one compile for both JAX runs (the same conf)
        init = initial.setdefault("init", jax.jit(lm.init))

        def recorded(*a, **kw):
            out = init(*a, **kw)
            initial.setdefault("params", jax.tree.map(np.asarray,
                                                      out["params"]))
            return out
        object.__setattr__(lm, "init", recorded)
        return lm

    def jax_weights(lm, seed):
        lm.load_state_dict(convert_params(initial["params"]), strict=True)
        return lm

    monkeypatch.setattr(jax_lm_train, "build_lm", capture_init)
    monkeypatch.setattr(port_lm_train, "init_params", jax_weights)
    rows = {}
    for tag, dt in (("jax_bf16", "bfloat16"), ("jax_f32", "float32"),
                    ("port_bf16", "bfloat16")):
        out = str(tmp_path / tag)
        argv = data + ["--model_save_dir", out, "--train_dtype", dt]
        if tag.startswith("jax"):
            # no dev pass: one compile less (only the port's dev PPL is
            # read)
            jax_lm_train.main(argv + ["--eval_start_epoch", "2"])
        else:
            port_lm_train.main(argv, device="cpu")
        with open(os.path.join(out, "history.csv")) as f:
            head, *body = f.read().splitlines()
        rows[tag] = dict(zip(head.split(","), body[-1].split(",")))
    got, wb, wf = (float(rows[t]["train_loss"])
                   for t in ("port_bf16", "jax_bf16", "jax_f32"))
    assert_rule(got, wb, wf, "train_loss")
    assert np.isfinite(float(rows["port_bf16"]["dev_ppl"]))
