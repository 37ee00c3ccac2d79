"""Port parity: random state passing (RSP), the RNN encoder's carry passed
from one training batch to the next, against the JAX package on the same
numpy inputs with the JAX weights converted (``convert_params``), float32,
atol = rtol = 2e-4 (the repo's).

* ``make_rsp_train_step`` against JAX's on pinned draws (ROADMAP C4's
  way: the two packages draw differently, so each is handed the same
  decisions): three SGD steps of a small LSTM-LAS with CTC, the carry
  passed on, passed again and dropped; each step's losses, its update
  (lr times its gradient, each leaf within 2e-4 of its max plus lr 1e-6)
  and the carry it returns (``RNNEncoder.forward_with_carry``: a conv
  front end, two LSTM layers, ragged lengths).
* C16: the recipes' ``rsp_prob_enc``, which the JAX CLI does not read (it
  reads ``rsp_prob`` alone), is the rate of the port's train CLI; on the
  CPU the CLI passes each batch's carry to the next when the draw says
  so, and starts a batch of another size from zeros.
"""
import inspect
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import torch

import neural_sp_tpu_torch.parallel.mesh as port_mesh
from neural_sp_tpu.bin.args import parse_args_train as jax_parse_args
from neural_sp_tpu.bin.asr import train as jax_train
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu.parallel.mesh import make_rsp_train_step as jax_rsp_step
from neural_sp_tpu.trainers.optimizer import (
    build_optimizer as jax_build_optimizer)
from neural_sp_tpu_torch.bin.args import parse_args_train, save_config
from neural_sp_tpu_torch.bin.asr import train as port_train
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.parallel.mesh import make_rsp_train_step
from neural_sp_tpu_torch.trainers.optimizer import build_optimizer
from neural_sp_tpu_torch.utils.convert_params import convert_params

from test_torch_rnn_encoder import _tree, las_batch, small_las

ATOL = RTOL = 2e-4
ROOT = Path(__file__).resolve().parents[1]
RSP_CONF = "tedlium/conf/asr/mocha/lstm_mocha_rsp_enc.yaml"


def _carry_close(got, want):
    if torch.is_tensor(got):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _carry_close(g, w)


# pinned draws: JAX's step draws from fold_in(rng, 3); its draw is replaced
# by a function of that key, and the port's by the same decisions
def _jax_draw(key, p=0.5, shape=None):
    return key[-1] % 2 == 0


def _decisions(n_steps):
    """Seeds of the steps' keys whose pinned draws are True, True, False
    (the first step's carry is zeros either way), and those draws."""
    seeds, want = [], [True, True, False]
    seed = 0
    for use in want[:n_steps]:
        while bool(_jax_draw(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                3))) != use:
            seed += 1
        seeds.append(seed)
        seed += 1
    return seeds, want[:n_steps]


def test_rsp_step_matches_jax_on_pinned_draws(monkeypatch):
    lr = 0.1
    args = small_las("conv_lstm", dropout_enc=0.0, dropout_dec=0.0,
                     dropout_emb=0.0, ss_prob=0.0)
    jm = jax_build(args)
    batches = [las_batch(20 + i) for i in range(3)]
    params = _tree(jax.jit(jm.init)(jax.random.PRNGKey(0), *map(
        jnp.asarray, batches[0]))["params"])
    tm = build_speech2text(args, device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    tm.train()
    seeds, draws = _decisions(3)
    monkeypatch.setattr(jax.random, "bernoulli", _jax_draw)
    pinned = iter(draws)
    monkeypatch.setattr(port_mesh, "rsp_draw", lambda gen, p: next(pinned))
    tx = jax_build_optimizer("sgd", lr=lr)
    jstep = jax_rsp_step(jm, tx, 0.5)
    opt_state = tx.init(params)
    step = make_rsp_train_step(tm, build_optimizer("sgd", lr=lr), 0.5)
    _, jcarry = jax.jit(lambda p, x, xl: jm.apply(
        {"params": p}, x, xl, method=jm.encode))(
        params, *map(jnp.asarray, batches[0][:2]))
    jcarry = jax.tree.map(jnp.zeros_like, jcarry)
    carry = None
    for seed, b in zip(seeds, batches):
        before = convert_params(_tree(params))
        params, opt_state, jcarry, jmet = jstep(
            params, opt_state, jax.random.PRNGKey(seed), jcarry,
            *map(jnp.asarray, b))
        met, carry = step(carry, *map(torch.from_numpy, b),
                          gen=torch.Generator().manual_seed(seed))
        for name in ("loss", "loss_ctc", "loss_att", "grad_norm"):
            np.testing.assert_allclose(float(met[name]), float(jmet[name]),
                                       rtol=RTOL, err_msg=name)
        _carry_close(carry, jcarry)
        assert all(not c.requires_grad for layer in carry for c in layer)
        after = convert_params(_tree(params))
        state = tm.state_dict()
        for name, p0 in before.items():
            want_u = (after[name] - p0).numpy()
            got_u = (state[name] - p0).numpy()
            # the gradient's rule of test_torch_attention_dropout.py (2e-4
            # of the leaf's max plus 1e-6), on the update lr g
            np.testing.assert_allclose(
                got_u, want_u, rtol=0,
                atol=RTOL * float(np.abs(want_u).max()) + lr * 1e-6,
                err_msg=name)


def test_c16_the_port_reads_rsp_prob_enc_as_the_rate():
    """The conf sets ``rsp_prob_enc`` 0.5. The JAX CLI reads ``rsp_prob``
    alone (0 by its defaults), so it trains this conf without RSP; the
    port's CLI takes 0.5, as upstream. ``rsp_prob`` wins where both are
    set."""
    path = str(ROOT / "examples" / RSP_CONF)
    jargs, args = jax_parse_args(["--config", path]), \
        parse_args_train(["--config", path])
    assert jargs.rsp_prob_enc == args.rsp_prob_enc == 0.5
    assert getattr(jargs, "rsp_prob", 0.0) == 0.0
    src = inspect.getsource(jax_train.main)
    assert 'getattr(args, "rsp_prob", 0.0)' in src and \
        "rsp_prob_enc" not in src
    assert port_train.rsp_rate(args) == 0.5
    args.rsp_prob = 0.2
    assert port_train.rsp_rate(args) == 0.2


def _word_corpus(root: Path, n_train: int = 8) -> dict:
    """A tiny seeded corpus for the train CLI: features of 40-70 frames x
    20 as .npy, 1-4 words of a dictionary of 12, TSVs in the JAX
    package's columns."""
    rng = np.random.default_rng(4)
    root.mkdir(parents=True)
    (root / "dict.txt").write_text("".join(f"w{i} {i + 4}\n"
                                           for i in range(12)))
    paths = {"dict": str(root / "dict.txt")}
    for name, n in (("train", n_train), ("dev", 2)):
        rows = ["utt_id\tspeaker\tfeat_path\txlen\txdim\ttext\ttoken_id"
                "\tylen\tydim"]
        for i in range(n):
            t = int(rng.integers(40, 71))
            feat = root / f"{name}_{i}.npy"
            np.save(feat, rng.standard_normal((t, 20)).astype(np.float32))
            ids = rng.integers(0, 12, int(rng.integers(1, 5)))
            rows.append("\t".join((
                f"{name}_{i}", f"spk{i % 2}", str(feat), str(t), "20",
                " ".join(f"w{j}" for j in ids),
                " ".join(str(j + 4) for j in ids), str(len(ids)), "16")))
        paths[name] = str(root / f"{name}.tsv")
        Path(paths[name]).write_text("\n".join(rows) + "\n")
    return paths


def test_train_cli_passes_the_carry(tmp_path, monkeypatch):
    """A small LSTM-LAS conf with ``rsp_prob_enc`` one epoch on the CPU
    (batches of 3 and one smaller): each step gets the carry the step before
    returned when the draw says so, zeros (None) otherwise and for the
    batch of another size; the draws come from the step's generator."""
    corpus = _word_corpus(tmp_path / "corpus")
    conf = vars(small_las("conv_lstm", ss_prob=0.0))
    conf.pop("vocab")
    conf.update(batch_size=3, n_epochs=1, rsp_prob_enc=0.5, unit="word",
                print_step=1)
    save_config(conf, str(tmp_path / "conf.yml"))
    draws, calls = [], []
    real_draw, real_call = port_mesh.rsp_draw, port_mesh.RSPTrainStep.__call__

    def draw(gen, p):
        draws.append(real_draw(gen, p))
        return draws[-1]

    def call(self, carry, xs, *a, **kw):
        calls.append((carry, xs.shape[0]))
        out = real_call(self, carry, xs, *a, **kw)
        calls[-1] += (out[1],)
        return out

    monkeypatch.setattr(port_mesh, "rsp_draw", draw)
    monkeypatch.setattr(port_mesh.RSPTrainStep, "__call__", call)
    port_train.main(["--config", str(tmp_path / "conf.yml"), "--train_set",
                     corpus["train"], "--dev_set", corpus["dev"], "--dict",
                     corpus["dict"], "--model_save_dir",
                     str(tmp_path / "exp")], device="cpu")
    sizes = [n for _, n, _ in calls]
    assert len(draws) == len(calls) == 3 and len(set(sizes)) == 2
    for i, (carry, n, new) in enumerate(calls):
        # handed on as returned, None (zeros) first and at a new size
        if i == 0 or sizes[i - 1] != n:
            assert carry is None
        else:
            assert carry is calls[i - 1][2]
        assert len(new) == 2 and new[0][0].shape == (n, 16)
    assert any(calls[i][0] is not None for i in range(3))
