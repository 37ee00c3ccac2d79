"""The port as a package: its flagship config equals the benchmark's, it
never imports jax, and the weight converter fills every port tensor from
the JAX tree and refuses leaves it does not know."""
import ast
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import torch
import jax.numpy as jnp

from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu_torch import BLANK, EOS, PAD, SOS, UNK
from neural_sp_tpu_torch.configs import flagship_args
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.utils.convert_params import convert_params
from neural_sp_tpu_torch.utils.init_params import init_params

ROOT = Path(__file__).resolve().parents[1]


def _bench_flagship_args():
    """bench.py's flagship_args, taken from its source without importing
    bench.py (whose import configures jax for benchmarking)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "flagship_args")
    ns = {}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "bench.py", "exec"),
         ns)
    return ns["flagship_args"]


@pytest.mark.parametrize("faithful", [True, False])
def test_flagship_args_equal_bench(faithful):
    assert vars(flagship_args(faithful)) == \
        vars(_bench_flagship_args()(faithful))


def test_special_tokens_match():
    import neural_sp_tpu as ref
    assert (BLANK, UNK, EOS, SOS, PAD) == \
        (ref.BLANK, ref.UNK, ref.EOS, ref.SOS, ref.PAD)


def test_masks_match_jax():
    from neural_sp_tpu.ops import masks as jax_masks
    from neural_sp_tpu_torch.ops import masks
    import torch
    lens = np.array([5, 2, 0], np.int32)
    pad = masks.make_pad_mask(torch.from_numpy(lens), 6)
    np.testing.assert_array_equal(
        pad.numpy(), np.asarray(jax_masks.make_pad_mask(jnp.asarray(lens), 6)))
    san = masks.make_san_mask(pad)
    np.testing.assert_array_equal(
        san.numpy(), np.asarray(jax_masks.make_san_mask(jnp.asarray(
            pad.numpy()))))
    logits = np.random.RandomState(0).randn(3, 6, 6).astype(np.float32)
    got = masks.apply_mask_logits(torch.from_numpy(logits), san)
    want = jax_masks.apply_mask_logits(jnp.asarray(logits),
                                       jnp.asarray(san.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the all-masked row softmaxes to uniform, not NaN
    np.testing.assert_allclose(torch.softmax(got[2], -1).numpy(), 1 / 6)


_NO_JAX = """
import sys
from types import SimpleNamespace
import numpy as np
import neural_sp_tpu_torch
from neural_sp_tpu_torch.configs import flagship_args
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.models.decoders.decoding import (
    DecodeConfig, Speech2TextSession)
from neural_sp_tpu_torch.utils.init_params import init_params
args = vars(flagship_args(True))
args.update(enc_n_layers=2, transformer_d_model=32, transformer_d_ff=64,
            transformer_n_heads=2, dec_n_units=32, emb_dim=16,
            dec_bottleneck_dim=32, attn_dim=16, vocab=20, subsample="1_2")
model = init_params(build_speech2text(SimpleNamespace(**args), device="cpu"),
                    0).eval()
xs = np.random.RandomState(0).randn(1, 40, 80).astype(np.float32)
hyps = Speech2TextSession(model, DecodeConfig(beam_width=2, ctc_weight=0.3)
                          ).decode(xs, np.array([40]))
assert len(hyps) == 1
from neural_sp_tpu_torch.models.lm.build import build_lm
from neural_sp_tpu_torch.models.lm.session import LMSession
lm = init_params(build_lm(SimpleNamespace(
    lm_type="lstm", vocab=20, n_units=16, n_layers=2, emb_dim=16,
    tie_embedding=True, residual=True, use_glu=True), device="cpu"), 1).eval()
hyps = Speech2TextSession(
    model, DecodeConfig(beam_width=2, lm_weight=0.5, ilm_weight=0.2),
    lm_session=LMSession(lm)).decode(xs, np.array([40]))
assert len(hyps) == 1
import torch
from neural_sp_tpu_torch.parallel.mesh import make_train_step
from neural_sp_tpu_torch.trainers.lr_scheduler import noam_schedule
from neural_sp_tpu_torch.trainers.optimizer import build_optimizer
step = make_train_step(model.train(), build_optimizer(
    "noam", schedule=noam_schedule(32, 10), accum_grad_n_steps=1))
ys = np.array([[5, 6, 7]], np.int32)
met = step(*map(torch.from_numpy, (xs, np.array([40]), ys, np.array([3]))),
           gen=torch.Generator().manual_seed(0))
assert met["emitted"] and bool(torch.isfinite(met["grad_norm"]))
from neural_sp_tpu_torch.configs import librispeech_blstm_las_args
blstm = vars(librispeech_blstm_las_args())
blstm.update(conv_channels="4", conv_kernel_sizes="(3,3)",
             conv_poolings="(2,2)", enc_n_units=16, enc_n_layers=2,
             dec_n_units=32, emb_dim=16, dec_bottleneck_dim=32, attn_dim=16,
             vocab=20)
model = init_params(build_speech2text(SimpleNamespace(**blstm),
                                      device="cpu"), 0)
step = make_train_step(model.train(), build_optimizer("adam", lr=1e-3))
met = step(*map(torch.from_numpy, (xs, np.array([40]), ys, np.array([3]))),
           gen=torch.Generator().manual_seed(0))
assert met["emitted"] and bool(torch.isfinite(met["grad_norm"]))
hyps = Speech2TextSession(model.eval(), DecodeConfig(
    beam_width=2, ctc_weight=0.3)).decode(xs, np.array([40]))
assert len(hyps) == 1
import neural_sp_tpu_torch.bin.asr.eval
import neural_sp_tpu_torch.bin.asr.train
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("neural_sp_tpu.") or m == "neural_sp_tpu")
assert not bad, bad
print("ok")
"""


def test_port_never_imports_jax():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _small_args():
    args = vars(flagship_args(True))
    args.update(enc_n_layers=2, transformer_d_model=32, transformer_d_ff=64,
                transformer_n_heads=2, dec_n_units=32, emb_dim=16,
                dec_bottleneck_dim=32, attn_dim=16, vocab=20,
                subsample="1_2")
    return SimpleNamespace(**args)


@pytest.fixture(scope="module")
def jax_params():
    args = _small_args()
    v = jax_build(args).init(jax.random.PRNGKey(0), jnp.zeros((2, 40, 80)),
                             jnp.array([40, 30]), jnp.ones((2, 4), jnp.int32),
                             jnp.array([4, 2]))
    return jax.tree.map(np.asarray, v["params"])


def test_convert_params_fills_every_tensor(jax_params):
    model = build_speech2text(_small_args(), device="cpu")
    sd = convert_params(jax_params)
    n_leaves = len(jax.tree.leaves(jax_params))
    cell = jax_params["dec_fwd"]["step"]["cells_0"]
    # 8 LSTM leaves + 4 biases become w_ih / w_hh / bias
    assert len(sd) == n_leaves - len(jax.tree.leaves(cell)) + 3
    model.load_state_dict(sd, strict=True)
    assert set(sd) == set(model.state_dict())


def test_convert_params_ignores_attention_w_key_only(jax_params):
    tree = jax.tree.map(lambda x: x, jax_params)
    attn = dict(tree["dec_fwd"]["step"]["attn"])
    attn["w_key"] = {"kernel": np.zeros((32, 16), np.float32),
                     "bias": np.zeros(16, np.float32)}
    tree["dec_fwd"]["step"]["attn"] = attn
    assert set(convert_params(tree)) == set(convert_params(jax_params))
    tree["encoder"] = dict(tree["encoder"], extra={"kernel": np.zeros((2, 2))})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        build_speech2text(_small_args(), device="cpu").load_state_dict(
            convert_params(tree), strict=True)


def test_init_params_is_seeded():
    def built(seed):
        return init_params(build_speech2text(_small_args(), device="cpu"),
                           seed).state_dict()

    a, b, c = built(3), built(3), built(4)
    assert all(np.array_equal(a[k].numpy(), b[k].numpy()) for k in a)
    assert not np.array_equal(a["dec_fwd.key_proj.weight"].numpy(),
                              c["dec_fwd.key_proj.weight"].numpy())
    assert float(a["encoder.norm_out.weight"].min()) == 1.0


def test_build_speech2text_needs_the_card_or_an_explicit_cpu(monkeypatch):
    """The port's entry point builds on the card by default; without one it
    raises instead of falling back to the CPU, unless the caller asks for
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_speech2text(_small_args())
    model = build_speech2text(_small_args(), device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
