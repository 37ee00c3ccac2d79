"""Every recipe conf of ``examples/`` builds in the port at the JAX
package's parameter count: the 132 ASR confs (``examples/*/conf/asr/**``)
and the 27 other model confs (the 21 ASR confs of ``examples/*/conf/*.yaml``
and the 6 LM confs of ``examples/language_model/``), each on the meta
device, vocab 10,000 (the LMs 1,000).

The count is ``jax.eval_shape`` of the JAX model's ``init`` (the ASR
models on a [1, 64, 80] input, the LMs on [1, 4] tokens), traced here
once for each distinct set of the options JAX's builder reads, less the
ones that set no parameter (``NO_PARAMETER``; a float counts by its
sign, as a task's weight switches its head on). The confs that another
file already holds against ``jax.eval_shape`` (``HELD_ELSEWHERE``) are
left to it. Where JAX's builder fails on a conf, its count is that of
JAX's model with the recorded fault taken out, and the port builds the
conf as it is; each such conf is listed with its fault (``FAULTY``):

* C19, the swbd (B)LSTM confs with fewer subsampling factors than layers:
  JAX indexes a factor per layer and raises ``IndexError``; its count with
  the missing factors 1 (``swbd/conf/blstm_las.yaml`` is the one such
  conf among the 27). The other recorded faults of JAX's builder (C28,
  C44) are on confs held elsewhere.

``tedlium3/conf/*.yaml`` hold data options only and build no model.
"""
import math
from pathlib import Path
from types import SimpleNamespace

import pytest
import jax
import jax.numpy as jnp
import torch
import yaml

from neural_sp_tpu.models.lm.build import build_lm as jax_build_lm
from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu_torch.bin.args import parse_args_train
from neural_sp_tpu_torch.models.lm.build import build_lm
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from test_torch_lc_blstm import LC_CONFS
from test_torch_mocha import BUILDING as MOCHA_CONFS, _raising_confs
from test_torch_transducer import TRANSDUCER_CONFS
from test_torch_transformer import MMA_CONFS, PLAIN_CONFS
from test_torch_triggered import TRIG_CONF
from test_torch_uni_conformer import BUILDING as STREAMING_CONFS

ROOT = Path(__file__).resolve().parents[1] / "examples"
# the confs whose counts other files hold against jax.eval_shape (the MoChA
# ones with the MBR conf, the streaming, transformer-decoder, LC-BLSTM and
# transducer ones, and the triggered-attention one, C44)
HELD_ELSEWHERE = {*MOCHA_CONFS, *_raising_confs(), *STREAMING_CONFS,
                  *PLAIN_CONFS, *MMA_CONFS, *LC_CONFS, *TRANSDUCER_CONFS,
                  TRIG_CONF}
ASR_CONFS = sorted(str(p.relative_to(ROOT)) for p in ROOT.rglob("*.yaml")
                   if "/conf/asr/" in str(p))
OTHER_CONFS = sorted(
    c for c in (str(p.relative_to(ROOT)) for p in ROOT.rglob("*.yaml"))
    if "/conf/asr/" not in c and "/lm/" not in c and "/data/" not in c
    and not c.startswith("tedlium3/"))
LM_CONFS = [c for c in OTHER_CONFS if c.startswith("language_model/")]
HELD_HERE = [c for c in ASR_CONFS + OTHER_CONFS
             if c not in HELD_ELSEWHERE and c not in LM_CONFS]
# options JAX's builder reads that set no parameter: training, data,
# augmentation, latency training and the latency-controlled chunks
NO_PARAMETER = frozenset("""
    accum_grad_n_steps batch_size batch_size_type bucketing clip_grad_norm
    convert_to_sgd_epoch dynamic_batching early_stop_patient_n_epochs
    eval_start_epoch lr lr_decay_patient_n_epochs lr_decay_rate
    lr_decay_start_epoch lr_decay_type lr_factor max_n_frames min_n_frames
    metric mtl_per_batch n_epochs n_keep_best_checkpoints optimizer
    param_init print_step resume seed shuffle_bucket sort_stop_epoch
    train_dtype unit warmup_n_steps warmup_start_lr weight_decay freq_width
    n_freq_masks n_time_masks time_width time_width_upper input_noise_std
    mocha_decot_lookahead mocha_latency_metric mocha_init_r
    lc_chunk_size_left lc_chunk_size_current lc_chunk_size_right lc_type
    """.split())
FAULTY = {"swbd/conf/asr/blstm_las.yaml": "C19",
          "swbd/conf/asr/blstm_las_2mtl.yaml": "C19",
          "swbd/conf/asr/blstm_las_3mtl.yaml": "C19",
          "swbd/conf/asr/blstm_las_fisher_swbd.yaml": "C19",
          "swbd/conf/blstm_las.yaml": "C19"}
_JAX_COUNTS = {}
_MISSING = "<missing>"


def _read_options(args) -> tuple:
    """The options JAX's builder reads of ``args`` that can set a parameter,
    as a key: (name, value) pairs, a float by its sign (``vars`` of the
    namespace reads every option)."""
    read = set()

    class Recording(SimpleNamespace):
        def __getattribute__(self, name):
            if name == "__dict__":
                read.update(object.__getattribute__(self, "__dict__"))
            elif not name.startswith("__"):
                read.add(name)
            return object.__getattribute__(self, name)

    jax_build(Recording(**vars(args)))

    def value(v):
        return v > 0 if isinstance(v, float) else repr(v)

    return tuple(sorted((n, value(getattr(args, n)) if hasattr(args, n)
                        else _MISSING) for n in read - NO_PARAMETER))


def _eval_shape_count(init) -> int:
    shapes = jax.eval_shape(init)
    return sum(math.prod(x.shape) for x in jax.tree.leaves(shapes["params"]))


def _init_count(args) -> int:
    jm = jax_build(args)
    return _eval_shape_count(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 80)), jnp.array([64]),
        jnp.ones((1, 3), jnp.int32), jnp.array([3])))


def _jax_count(args) -> tuple:
    """(JAX's parameter count of the ASR conf ``args``, the fault taken out
    of it or None), traced once per key of ``_read_options``. C19: JAX's
    RNN encoder indexes a subsampling factor per layer and raises
    ``IndexError`` where the conf lists fewer; its count with the missing
    factors 1."""
    key = _read_options(args)
    if key not in _JAX_COUNTS:
        try:
            _JAX_COUNTS[key] = (_init_count(args), None)
        except IndexError:
            factors = str(getattr(args, "subsample", "") or "1").split("_")
            factors += ["1"] * (args.enc_n_layers - len(factors))
            _JAX_COUNTS[key] = (_init_count(SimpleNamespace(
                **{**vars(args), "subsample": "_".join(factors)})), "C19")
    return _JAX_COUNTS[key]


def _asr_args(conf: str):
    args = parse_args_train(["--config", str(ROOT / conf)])
    args.vocab = 10000
    return args


def _count(model) -> int:
    return sum(p.numel() for p in model.parameters())


def _meta_model(conf: str):
    """The conf's model built straight on the meta device (no CPU
    initialisation to throw away)."""
    with torch.device("meta"):
        return build_speech2text(_asr_args(conf), device="meta")


def test_every_model_conf_is_held():
    """The 132 + 27 confs, each held here or in another file, and the
    faults recorded are those of confs held here."""
    assert (len(ASR_CONFS), len(OTHER_CONFS), len(LM_CONFS)) == (132, 27, 6)
    assert HELD_ELSEWHERE <= set(ASR_CONFS + OTHER_CONFS)
    assert set(HELD_HERE) | HELD_ELSEWHERE | set(LM_CONFS) == \
        set(ASR_CONFS + OTHER_CONFS)
    assert set(FAULTY) <= set(HELD_HERE)


@pytest.mark.parametrize("conf", HELD_HERE)
def test_asr_conf_builds_at_jax_count(conf):
    args = _asr_args(conf)
    n, fault = _jax_count(args)
    assert fault == FAULTY.get(conf)
    assert _count(_meta_model(conf)) == n


@pytest.mark.parametrize("conf", LM_CONFS)
def test_lm_conf_builds_at_jax_count(conf):
    args = SimpleNamespace(vocab=1000,
                           **yaml.safe_load((ROOT / conf).read_text()))
    jm = jax_build_lm(args)
    want = _eval_shape_count(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32),
        jnp.ones((1, 4), jnp.int32)))
    with torch.device("meta"):
        assert _count(build_lm(args, device="meta")) == want


def test_relative_transformer_adds_no_parameter():
    """``relative`` positions go through ``w_value``: the transformer conf
    with them has the count of the one with ``add``, on blocks that attend
    with relative positions."""
    model = _meta_model("timit/conf/transformer_relative.yaml")
    assert _count(model) == _count(_meta_model("timit/conf/transformer.yaml"))
    assert all(b.relative and not b.conformer for b in model.encoder.blocks)
