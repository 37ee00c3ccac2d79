"""Port parity: the TDS and gated-conv (GLU) encoders.

* Each encoder's forward with the JAX module's weights carried across
  (``convert_params``: the (k, 1) Conv2d kernels, the LayerNorms over
  frequency and channels, the GLU blocks and their width changes), ragged
  lengths, against the JAX module: outputs within 2e-4 (float32, the
  repo's atol = rtol), lengths, output width and subsampling equal.
* How JAX's builder reads the recipes' keys, mirrored (ROADMAP C41, C42):
  the TDS kernels come from ``tds_kernel_sizes`` (six 21s by default),
  never from ``conv_kernel_sizes``, zipped with ``conv_channels``, so the
  WSJ conf's 11 layers build as 6 (14,278,720 encoder parameters, output
  1,440, subsampling 8) and the ``ci_test`` conf's 11 layers of (3, 1)
  kernels as 6 of 21 (1,826,360, output 560), and ``output_dim`` reads the
  last channel count even where the zip left it out; the gated-conv
  encoder reads
  ``gated_conv_layers`` (three ``100:3`` by default), never the WSJ GLU
  conf's 15 ``conv_channels`` / ``conv_kernel_sizes`` (208,900, output
  100). Each count is held to ``jax.eval_shape`` of JAX's encoder.
"""
import math
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from neural_sp_tpu.models.encoders.build import (
    build_encoder as jax_build_encoder)
from neural_sp_tpu.models.encoders.gated_conv import (
    GatedConvEncoder as JaxGLU)
from neural_sp_tpu.models.encoders.tds import TDSEncoder as JaxTDS
from neural_sp_tpu_torch.bin.args import parse_args_train
from neural_sp_tpu_torch.models.encoders.build import build_encoder
from neural_sp_tpu_torch.models.encoders.gated_conv import GatedConvEncoder
from neural_sp_tpu_torch.models.encoders.tds import TDSEncoder
from neural_sp_tpu_torch.utils.convert_params import convert_params

ATOL = RTOL = 2e-4
ROOT = Path(__file__).resolve().parents[1]
CASES = {
    # channel changes at layers 0 and 2 (two subsample blocks), kernels of
    # both parities, a bridge
    "tds": (JaxTDS, TDSEncoder, dict(channels="3_3_5_5", kernel_sizes="3_4_3_5",
                                     last_proj_dim=7)),
    # the ci_test conf's channels, zipped with fewer kernels (C41)
    "tds_zip": (JaxTDS, TDSEncoder, dict(channels="3_3_5_5_5_7_7",
                                         kernel_sizes="3_3_3")),
    # a width change mid-stack (a resize), even and odd kernels, a bridge
    "glu": (JaxGLU, GatedConvEncoder, dict(layers="8:3_8:4_10:2",
                                           last_proj_dim=5)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_encoder_matches_jax(name):
    jax_cls, port_cls, kw = CASES[name]
    rng = np.random.RandomState(0)
    xs = rng.randn(3, 19, 6).astype(np.float32)
    xlens = np.array([19, 11, 1], np.int32)
    jenc = jax_cls(input_dim=6, **kw)
    v = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(xs),
                           jnp.asarray(xlens))
    params = jax.tree.map(lambda x: np.asarray(x) + 0.1 * rng.randn(
        *x.shape).astype(np.float32), jax.tree.map(np.asarray, v["params"]))
    want = jax.jit(jenc.apply)({"params": params}, jnp.asarray(xs),
                               jnp.asarray(xlens))["ys"]
    port = port_cls(input_dim=6, **kw)
    port.load_state_dict(convert_params(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(xs), torch.from_numpy(xlens))["ys"]
    np.testing.assert_allclose(got["xs"].numpy(), np.asarray(want["xs"]),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got["xlens"].numpy(),
                                  np.asarray(want["xlens"]))
    assert port.output_dim == jenc.output_dim
    assert port.subsampling_factor == jenc.subsampling_factor
    if name == "tds_zip":
        # C41: output_dim and the subsampling factor read the channel
        # count 7, which the zip with three kernels left out: the stream
        # is 5 channels wide and halved twice
        assert (port.output_dim, got["xs"].shape[-1]) == (7 * 6, 5 * 6)
        assert (port.subsampling_factor, got["xlens"][0]) == (8, 5)


def _jax_count(args):
    enc = jax_build_encoder(args)
    shapes = jax.eval_shape(lambda: enc.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, args.input_dim)),
        jnp.array([64])))
    return sum(math.prod(x.shape) for x in jax.tree.leaves(shapes["params"]))


def _conf_args(conf):
    return parse_args_train(["--config", str(ROOT / "examples" / conf)])


# both confs' channels change at layers 0, 2 and 5 of the six kept
LAYERS = ["subsample0", "tds0", "tds1", "subsample2", "tds2", "tds3", "tds4",
          "subsample5", "tds5"]


@pytest.mark.parametrize("conf, n, out, factor", [
    ("wsj/conf/asr/tds_encoder.yaml", 14278720, 1440, 8),
    ("ci_test/conf/asr/tds_las.yaml", 1826360, 560, 8)])
def test_c41_tds_kernels_from_tds_kernel_sizes(conf, n, out, factor):
    args = _conf_args(conf)
    assert len(args.conv_channels.split("_")) == 11
    with torch.device("meta"):
        enc = build_encoder(args)
    names = [m for pair in enc.layers for m in pair if m is not None]
    assert names == LAYERS
    assert {getattr(enc, t).conv.kernel_size for _, t in enc.layers} == \
        {(21, 1)}
    assert sum(p.numel() for p in enc.parameters()) == n == _jax_count(args)
    assert (enc.output_dim, enc.subsampling_factor) == (out, factor)


def test_c42_gated_conv_layers_not_conv_channels():
    args = _conf_args("wsj/conf/asr/glu_encoder.yaml")
    assert len(args.conv_channels.split("_")) == 15
    with torch.device("meta"):
        enc = build_encoder(args)
    assert enc.n_layers == 3
    assert [getattr(enc, f"glu{i}").conv.kernel_size for i in range(3)] == \
        [(3,)] * 3
    assert sum(p.numel() for p in enc.parameters()) == 208900 == \
        _jax_count(args)
    assert (enc.output_dim, enc.subsampling_factor) == (100, 1)
