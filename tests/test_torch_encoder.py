"""Port parity: the conformer encoder at the flagship's configuration with
the widths shrunk (2 layers, d_model 64, 4 heads, d_ff 128), both
subsampling variants, plus the padded == packed invariance of the batch
edge. Weights come from the JAX model through ``convert_params``.
Tolerance: float32, atol = rtol = 2e-4 (the repo's)."""
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu_torch.configs import flagship_args
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.utils.convert_params import convert_params

ATOL = RTOL = 2e-4


def small_flagship(faithful: bool):
    """The flagship with its widths shrunk; the subsampling layout (conv
    pooling, interlayer max_pool / drop) stays, moved to 2 layers."""
    args = vars(flagship_args(faithful))
    args.update(enc_n_layers=2, transformer_d_model=64,
                transformer_d_ff=128, transformer_n_heads=4, dec_n_units=64,
                emb_dim=32, dec_bottleneck_dim=64, attn_dim=32, vocab=40,
                subsample="1_2" if faithful else "2_1")
    return SimpleNamespace(**args)


def _models(faithful: bool, seed: int = 0):
    args = small_flagship(faithful)
    jm = jax_build(args)
    rng = np.random.RandomState(seed)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((2, 48, 80)),
                jnp.array([48, 30]), jnp.ones((2, 4), jnp.int32),
                jnp.array([4, 2]))
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.randn(*x.shape).astype(
            np.float32), jax.tree.map(np.asarray, v["params"]))
    tm = build_speech2text(args, device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    return jm, {"params": params}, tm.eval()


@pytest.mark.parametrize("t,xlens", [
    (67, [67, 50, 21]),     # packed
    (80, [45, 30, 21]),     # bucket-padded past max(xlens)
])
@pytest.mark.parametrize("faithful", [True, False])
def test_encoder_parity(faithful, t, xlens):
    jm, v, tm = _models(faithful)
    rng = np.random.RandomState(1)
    xs = rng.randn(3, t, 80).astype(np.float32)
    xlens = np.asarray(xlens, np.int32)
    want, _ = jm.apply(v, jnp.asarray(xs), jnp.asarray(xlens),
                       method=jm.encode)
    with torch.no_grad():
        got, _ = tm.encode(torch.from_numpy(xs), torch.from_numpy(xlens))
    np.testing.assert_array_equal(got["ys"]["xlens"].numpy(),
                                  np.asarray(want["ys"]["xlens"]))
    np.testing.assert_allclose(got["ys"]["xs"].numpy(),
                               np.asarray(want["ys"]["xs"]),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("faithful", [True, False])
def test_encoder_padded_equals_packed(faithful):
    """A bucket-padded batch (T past max(xlens)) gives the same valid
    frames as the packed one: the conv frontend and the conformer conv
    both treat max(xlens) as the array's end. The interlayer max_pool
    does not: at an odd frame count its last window takes the frame past
    the edge (zero-padded only past the array's end), in the JAX model as
    here (test_encoder_parity's padded case holds the port to that), so
    the invariance is asserted at a length whose frame count is even at
    the pool."""
    _, _, tm = _models(faithful)
    rng = np.random.RandomState(2)
    xlens = np.array([44, 30], np.int32)
    packed = rng.randn(2, 44, 80).astype(np.float32)
    padded = np.concatenate(
        [packed, 5.0 * rng.randn(2, 35, 80).astype(np.float32)], 1)
    with torch.no_grad():
        a, _ = tm.encode(torch.from_numpy(packed), torch.from_numpy(xlens))
        b, _ = tm.encode(torch.from_numpy(padded), torch.from_numpy(xlens))
    for i, n in enumerate(a["ys"]["xlens"].tolist()):
        np.testing.assert_allclose(b["ys"]["xs"][i, :n].numpy(),
                                   a["ys"]["xs"][i, :n].numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_unported_options_raise():
    args = small_flagship(True)
    for field, value in (("transformer_enc_pe_type", "relative_xl"),
                         ("enc_type", "bgru"), ("dec_type", "transformer"),
                         ("lm_fusion", "cold"), ("bwd_weight", 0.3),
                         ("subsample_type", "conv1d"), ("dec_n_layers", 2)):
        bad = SimpleNamespace(**{**vars(args), field: value})
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_speech2text(bad, device="cpu")
