"""Port parity: the unidirectional Conformer with MoChA (the LibriSpeech
recipe's conf, its widths cut), the confs of the streaming slice, and the
reference quirks it meets, against the JAX package on the same numpy
inputs with the JAX weights converted (``convert_params``), float32,
atol = rtol = 2e-4 (the repo's).
* A small uni-Conformer-MoChA ``Speech2Text`` (two interlayer max_pools,
  the causal mask rebuilt after each, the causal conformer convolution,
  MoChA with the quantity loss and StableEmit) in ``train()`` with dropout
  and noise off: the loss, its parts and every gradient leaf against
  ``jax.grad``; one clipped Adam update with accumulation against JAX's
  ``make_train_step`` (``test_torch_train_step.py``'s rule).
* The 15 confs that set chunk sizes or a ``uni_`` encoder and get past
  every other raise build on the meta device at JAX's parameter counts
  (the transducer uni-Conformer among them since the RNN transducer was
  ported; it raised on its decoder before); the ci_test LC conf raises on
  ``dropout_att``, naming ROADMAP; ``configs``' three new arg sets equal
  their yamls.
* The quirks (ROADMAP C17, C25-C28), each as the JAX package has it.
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

from neural_sp_tpu.models.speech2text import build_speech2text as jax_build
from neural_sp_tpu.parallel.mesh import make_train_step as jax_make_step
from neural_sp_tpu.trainers.optimizer import (
    build_optimizer as jax_build_optimizer)
from neural_sp_tpu_torch.bin.args import parse_args_train
from neural_sp_tpu_torch.configs import (
    librispeech_lc_transformer_mma_args, librispeech_uni_conformer_mocha_args,
    uni_conformer_mocha_streaming_args)
from neural_sp_tpu_torch.models.modules import \
    relative_multihead_attention as rma
from neural_sp_tpu_torch.models.speech2text import build_speech2text
from neural_sp_tpu_torch.parallel.mesh import make_train_step
from neural_sp_tpu_torch.trainers.optimizer import build_optimizer
from neural_sp_tpu_torch.utils.convert_params import convert_params
from neural_sp_tpu_torch.utils.init_params import init_params

from test_torch_train_step import _moments

ATOL = RTOL = 2e-4
ROOT = Path(__file__).resolve().parents[1]
UNI_CONFORMER = ("librispeech/conf/asr/mocha/uni_conformer_kernel7_clamp10_"
                 "hie_subsample8_mocha_ln_stableemit0.2_qua0.2.yaml")
STREAMING = "librispeech/conf/asr/uni_conformer_mocha_streaming.yaml"
LC_TRANSFORMER = ("librispeech/conf/asr/mma/streaming/lc_transformer_mma_"
                  "subsample8_ma4H_ca4H_w16_from4L_64_128_64.yaml")
# the confs of the slice, with JAX's parameter counts at vocab 10,000
BUILDING = {
    "aishell/conf/asr/mma/lc_transformer_mma_hie_subsample8_ma4H_ca4H_w16_"
    "from4L_64_128_64.yaml": 35803468,
    "aishell/conf/asr/mma/lc_transformer_mma_hie_subsample8_ma4H_ca4H_w16_"
    "from4L_96_64_32.yaml": 35803468,
    "librispeech/conf/asr/lc_transformer_mma_64_128_64.yaml": 35576204,
    LC_TRANSFORMER: 35576204,
    "librispeech/conf/asr/mma/streaming/lc_transformer_mma_subsample8_ma4H_"
    "ca4H_w16_from4L_96_64_32.yaml": 35576204,
    "librispeech/conf/asr/mma/streaming/lc_transformer_mma_subsample8_ma4H_"
    "ca4H_w16_from4L_512dmodel_8H_64_128_64.yaml": 78118156,
    "librispeech/conf/asr/mma/streaming/lc_transformer_mma_subsample8_ma4H_"
    "ca4H_w16_from4L_512dmodel_8H_96_64_32.yaml": 78118156,
    "librispeech/conf/asr/mma/streaming/lc_transformer_mma_subsample8_ma4H_"
    "ca4H_w16_from4L_768dmodel_3072dff_8H_64_128_64.yaml": 161179788,
    "tedlium/conf/asr/mma/streaming/lc_transformer_mma_subsample8_ma4H_ca4H_"
    "w16_from4L_64_128_64.yaml": 35639628,
    "tedlium/conf/asr/mma/streaming/lc_transformer_mma_subsample8_ma4H_ca4H_"
    "w16_from4L_96_64_32.yaml": 35639628,
    UNI_CONFORMER: 49158337,
    "tedlium/conf/asr/mocha/uni_conformer_kernel7_clamp10_hie_subsample8_"
    "mocha_long_ln.yaml": 49158337,
    "tedlium/conf/asr/mocha/uni_conformer_kernel7_clamp10_hie_subsample8_"
    "mocha_long_ln_stableemit0.1.yaml": 49158337,
    STREAMING: 31935681,
    "tedlium/conf/asr/transducer/uni_conformer_kernel7_clamp10_hie_"
    "subsample8_rnnt_long_ln_bpe1k.yaml": 55189696,
}
# the ci_test conf raised on its attention dropout until that was ported;
# it builds now at JAX's count (tests/test_torch_ci_test_confs.py holds
# the ci_test confs' counts)
CI_LC = {"ci_test/conf/asr/lc_transformer_mma_ma4H_ca4H_w16_from4L_64_128_"
         "64.yaml": 547016}


def _tree(params):
    return jax.tree.map(np.asarray, params)


def _conf_args(conf, vocab=10000):
    args = parse_args_train(["--config", str(ROOT / "examples" / conf)])
    args.vocab = vocab
    return args


# ----------------------------------------------------------- whole model
def small_uni_conformer(**over):
    """The LibriSpeech uni-Conformer-MoChA with its widths cut: the conv
    front end (4 channels, pooling (1, 1) then (2, 2)), 2 conformer layers
    of d 32 / 2 heads / d_ff 48, each followed by a max_pool, clamp 10,
    kernel 7; decoder 32, attention 16, vocab 40, CTC fc 16; dropout,
    SpecAugment and noise off; ``mocha_init_r`` a float (C17)."""
    args = vars(librispeech_uni_conformer_mocha_args())
    args.update(input_dim=20, conv_channels="4_4", enc_n_layers=2,
                subsample="2_2", transformer_enc_d_model=32,
                transformer_enc_d_ff=48, transformer_enc_n_heads=2,
                dec_n_units=32, emb_dim=16, dec_bottleneck_dim=32,
                attn_dim=16, vocab=40, ctc_fc_list="16", dropout_enc=0.0,
                dropout_dec=0.0, dropout_emb=0.0, mocha_std=0.0,
                mocha_init_r=-1.0, n_freq_masks=0, n_time_masks=0)
    args.update(over)
    return SimpleNamespace(**args)


def uni_batch(seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.randn(3, 48, 20).astype(np.float32)
    xlens = np.array([48, 37, 25], np.int32)
    ylens = np.array([5, 3, 2], np.int32)
    ys = np.full((3, 5), 3, np.int32)
    for b, u in enumerate(ylens):
        ys[b, :u] = rng.randint(4, 40, u)
    return xs, xlens, ys, ylens


_INIT = {}


def _models():
    args = small_uni_conformer()
    jm = jax_build(args)
    if "p" not in _INIT:
        rng = np.random.RandomState(3)
        _INIT["p"] = jax.tree.map(lambda x: x + 0.05 * rng.randn(
            *x.shape).astype(np.float32), _tree(jax.jit(jm.init)(
                jax.random.PRNGKey(0), *map(jnp.asarray, uni_batch()))[
                    "params"]))
    params = _INIT["p"]
    tm = build_speech2text(args, device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    return jm, params, tm


def test_uni_conformer_mocha_loss_and_grads_match_jax(monkeypatch):
    jm, params, tm = _models()
    b = uni_batch(1)
    windows = []
    orig = rma.rel_attention

    def spy(*a, **kw):
        windows.append(kw.get("window"))
        return orig(*a, **kw)

    monkeypatch.setattr(rma, "rel_attention", spy)

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
    assert windows == [(-1, 1, 0)] * 2        # K1 (plain here), causal
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=RTOL)
    for name in ("loss_ctc", "loss_att", "acc_att", "loss_quantity"):
        np.testing.assert_allclose(float(obs[name].detach()),
                                   float(jobs[name]), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    want_g = convert_params(_tree(grads))
    assert set(want_g) == {n for n, _ in tm.named_parameters()}
    # the attention keys' bias shifts every score of a row alike: its
    # gradient is 0 up to rounding, held to 1e-5 of the largest gradient
    floor = 1e-5 * max(float(g.abs().max()) for g in want_g.values())
    for name, p in tm.named_parameters():
        w = want_g[name].numpy()
        atol = floor if name.endswith("mha.w_key.bias") else \
            RTOL * max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=atol,
                                   err_msg=name)


def test_uni_conformer_mocha_update_matches_jax():
    """Two microbatches, Adam with k = 2 accumulation and clip 0.5 (active):
    the metrics of each microstep and the update, by
    test_torch_train_step.py's rule."""
    clip, k, lr = 0.5, 2, 1e-3
    jm, params, tm = _models()
    params0 = convert_params(params)
    tx = jax_build_optimizer("adam", lr=lr, clip_grad_norm=clip,
                             accum_grad_n_steps=k)
    jstep = jax_make_step(jm, tx, donate=False)
    opt_state = tx.init(params)
    step = make_train_step(tm.train(), build_optimizer(
        "adam", lr=lr, clip_grad_norm=clip, accum_grad_n_steps=k))
    for i, b in enumerate((uni_batch(10), uni_batch(11))):
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
        n_sure += int(sure.sum())
        n_all += sure.size
    assert n_sure > 0.8 * n_all


# ---------------------------------------------------------------- confs
_JAX_COUNTS = {}
# the fields a parameter count can depend on (none of the lc_* ones)
_SHAPE_KEYS = ("enc_type", "input_dim", "conv_channels", "conv_poolings",
               "subsample", "enc_n_layers", "transformer_enc_d_model",
               "transformer_enc_d_ff", "transformer_d_model",
               "transformer_d_ff", "conformer_kernel_size", "dec_type",
               "dec_n_layers", "dec_n_units", "emb_dim", "attn_dim",
               "transformer_dec_d_model", "transformer_dec_d_ff",
               "mocha_first_layer", "mocha_n_heads_mono",
               "mocha_n_heads_chunk", "mocha_chunk_size", "ctc_fc_list",
               "vocab")


def _jax_count(args):
    """JAX's parameter count, once per shape; the confs with an interlayer
    subsample and chunks cannot run JAX's forward (C28), so they count
    with the chunks off (no parameter depends on them)."""
    key = tuple(str(getattr(args, k, None)) for k in _SHAPE_KEYS)
    if key not in _JAX_COUNTS:
        jm = jax_build(SimpleNamespace(**{**vars(args),
                                          "lc_chunk_size_current": -1}))
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 256, 80)),
            jnp.array([256]), jnp.ones((1, 3), jnp.int32), jnp.array([3])))
        _JAX_COUNTS[key] = sum(math.prod(x.shape)
                               for x in jax.tree.leaves(shapes["params"]))
    return _JAX_COUNTS[key]


@pytest.mark.parametrize("conf", list(BUILDING))
def test_streaming_slice_conf_builds(conf):
    args = _conf_args(conf)
    with torch.device("meta"):
        model = build_speech2text(args, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == BUILDING[conf] == _jax_count(args)
    enc = model.encoder
    assert enc.unidirectional == ("uni_" in args.enc_type)
    assert enc.chunk_size_current == getattr(args, "lc_chunk_size_current",
                                             -1)


def test_the_other_streaming_confs_raise():
    out = subprocess.run(
        ["grep", "-rlE", "lc_chunk|uni_conformer|uni_transformer",
         str(ROOT / "examples")], capture_output=True, text=True,
        check=True).stdout.split()
    confs = sorted(str(Path(p).relative_to(ROOT / "examples")) for p in out
                   if "/conf/" in p and p.endswith(".yaml")
                   and ("transformer" in p or "conformer" in p)
                   and "blstm" not in p)   # an LC-BLSTM encoder: C13
    assert set(BUILDING) | set(CI_LC) == set(confs)
    for conf, n in CI_LC.items():
        model = build_speech2text(_conf_args(conf), device="meta")
        assert sum(p.numel() for p in model.parameters()) == n


@pytest.mark.parametrize("conf, make, dtype", [
    (UNI_CONFORMER, librispeech_uni_conformer_mocha_args, "float32"),
    (STREAMING, uni_conformer_mocha_streaming_args, "bfloat16"),
    (LC_TRANSFORMER, librispeech_lc_transformer_mma_args, "float32")])
def test_streaming_slice_args_equal_the_conf(conf, make, dtype):
    full = vars(parse_args_train(["--config", str(ROOT / "examples" / conf)]))
    args = vars(make())
    assert args.pop("vocab") == 10000
    assert args == {k: full[k] for k in args}
    assert full.get("train_dtype") == dtype


# --------------------------------------------------------------- quirks
def test_c25_recipe_uni_conformer_cannot_stream():
    """The recipe uni-Conformer confs set no chunk: JAX's stream_geometry
    asserts chunk_size_current > 0, and the port's raises too."""
    args = _conf_args(UNI_CONFORMER)
    with pytest.raises(AssertionError, match="chunk_size_current"):
        jax_build(args).encoder.stream_geometry()
    with torch.device("meta"):
        model = build_speech2text(args, device="meta")
    with pytest.raises(ValueError, match="chunk_size_current"):
        model.encoder.stream_geometry()


def test_c17_integer_init_r_trains_in_the_port_only():
    """``mocha_init_r: -2`` is a YAML integer (C17): JAX makes ``r`` an
    int32 leaf, which ``jax.grad`` refuses; the port's ``r`` is float32
    and trains."""
    args = small_uni_conformer(mocha_init_r=-2)
    assert isinstance(_conf_args(UNI_CONFORMER).mocha_init_r, int)
    jm = jax_build(args)
    b = tuple(map(jnp.asarray, uni_batch()))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *b))
    assert shapes["params"]["dec_fwd"]["step"]["attn"]["monotonic_energy"][
        "r"].dtype == jnp.int32
    params = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype),
                          shapes["params"])
    with pytest.raises(TypeError, match="int32"):
        jax.grad(lambda p: jm.apply({"params": p}, *b)[0])(params)
    tm = init_params(build_speech2text(args, device="cpu"), 0)
    assert tm.dec_fwd.step.attn.monotonic_energy.r.dtype == torch.float32
    loss, _ = tm.train()(*map(torch.from_numpy, uni_batch()),
                         torch.Generator().manual_seed(0))
    loss.backward()
    assert torch.isfinite(tm.dec_fwd.step.attn.monotonic_energy.r.grad).all()


def test_c27_streamed_uni_encoder_is_the_chunk_before_conv_forward():
    """The streaming conf is unidirectional, so its offline mask-mode
    forward runs the CNN over the whole utterance, while streaming_step
    runs it per block: the two differ at block edges (in JAX as here).
    What a block-by-block stream equals is the offline forward with the
    CNN per chunk, the bidirectional (``lc_bidir``) path: the same weights
    with ``unidirectional`` off, whose blocks are identical otherwise
    (the chunkwise mask, the causal convolution)."""
    from neural_sp_tpu_torch.frontends.streaming import StreamingDriver
    from neural_sp_tpu_torch.models.encoders.transformer import XformerEncoder
    kw = dict(input_dim=20, btype="conformer", d_model=32, d_ff=48,
              n_heads=2, n_layers=2, pe_type="relative",
              conv_kernel_size=7, conv_channels="4_4",
              conv_kernel_sizes="(3,3)_(3,3)", conv_poolings="(2,2)_(2,2)",
              chunk_size_left=64, chunk_size_current=32,
              chunk_size_right=0, streaming_type="mask")
    torch.manual_seed(0)
    uni = XformerEncoder(unidirectional=True, **kw).eval()
    bidir = XformerEncoder(unidirectional=False, **kw).eval()
    bidir.load_state_dict(uni.state_dict())
    x = torch.randn(1, 128, 20)
    with torch.no_grad():
        cache, outs = uni.init_stream_cache(1), []
        for blk, _, _ in StreamingDriver(x[0].numpy(), 32, 32, 0):
            o, cache = uni.streaming_step(torch.from_numpy(blk)[None], cache)
            outs.append(o)
        stream = torch.cat(outs, 1)
        full = torch.tensor([128])
        off_uni = uni(x, full)["ys"]["xs"]
        off_chunked = bidir(x, full)["ys"]["xs"]
    scale = float(off_chunked.abs().max())
    assert float((stream - off_chunked).abs().max()) <= 1e-5 * scale
    assert float((stream - off_uni).abs().max()) > 1e-2 * scale


def test_c28_interlayer_subsample_with_chunks_raises_at_forward():
    """The aishell and tedlium LC-Transformer-MMA confs set an interlayer
    subsample: JAX's streaming encoder asserts against it at its first
    forward (its init included); the port builds the conf and raises
    there too."""
    conf = next(c for c in BUILDING if c.startswith("tedlium/conf/asr/mma"))
    args = _conf_args(conf, vocab=20)
    small = SimpleNamespace(**{**vars(args), "enc_n_layers": 2,
                               "transformer_enc_d_model": 16,
                               "transformer_enc_d_ff": 16,
                               "transformer_dec_d_model": 16,
                               "transformer_dec_d_ff": 16,
                               "dec_n_layers": 1, "mocha_first_layer": 1,
                               "subsample": "2_1"})
    with pytest.raises(AssertionError, match="subsample"):
        jax_build(small).init(jax.random.PRNGKey(0), jnp.zeros((1, 256, 80)),
                              jnp.array([256]), jnp.ones((1, 3), jnp.int32),
                              jnp.array([3]))
    tm = build_speech2text(small, device="cpu")
    with pytest.raises(ValueError, match="subsampling"):
        tm.encode(torch.zeros(1, 256, 80), torch.tensor([256]))
