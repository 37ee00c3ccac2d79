"""Model configurations of the port.

``flagship_args`` is ``bench.py::flagship_args`` copied field for field
(``bench.py`` imports jax, which the port never does); a test holds the two
equal. It is the shipped large Librispeech config, reference conf
``conf/asr/transformer/conformer_kernel15_clamp10_hie_subsample8_las_long_
ln_large.yaml``: 12-layer conformer, d512 / 8 heads / d_ff 2048, rel-PE
clamped at 10, depthwise kernel 15, LAS LSTM-1024 decoder with location
attention, wordpiece vocab 10k, CTC weight 0.3.

``librispeech_rnnlm_args`` is the LibriSpeech recipe's LM,
``examples/librispeech/conf/lm/rnnlm_6L.yaml`` (transcribed from upstream
``examples/librispeech/s5/conf/lm/rnnlm_6L.yaml``): a 6-layer LSTM-1024
with 1024-wide embeddings, residual connections, a GLU head and tied
embeddings, over the flagship's vocabulary; a test holds it to the yaml.

``librispeech_blstm_las_args`` is the LibriSpeech recipe's BLSTM-LAS,
``examples/librispeech/conf/asr/blstm_las.yaml``: a conv front end of two
32-channel 3x3 blocks, each pooling (2, 2), 5 BLSTM-512 layers with the two
directions concatenated (the conf sets no ``bidirectional_sum_fwd_bwd``),
dropout 0.4, the flagship's LSTM-1024 LAS decoder with scheduled sampling
at 0.2, CTC weight 0.3; float32 (no ``train_dtype``). The model fields and
``input_dim`` (the train CLI's default) are the conf's, field for field; a
test holds them to the yaml. ``vocab`` is the flagship's.

``librispeech_lstm_mocha_args`` is the LibriSpeech recipe's UniLSTM-MoChA,
``examples/librispeech/conf/asr/mocha/lstm_mocha.yaml``: the same conv front
end, 5 unidirectional LSTM-1024 layers, the LSTM-1024 LAS decoder with
MoChA (chunk 4, one monotonic and one chunk head, additive energies,
attn_dim 512, ``init_r`` -4, noise std 1.0, quantity-loss weight 0.1),
CTC weight 0.3 with fc 512 and ``ctc_lsm_prob`` 0.1, dropout 0.4, label
smoothing 0.1; float32. Its model fields are the conf's, field for field
(a test holds them to the yaml); ``vocab`` is the flagship's.

``librispeech_transformer_args`` is the LibriSpeech recipe's Transformer,
``examples/librispeech/conf/asr/transformer/transformer.yaml`` (the
upstream README's best test-clean WER): the same conv front end (x4), 12
transformer encoder blocks (d 256, 4 heads, d_ff 2048, no positional
encoding), 6 transformer decoder blocks of the same widths with
``transformer_dec_pe_type`` "1dconv3L" (no positions in JAX: ROADMAP C21),
CTC weight 0.3 with fc 512, dropout 0.1, ``dropout_emb`` 0.1, label
smoothing 0.1, SpecAugment; float32. ``librispeech_transformer_mma_args``
is its offline MMA variant, ``examples/librispeech/conf/asr/mma/offline/
transformer_mma_subsample8_ma4H_ca4H_w16_from4L.yaml``: a third pooling
block (x8), MMA source attention from decoder layer 4 with 4 monotonic x
4 chunk heads, chunk 16, shared chunk heads, no SpecAugment. Their model
fields are the confs', field for field (a test holds them to the yamls);
``vocab`` is the flagship's.

``librispeech_uni_conformer_mocha_args`` is the LibriSpeech recipe's
unidirectional Conformer with MoChA, ``examples/librispeech/conf/asr/
mocha/uni_conformer_kernel7_clamp10_hie_subsample8_mocha_ln_stableemit0.2_
qua0.2.yaml``: the flagship's conv front end (x2) and interlayer max_pool
(x8 in all), 12 causal conformer blocks (d 256, 4 heads, d_ff 1024, rel-PE
clamped at 10, depthwise kernel 7), the LSTM-1024 LAS decoder with MoChA
(chunk 4, ``init_r`` -2, a YAML integer: ROADMAP C17), quantity loss 0.2,
StableEmit 0.2, CTC 0.3 with fc 512; float32. It sets no chunk sizes, so
it is not streamed (ROADMAP C25). ``uni_conformer_mocha_streaming_args``
is the repo's ``examples/librispeech/conf/asr/uni_conformer_mocha_
streaming.yaml``: a conv front end x4, 12 causal conformer blocks (d 256,
4 heads, d_ff 1024, unclamped rel-PE, kernel 7) under the chunkwise mask
(left 64, current 32, right 0 input frames), an LSTM-512 decoder with
MoChA (chunk 4), CTC 0.3; its ``train_dtype`` is bfloat16 (MoChA's
alignment then in float32: ROADMAP C39).
``librispeech_lc_transformer_mma_args`` is
the LibriSpeech recipe's latency-controlled Transformer-MMA,
``examples/librispeech/conf/asr/mma/streaming/lc_transformer_mma_
subsample8_ma4H_ca4H_w16_from4L_64_128_64.yaml``: the offline MMA conf's
model with the encoder in ``reshape`` mode, chunks of 64 / 128 / 64 input
frames. Their model fields are the confs', field for field (a test holds
them to the yamls); ``vocab`` is the flagship's.

``flagship_args`` carries no ``train_dtype`` (``bench.py``'s has none): an
args namespace may set one, and ``compute_dtype(args)`` turns it into the
train step's ``compute_dtype``.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

# JAX ``bin/args.py``'s default: train in float32 unless asked for bf16
TRAIN_DTYPE = "float32"


def flagship_args(faithful: bool = False):
    """faithful=True: the conf's exact x8 subsampling (conv x2 + two
    interlayer max_pool x2); default: the equal-output-rate variant (conv
    x4 + one interlayer drop) that ``bench.py`` times."""
    return SimpleNamespace(
        enc_type="conv_conformer", input_dim=80,
        conv_channels="32_32", conv_kernel_sizes="(3,3)_(3,3)",
        conv_poolings="(1,1)_(2,2)" if faithful else "(2,2)_(2,2)",
        enc_n_layers=12, transformer_d_model=512, transformer_d_ff=2048,
        transformer_n_heads=8, transformer_enc_pe_type="relative",
        transformer_enc_clamp_len=10, conformer_kernel_size=15,
        subsample=("1_1_1_2_1_1_1_2_1_1_1_1" if faithful
                   else "1_1_1_2_1_1_1_1_1_1_1_1"),
        subsample_type="max_pool" if faithful else "drop",
        dropout_enc=0.1, dropout_att=0.0,
        dec_type="lstm", dec_n_units=1024, dec_n_layers=1, emb_dim=512,
        dec_bottleneck_dim=1024, attn_type="location", attn_dim=512,
        attn_conv_width=201, dropout_dec=0.1, dropout_emb=0.1,
        vocab=10000, ctc_weight=0.3, lsm_prob=0.1,
        freq_width=27, n_freq_masks=2, time_width=100, n_time_masks=2,
        time_width_upper=1.0,
    )


def librispeech_blstm_las_args():
    """The conf's model fields, ``input_dim`` 80 and the flagship's
    ``vocab``."""
    return SimpleNamespace(
        enc_type="conv_blstm", input_dim=80, conv_channels="32_32",
        conv_kernel_sizes="(3,3)_(3,3)", conv_poolings="(2,2)_(2,2)",
        enc_n_units=512, enc_n_layers=5, dropout_enc=0.4,
        dec_type="lstm", dec_n_units=1024, dec_n_layers=1, emb_dim=512,
        dec_bottleneck_dim=1024, attn_type="location", attn_dim=512,
        attn_conv_width=201, dropout_dec=0.4, dropout_emb=0.4, ss_prob=0.2,
        ctc_weight=0.3, lsm_prob=0.1, vocab=flagship_args().vocab)


def librispeech_lstm_mocha_args():
    """The conf's model fields, ``input_dim`` 80 and the flagship's
    ``vocab``."""
    return SimpleNamespace(
        enc_type="conv_lstm", input_dim=80, conv_channels="32_32",
        conv_kernel_sizes="(3,3)_(3,3)", conv_poolings="(2,2)_(2,2)",
        subsample="1_1_1_1_1", subsample_type="drop", enc_n_units=1024,
        enc_n_layers=5, dropout_enc=0.4,
        dec_type="lstm", dec_n_units=1024, dec_n_layers=1, emb_dim=512,
        dec_bottleneck_dim=1024, attn_type="mocha", attn_dim=512,
        mocha_chunk_size=4, mocha_init_r=-4, mocha_std=1.0,
        mocha_quantity_loss_weight=0.1, dropout_dec=0.4, dropout_emb=0.4,
        ctc_weight=0.3, ctc_fc_list="512", ctc_lsm_prob=0.1, lsm_prob=0.1,
        vocab=flagship_args().vocab)


def librispeech_transformer_args():
    """The conf's model fields, ``input_dim`` 80 and the flagship's
    ``vocab``."""
    return SimpleNamespace(
        enc_type="conv_transformer", input_dim=80, conv_channels="32_32",
        conv_kernel_sizes="(3,3)_(3,3)", conv_poolings="(2,2)_(2,2)",
        enc_n_layers=12, transformer_enc_pe_type="none",
        transformer_enc_d_model=256, transformer_enc_d_ff=2048,
        transformer_enc_n_heads=4, dec_type="transformer", dec_n_layers=6,
        transformer_dec_pe_type="1dconv3L", transformer_dec_d_model=256,
        transformer_dec_d_ff=2048, transformer_dec_n_heads=4,
        dropout_in=0.0, dropout_enc=0.1, dropout_dec=0.1, dropout_emb=0.1,
        dropout_att=0.0, lsm_prob=0.1, freq_width=27, n_freq_masks=2,
        time_width=100, n_time_masks=2, time_width_upper=1.0,
        ctc_weight=0.3, ctc_fc_list="512", ctc_lsm_prob=0.1,
        vocab=flagship_args().vocab)


def librispeech_transformer_mma_args():
    """The conf's model fields, ``input_dim`` 80 and the flagship's
    ``vocab``."""
    return SimpleNamespace(
        enc_type="conv_transformer", input_dim=80,
        conv_channels="32_32_32",
        conv_kernel_sizes="(3,3)_(3,3)_(3,3)",
        conv_strides="(1,1)_(1,1)_(1,1)",
        conv_poolings="(2,2)_(2,2)_(2,2)", enc_n_layers=12,
        transformer_enc_pe_type="none", transformer_enc_d_model=256,
        transformer_enc_d_ff=2048, transformer_enc_n_heads=4,
        dec_type="transformer", dec_n_layers=6,
        transformer_dec_pe_type="1dconv3L", mocha_n_heads_mono=4,
        mocha_n_heads_chunk=4, mocha_chunk_size=16, mocha_init_r=-2.0,
        mocha_std=1.0, mocha_quantity_loss_weight=0.0, mocha_first_layer=4,
        share_chunkwise_attention=True, transformer_dec_d_model=256,
        transformer_dec_d_ff=2048, transformer_dec_n_heads=4,
        dropout_in=0.0, dropout_enc=0.1, dropout_dec=0.1, dropout_emb=0.1,
        dropout_att=0.0, dropout_head=0.5, lsm_prob=0.1, ctc_weight=0.3,
        ctc_fc_list="512", ctc_lsm_prob=0.1, vocab=flagship_args().vocab)


def librispeech_uni_conformer_mocha_args():
    """The conf's model fields, ``input_dim`` 80 and the flagship's
    ``vocab``."""
    return SimpleNamespace(
        enc_type="conv_uni_conformer", input_dim=80, conv_channels="32_32",
        conv_kernel_sizes="(3,3)_(3,3)", conv_poolings="(1,1)_(2,2)",
        subsample="1_1_1_2_1_1_1_2_1_1_1_1", subsample_type="max_pool",
        conformer_kernel_size=7, conformer_normalization="layer_norm",
        enc_n_layers=12, transformer_enc_pe_type="relative",
        transformer_enc_clamp_len=10, transformer_enc_d_model=256,
        transformer_enc_d_ff=1024, transformer_enc_n_heads=4,
        attn_type="mocha", mocha_chunk_size=4, mocha_init_r=-2,
        mocha_std=1.0, mocha_quantity_loss_weight=0.2,
        mocha_quantity_loss_start_epoch=5, mocha_stableemit_weight=0.2,
        mocha_stableemit_start_epoch=0, attn_dim=512, dec_type="lstm",
        dec_n_units=1024, dec_n_layers=1, dec_bottleneck_dim=1024,
        emb_dim=512, ctc_fc_list="512", param_init=0.1, dropout_in=0.0,
        dropout_enc=0.1, dropout_dec=0.1, dropout_emb=0.1, dropout_att=0.0,
        lsm_prob=0.1, freq_width=13, n_freq_masks=2, time_width=50,
        n_time_masks=2, time_width_upper=1.0, ctc_weight=0.3,
        ctc_lsm_prob=0.1, vocab=flagship_args().vocab)


def uni_conformer_mocha_streaming_args():
    """The conf's model fields, ``input_dim`` 80 and the flagship's
    ``vocab``."""
    return SimpleNamespace(
        enc_type="conv_uni_conformer", input_dim=80, conv_channels="32_32",
        conv_kernel_sizes="(3,3)_(3,3)", conv_poolings="(2,2)_(2,2)",
        enc_n_layers=12, transformer_d_model=256, transformer_d_ff=1024,
        transformer_n_heads=4, transformer_enc_pe_type="relative",
        conformer_kernel_size=7, lc_chunk_size_left=64,
        lc_chunk_size_current=32, lc_chunk_size_right=0, lc_type="mask",
        dec_type="lstm", dec_n_units=512, emb_dim=256,
        dec_bottleneck_dim=512, attn_type="mocha", mocha_chunk_size=4,
        mocha_quantity_loss_weight=1.0, ctc_weight=0.3, lsm_prob=0.1,
        vocab=flagship_args().vocab)


def librispeech_lc_transformer_mma_args():
    """The conf's model fields, ``input_dim`` 80 and the flagship's
    ``vocab``."""
    return SimpleNamespace(**{
        **vars(librispeech_transformer_mma_args()),
        "lc_chunk_size_left": 64, "lc_chunk_size_current": 128,
        "lc_chunk_size_right": 64, "lc_type": "reshape"})


def librispeech_rnnlm_args():
    """The yaml's topology and the regularisation ``build_lm`` reads, field
    for field; ``vocab`` from ``flagship_args``."""
    return SimpleNamespace(
        lm_type="lstm", n_units=1024, n_projs=0, n_layers=6, emb_dim=1024,
        n_units_null_context=0, tie_embedding=True, residual=True,
        use_glu=True, bptt=200, param_init=0.05, adaptive_softmax=False,
        dropout_in=0.0, dropout_hidden=0.0, lsm_prob=0.0,
        vocab=flagship_args().vocab)


def compute_dtype(args):
    """The train step's ``compute_dtype`` from ``args.train_dtype`` (default
    ``TRAIN_DTYPE``), as the JAX train CLI reads it
    (``bin/asr/train.py``): ``torch.bfloat16`` for "bfloat16" or "bf16",
    None (float32) for "float32"; anything else raises."""
    name = getattr(args, "train_dtype", TRAIN_DTYPE)
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name == "float32":
        return None
    raise ValueError(f"train_dtype {name!r}: 'float32' or 'bfloat16'")
