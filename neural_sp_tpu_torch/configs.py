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
