#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port (``neural_sp_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build the CUDA kernels from ``neural_sp_tpu_torch/ops/kernels/csrc``
     with nvcc (sm_90a, one nvcc per source, all at once) and time the
     build;
  2. hold each kernel against its plain PyTorch twin at the serving path's
     shapes (K1 rel_attention: B=4, H=8, dk=64, R=11, T in 800/400/200 with
     ragged lengths; K2 las_step: N=10, 4 and 40 rows at T=200, as the three
     served sessions give it, and N=10 at T=400, the checked call and the
     workspace form a decode loop uses, each with and without a beam's
     reorder ``parent``, the two forms equal bit for bit; and N=32 at
     T=188 with a dropout scale ``keep``, scheduled sampling's pass 1),
     TF32 off, and time kernel and twin with CUDA events; K1 also against
     its library yardstick, ``F.scaled_dot_product_attention`` with the
     rel-PE bias as an additive mask (efficient backend), timed in turns
     with the kernel;
     each kernel's bound (``ops/kernels/roofline.py`` from its ``*_cost``)
     is printed beside its time;
  3. build the flagship Conformer-LAS (``configs.flagship_args(faithful=
     True)``, full widths, seeded random weights) on the card and serve a
     batch of 4 fbank-shaped utterances (700/1000/1300/1600 frames x 80)
     through ``Speech2TextSession.decode`` with beam 10 + CTC weight 0.3,
     with the on-device batched beam 10 (no CTC) and with greedy
     decoding (wall per decode step beside each RTF); launch counters are
     zeroed just before and read just after, and both kernels must have run;
     then time the encoder alone and profile one beam request (device
     busy time against wall time, the kernels taking the most time);
  3c. serve the same 4 utterances with the LibriSpeech recipe's RNNLM
     (``configs.librispeech_rnnlm_args``: 6 x LSTM-1024, tied, residual,
     GLU, vocab 10k; seeded, on the card): (a) beam 10 + CTC 0.3 + LM 0.5
     + length norm (the recipe's stage 5) and (b) beam 10 + LM 0.5 + ILM
     0.2 with a 10-best rescored by a second-pass and a backward LM (0.3
     each), counters zeroed around each, K1 and K2 must have run (hyp
     lengths, RTF, wall per decode step, rescoring wall, peak memory);
     profile one request of (a) (idle share, top kernels, the LM step's
     device time against its byte bound); hold the LM on the card against
     the same LM on the CPU (20 chained steps at N=10 with beam reorders,
     1e-4 of the largest log-prob) and the ILM loop (zeroed keys and
     values, real lengths) against the chain of plain steps;
  4. run the encoder with the twins in place of the kernels and compare
     the encoder outputs, then replay the best beam hypothesis through the
     twin decode step and compare the logits at every step; then step the
     serving loops' ``DecodeLoop`` (the carry in K2's workspace) at N=40, 10
     and 4 rows for 8 steps with random tokens and random ``parent`` rows,
     against the chain of plain steps, logits and attention weights at
     every step;
  2b. (after 4, so the serving phases keep their order) hold the training
     kernels against their plain versions at the training path's shapes:
     K1b rel_attention_bwd (B=32, H=8, dk=64, R=11, T in 750/375/188,
     ragged lengths; and K1 there at full lengths), K3 las_scan and K3b
     las_scan_bwd (B=32, U+1=101, T=188, H=1024, D=A=512, C=10, K=201,
     dropout keep-masks; K3's kernel launches per call; the time of K3b's
     wrapper's work after its kernel loop), K4 ctc_loss forward and backward
     (B=32, T=188, U=100, V=10000, ragged lengths, a repeated label);
     errors are normalised by the reference's largest magnitude; K1b
     against the autograd backward of K1's yardstick, K4 against
     ``F.ctc_loss`` (timed in float32, held to the plain version in
     float64); each with its bound;
     Then K1's and K1b's bf16 entries at the same shapes, ragged and full
     lengths, each against its plain bf16 version (1e-2 of the
     reference's max) and against the plain float32 version on the same
     bf16-rounded inputs (its error at most 1.5x the plain bf16
     version's), timed in turns with efficient SDPA in bf16 (and its
     backward), with the bound at the bf16 tensor-core peak; and the time
     of LASScan's casts at K3's and K3b's boundary under bf16 compute;
  5. train the flagship (same model, ``train()`` mode: SpecAugment and
     dropout on, f32, TF32 off) with noam Adam, clip 5 and 4-step
     accumulation on B=32 utterances of 1500 frames x 80 with U=100 labels:
     one warm-up optimizer step, then 2 timed ones (counts zeroed just
     before all 12 microsteps and read just after; K1, K1b, K3, K3b and K4
     must have run; K3's and K3b's kernel launches per call read there
     too), and profile one microstep; then the same at bf16 compute over
     float32 master weights (``train_dtype`` "bfloat16", as ``bench.py``
     times the JAX step): K1's and K1b's bf16 entries, K3, K3b and K4 must
     have run, and no float32 K1 / K1b;
  6. one microstep's loss and every gradient in ``eval()`` mode with the
     kernels against the plain versions patched in; then one ``train()``
     microstep run twice from one generator seed, in float32 and at bf16
     compute: the losses and every gradient leaf must be the same bits;
  6b. the same at bf16 compute: the kernels' loss and each gradient leaf
     no farther from the plain f32 microstep than twice the plain bf16
     microstep, plus phase 6's tolerance, in the L2 norm; then
     5 Adam steps (lr 1e-4) on a fixed batch of 8 utterances in
     ``train()`` mode, in float32 and at bf16, whose loss must fall; then
     (5s) at phase 5's shape a float32 microstep with scheduled sampling
     (ss_prob 0.2) and one without, in turns, and pass 1 alone under the
     profiler (device time, kernels, K2 steps);
  7. the CLIs, as a user runs them, on the LibriSpeech Conformer-LAS conf
     (``CLI_CONF``: 12 x d512 conformer, LSTM-1024 LAS, CTC fc 512,
     ``ctc_lsm_prob`` 0.1, weight decay 1e-6, bf16 compute) at full width
     and depth, on a synthesized corpus in a temporary directory (64 train,
     8 dev, 4 test utterances of 700-1600 frames x 80, standard normal,
     numpy seed 0; ~100-word transcripts over a 10k-entry vocabulary):
     ``bin.asr.train.main`` for 2 epochs (overrides ``CLI_OVERRIDES``),
     then resumed for a third (the controller's epoch and the Adam count
     must continue), then ``bin.asr.eval.main`` with beam 10 + CTC 0.3 +
     length norm + a seeded rnnlm_6L at 0.5, averaging 2 epochs (the
     recipe's stage 5); counts zeroed around each CLI: K1 / K1b bf16, K3,
     K3b and K4 (both entries) must run in training, K1 and K2 in
     evaluation; every microstep's loss and each epoch's train and dev
     loss in ``history.csv`` must be finite; the widest microbatch the
     train CLI ran (1664-frame pads: K1 / K1b at T = 832 / 416 / 208) and
     the one of most utterances are held on the trained model to the plain
     versions as in phase 6 in float32, and by phase 6b's rule at bf16;
     wall per optimizer step, frames/s, peak memory, the
     checkpoints' size and save time, RTF, decode wall per utterance, WER
     / CER (random weights: a sign that the pipeline ran, no more);
  7b. the train CLI on the North star's reference conf (``SS_CONF``:
     phase 7's model with ss_prob 0.2, float32, noam) at full width and
     depth on phase 7's corpus, overrides ``SS_OVERRIDES`` (2 epochs, 2
     accumulated microsteps, the word unit, the switch to SGD after epoch
     1); counts zeroed around it: K1 / K1b, K2 (pass 1), K3 / K3b (pass
     2) and K4 must run; every loss finite; the sampled share of the valid
     positions within 4 binomial standard deviations of 0.2; epoch 2 SGD
     at every microstep, its first update -1e-4 times the clipped gradient
     to within one f32 spacing of each parameter; then the widest
     microbatch on the trained weights, sampling on, kernels against the
     plain versions (K2 in pass 1 too) at phase 6's tolerance;
  8. the LibriSpeech recipe's BLSTM-LAS (``BLSTM_CONF``: the conv front
     end, BLSTM-512 layers concatenated, D = 1024, on cuDNN, the conf's 5
     cut to ``RNN_DEPTH`` = 1 for the script's time limit; LSTM-1024 LAS;
     CTC 0.3; f32): (8a) K2 at N = 10 and at
     N = 32 with keep (T = 400), K3 and K3b at B = 32, U+1 = 101, ragged T
     up to 500, K4 at B = 32, T = 500, U = 100, V = 10,000, each against
     its plain version at phase 2's / 2b's tolerance, timed, with its
     bound; (8b) phase 3's four utterances, beam 10 + CTC 0.3 and greedy
     on the seeded model (counts zeroed around them: K2 must run, K1 / K1b
     must not), the encoder's time, the cuDNN encoder against the layers'
     written-out loop (``RNN_ENCODER_ATOL``; with cuDNN's TF32 on as the
     control, which must exceed it), the best hypothesis replayed against
     the plain decode step, one profiled beam request; (8c) the train CLI
     on the conf (``BLSTM_OVERRIDES``: 2 epochs, the word unit; phase 7's
     corpus) and the eval CLI as the recipe's stage 5, each started with
     cuDNN's TF32 on (PyTorch's default) and bound to turn it off, counts
     zeroed around each (K2 in pass 1, K3, K3b and K4 in training, K2 in
     evaluation, K1 / K1b in neither), every loss finite, the sampled
     share within 4 binomial standard deviations of 0.2, a profiled
     microstep (the cuDNN RNN operators' share of the device time); (8d)
     the widest CLI microbatch on the trained weights, kernels against the
     plain versions at phase 6's tolerance, and one train() microstep
     twice: the same bits;
  9. the LibriSpeech recipe's UniLSTM-MoChA (``MOCHA_CONF``: the conv front
     end, LSTM-1024 layers on cuDNN (the conf's 5 cut to ``RNN_DEPTH``), the
     LSTM-1024 LAS with MoChA chunk 4, CTC 0.3 with fc 512; float32, full
     width): (9a) phase 3's
     four utterances, beam 10 + CTC 0.3 and greedy, counts zeroed around
     them (K1, K1b, K2, K3 and K3b must not run: MoChA has no kernel, and
     K2 / K3 / K3b fuse location attention), the encoder's time, one
     profiled beam request (device time per decode step, idle share);
     (9b) one train() microstep at B = 4 (T 175-400, U 40-100) on the card
     held to the same microstep on the CPU in float64 (phase 6's rule),
     and greedy decoding on both, the tokens identical up to each row's
     first decision under ``DECISION_MARGIN``; (9c) the train CLI on the
     conf (``MOCHA_OVERRIDES``, phase 7's corpus) and the eval CLI as the
     recipe's stage 5, each started with cuDNN's TF32 on and bound to turn
     it off, counts zeroed around each (K4 in training; K1, K1b, K2, K3,
     K3b in neither), every loss and the quantity loss finite, a profiled
     microstep (the cuDNN RNN operators' share, the MoChA decoder's
     forward and backward alone: its device time and operations); (9d)
     the widest CLI microbatch on the trained weights, K4 against its plain
     version at phase 6's tolerance, a microstep twice with the noise on:
     the same bits; (9e) one train() microstep of the ``ctc_sync`` conf's
     model: its trigger points on the card identical to the CPU's forced
     alignment of the same log-probabilities, ``loss_latency`` finite;
  10. the LibriSpeech recipe's Transformer (``XF_CONF``: the conv front end
     x4, 12 transformer encoder and 6 decoder blocks of d 256 / 4 heads /
     d_ff 2048, CTC 0.3 with fc 512; float32, full width, cut to 4 encoder
     and 2 decoder blocks, ``XF_DEPTH``; no kernel of its own): (10a) phase
     3's four utterances, beam 10 + CTC 0.3 and beam 1 (counts zeroed around
     them: no kernel of the repo runs), the encoder's time, one profiled
     beam request (device time per decode step, idle share), and the decode
     loop's incremental logits against the teacher-forced forward's on the
     best hypothesis and 100 seeded tokens (``XF_STEP_RTOL``); (10b) a B = 4
     train() microstep (dropout off) held to the CPU in float64 by 9b's rule
     with a TF32 control that must break it, and again with the CPU's ReLU
     masks pinned to the card's (a mask may flip only within ``XF_PRE_RTOL``
     of 0), beam 1 on both (weights moved by GREEDY_NOISE) identical up to
     the first decision under ``DECISION_MARGIN``, and a microstep twice:
     the same bits; (10c) the train CLI on the conf (``XF_OVERRIDES``: 4
     epochs, the conf's accumulation 8, one optimizer update, every weight
     leaf moved from its initial value) and the eval CLI as stage 5, counts
     zeroed around each (K4 in training only), a profiled microstep (K4's
     share) and the decoder alone; (10d) the same for the offline
     Transformer-MMA conf (``XF_MMA_CONF``: conv x8, MMA from decoder layer
     4; cut to 4 encoder and 4 decoder blocks, one of them MMA): beam 10 +
     CTC 0.3 (hard-mode alphas), the microstep held (MoChA noise off), the
     train CLI for one epoch at accumulation 2 (one update) and the eval
     CLI, the MMA decoder's device time and operations per microstep;
  11. the unidirectional and latency-controlled encoders (float32, full
     width, seeded; the encoders cut by ``XF_DEPTH``: the uni-Conformer to 8
     of 12 layers, the streaming conf's to 4): K1 with the causal window (B
     4 and 32, H 4, dk 64, R 11, T 800 / 400 / 200: the uni-Conformer's conv
     x2 and two max_pools), K1b with it (B 32) and both bf16 entries; the
     streaming conf's chunk window (16, 8, 0; R = T = 400) with a row of
     klen 10 whose pad queries have no allowed key (uniform rows), f32 and
     bf16, forward and backward; K1 against cached keys (8 queries, 24 keys,
     0 / 8 / 16 empty cache slots), f32 and bf16; each against its plain
     version (phase 2's / 2b's rules), timed in turns with efficient SDPA
     given the bias and the window as one mask, with the bound of the
     window's work. (11a) the LibriSpeech uni-Conformer-MoChA (``UNI_CONF``,
     49,158,337 parameters) serves phase 3's utterances, beam 10 + CTC 0.3
     and greedy (K1 with the window must run); (11b) its B = 4 train()
     microstep held to the CPU in float64 by 9b's rule, a TF32 control (K1b
     with the window must run); (11c) its train CLI for one update
     (``STREAM_OVERRIDES``) and the eval CLI as stage 5; (11d) the repo's
     streaming conf (``STREAM_CONF``, mask mode, 31,935,681 parameters):
     phase 3's utterances cut to whole blocks, streamed through
     ``streaming_step`` (K1 against the cached keys), held within
     ``STREAM_RTOL`` to the offline chunk-before-conv forward (ROADMAP C27),
     its microstep held as 11b, ``decode_streaming`` (the block-synchronous
     MoChA beam 10 + CTC 0.3) of the 4 utterances (RTF, wall per block,
     resets) and the eval CLI with ``--recog_streaming true`` on its seeded
     weights (the conf's bf16 training with MoChA raises); (11e) the
     LibriSpeech LC-Transformer-MMA (``LC_CONF``, reshape mode, 35,576,204
     parameters): its microstep held as 10d, its train CLI for one update,
     the eval CLI offline and streaming (JAX's dispatch runs the CTC
     block-synchronous beam for a transformer decoder, ROADMAP C26).
  12. the latency-controlled BLSTM and the RNN transducer (float32,
     seeded): K5, the transducer's lattice loss, forward and backward
     against its plain float64 twin at B 32, T 400, U 200 (and the plain
     recurrence in float32, JAX's precision, against it) and at ragged
     lengths (a row of U 0, a row of T 1, U > T), timed with its bound;
     (12a) the LibriSpeech LC-BLSTM-RNN-T (``RNNT_CONF``: conv x4, 5
     LC-BLSTM-512 layers summed, chunk 40 / 40, a 2-layer LSTM-1024
     prediction net, CTC 0.3 with fc 512; full width and depth, V 1,000)
     serves phase 3's utterances, greedy and beam 10 (tsd), streams each
     through ``decode_streaming`` (the mono beam; RTF, wall per block),
     its LC-BLSTM encoder held to the written-out loops
     (``RNN_ENCODER_ATOL``, a TF32 control) and its ``streaming_step``
     chain to the CPU port's, a B = 4 microstep held to float64 by 9b's
     rule with a TF32 control (K5 and K4 must run), the train CLI for one
     epoch (one update) on a V 1,000 corpus and the eval CLI with beam 10
     and streaming; (12b) the LibriSpeech LC-BLSTM-MoChA
     (``LC_MOCHA_CONF``, at ``RNN_DEPTH``) served (beam 10 + CTC 0.3,
     greedy), streamed (the CTC block-synchronous beam, JAX's dispatch for
     an RNN encoder: ROADMAP C30) and its microstep held as 11d's: the
     MoChA microstep rounds in float32 (C29), so the whole microstep is
     held to float64 by 11d's gates, 9b's rule (with its control) holds the
     encoder + CTC microstep, and 9b's readings on the whole microstep
     (the card's, the CPU float32's, the card's against float64 with the
     card's energy ReLU masks pinned) are logged.
  13. the language-model stage (the recipes' stage 3 and stage 5's LM;
     float32, seeded, V 10,000 over phase 7's dictionary, a synthesized
     text corpus of 440 train and 100 dev rows of ~100 words): (13k) K1
     and K1b over the Transformer-XL's memory (``LM_K_SHAPE``: B 24, H 8,
     a 200-token segment against 400 keys under the causal window, R 400),
     without and with dropout of the attention probabilities at 0.1 on
     given key words, each against its plain version (phase 2's / 2b's
     rules), timed in turns with efficient SDPA (``dropout_p`` 0.1, its
     own mask) and its backward, with the bound of the window's work;
     (13a) the swbd Transformer-XL conf (``LM_XL_CONF``: 12 layers, d 512,
     8 heads, d_ff 2048, bptt 200, mem_len 200, B 24; full width and
     depth, 46,107,648 parameters): a window against the memory of the
     window before, its loss and every gradient through the kernels
     against the same with the plain versions patched in, in ``eval()``
     and ``train()`` mode (dropout on, one generator seed), by phase 6's
     rule with the FFNs' ReLU masks pinned to the kernels' run (the
     pre-activations within ``XF_PRE_RTOL``; the unpinned reading
     logged); then ``bin.lm.train.main`` for one epoch and a resumed
     second, ``bin.lm.eval.main`` with and without the cache model, K1 /
     K1b with dropout bound to run in training, K1 over the memory without
     dropout in evaluation, every loss and PPL finite; (13b) the
     swbd Transformer LM, the WSJ GCNN-14B and LibriSpeech's rnnlm_6L
     through both CLIs at full width and depth (``LM_CONFS``; no kernel
     of the repo on their paths); (13c) phase 7's trained model decoded
     by ``bin.asr.eval.main`` as stage 5 with 13a's XL as its LM: K1 at
     one query per step against the growing memory. Each phase's wall is
     printed on a line of its own.

Launches per step (per encode for K1, per decode step for K2, per training
microstep for the rest; K1 / K1b bf16 in phase 5's bf16 run) are counted
in phases 3b, 4 and 5; K1's and K2's launches on the main path over the
served requests of phases 3 and 3c; each kernel's launches in phase 7's
three CLI runs, phase 7b's and phase 8's two apart (``cli_launches``), K2's
per training microstep (``train_launches_per_microstep``); phase 8's path
(its served requests and its two CLI runs, ``blstm_launches``) and each
kernel's numbers at phase 8's shapes (``blstm``); phase 9's path (its served
requests and its two CLI runs, ``mocha_launches``); phase 10's path
(the served requests and the CLI runs of both confs,
``transformer_launches``); phase 11's path (``streaming_launches``), with
rows of their own for K1 with a window, K1b with a window and K1 against
cached keys; phase 12's path (``transducer_launches``), with a row of its
own for K5; phase 13's path (``lm_launches``: 13a's and 13b's CLIs and
13c's fused eval), with rows of their own for K1 / K1b over the XL's
memory without dropout and with dropout (launches per training microstep
from 13a's held one; K1's over the memory per dev window of the XL's eval
CLI). Prints the
details as JSON (also written to ``chiprun_out/chip_smoke.json``), then one
JSON line of per-kernel results (launches, launches_per_step, ms,
plain_ms, bound_ms, bound_by, library_ms, errors), the card's ``name,
power.limit`` (nvidia-smi), and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the package beside this script, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "neural_sp_tpu_torch"
SEED = 0
UTT_FRAMES = (700, 1000, 1300, 1600)   # 10 ms frames
FRAME_SEC = 0.01
# Kernel vs twin, float32 on both sides: the sums run in other orders
# (online softmax, split-K GEMV), so agreement is to float32 rounding
# amplified by the reduction length.
KERNEL_ATOL = 1e-4
# A library yardstick's output against the plain version, max |err| / max
# |reference|: it must compute the same function.
YARDSTICK_RTOL = 1e-3
# Whole encoder (12 layers) and a replayed decoder chain: the per-kernel
# rounding differences above, carried through every layer / step.
PATH_ATOL = 2e-3
# Training kernels vs plain versions, max |err| / max |reference|: sums in
# other orders (K1b over T keys, K4 over T frames); K3 / K3b carry them
# through a 101-step recurrence.
TRAIN_KERNEL_TOL = {"rel_attention_bwd": 1e-4, "ctc_loss": 1e-4,
                    "las_scan": 1e-3, "las_scan_bwd": 1e-3,
                    "rnnt_loss": 1e-4}
# Train-step parity (phase 6), kernels vs plain versions through the whole
# model: loss to 1e-4 relative; each gradient leaf to 2e-3 of its own
# largest magnitude. The self-attention key biases are the exception: the
# softmax's shift invariance makes their gradient zero in exact arithmetic,
# so both sides hold rounding only, and they are held to 1e-5 of the
# largest gradient of all leaves instead.
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_FLOOR = 2e-3, 1e-5
ZERO_GRAD_LEAF = ".mha.w_key.bias"
TRAIN_B, TRAIN_FRAMES, TRAIN_U, ACCUM = 32, 1500, 100, 4
# K1 / K1b's bf16 entries vs their plain bf16 versions, max |err| / max
# |reference|: bf16 carries 8 significant bits; the two round P and ds at
# the same points but sum in other orders.
BF16_KERNEL_TOL = 1e-2
# ... and against the plain float32 version on the same bf16-rounded
# inputs: the kernel's error at most this multiple of the plain bf16
# version's, so the kernel is no less exact than the plain path.
BF16_VS_F32_RATIO = 1.5
# Phase 6b, the bf16 microstep with the kernels against the same microstep
# with the plain versions: the loss and each gradient leaf of the kernels'
# microstep may lie no farther from the plain float32 microstep's than
# twice the plain bf16 microstep does (the kernels no less exact than the
# plain path), in the L2 norm (as the CPU tests' rule), plus phase 6's
# float32 tolerance carried to the L2 norm (LOSS_RTOL; per element
# GRAD_RTOL of the leaf's max, GRAD_FLOOR of the largest gradient for the
# key biases, times the root of the leaf's size): the kernels no less
# exact than the plain path, as phase 2b holds each kernel. Not |kernels -
# plain bf16|: in the attention query / key projections' gradients
# (zero-sum in exact arithmetic, so rounding is most of what bf16 leaves
# there) the two paths' bf16 errors are of one size and point apart, so
# their difference reaches twice either (0.996 of that tolerance on the
# H100 with K1 rounding P where the plain version does; 1.1 when K1
# rounded it before the 1 / l, its error then up to 3x the plain one's).
BF16_PATH_FACTOR = 2.0
# Phase 9b holds the card's float32 microstep to the same microstep in
# float64 on the CPU, which carries no rounding of its own: a leaf whose
# gradient is a near-cancelling sum of far larger terms (the front end's
# first convolution, the chunk energy's query weight at init_r -4: 1e-3
# to 6e-6 of the largest gradient) holds all of the card's float32
# rounding of those terms, which GRAD_RTOL of its own max does not bound
# (on the H100: 1.09 of it at the first convolution's weight on one draw
# of inputs, an error of 2e-6 of the largest gradient; 9b logs this
# reading, and the TF32 control's, beside its own). So 9b gives every
# leaf at least
# GRAD_FLOOR of the largest gradient, the floor phase 6 gives its
# zero-gradient leaves; it governs the leaves under GRAD_FLOOR / GRAD_RTOL
# = 0.5% of the largest gradient. On each draw a control, the card's
# microstep with TF32 on, must break the rule.
# Phase 6's determinism check: one train() microstep run twice from one
# generator seed must give the same loss and gradient leaves bit for bit,
# in float32 and at bf16 compute, with no bound: no source of drift is
# kept. K4's backward sums the states that share an id in a fixed order,
# K1b and K3b add in a fixed order, and cuBLAS and cuDNN gave the same bits
# twice on the H100 (tools/train_diagnosis.py determinism).


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_pair(fn, library, iters: int = 20) -> tuple[float, float]:
    """CUDA-event ms of a kernel and of its library yardstick, timed in
    turns (kernel, library, library, kernel), each the mean of its two."""
    k1, l1 = cuda_ms(fn, iters), cuda_ms(library, iters)
    l2, k2 = cuda_ms(library, iters), cuda_ms(fn, iters)
    return (k1 + k2) / 2, (l1 + l2) / 2


def roofline(cost: tuple[int, int], simt: bool = False,
             bf16: bool = False) -> dict:
    """The least time the card could take for (flops, bytes): bound_ms and
    bound_by, at the peak of the kernel's products (``peak_flops``: float32
    on the tensor cores by the 3xTF32 split, bf16 on the tensor cores for
    the bf16 entries, or the SIMT pipes); for matrix products also the
    bound on the SIMT pipes alone (what the f32 kernels without tensor
    cores can reach at best)."""
    from neural_sp_tpu_torch.ops.kernels.roofline import (
        BF16_TENSOR_FLOPS, F32_SIMT_FLOPS, F32_TENSOR_FLOPS, bound_ms)
    flops, nbytes = cost
    peak = F32_SIMT_FLOPS if simt else BF16_TENSOR_FLOPS if bf16 \
        else F32_TENSOR_FLOPS
    ms, by = bound_ms(flops, nbytes, peak)
    out = {"flops": flops, "bytes": nbytes, "bound_ms": ms, "bound_by": by,
           "peak_flops": peak}
    if not simt:
        out["simt_bound_ms"] = bound_ms(flops, nbytes, F32_SIMT_FLOPS)[0]
    return out


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def rel_bias(torch, p, klens):
    """K1's rel-PE bias and key mask as one additive [B, H, T, T] mask, in
    p's type, for the library yardstick: p[b, h, i, min(|i-j|, R-1)] on
    valid keys, finfo(f32).min / 2 on masked ones. A view into rows padded
    to a multiple of 16 elements, the alignment the efficient kernel
    takes."""
    b, h, t, r = p.shape
    pos = torch.arange(t, device=p.device)
    idx = (pos[:, None] - pos[None, :]).abs().clamp(max=r - 1)
    bias = torch.empty((b, h, t, -(-t // 16) * 16), device=p.device,
                       dtype=p.dtype)[..., :t]
    bias.copy_(torch.gather(p, -1, idx.expand(b, h, t, t)))
    masked = pos[None, :] >= klens[:, None].long()
    return bias.masked_fill_(masked[:, None, None, :],
                             torch.finfo(torch.float32).min / 2)


def bias_grad_to_buckets(torch, dbias, r):
    """dbias [B, H, T, T] summed into the R distance buckets of dp (in
    float32, returned in dbias's type)."""
    b, h, t, _ = dbias.shape
    pos = torch.arange(t, device=dbias.device)
    idx = (pos[:, None] - pos[None, :]).abs().clamp(max=r - 1)
    return torch.zeros((b, h, t, r), device=dbias.device).scatter_add_(
        -1, idx.expand(b, h, t, t), dbias.float()).to(dbias.dtype)


def efficient_sdpa():
    """The efficient-attention backend only: float32 on the tensor cores
    with the 3xTF32 split (bf16 inputs: bf16 products), taking an additive
    mask of the inputs' type."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    return sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION)


def rel_attention_yardstick(torch, args, kernel, what: str,
                            phase: str = "2",
                            tol: float = YARDSTICK_RTOL) -> dict:
    """K1 against F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
    scale=1.0), the efficient backend, on the same inputs (float32 or
    bf16). The bias is built once, outside the timed region, and its time
    is logged apart. The library's output is held to the plain version
    (within ``tol`` of its max): a yardstick that computes something else
    is none."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from neural_sp_tpu_torch.ops.kernels import rel_attention_ref
    q, k, v, p, klens = args
    bias_ms = cuda_ms(lambda: rel_bias(torch, p, klens), iters=3, warmup=1)
    bias = rel_bias(torch, p, klens)
    with efficient_sdpa():
        err = rel_err(sdpa(q, k, v, attn_mask=bias, scale=1.0),
                      rel_attention_ref(*args))
        ms, lib_ms = timed_pair(lambda: kernel(*args), lambda: sdpa(
            q, k, v, attn_mask=bias, scale=1.0))
    log(f"[{phase}] K1 {what}: kernel {ms:.4f} ms  library (SDPA, efficient) "
        f"{lib_ms:.4f} ms, its error {err:.3e} of the plain max; bias "
        f"built in {bias_ms:.4f} ms")
    expect(err <= tol, f"K1 yardstick {what}: error {err}")
    return {"kernel_ms": ms, "library_ms": lib_ms, "library_err": err,
            "bias_ms": bias_ms}


def expect(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_build():
    from neural_sp_tpu_torch.ops.kernels.build import build_library, \
        load_library
    t0 = time.perf_counter()
    path, nvcc_out = build_library()
    load_library()
    sec = time.perf_counter() - t0
    log(f"[1] built {path.name} in {sec:.2f} s")
    for line in nvcc_out.splitlines():
        if "registers" in line or "Compiling entry" in line or \
                "spill" in line:
            log(f"    {line.strip()}")
    return sec


def phase_kernels(torch, rng):
    from neural_sp_tpu_torch.ops.kernels import (rel_attention,
                                                 rel_attention_ref)
    from neural_sp_tpu_torch.ops.kernels.rel_attention import \
        rel_attention_cost
    dev = torch.device("cuda")

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype("float32")).to(dev)

    res = {"rel_attention": {"max_abs_err": 0.0, "shapes": []},
           "las_step": {"max_abs_err": 0.0}}
    b, h, dk, r = 4, 8, 64, 11
    for tt in (800, 400, 200):
        q, k, v = t(b, h, tt, dk, scale=dk ** -0.5), t(b, h, tt, dk), \
            t(b, h, tt, dk)
        p = t(b, h, tt, r, scale=dk ** -0.5)
        kl = [tt, tt - tt // 4, tt // 2, tt // 3 + 1]
        klens = torch.tensor(kl, dtype=torch.int32, device=dev)
        args = (q, k, v, p, klens)
        err = max_err(rel_attention(*args), rel_attention_ref(*args))
        ref_ms = cuda_ms(lambda: rel_attention_ref(*args))
        what = f"B={b} H={h} T={tt} dk={dk} R={r} klens={kl}"
        yard = rel_attention_yardstick(torch, args, rel_attention, what)
        bound = roofline(rel_attention_cost(b, h, tt, dk, r, kl))
        ms = yard["kernel_ms"]
        log(f"[2] K1 rel_attention {what}: max_abs_err {err:.3e}  kernel "
            f"{ms:.4f} ms  twin {ref_ms:.4f} ms  bound {bound['bound_ms']:.4f}"
            f" ms ({bound['bound_by']}; SIMT f32 alone "
            f"{bound['simt_bound_ms']:.4f} ms)")
        expect(err <= KERNEL_ATOL, f"K1 T={tt}: error {err} > {KERNEL_ATOL}")
        row = res["rel_attention"]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        shape = {"shape": what, "ms": ms, "plain_ms": ref_ms, **yard, **bound}
        row["shapes"].append(shape)
        if tt == 800:
            row.update(ms=ms, plain_ms=ref_ms, library_ms=yard["library_ms"],
                       library_err=yard["library_err"], **bound)

    # the rows the served sessions give it: 10 (beam 10 of one utterance),
    # 4 (greedy, the batch) and 40 (the on-device beam over the batch); and
    # scheduled sampling's pass 1 over a training microbatch (32 rows, T
    # 188, the LSTM output's dropout scale as keep)
    row = res["las_step"]
    for n, tt in ((10, 200), (4, 200), (40, 200), (10, 400), (32, 188)):
        shape = k2_case(torch, rng, n, tt, 512, keep=n == 32)
        row["max_abs_err"] = max(row["max_abs_err"], shape["max_abs_err"])
        row.setdefault("shapes", []).append(shape)
        if (n, tt) == (10, 200):
            # no single PyTorch call computes an LSTM cell with location
            # attention fed back: no library yardstick
            row.update(library_ms=None, **{
                k: v for k, v in shape.items()
                if k not in ("shape", "keep", "max_abs_err")})
    return res


def k2_case(torch, rng, n, tt, d, keep=False, tag="2"):
    """K2 at N rows, T frames and encoder width d (H 1024, A 512, C 10, K
    201), with a dropout scale ``keep`` (rate 0.1) or none: both forms of
    the wrapper (the checked, allocating call and the workspace a decode
    loop steps through), without and with a beam's reorder, against the
    plain version (KERNEL_ATOL), the two forms equal bit for bit; CUDA-event
    times of the workspace form, the checked call and the plain version,
    and the bound."""
    from neural_sp_tpu_torch.ops.kernels import las_step, las_step_ref
    from neural_sp_tpu_torch.ops.kernels.las_step import (LasStepWorkspace,
                                                          las_step_cost)
    dev = torch.device("cuda")
    hd, a, c, kw = 1024, 512, 10, 201

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype("float32")).to(dev)

    keep = (torch.from_numpy((rng.random((n, hd)) >= 0.1).astype(
        "float32")) / 0.9).to(dev) if keep else None
    aw_prev = torch.softmax(t(n, tt, scale=3.0), -1)
    args = (t(n, 4 * hd, scale=0.5), t(n, d), t(n, hd, scale=0.5),
            t(n, hd), aw_prev, t(d, 4 * hd, scale=(d + hd) ** -0.5),
            t(hd, 4 * hd, scale=(d + hd) ** -0.5), t(4 * hd, scale=0.1),
            t(a, hd, scale=hd ** -0.5), t(c, kw, scale=kw ** -0.5),
            t(a, c, scale=c ** -0.5), t(a, scale=a ** -0.5),
            t(n, tt, a), t(n, tt, d),
            torch.tensor([tt - 3 * i for i in range(n)],
                         dtype=torch.int32, device=dev))
    ws = LasStepWorkspace(*args[5:])
    parent = torch.from_numpy(
        rng.integers(0, n, n).astype("int32")).to(dev)
    err = 0.0
    for par in (None, parent):
        refs = las_step_ref(*args, parent=par, keep=keep)
        outs = las_step(*args, parent=par, keep=keep)
        ws.load_carry(*args[1:5])
        ws.eg.copy_(args[0])
        if par is not None:
            ws.parent.copy_(par)
        stepped = ws.step(use_parent=par is not None, keep=keep)
        err = max(err, *(max_err(x, y) for x, y in zip(outs, refs)))
        expect(all(torch.equal(x, y) for x, y in zip(stepped, outs)),
               f"K2 N={n} T={tt} D={d}: the workspace form differs from "
               f"the call")
    per_step = las_step.kernels_per_step
    ms = cuda_ms(lambda: ws.step(use_parent=True, keep=keep), iters=200)
    call_ms = cuda_ms(lambda: las_step(*args, parent=parent, keep=keep),
                      iters=200)
    ref_ms = cuda_ms(lambda: las_step_ref(*args, parent=parent, keep=keep))
    bound = roofline(las_step_cost(n, tt, hd, d, a, c, kw,
                                   args[-1].tolist()))
    log(f"[{tag}] K2 las_step N={n} T={tt} H={hd} D={d} A={a} C={c} K={kw}"
        f"{' with keep' if keep is not None else ''}: "
        f"max_abs_err {err:.3e}  kernel {ms:.4f} ms through its "
        f"workspace, {call_ms:.4f} ms as a checked call, {per_step} "
        f"kernels per step  twin {ref_ms:.4f} ms  bound "
        f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    expect(err <= KERNEL_ATOL,
           f"K2 N={n} T={tt} D={d}: error {err} > {KERNEL_ATOL}")
    return {"shape": f"N={n} T={tt}" + (f" D={d}" if d != 512 else ""),
            "keep": keep is not None, "max_abs_err": err, "ms": ms,
            "checked_call_ms": call_ms, "kernels_per_step": per_step,
            "plain_ms": ref_ms, **bound}


def flagship_model(torch):
    from neural_sp_tpu_torch.configs import flagship_args
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.utils.init_params import init_params
    model = build_speech2text(flagship_args(faithful=True))   # on the card
    init_params(model, SEED)
    return model.eval()


def utterances(rng):
    import numpy as np
    xs = np.zeros((len(UTT_FRAMES), max(UTT_FRAMES), 80), np.float32)
    for i, t in enumerate(UTT_FRAMES):
        xs[i, :t] = rng.standard_normal((t, 80))
    return xs, np.asarray(UTT_FRAMES, np.int64)


SERVED = {"beam10_ctc0.3": dict(beam_width=10, ctc_weight=0.3),
          "beam10_device": dict(beam_width=10, device_beam=True),
          "greedy": dict(beam_width=1)}


def phase_serve(torch, model, xs, xlens, names=tuple(SERVED), tag="3",
                table=SERVED):
    """The sessions ``names`` (of ``table``) on the utterances, each timed,
    the launch counts zeroed before the first and read after the last;
    returns (results, counts)."""
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
    from neural_sp_tpu_torch.models.decoders.las import DecodeLoop
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    sessions = [(name, Speech2TextSession(model, DecodeConfig(
        **table[name]))) for name in names]
    for _, sess in sessions:   # warm-up, not counted
        sess.decode(xs[:1, :200], xlens[:1] * 0 + 200)
    torch.cuda.synchronize()
    audio_sec = float(xlens.sum()) * FRAME_SEC
    out = {}
    reset_launches()
    for name, sess in sessions:
        torch.cuda.reset_peak_memory_stats()
        steps_before = DecodeLoop.steps
        t0 = time.perf_counter()
        hyps = sess.decode(xs, xlens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = DecodeLoop.steps - steps_before
        expect(len(hyps) == len(UTT_FRAMES) and all(
            all(isinstance(y, int) and 0 <= y < model.dec_fwd.vocab
                for y in hyp) for hyp in hyps), f"{name}: malformed {hyps}")
        out[name] = {"hyp_lens": [len(h) for h in hyps], "wall_s": wall,
                     "wall_s_per_utt": wall / len(hyps),
                     "rtf": wall / audio_sec, "decode_steps": steps,
                     "wall_ms_per_decode_step": wall * 1e3 / max(steps, 1),
                     "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        if name == "beam10_ctc0.3":
            out["best_hyp0"] = hyps[0]
        log(f"[{tag}] {name}: hyp lens {out[name]['hyp_lens']}  wall "
            f"{wall:.3f} s ({wall / len(hyps):.3f} s/utt)  RTF "
            f"{wall / audio_sec:.4f}  {steps} decode steps, "
            f"{out[name]['wall_ms_per_decode_step']:.4f} ms of wall each  "
            f"peak mem "
            f"{out[name]['peak_mem_bytes']} B")
    counts = launches()
    log(f"[{tag}] launches during the served requests: {counts}")
    return out, counts


def profiled(torch, what: str, fn, annotation: str | None = None,
             ops: tuple = (), tag: str = "3b", kernels: tuple = (),
             cpu: bool = True) -> dict:
    """Run fn once under torch.profiler: wall time, device busy time (the
    union of the device events' intervals), idle share, and the kernels
    that take the most device time; with ``annotation``, also the device
    time of the kernels launched inside the ``record_function`` ranges of
    that name, and how many ranges there were; with ``ops``, the device
    time of the kernels launched inside the operators of those names
    (``ops_device_ms``); with ``kernels``, the device time of the kernels
    whose names hold one of those strings (``kernels_device_ms``). With
    ``cpu`` False only the device is traced (no operator ranges: the trace
    of a loop of many small operators is read several times faster)."""
    from collections import defaultdict
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 if cpu else [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], defaultdict(float)
    ranges, range_us, ops_us, kernels_us = 0, 0.0, 0.0, 0.0
    for evt in prof.events():
        if evt.name in ops and \
                evt.device_type == torch.autograd.DeviceType.CPU:
            ops_us += evt.device_time_total
            continue
        if annotation is not None and evt.name == annotation:
            # the host's range sums the device time of the kernels
            # launched inside it; the range's device-side copy spans them
            # with their gaps, so it counts toward neither
            if evt.device_type == torch.autograd.DeviceType.CPU:
                ranges += 1
                range_us += evt.device_time_total
            continue
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            start, end = evt.time_range.start, evt.time_range.end
            spans.append((start, end))
            by_name[evt.name[:110]] += (end - start) / 1e3
            if any(k in evt.name for k in kernels):
                kernels_us += end - start
    busy_us, last = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > last:
            busy_us += end - max(start, last)
            last = end
    out = {"wall_s": wall, "device_events": len(spans)}
    if annotation is not None:
        out.update({f"{annotation}_ranges": ranges,
                    f"{annotation}_device_ms": range_us / 1e3})
    if ops:
        out["ops_device_ms"] = ops_us / 1e3
    if kernels:
        out["kernels_device_ms"] = kernels_us / 1e3
    if not spans:
        log(f"[{tag}] {what}: wall {wall:.3f} s; device time not measured "
            f"(the profiler saw no device events)")
        return out
    out.update(device_busy_s=busy_us / 1e6,
               device_idle_share=1.0 - busy_us / 1e6 / wall,
               top_device_ms=dict(sorted(by_name.items(),
                                         key=lambda kv: -kv[1])[:12]))
    log(f"[{tag}] {what}: wall {wall:.3f} s, device busy "
        f"{busy_us / 1e6:.4f} s, idle share {out['device_idle_share']:.4f}")
    for name, ms in out["top_device_ms"].items():
        log(f"      {ms:9.3f} ms  {name}")
    return out


def phase_breakdown(torch, model, xs, xlens):
    """Where a request's time goes: the encoder alone, one beam-10 + CTC
    request on the shortest utterance, and the on-device beam over the
    whole batch, each profiled."""
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
    beam = Speech2TextSession(model, DecodeConfig(beam_width=10,
                                                  ctc_weight=0.3))
    device_beam = Speech2TextSession(model, DecodeConfig(beam_width=10,
                                                         device_beam=True))
    from neural_sp_tpu_torch.ops.kernels import rel_attention, reset_launches
    reset_launches()
    t0 = time.perf_counter()
    beam.encode(xs, xlens)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    per_encode = rel_attention.launches
    log(f"[3b] encoder, batch of {len(UTT_FRAMES)}: {enc_s:.4f} s; K1 "
        f"launches per encode {per_encode}")
    n = UTT_FRAMES[0]
    return {"encode_batch_s": enc_s, "k1_launches_per_encode": per_encode,
            "beam10_ctc0.3_one_utt": profiled(
                torch, f"beam 10 + CTC 0.3, the {n}-frame utterance",
                lambda: beam.decode(xs[:1, :n], xlens[:1])),
            "beam10_device_batch": profiled(
                torch, f"on-device beam 10, batch of {len(UTT_FRAMES)}",
                lambda: device_beam.decode(xs, xlens))}


# LM serving (phase 3c): the LibriSpeech recipe's RNNLM at full width
# (``configs.librispeech_rnnlm_args``), and the stage-5 decode settings.
LM_SEEDS = {"lm": SEED + 1, "second": SEED + 2, "bwd": SEED + 3}
# the LM on the card against the same LM on the CPU, max |err| / max
# |reference| per step: float32 on both sides, products summed in other
# orders, carried through 6 layers and 20 steps
LM_RTOL = 1e-4
LM_CHAIN_STEPS, LM_ROWS = 20, 10


def rnnlm(torch, seed: int):
    from neural_sp_tpu_torch.configs import librispeech_rnnlm_args
    from neural_sp_tpu_torch.models.lm.build import build_lm
    from neural_sp_tpu_torch.utils.init_params import init_params
    lm = build_lm(librispeech_rnnlm_args())    # on the card
    init_params(lm, seed)
    return lm.eval()


def lm_step_cost(lm, n: int) -> tuple[int, int]:
    """(flops, bytes) of one LM step over n rows: every weight read once
    (the tied output reads the whole embedding matrix), the log-probs
    written once; two operations per weight and row."""
    n_weights = sum(p.numel() for p in lm.parameters())
    return 2 * n * n_weights, 4 * (n_weights + n * lm.vocab)


def lm_steps_counted(torch):
    """Patches of ``LMSession.predict`` (each call counted by its rows and
    wrapped in a profiler range "lm_step") and of
    ``Speech2TextSession._post_process_nbest`` (the rescoring's wall
    summed). Returns (the patches, the counts by rows, the wall list)."""
    from collections import Counter
    from neural_sp_tpu_torch.models.decoders.decoding import \
        Speech2TextSession
    from neural_sp_tpu_torch.models.lm.session import LMSession
    predict, post = LMSession.predict, Speech2TextSession._post_process_nbest
    rows, rescore_s = Counter(), []

    def counted(self, y, state):
        rows[len(y)] += 1
        with torch.profiler.record_function("lm_step"):
            return predict(self, y, state)

    def timed(self, nbest):
        t0 = time.perf_counter()
        best = post(self, nbest)
        rescore_s.append(time.perf_counter() - t0)
        return best

    return (mock.patch.object(LMSession, "predict", counted),
            mock.patch.object(Speech2TextSession, "_post_process_nbest",
                              timed)), rows, rescore_s


def phase_serve_lm(torch, model, xs, xlens):
    """Phase 3c: serve the 4 utterances with the RNNLM, (a) the LibriSpeech
    stage-5 recipe, beam 10 + CTC 0.3 + LM 0.5 + length norm, and (b)
    beam 10 + LM 0.5 + ILM 0.2 with a 10-best rescored by a second-pass LM
    and a backward LM (0.3 each); profile one request of (a); hold the LM
    on the card against the same LM on the CPU, and the ILM loop (zeroed
    keys and values, real lengths) against the chain of plain steps."""
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
    from neural_sp_tpu_torch.models.decoders.las import DecodeLoop
    from neural_sp_tpu_torch.models.lm.session import LMSession
    from neural_sp_tpu_torch.ops.kernels import (
        las_step, rel_attention, reset_launches)
    from neural_sp_tpu_torch.ops.kernels.roofline import (
        F32_SIMT_FLOPS, bound_ms)
    t0 = time.perf_counter()
    lms = {name: rnnlm(torch, seed) for name, seed in LM_SEEDS.items()}
    lm = lms["lm"]
    n_params = sum(p.numel() for p in lm.parameters())
    expect(all(p.is_cuda for m in lms.values() for p in m.parameters()),
           "an LM parameter is not on the card")
    log(f"[3c] 3 RNNLMs (rnnlm_6L, {n_params} parameters each) built on "
        f"the card in {time.perf_counter() - t0:.2f} s")
    a = Speech2TextSession(model, DecodeConfig(
        beam_width=10, ctc_weight=0.3, lm_weight=0.5, length_norm=True),
        lm_session=LMSession(lm))
    b = Speech2TextSession(model, DecodeConfig(
        beam_width=10, lm_weight=0.5, ilm_weight=0.2, n_best=10,
        lm_second_weight=0.3, lm_bwd_weight=0.3), lm_session=LMSession(lm))
    b.attach_second_pass_lms(LMSession(lms["second"]), LMSession(lms["bwd"]))
    sessions = (("beam10_ctc0.3_lm0.5_lnorm", a, True),
                ("beam10_lm0.5_ilm0.2_rescore", b, False))
    for _, sess, _ in sessions:   # warm-up, not counted
        sess.decode(xs[:1, :200], xlens[:1] * 0 + 200)
    torch.cuda.synchronize()
    audio_sec = float(xlens.sum()) * FRAME_SEC
    out, launches = {}, {"rel_attention": 0, "las_step": 0}
    for name, sess, with_ctc in sessions:
        patches, rows, rescore_s = lm_steps_counted(torch)
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        loop_steps = DecodeLoop.steps
        with patches[0], patches[1]:
            t0 = time.perf_counter()
            hyps = sess.decode(xs, xlens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        loop_steps = DecodeLoop.steps - loop_steps
        steps = rows[10]                  # one LM step per decode step
        expect(loop_steps == steps * (1 if with_ctc else 2),
               f"{name}: {loop_steps} loop steps for {steps} decode steps")
        expect(len(hyps) == len(UTT_FRAMES) and all(
            all(isinstance(y, int) and 0 <= y < model.dec_fwd.vocab
                for y in hyp) for hyp in hyps), f"{name}: malformed {hyps}")
        ran = {"rel_attention": rel_attention.launches,
               "las_step": las_step.launches}
        expect(all(v > 0 for v in ran.values()),
               f"{name}: a kernel of the path never launched: {ran}")
        for k in launches:
            launches[k] += ran[k]
        rescore = sum(rescore_s)
        res = {"hyp_lens": [len(h) for h in hyps], "wall_s": wall,
               "wall_s_per_utt": wall / len(hyps), "rtf": wall / audio_sec,
               "decode_steps": steps, "lm_steps_by_rows": dict(rows),
               "wall_ms_per_decode_step": (wall - rescore) * 1e3 / steps,
               "rescore_wall_s": rescore,
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "launches": ran}
        out[name] = res
        log(f"[3c] {name}: hyp lens {res['hyp_lens']}  wall {wall:.3f} s  "
            f"RTF {res['rtf']:.4f}  {steps} decode steps, "
            f"{res['wall_ms_per_decode_step']:.4f} ms of wall each "
            f"(rescoring apart)  rescoring {rescore:.3f} s over "
            f"{sum(n for r, n in rows.items() if r == 1)} LM steps at B=1  "
            f"peak mem {res['peak_mem_bytes']} B  launches {ran}")

    # where a request's time goes, and the LM step's device time
    n = UTT_FRAMES[0]
    patches, rows, _ = lm_steps_counted(torch)
    with patches[0]:
        prof = profiled(torch, f"beam 10 + CTC 0.3 + LM 0.5, the {n}-frame "
                        f"utterance", lambda: a.decode(xs[:1, :n], xlens[:1]),
                        annotation="lm_step")
    flops, nbytes = lm_step_cost(lm, LM_ROWS)
    bound, by = bound_ms(flops, nbytes, F32_SIMT_FLOPS)
    in_request = prof["lm_step_device_ms"] / max(prof["lm_step_ranges"], 1)
    alone = profiled(torch, f"{LM_CHAIN_STEPS} LM steps alone at "
                     f"N={LM_ROWS}", lambda: lm_chain(torch, LMSession(lm)))
    alone_ms = alone.get("device_busy_s", 0.0) * 1e3 / LM_CHAIN_STEPS
    lm_step = {"device_ms_in_request": in_request or None,
               "device_ms_alone": alone_ms or None,
               "wall_ms_alone": alone["wall_s"] * 1e3 / LM_CHAIN_STEPS,
               "flops": flops, "bytes": nbytes, "bound_ms": bound,
               "bound_by": by, "peak_flops": F32_SIMT_FLOPS}
    log(f"[3c] LM step at N={LM_ROWS}: device {in_request:.4f} ms per "
        f"decode step in the request ({prof['lm_step_ranges']} steps), "
        f"{alone_ms:.4f} ms alone (wall {lm_step['wall_ms_alone']:.4f}); "
        f"bound {bound:.4f} ms by {by} ({nbytes} B, {flops} flop)")

    # the LM on the card against the same LM on the CPU
    lm_err = lm_against_cpu(torch, lm)
    # the ILM loop: zeroed keys and values, the real lengths
    e = a.encode(xs[:1], xlens[:1])["ys"]
    e_t = e["xs"].repeat_interleave(10, 0)
    with torch.inference_mode():
        kc = model.dec_fwd.precompute_keys(e_t)
    ilm_err = loop_against_plain(
        torch, model.dec_fwd, torch.zeros_like(e_t),
        e["xlens"].repeat_interleave(10), reorder=True,
        keys=torch.zeros_like(kc), tag="3c")
    out.update(profile_a=prof, lm_step=lm_step, lm_vs_cpu_rel_err=lm_err,
               ilm_loop_max_abs_err=ilm_err)
    return out, launches


def lm_chain(torch, sess, rows: int = LM_ROWS, steps: int = LM_CHAIN_STEPS,
             seed: int = SEED):
    """``steps`` LMSession.predict calls over ``rows`` rows, seeded random
    tokens and beam reorders; returns the log-probs of each step."""
    import numpy as np
    rng = np.random.default_rng(seed)
    state, out = None, []
    for _ in range(steps):
        lp, state = sess.predict(rng.integers(0, sess.lm.vocab, rows), state)
        out.append(lp)
        state = sess.select(state, rng.integers(0, rows, rows))
    return out


def lm_against_cpu(torch, lm) -> float:
    """The LM's chain on the card against the same chain of the same LM
    (its state_dict copied) on the CPU, float32, TF32 off: each step's
    max |err| over the CPU step's max |log-prob|."""
    import numpy as np
    from neural_sp_tpu_torch.configs import librispeech_rnnlm_args
    from neural_sp_tpu_torch.models.lm.build import build_lm
    from neural_sp_tpu_torch.models.lm.session import LMSession
    cpu = build_lm(librispeech_rnnlm_args(), device="cpu").eval()
    cpu.load_state_dict(lm.state_dict(), strict=True)
    card_lp = lm_chain(torch, LMSession(lm))
    cpu_lp = lm_chain(torch, LMSession(cpu))
    err = max(float(np.abs(g - w).max()) / float(np.abs(w).max())
              for g, w in zip(card_lp, cpu_lp))
    expect(all(np.isfinite(g).all() for g in card_lp), "LM log-probs")
    log(f"[3c] LM on the card vs on the CPU, {LM_CHAIN_STEPS} steps at "
        f"N={LM_ROWS} with beam reorders: max |err| / max |log-prob| "
        f"{err:.3e} (tolerance {LM_RTOL})")
    expect(err <= LM_RTOL, f"LM card vs CPU: {err} > {LM_RTOL}")
    return err


def phase_twins(torch, model, xs, xlens, best_hyp):
    """Encoder and decoder chain with the kernels against the twins."""
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
    from neural_sp_tpu_torch.models.modules import \
        relative_multihead_attention as rma
    from neural_sp_tpu_torch.ops.kernels import rel_attention_ref
    sess = Speech2TextSession(model, DecodeConfig(beam_width=10,
                                                  ctc_weight=0.3))
    eouts = sess.encode(xs, xlens)
    with mock.patch.object(rma, "rel_attention", rel_attention_ref):
        eouts_ref = sess.encode(xs, xlens)
    e, el = eouts["ys"]["xs"], eouts["ys"]["xlens"]
    expect(bool(torch.isfinite(e).all()), "encoder output not finite")
    expect(bool((el == eouts_ref["ys"]["xlens"]).all()), "encoder lengths")
    enc_err = max_err(e, eouts_ref["ys"]["xs"])
    log(f"[4] encoder {tuple(e.shape)}, lens {el.tolist()}: kernels vs "
        f"twins max_abs_err {enc_err:.3e}")
    expect(enc_err <= PATH_ATOL, f"encoder error {enc_err} > {PATH_ATOL}")

    dec = model.dec_fwd
    e0, el0 = e[:1], el[:1]
    step_err, per_step = replay_against_plain(torch, dec, e0, el0, best_hyp)
    # the loops as the sessions step them: beam 10 of one utterance, the
    # on-device beam over the batch, greedy over the batch
    k = 10
    loop_err = max(
        loop_against_plain(torch, dec, e0.repeat_interleave(k, 0),
                           el0.repeat_interleave(k), reorder=True),
        loop_against_plain(torch, dec, e.repeat_interleave(k, 0),
                           el.repeat_interleave(k), reorder=True),
        loop_against_plain(torch, dec, e, el, reorder=True),
        loop_against_plain(torch, dec, e, el, reorder=False))
    return enc_err, max(step_err, loop_err), per_step


def replay_against_plain(torch, dec, e0, el0, hyp, tag="4"):
    """Replays ``hyp`` (after the start token) through the decode step on
    one utterance's encoder outputs e0 [1, T, D], K2 against the plain step
    chain: the largest logit error over the steps (PATH_ATOL), and K2's
    launches per decode step."""
    from neural_sp_tpu_torch import EOS
    from neural_sp_tpu_torch.models.decoders import las
    from neural_sp_tpu_torch.ops.kernels import las_step, las_step_ref
    klens = el0.to(torch.int32)
    tokens = [EOS] + hyp
    step_err = 0.0
    before = las_step.launches
    with torch.inference_mode():
        kc = dec.precompute_keys(e0)
        carry = carry_ref = dec.init_carry(1, e0.shape[1], e0.device)
        for y in tokens:
            y_t = torch.tensor([y], device=e0.device)
            carry, logits, _ = dec.decode_step(carry, y_t, kc, e0, klens)
            with mock.patch.object(las, "las_step", las_step_ref):
                carry_ref, logits_ref, _ = dec.decode_step(
                    carry_ref, y_t, kc, e0, klens)
            expect(bool(torch.isfinite(logits).all()), "logits not finite")
            step_err = max(step_err, max_err(logits, logits_ref))
    per_step = (las_step.launches - before) / len(tokens)
    log(f"[{tag}] best hypothesis replay, {len(tokens)} steps: kernels vs "
        f"twins logits max_abs_err {step_err:.3e}; K2 launches per decode "
        f"step {per_step}")
    expect(step_err <= PATH_ATOL, f"decoder error {step_err} > {PATH_ATOL}")
    return step_err, per_step


def loop_against_plain(torch, dec, e, el, reorder: bool, n_steps: int = 8,
                       keys=None, tag: str = "4"):
    """Steps a ``DecodeLoop`` over the encoder outputs e [N, T, D] (and
    ``keys``, the projected ones by default) with seeded random tokens and,
    with ``reorder``, random parent rows, against the chain of plain decode
    steps on the same tokens and parents. Returns the largest error of the
    logits and the attention weights over the steps."""
    from neural_sp_tpu_torch.models.decoders import las
    from neural_sp_tpu_torch.ops.kernels import las_step, las_step_ref
    n, dev = e.shape[0], e.device
    gen = torch.Generator().manual_seed(SEED + n)
    klens = el.to(torch.int32)
    err = 0.0
    with torch.inference_mode():
        kc = dec.precompute_keys(e) if keys is None else keys
        before = las_step.launches
        loop = dec.decode_loop(kc, e, klens)
        carry = dec.init_carry(n, e.shape[1], dev)
        par = None
        for i in range(n_steps):
            y = torch.randint(4, dec.vocab, (n,), generator=gen).to(dev)
            if reorder and i > 0:
                par = torch.randint(0, n, (n,), generator=gen).to(
                    device=dev, dtype=torch.int32)
            logits, aw = loop.step(y, par)
            with mock.patch.object(las, "las_step", las_step_ref):
                carry, logits_ref, aw_ref = dec.decode_step(
                    carry, y, kc, e, klens, parent=par)
            expect(bool(torch.isfinite(logits).all()), "logits not finite")
            err = max(err, max_err(logits, logits_ref), max_err(aw, aw_ref))
        launched = las_step.launches - before
    log(f"[{tag}] DecodeLoop N={n} reorder={reorder}, {n_steps} steps: "
        f"logits and attention weights vs the plain chain max_abs_err "
        f"{err:.3e}; K2 launches {launched}")
    expect(launched == n_steps, f"{launched} K2 launches in {n_steps} steps")
    expect(err <= PATH_ATOL, f"DecodeLoop N={n}: error {err} > {PATH_ATOL}")
    return err


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in float32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def rel_attention_bwd_yardstick(torch, args, kernel, what: str,
                                tol: float = YARDSTICK_RTOL) -> dict:
    """K1b against the autograd backward of K1's yardstick call
    (torch.autograd.grad of the efficient SDPA output w.r.t. q, k, v and
    the bias, on the same do), timed alone; the scatter of dbias into the R
    buckets of dp is timed apart. The library's dq, dk, dv, dp are held to
    the plain version (within ``tol`` of each one's max) taken with the
    library's own output as o: its D is sum dO out, so at bf16 its
    gradients follow where its forward rounded P."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from neural_sp_tpu_torch.ops.kernels.rel_attention import \
        rel_attention_bwd_ref
    q, k, v, p, klens, _, m, l, do = args
    bias = rel_bias(torch, p, klens).requires_grad_()
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    with efficient_sdpa():
        out = sdpa(*leaves, attn_mask=bias, scale=1.0)

        def grads():
            return torch.autograd.grad(out, (*leaves, bias), do,
                                       retain_graph=True)

        *dqkv, dbias = grads()
        ms, lib_ms = timed_pair(lambda: kernel(*args), grads, iters=10)
    r = p.shape[-1]
    scatter_ms = cuda_ms(lambda: bias_grad_to_buckets(torch, dbias, r),
                         iters=5, warmup=1)
    got = (*dqkv, bias_grad_to_buckets(torch, dbias, r))
    want = rel_attention_bwd_ref(q, k, v, p, klens, out.detach(), m, l, do)
    err = max(rel_err(x, y) for x, y in zip(got, want))
    log(f"[2b] K1b {what}: kernel {ms:.4f} ms  library (SDPA backward, "
        f"efficient) {lib_ms:.4f} ms + dbias into buckets {scatter_ms:.4f} "
        f"ms; library error {err:.3e} of the plain max")
    expect(err <= tol, f"K1b yardstick {what}: error {err}")
    return {"kernel_ms": ms, "library_ms": lib_ms, "library_err": err,
            "bucket_scatter_ms": scatter_ms}


def ctc_yardstick(torch, cargs, saved_r, nll_r, g, tag="2b") -> dict:
    """K4 against F.ctc_loss(lp.transpose(0, 1), labels, lengths, blank=0,
    reduction="none"): forward against K4's forward; F.ctc_loss's backward
    gives the gradient w.r.t. the logits, so it is set against K4's
    backward followed by the log-softmax backward. The library is timed in
    float32 and held to the plain version (float64 inside) in float64,
    where it computes the same function without float32's log-space
    rounding (its float32 error, reported: 2.6e-3 of the plain max at T =
    500); ``saved_r`` is what the plain forward saves, (alphas,)."""
    from torch.nn.functional import ctc_loss
    from neural_sp_tpu_torch.ops.kernels.ctc_loss import (
        ctc_loss_bwd, ctc_loss_bwd_ref, ctc_loss_fwd)
    lp, labels, tl, ul = cargs

    def lib_fwd(x=lp):
        return ctc_loss(x.transpose(0, 1), labels, tl, ul, blank=0,
                        reduction="none")

    def lsm_bwd(grad):
        return torch._log_softmax_backward_data(grad, lp, -1, lp.dtype)

    def lib_grad(x):
        leaf = x.detach().requires_grad_()
        return torch.autograd.grad(lib_fwd(leaf), leaf, g.to(x.dtype))[0]

    leaf = lp.detach().requires_grad_()
    loss = lib_fwd(leaf)

    def lib_bwd():
        return torch.autograd.grad(loss, leaf, g, retain_graph=True)[0]

    grad_r = lsm_bwd(ctc_loss_bwd_ref(*cargs, *saved_r, g))
    errs = {dt: max(rel_err(lib_fwd(lp.to(dt)), nll_r),
                    rel_err(lib_grad(lp.to(dt)), grad_r))
            for dt in (torch.float64, torch.float32)}
    err = errs[torch.float64]
    fwd_ms, fwd_lib = timed_pair(lambda: ctc_loss_fwd(*cargs), lib_fwd)
    bwd_lsm_ms, bwd_lib = timed_pair(
        lambda: lsm_bwd(ctc_loss_bwd(*cargs, *saved_r, g)), lib_bwd)
    log(f"[{tag}] K4 forward {fwd_ms:.4f} ms, F.ctc_loss forward "
        f"{fwd_lib:.4f} ms; K4 backward + log-softmax backward "
        f"{bwd_lsm_ms:.4f} ms, F.ctc_loss backward {bwd_lib:.4f} ms; library "
        f"error {err:.3e} of the plain max in float64, "
        f"{errs[torch.float32]:.3e} in float32")
    expect(err <= YARDSTICK_RTOL, f"K4 yardstick: error {err}")
    return {"fwd_kernel_ms": fwd_ms, "fwd_library_ms": fwd_lib,
            "bwd_with_log_softmax_ms": bwd_lsm_ms, "bwd_library_ms": bwd_lib,
            "library_ms": fwd_lib + bwd_lib, "library_err": err,
            "library_f32_err": errs[torch.float32]}


def phase_train_kernels(torch, rng):
    """2b: the training kernels against their plain versions, at the
    training path's shapes, with CUDA-event times of each, their bounds
    and their library yardsticks; K1 at the training shapes too."""
    import numpy as np
    from neural_sp_tpu_torch.ops.kernels import rel_attention
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_bwd, rel_attention_bwd_cost, rel_attention_bwd_ref,
        rel_attention_cost, rel_attention_fwd, rel_attention_ref)
    dev = torch.device("cuda")

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype("float32")).to(dev)

    res = {"rel_attention_train_shapes": []}
    record = kernel_recorder(res, "2b")

    b, h, dk, r = TRAIN_B, 8, 64, 11
    for tt in (750, 375, 188):
        q, k, v = t(b, h, tt, dk, scale=dk ** -0.5), t(b, h, tt, dk), \
            t(b, h, tt, dk)
        p = t(b, h, tt, r, scale=dk ** -0.5)
        kl = np.maximum(tt - (np.arange(b) * tt) // (2 * b), 1).tolist()
        klens = torch.tensor(kl, dtype=torch.int32, device=dev)
        o, m, l = rel_attention_fwd(q, k, v, p, klens)
        do = t(b, h, tt, dk)
        args = (q, k, v, p, klens, o, m, l, do)
        got, want = rel_attention_bwd(*args), rel_attention_bwd_ref(*args)
        err = max(rel_err(x, y) for x, y in zip(got, want))
        what = f"B={b} H={h} T={tt} dk={dk} R={r}"
        yard = rel_attention_bwd_yardstick(
            torch, args, rel_attention_bwd, what + " ragged klens")
        record("rel_attention_bwd", err, yard["kernel_ms"],
               cuda_ms(lambda: rel_attention_bwd_ref(*args), iters=5),
               what, **yard,
               **roofline(rel_attention_bwd_cost(b, h, tt, dk, r, kl)))
        # K1 at the training shapes, full lengths as phase 5 runs it
        full = torch.full((b,), tt, dtype=torch.int32, device=dev)
        fargs = (q, k, v, p, full)
        err = max_err(rel_attention(*fargs), rel_attention_ref(*fargs))
        expect(err <= KERNEL_ATOL, f"K1 {what}: error {err} > {KERNEL_ATOL}")
        yard = rel_attention_yardstick(torch, fargs, rel_attention,
                                       what + " full lengths", phase="2b")
        bound = roofline(rel_attention_cost(b, h, tt, dk, r, [tt] * b))
        res["rel_attention_train_shapes"].append(
            {"shape": what + " full lengths", "ms": yard["kernel_ms"],
             "plain_ms": cuda_ms(lambda: rel_attention_ref(*fargs), iters=5),
             "max_abs_err": err, **yard, **bound})
        log(f"[2b] K1 {what} full lengths: max_abs_err {err:.3e}  bound "
            f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        del got, want, args, fargs, o, m, l, do

    kl = [188 - 3 * i for i in range(b)]
    tensors = las_scan_case(torch, rng, record, b, 101, 188, 512, kl)
    # at bf16 compute K3 and K3b stay float32 and LASScan casts at their
    # boundary: the inputs (and keep) to float32 and h, ctx, aw back to
    # bf16 around K3; the output gradients to float32 and the ten input
    # gradients back to bf16 around K3b. The casts alone, on these shapes:
    args, bargs, refs, got = tensors
    bf = torch.bfloat16
    ins16 = [x.to(bf) for x in args if x.is_floating_point()]
    outs32 = (refs[0], refs[5], refs[4])
    douts16 = [x.to(bf) for x in bargs[-2:]]
    cast_fwd = cuda_ms(lambda: ([x.float() for x in ins16],
                                [y.to(bf) for y in outs32]), iters=5)
    cast_bwd = cuda_ms(lambda: ([x.float() for x in douts16],
                                [g.to(bf) for g in got]), iters=5)
    res["las_scan"]["bf16_boundary_cast_ms"] = cast_fwd
    res["las_scan_bwd"]["bf16_boundary_cast_ms"] = cast_bwd
    log(f"[2b] bf16 compute: LASScan's casts at K3's boundary {cast_fwd:.4f}"
        f" ms, at K3b's {cast_bwd:.4f} ms (the kernels stay float32)")
    del tensors, args, bargs, refs, got
    ctc_case(torch, rng, record, b, 188, TRAIN_U, 10000)
    return res


def kernel_recorder(res: dict, tag: str):
    """``record(name, err, ms, ref_ms, what, **extra)``: logs a training
    kernel's check, holds its error to TRAIN_KERNEL_TOL and keeps the row
    in ``res`` (the first shape's numbers as the kernel's own)."""
    def record(name, err, ms, ref_ms, what, **extra):
        log(f"[{tag}] {name} {what}: error {err:.3e} (of the reference's "
            f"max)  kernel {ms:.4f} ms  plain {ref_ms:.4f} ms"
            + (f"  bound {extra['bound_ms']:.4f} ms ({extra['bound_by']})"
               if "bound_ms" in extra else ""))
        tol = TRAIN_KERNEL_TOL[name]
        expect(err <= tol, f"{name} {what}: error {err} > {tol}")
        r = res.setdefault(name, {"max_abs_err": 0.0, "shapes": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["shapes"].append({"shape": what, "ms": ms, "plain_ms": ref_ms,
                            **extra})
        if "ms" not in r:
            r.update(ms=ms, plain_ms=ref_ms, **extra)
    return record


def las_scan_case(torch, rng, record, b, u, tt, d, kl, tag="2b"):
    """K3 and K3b at B rows, U steps, T frames and encoder width d (H 1024,
    A 512, C 10, K 201, klens ``kl``, dropout keep-masks at rate 0.1)
    against their plain versions, with CUDA-event times, bounds, K3's and
    K3b's kernel launches per call and the time of K3b's wrapper's work
    after its kernel loop; returns (args, backward args, K3's plain
    outputs, K3b's outputs)."""
    from neural_sp_tpu_torch.ops.kernels.las_scan import (
        las_scan, las_scan_bwd, las_scan_bwd_chain, las_scan_bwd_cost,
        las_scan_bwd_finish, las_scan_bwd_ref, las_scan_cost, las_scan_ref)
    dev = torch.device("cuda")
    hd, a, c, kw = 1024, 512, 10, 201

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype("float32")).to(dev)

    rate = 0.1
    keep = (torch.from_numpy((rng.random((u, b, hd)) >= rate).astype(
        "float32")) / (1 - rate)).to(dev)
    args = (t(u, b, 4 * hd, scale=0.5), t(d, 4 * hd, scale=(d + hd) ** -0.5),
            t(hd, 4 * hd, scale=(d + hd) ** -0.5), t(4 * hd, scale=0.1),
            t(a, hd, scale=hd ** -0.5), t(c, kw, scale=kw ** -0.5),
            t(a, c, scale=c ** -0.5), t(a, scale=a ** -0.5), t(b, tt, a),
            t(b, tt, d), torch.tensor(kl, dtype=torch.int32, device=dev),
            keep)
    outs, refs = las_scan(*args), las_scan_ref(*args)
    what = f"B={b} U={u} T={tt} H={hd} D={d} A={a} C={c} K={kw}"
    log(f"[{tag}] las_scan: {las_scan.kernel_launches_per_call} kernel "
        f"launches per call")
    # no single PyTorch call computes the scan (cuDNN's LSTM has no
    # attention fed back into its input): no library yardstick
    record("las_scan", max(rel_err(x, y) for x, y in zip(outs, refs)),
           cuda_ms(lambda: las_scan(*args), iters=5, warmup=1),
           cuda_ms(lambda: las_scan_ref(*args), iters=5, warmup=1), what,
           library_ms=None,
           **roofline(las_scan_cost(u, b, tt, hd, d, a, c, kw, kl)))
    del outs
    w_ctx, w_h, _, w_q, conv_w, w_f, v, kc, values, klt, keep = args[1:]
    bargs = (w_ctx, w_h, w_q, conv_w, w_f, v, kc, values, klt, keep, *refs,
             t(u, b, hd), t(u, b, d))
    got, want = las_scan_bwd(*bargs), las_scan_bwd_ref(*bargs)
    # the wrapper's work after the kernel loop (weight-gradient and
    # dvalues products, partial sums), timed alone on the loop's outputs
    h, _, _, _, aw, ctx = refs
    raw = las_scan_bwd_chain(*bargs)
    outside_ms = cuda_ms(lambda: las_scan_bwd_finish(h, ctx, keep, aw, *raw),
                         iters=5, warmup=1)
    log(f"[{tag}] las_scan_bwd: {las_scan_bwd.kernel_launches_per_call} "
        f"kernel launches per call; the work after the loop "
        f"{outside_ms:.4f} ms")
    record("las_scan_bwd", max(rel_err(x, y) for x, y in zip(got, want)),
           cuda_ms(lambda: las_scan_bwd(*bargs), iters=5, warmup=1),
           cuda_ms(lambda: las_scan_bwd_ref(*bargs), iters=5, warmup=1),
           what, library_ms=None, outside_ms=outside_ms,
           **roofline(las_scan_bwd_cost(u, b, tt, hd, d, a, c, kw, kl)))
    return args, bargs, refs, got


def ctc_case(torch, rng, record, b, tt, uu, vv, tag="2b"):
    """K4 forward and backward at B, T, U, V (ragged lengths, a repeated
    label) against the plain versions and F.ctc_loss, with times and the
    bound."""
    from neural_sp_tpu_torch.ops.kernels.ctc_loss import (
        ctc_forward_alphas, ctc_loss_bwd, ctc_loss_bwd_cost,
        ctc_loss_bwd_ref, ctc_loss_cost, ctc_loss_fwd)
    dev = torch.device("cuda")
    lp = torch.log_softmax(torch.from_numpy(
        (rng.standard_normal((b, tt, vv)) * 2.0).astype("float32")).to(dev),
        -1)
    labels = rng.integers(4, vv, (b, uu))
    labels[:, 1] = labels[:, 0]                       # a repeated label
    tl, ul = [tt - 2 * i for i in range(b)], [uu - (i % 9) for i in range(b)]
    cargs = (lp, torch.from_numpy(labels.astype("int32")).to(dev),
             torch.tensor(tl, dtype=torch.int32, device=dev),
             torch.tensor(ul, dtype=torch.int32, device=dev))
    nll, *saved = ctc_loss_fwd(*cargs)
    nll_r, *saved_r = ctc_forward_alphas(*cargs)
    g = torch.linspace(0.5, 1.5, b, device=dev)
    grad = ctc_loss_bwd(*cargs, *saved_r, g)
    grad_r = ctc_loss_bwd_ref(*cargs, *saved_r, g)

    # the alphas with the unreachable states at -1e4; the gradient from
    # the plain alphas and from K4's own
    err = max(rel_err(nll, nll_r),
              rel_err(saved[0].clamp(min=-1e4), saved_r[0].clamp(min=-1e4)),
              rel_err(grad, grad_r),
              rel_err(ctc_loss_bwd(*cargs, *saved, g), grad_r))
    yard = ctc_yardstick(torch, cargs, saved_r, nll_r, g, tag)
    fwd_ms = yard["fwd_kernel_ms"]
    fwd_ref = cuda_ms(lambda: ctc_forward_alphas(*cargs), iters=5, warmup=1)
    bwd_ms = cuda_ms(lambda: ctc_loss_bwd(*cargs, *saved_r, g))
    bwd_ref = cuda_ms(lambda: ctc_loss_bwd_ref(*cargs, *saved_r, g),
                      iters=5, warmup=1)
    fwd_cost = ctc_loss_cost(b, tt, uu, vv, tl, ul)
    bwd_cost = ctc_loss_bwd_cost(b, tt, uu, vv, tl, ul)
    log(f"[{tag}] ctc_loss forward kernel {fwd_ms:.4f} ms plain "
        f"{fwd_ref:.4f} ms; backward kernel {bwd_ms:.4f} ms plain "
        f"{bwd_ref:.4f} ms")
    record("ctc_loss", err, fwd_ms + bwd_ms, fwd_ref + bwd_ref,
           f"forward + backward B={b} T={tt} U={uu} V={vv}", **yard,
           **roofline((fwd_cost[0] + bwd_cost[0], fwd_cost[1] + bwd_cost[1]),
                      simt=True),
           fwd_bound_ms=roofline(fwd_cost, simt=True)["bound_ms"],
           bwd_bound_ms=roofline(bwd_cost, simt=True)["bound_ms"],
           fwd_ms=fwd_ms, fwd_plain_ms=fwd_ref, bwd_ms=bwd_ms,
           bwd_plain_ms=bwd_ref)


def phase_train_kernels_bf16(torch, rng):
    """2b at bf16: K1's and K1b's bf16 entries at the training shapes, with
    ragged and full lengths. Each is held against its plain bf16 version
    (within BF16_KERNEL_TOL of the reference's max) and against the plain
    float32 version on the same bf16-rounded inputs (its error at most
    BF16_VS_F32_RATIO times the plain bf16 version's error there), and
    timed in turns with its library yardstick (efficient SDPA in bf16 with
    the rel-PE bias as a bf16 mask; its autograd backward for K1b), with
    its bound at the bf16 tensor-core peak."""
    import numpy as np
    from neural_sp_tpu_torch.ops.kernels import rel_attention
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_bwd, rel_attention_bwd_cost, rel_attention_bwd_ref,
        rel_attention_cost, rel_attention_fwd, rel_attention_ref)
    dev, bf = torch.device("cuda"), torch.bfloat16

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            "float32")).to(dev).to(bf)

    def vs_f32(got, plain, f32):
        """(kernel's max |err| against the float32 plain version) / (the
        plain bf16 version's)."""
        return max_err(got.float(), f32) / max(max_err(plain.float(), f32),
                                               1e-30)

    res = {"rel_attention_bf16": {"max_abs_err": 0.0, "shapes": []},
           "rel_attention_bwd_bf16": {"max_abs_err": 0.0, "shapes": []}}

    def record(name, what, err, ratio, full_750, **extra):
        log(f"[2b] {name} {what}: error {err:.3e} of the plain bf16 max; "
            f"against plain f32 {ratio:.3f}x the plain bf16 version's  "
            f"kernel {extra['ms']:.4f} ms  plain {extra['plain_ms']:.4f} ms "
            f" library {extra['library_ms']:.4f} ms  bound "
            f"{extra['bound_ms']:.4f} ms ({extra['bound_by']}, bf16 peak)")
        expect(err <= BF16_KERNEL_TOL, f"{name} {what}: error {err}")
        expect(ratio <= BF16_VS_F32_RATIO,
               f"{name} {what}: {ratio:.3f}x the plain bf16 error vs f32")
        r = res[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        row = {"shape": what, "max_abs_err": err, "vs_f32_ratio": ratio,
               **extra}
        r["shapes"].append(row)
        if full_750:           # the main path's shape: phase 5's batch
            r.update({k: v for k, v in row.items()
                      if k not in ("shape", "max_abs_err")})

    b, h, dk, r = TRAIN_B, 8, 64, 11
    for tt in (750, 375, 188):
        ragged = np.maximum(tt - (np.arange(b) * tt) // (2 * b), 1).tolist()
        for lens, kl in (("ragged", ragged), ("full", [tt] * b)):
            q, k, v = t(b, h, tt, dk, scale=dk ** -0.5), t(b, h, tt, dk), \
                t(b, h, tt, dk)
            p = t(b, h, tt, r, scale=dk ** -0.5)
            klens = torch.tensor(kl, dtype=torch.int32, device=dev)
            fwd = (q, k, v, p, klens)
            fwd32 = (*(x.float() for x in (q, k, v, p)), klens)
            what = f"B={b} H={h} T={tt} dk={dk} R={r} {lens} lengths"
            full_750 = lens == "full" and tt == 750

            o, m, l = rel_attention_fwd(*fwd)
            o16, o32 = rel_attention_ref(*fwd), rel_attention_ref(*fwd32)
            err, ratio = rel_err(o, o16), vs_f32(o, o16, o32)
            del o16, o32
            yard = rel_attention_yardstick(torch, fwd, rel_attention,
                                           what + " bf16", phase="2b",
                                           tol=BF16_KERNEL_TOL)
            record("rel_attention_bf16", what, err, ratio, full_750,
                   ms=yard["kernel_ms"],
                   plain_ms=cuda_ms(lambda: rel_attention_ref(*fwd),
                                    iters=5),
                   **yard, **roofline(rel_attention_cost(
                       b, h, tt, dk, r, kl, elem=2), bf16=True))

            args = (*fwd, o, m, l, t(b, h, tt, dk))
            got = rel_attention_bwd(*args)
            want16 = rel_attention_bwd_ref(*args)
            want32 = rel_attention_bwd_ref(*fwd32, o.float(), m, l,
                                           args[-1].float())
            err = max(rel_err(x, y) for x, y in zip(got, want16))
            ratio = max(vs_f32(*xyz) for xyz in zip(got, want16, want32))
            del got, want16, want32
            yard = rel_attention_bwd_yardstick(
                torch, args, rel_attention_bwd, what + " bf16",
                tol=BF16_KERNEL_TOL)
            record("rel_attention_bwd_bf16", what, err, ratio, full_750,
                   ms=yard["kernel_ms"],
                   plain_ms=cuda_ms(lambda: rel_attention_bwd_ref(*args),
                                    iters=3),
                   **yard, **roofline(rel_attention_bwd_cost(
                       b, h, tt, dk, r, kl, elem=2), bf16=True))
            del args, fwd, fwd32, o, m, l
    return res


def train_batch(torch, rng, bs=TRAIN_B):
    """bench.py's per-utterance shape: 1500 frames x 80, U=100 labels in
    [4, vocab), every utterance full length."""
    dev = torch.device("cuda")
    xs = rng.standard_normal((bs, TRAIN_FRAMES, 80)).astype("float32")
    ys = rng.integers(4, 10000, (bs, TRAIN_U)).astype("int32")
    return (torch.from_numpy(xs).to(dev),
            torch.full((bs,), TRAIN_FRAMES, dtype=torch.int32, device=dev),
            torch.from_numpy(ys).to(dev),
            torch.full((bs,), TRAIN_U, dtype=torch.int32, device=dev))


# the kernels each training run must launch, by compute dtype; the bf16 run
# must launch no float32 K1 / K1b (no cast to float32 around them)
TRAIN_KERNELS = {"float32": ("rel_attention", "rel_attention_bwd"),
                 "bfloat16": ("rel_attention_bf16", "rel_attention_bwd_bf16")}
TRAIN_KERNELS_BOTH = ("las_scan", "las_scan_bwd", "ctc_loss", "ctc_loss_bwd")


def phase_train(torch, model, batch, train_dtype: str = "float32"):
    """5: optimizer steps of the full flagship in ``train_dtype`` (float32,
    or bf16 compute over float32 masters), timed, with the kernels'
    launches counted over the run."""
    import numpy as np
    from neural_sp_tpu_torch.configs import compute_dtype, flagship_args
    from neural_sp_tpu_torch.ops.kernels import (las_scan, las_scan_bwd,
                                                 launches, reset_launches)
    from neural_sp_tpu_torch.parallel.mesh import make_train_step
    from neural_sp_tpu_torch.trainers.lr_scheduler import noam_schedule
    from neural_sp_tpu_torch.trainers.optimizer import build_optimizer
    args = flagship_args(faithful=True)
    args.train_dtype = train_dtype
    tag = "5" if train_dtype == "float32" else "5 bf16"
    model.train()
    model.zero_grad(set_to_none=True)
    step = make_train_step(model, build_optimizer(
        "noam", schedule=noam_schedule(512, 25000, factor=5.0),
        clip_grad_norm=5.0, accum_grad_n_steps=ACCUM),
        compute_dtype=compute_dtype(args))
    gen = torch.Generator().manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    walls, metrics = [], []
    for n in range(3):                       # step 0 warms up, untimed
        t0 = time.perf_counter()
        for _ in range(ACCUM):
            metrics.append(step(*batch, gen=gen))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = launches()
    # the kernels K3's and K3b's last calls in the run launched (their
    # per-step chains)
    k3_kernels = las_scan.kernel_launches_per_call
    k3b_kernels = las_scan_bwd.kernel_launches_per_call
    peak = torch.cuda.max_memory_allocated()
    expect(all(m["emitted"] == ((i + 1) % ACCUM == 0)
               for i, m in enumerate(metrics)), "accumulation cycle")
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    expect(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
           f"non-finite loss or grad norm: {losses} {gnorms}")
    expect(all(k in metrics[-1] for k in ("loss_ctc", "loss_att", "acc_att")),
           f"missing observations: {sorted(metrics[-1])}")
    log(f"[{tag}] launches over 3 optimizer steps (12 microsteps): {counts}")
    for name in TRAIN_KERNELS[train_dtype] + TRAIN_KERNELS_BOTH:
        expect(counts[name] > 0, f"{name} never launched in training")
    for other, names in TRAIN_KERNELS.items():
        if other != train_dtype:
            expect(all(counts[name] == 0 for name in names),
                   f"{train_dtype} training launched {other} K1 / K1b")
    expect(k3_kernels > 0, "las_scan launched no kernel in training")
    expect(k3b_kernels > 0, "las_scan_bwd launched no kernel in training")
    log(f"[{tag}] las_scan: {k3_kernels} kernel launches per call; "
        f"las_scan_bwd: {k3b_kernels}")
    step_s = sum(walls[1:]) / len(walls[1:])
    frames = float(batch[1].sum()) * ACCUM
    out = {"train_dtype": train_dtype, "step_s": walls,
           "ms_per_step": step_s * 1e3,
           "frames_per_s": frames / step_s,
           "utts_per_s": TRAIN_B * ACCUM / step_s, "peak_mem_bytes": peak,
           "losses": losses, "grad_norms": gnorms, "launches": counts,
           "las_scan_kernel_launches_per_call": k3_kernels,
           "las_scan_bwd_kernel_launches_per_call": k3b_kernels,
           "last_obs": {k: float(v) for k, v in metrics[-1].items()}}
    log(f"[{tag}] optimizer step (4 x B={TRAIN_B} x {TRAIN_FRAMES} frames, "
        f"{train_dtype}): {step_s * 1e3:.1f} ms (warm-up step "
        f"{walls[0] * 1e3:.1f} ms); {out['frames_per_s']:.0f} frames/s, "
        f"{out['utts_per_s']:.2f} utts/s; peak mem {peak} B")
    log(f"[{tag}] losses {['%.3f' % x for x in losses]}")
    log(f"[{tag}] grad norms {['%.3f' % x for x in gnorms]}")
    out["profile"] = profiled(torch, f"train microstep, {train_dtype}",
                              lambda: step(*batch, gen=gen))
    model.zero_grad(set_to_none=True)
    return out, counts


class PlainLASScan:
    """``LASScan`` with the plain forward, differentiated by autograd; as
    ``LASScan``, in float32 at every compute dtype, cast at its boundary."""

    @staticmethod
    def apply(eg, *args):
        from neural_sp_tpu_torch.ops.kernels.las_scan import las_scan_ref
        *args, klens, keep = args
        h, _, _, _, aw, ctx = las_scan_ref(
            eg.float().transpose(0, 1), *(x.float() for x in args), klens,
            keep.float().transpose(0, 1))
        return tuple(x.transpose(0, 1).to(eg.dtype) for x in (h, ctx, aw))


def plain_rel_attention(torch):
    """``rel_attention`` with its plain versions on the card:
    ``rel_attention_ref`` forward, ``rel_attention_bwd_ref`` (the adjoint
    written out, rounding where the kernels do at bf16) backward; with a
    window and dropout of the probabilities (the Transformer-XL's)."""
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_bwd_ref, rel_attention_ref, rel_attention_stats_ref)

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, p, klens, window, dropout):
            o = rel_attention_ref(q, k, v, p, klens, window, 0, dropout)
            ctx.save_for_backward(q, k, v, p, klens, o,
                                  *rel_attention_stats_ref(q, k, p, klens,
                                                           window))
            ctx.window, ctx.dropout = window, dropout
            return o

        @staticmethod
        def backward(ctx, do):
            return (*rel_attention_bwd_ref(*ctx.saved_tensors, do,
                                           ctx.window, ctx.dropout),
                    None, None, None)

    def plain(q, k, v, p, klens, window=None, key_start=0, dropout=None):
        expect(key_start == 0, "the plain K1 / K1b take no key_start")
        return Plain.apply(q, k, v, p, klens, window, dropout)
    return plain


def plain_patches(torch):
    """(module, name, plain version) of the training kernels: K1 / K1b
    (``plain_rel_attention``), K3 / K3b (``PlainLASScan``) and K4 (autograd
    through its plain forward)."""
    from neural_sp_tpu_torch.models.decoders import las
    from neural_sp_tpu_torch.models.modules import \
        relative_multihead_attention as rma
    from neural_sp_tpu_torch.ops import ctc
    from neural_sp_tpu_torch.ops.kernels.ctc_loss import ctc_forward_alphas
    return ((rma, "rel_attention", plain_rel_attention(torch)),
            (las, "LASScan", PlainLASScan),
            (ctc, "ctc_nll", lambda *a: ctc_forward_alphas(*a)[0]))


def eval_microstep(torch, model, batch, compute_dtype=None, plain=False):
    """One ``eval()`` microstep under ``compute_dtype`` (None: float32):
    (loss, {leaf: gradient}), through the kernels or, with ``plain``, the
    plain versions patched in (``plain_patches``)."""
    from contextlib import ExitStack
    from neural_sp_tpu_torch.parallel.mesh import compute_loss
    model.eval()
    model.zero_grad(set_to_none=True)
    with ExitStack() as stack:
        if plain:
            for target, name, value in plain_patches(torch):
                stack.enter_context(mock.patch.object(target, name, value))
        loss, _ = compute_loss(model, compute_dtype, *batch)
        loss.backward()
    # a leaf the loss does not reach has a zero gradient (MoChA's monotonic
    # energy in eval(): its hard boundaries pass none)
    grads = {n: torch.zeros_like(p) if p.grad is None else
             p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def phase_train_parity(torch, model, batch, tag="6"):
    """6: one eval() microstep's loss and gradients, kernels vs plain
    versions, float32. Returns the result and the plain microstep's (loss,
    gradients), phase 6b's float32 reference."""
    loss, grads = eval_microstep(torch, model, batch)
    loss_ref, grads_ref = eval_microstep(torch, model, batch, plain=True)
    return hold_microstep(loss, grads, loss_ref, grads_ref, tag), \
        (loss_ref, grads_ref)


def microstep_errors(loss, grads, loss_ref, grads_ref,
                     floor: bool = False,
                     zero_leaf: str = ZERO_GRAD_LEAF) -> dict:
    """Phase 6's readings of a microstep (loss, gradients) against a
    reference: the loss's relative error and, per leaf, (share of its
    tolerance used: GRAD_RTOL of its own max, the key biases GRAD_FLOOR
    of the largest gradient, with ``floor`` every leaf at least GRAD_FLOOR
    of it (9b's rule); max |reference| / g_max; max |error| / g_max),
    g_max the reference's largest gradient."""
    g_max = max(float(g.abs().max()) for g in grads_ref.values())
    leaves = {}
    for name, g in grads.items():
        ref = grads_ref[name]
        scale, err = float(ref.abs().max()), float((g - ref).abs().max())
        tol = GRAD_FLOOR * g_max if name.endswith(zero_leaf) else \
            GRAD_RTOL * scale
        if floor:
            tol = max(tol, GRAD_FLOOR * g_max)
        leaves[name] = (err / tol if err else 0.0, scale / g_max,
                        err / g_max)
    return {"loss_rel_err": abs(loss - loss_ref) / abs(loss_ref),
            "g_max": g_max, "leaves": leaves}


def hold_microstep(loss, grads, loss_ref, grads_ref, tag,
                   floor: bool = False,
                   zero_leaf: str = ZERO_GRAD_LEAF) -> dict:
    """Phase 6's rule: the kernels' microstep (loss, gradients) against the
    plain versions' to LOSS_RTOL and, per leaf, GRAD_RTOL of its own max
    (the key biases, leaves named ``*zero_leaf``: GRAD_FLOOR of the largest
    gradient; with ``floor``, 9b's rule, every leaf at least GRAD_FLOOR of
    it)."""
    e = microstep_errors(loss, grads, loss_ref, grads_ref, floor, zero_leaf)
    loss_err, g_max, leaves = e["loss_rel_err"], e["g_max"], e["leaves"]
    ranked = sorted(leaves.items(), key=lambda kv: -kv[1][0])
    zero = [kv for kv in ranked if kv[0].endswith(zero_leaf)]
    log(f"[{tag}] loss kernels {loss:.6f} plain {loss_ref:.6f} (rel "
        f"{loss_err:.2e}); largest gradient {g_max:.4e}")
    log(f"[{tag}] {len(leaves) - len(zero)} leaves held to {GRAD_RTOL} of "
        f"their own max ({f'at least {GRAD_FLOOR}' if floor else 'no'} "
        f"absolute floor), {len(zero)} key-bias leaves to {GRAD_FLOOR} of "
        f"the largest gradient")
    log(f"[{tag}] largest error {max(v[2] for v in leaves.values()):.3e} "
        f"of the largest gradient")
    for name, (share, scale, err) in ranked[:6]:
        log(f"[{tag}]   {name}: {share:.3f} of its tolerance (own max "
            f"{scale:.3e}, error {err:.3e} of the largest gradient)")
    for name, (share, scale, err) in zero[:2]:
        log(f"[{tag}]   key bias {name}: {share:.3f} of its tolerance (plain "
            f"max {scale:.3e}, error {err:.3e} of the largest gradient)")
    worst_name, (worst, _, _) = ranked[0]
    expect(loss_err <= LOSS_RTOL, f"loss {loss} vs plain {loss_ref}")
    expect(worst <= 1.0, f"gradient {worst_name} outside tolerance")
    return {"loss_rel_err": loss_err, "worst_grad": worst,
            "worst_grad_leaf": worst_name, "worst_leaves": dict(ranked[:6]),
            "key_bias_leaves": dict(zero),
            "largest_err_of_g_max": max(v[2] for v in leaves.values())}


def phase_determinism(torch, model, batch, bf16: bool = True,
                      phase: str = "6") -> dict:
    """6: one train() microstep twice, from a generator of one seed each
    time (the same dropout, SpecAugment and sampling draws), in float32
    and (``bf16``) at bf16 compute: the losses and every gradient leaf must
    be the same bits."""
    from neural_sp_tpu_torch.parallel.mesh import (compute_loss,
                                                   deterministic_cudnn)
    model.train()
    out = {}
    for tag, dtype in (("float32", None), ("bfloat16", torch.bfloat16))[
            :2 if bf16 else 1]:
        runs = []
        for _ in range(2):
            model.zero_grad(set_to_none=True)
            with deterministic_cudnn():     # as the train step runs
                loss, _ = compute_loss(model, dtype, *batch,
                                       torch.Generator().manual_seed(SEED))
                loss.backward()
            runs.append((loss.detach().float(), {
                n: p.grad.detach().clone()
                for n, p in model.named_parameters()}))
        model.zero_grad(set_to_none=True)
        (la, ga), (lb, gb) = runs
        differ = [n for n in ga if not torch.equal(ga[n], gb[n])]
        out[tag] = {"loss_equal": bool(torch.equal(la, lb)),
                    "leaves": len(ga), "leaves_differ": differ}
        log(f"[{phase}] {tag} microstep twice: loss {float(la):.6f} "
            f"{'==' if out[tag]['loss_equal'] else '!='} {float(lb):.6f}; "
            f"{len(differ)} of {len(ga)} gradient leaves differ")
        expect(out[tag]["loss_equal"] and not differ,
               f"{tag} microstep is not the same bits twice: {differ[:6]}")
    return out


def phase_train_parity_bf16(torch, model, batch, plain32, tag="6b"):
    """6b: one eval() microstep at bf16 compute through the kernels against
    the same microstep with the plain versions patched in (both bf16): each
    quantity's distance from phase 6's plain float32 microstep
    (``plain32``) held to BF16_PATH_FACTOR times the plain bf16
    microstep's, in the L2 norm, plus phase 6's float32 tolerance in that
    norm."""
    bf = torch.bfloat16
    loss, grads = eval_microstep(torch, model, batch, bf)
    loss16, grads16 = eval_microstep(torch, model, batch, bf, plain=True)
    loss32, grads32 = plain32
    g_max = max(float(g.abs().max()) for g in grads32.values())
    loss_tol = BF16_PATH_FACTOR * abs(loss16 - loss32) + \
        LOSS_RTOL * abs(loss32)
    norm = torch.linalg.vector_norm
    leaves = {}
    for name, g in grads.items():
        ref, ref32 = grads16[name], grads32[name]
        per_element = GRAD_FLOOR * g_max if name.endswith(ZERO_GRAD_LEAF) \
            else GRAD_RTOL * float(ref32.abs().max())
        floor = per_element * ref32.numel() ** 0.5
        plain_cost = float(norm(ref - ref32))
        tol = BF16_PATH_FACTOR * plain_cost + floor
        err = float(norm(g - ref32))
        leaves[name] = (err / tol if err else 0.0, err, plain_cost,
                        float(norm(g - ref)))
    ranked = sorted(leaves.items(), key=lambda kv: -kv[1][0])
    log(f"[{tag}] bf16 eval loss kernels {loss:.6f} plain bf16 {loss16:.6f} "
        f"plain f32 {loss32:.6f}: |kernels - f32| {abs(loss - loss32):.3e} "
        f"against a tolerance of {loss_tol:.3e}")
    for name, (share, err, cost, between) in ranked[:6]:
        log(f"[{tag}]   {name}: {share:.3f} of its tolerance (|kernels - f32| "
            f"{err:.3e}, |plain bf16 - f32| {cost:.3e}, |kernels - plain "
            f"bf16| {between:.3e}, L2)")
    worst_name, (worst, _, _, _) = ranked[0]
    expect(abs(loss - loss32) <= loss_tol,
           f"bf16 loss {loss} vs plain f32 {loss32} (plain bf16 {loss16})")
    expect(worst <= 1.0, f"bf16 gradient {worst_name} outside tolerance")
    return {"loss": loss, "loss_plain_bf16": loss16, "loss_plain_f32": loss32,
            "worst_grad": worst, "worst_grad_leaf": worst_name,
            "worst_leaves": dict(ranked[:6])}


def phase_fit(torch, model, batch, compute_dtype=None, tag="6"):
    """5 Adam steps (lr 1e-4) on a fixed batch of 8 utterances in train()
    mode, under ``compute_dtype``; the loss must fall."""
    from neural_sp_tpu_torch.parallel.mesh import make_train_step
    from neural_sp_tpu_torch.trainers.optimizer import build_optimizer
    model.train()
    small = tuple(x[:8] for x in batch)
    step = make_train_step(model, build_optimizer("adam", lr=1e-4),
                           compute_dtype=compute_dtype)
    gen = torch.Generator().manual_seed(SEED)
    losses = [float(step(*small, gen=gen)["loss"]) for _ in range(5)]
    model.zero_grad(set_to_none=True)
    log(f"[{tag}] fixed batch of 8, Adam 1e-4: losses "
        f"{['%.4f' % x for x in losses]}")
    expect(losses[-1] < losses[0], f"loss did not fall: {losses}")
    return losses


# Phase 7: the CLIs on the LibriSpeech Conformer-LAS conf. The conf is the
# recipe's, at full width and depth; the overrides are the run's length
# (two epochs, then a third resumed), two accumulated microbatches per
# update instead of 16 (so each epoch emits updates), and the word unit
# over a synthesized 10k vocabulary (the conf's wp needs a trained BPE).
CLI_CONF = "examples/librispeech/conf/asr/" \
    "conformer_kernel15_clamp10_hie_subsample8_las_ln_large.yaml"
CLI_OVERRIDES = ("--n_epochs", "2", "--accum_grad_n_steps", "2",
                 "--unit", "word")
CLI_UTTS = {"train": 64, "dev": 8, "test": 4}
CLI_VOCAB = 10000          # the 4 reserved ids and 9,996 words
# the recipe's stage 5 (examples/librispeech/run.sh) at 2 averaged epochs
CLI_EVAL = ("--recog_beam_width", "10", "--recog_ctc_weight", "0.3",
            "--recog_length_norm", "true", "--recog_lm_weight", "0.5",
            "--recog_n_average", "2")
CLI_TRAIN_KERNELS = ("rel_attention_bf16", "rel_attention_bwd_bf16",
                     "las_scan", "las_scan_bwd", "ctc_loss", "ctc_loss_bwd")
CLI_EVAL_KERNELS = ("rel_attention", "las_step")


def synth_corpus(root: Path, utts: dict, vocab: int, frames=(700, 1600),
                 dim: int = 80) -> dict:
    """A LibriSpeech-shaped corpus from numpy seed 0: standard normal
    features of ``frames`` (10 ms frames x ``dim``) as .npy, transcripts of
    ~100 words (at most the CTC limit, frames // 8) over a dictionary of
    ``vocab - 4`` words, TSVs in the JAX package's columns."""
    import numpy as np
    rng = np.random.default_rng(0)
    words = [f"w{i:04d}" for i in range(vocab - 4)]
    (root / "feat").mkdir(parents=True, exist_ok=True)
    paths = {"dict": str(root / "dict_word.txt")}
    (root / "dict_word.txt").write_text(
        "".join(f"{w} {i + 4}\n" for i, w in enumerate(words)))
    for name, n in utts.items():
        rows = ["utt_id\tspeaker\tfeat_path\txlen\txdim\ttext\ttoken_id"
                "\tylen\tydim"]
        for i in range(n):
            t = int(rng.integers(frames[0], frames[1] + 1))
            path = root / "feat" / f"{name}_{i:03d}.npy"
            np.save(path, rng.standard_normal((t, dim)).astype("float32"))
            u = min(int(rng.integers(90, 111)), t // 8)
            ids = rng.integers(0, vocab - 4, u)
            rows.append("\t".join((
                f"{name}_{i:03d}", f"spk{i % 4}", str(path), str(t),
                str(dim), " ".join(words[j] for j in ids),
                " ".join(str(j + 4) for j in ids), str(u), str(vocab))))
        paths[name] = str(root / f"{name}.tsv")
        Path(paths[name]).write_text("\n".join(rows) + "\n")
    return paths


def recipe_lm(root: Path) -> str:
    """The recipe's LM (rnnlm_6L over CLI_VOCAB) in ``root / "lm"``:
    seeded, saved as its train CLI would leave it; made once."""
    from neural_sp_tpu_torch.bin.args import save_config
    from neural_sp_tpu_torch.configs import librispeech_rnnlm_args
    from neural_sp_tpu_torch.models.lm.build import build_lm
    from neural_sp_tpu_torch.trainers.checkpoint import save_checkpoint
    from neural_sp_tpu_torch.utils.init_params import init_params
    lm_dir = root / "lm"
    if not (lm_dir / "conf.yml").exists():
        largs = librispeech_rnnlm_args()
        largs.vocab = CLI_VOCAB
        lm = init_params(build_lm(largs), SEED + 1)
        save_checkpoint(str(lm_dir), 1, lm.state_dict())
        save_config(vars(largs), str(lm_dir / "conf.yml"))
    return str(lm_dir)


def phase_cli(torch, root: Path, corpus: dict) -> dict:
    """7: the train CLI (two epochs, then a third resumed) and the eval CLI
    (beam 10 + CTC 0.3 + RNNLM 0.5, 2 averaged epochs) on the LibriSpeech
    conf and the synthesized ``corpus`` (``synth_corpus`` under ``root``),
    through their ``main`` entry points, launch counts zeroed around each.
    Every microstep's loss and every epoch's train and dev loss must be
    finite, and the widest microbatch the train CLI ran (longest padded
    frames, then most utterances) and the one of most utterances are held
    to the plain versions on the trained model at phase 6's tolerance in
    float32 and by phase 6b's rule at bf16: the kernels at the CLI's own
    shapes."""
    import csv
    import math
    import os
    from types import SimpleNamespace
    from neural_sp_tpu_torch.bin.asr import eval as cli_eval
    from neural_sp_tpu_torch.bin.asr import train as cli_train
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    from neural_sp_tpu_torch.parallel.mesh import TrainStep
    from neural_sp_tpu_torch.trainers.checkpoint import load_checkpoint
    sync = torch.cuda.synchronize
    out = {"conf": CLI_CONF, "overrides": list(CLI_OVERRIDES),
           "utterances": CLI_UTTS, "vocab": CLI_VOCAB}
    exp = str(root / "exp")
    data = ["--train_set", corpus["train"], "--dev_set", corpus["dev"],
            "--dict", corpus["dict"], "--model_save_dir", exp]

    # each microstep and checkpoint save timed (the CLI reads every
    # step's loss on the host, so the sync costs it nothing more); the
    # widest microbatch (by padded frames) and the one of most utterances
    # kept
    steps, saves, widest, most = [], [], [], []
    orig_call, orig_save = TrainStep.__call__, cli_train.save_checkpoint

    def timed_call(self, xs, xlens, ys, ylens, *a, **kw):
        sync()
        t = time.perf_counter()
        m = orig_call(self, xs, xlens, ys, ylens, *a, **kw)
        sync()
        steps.append((time.perf_counter() - t, bool(m["emitted"]),
                      int(xlens.sum()), int(xlens.numel()),
                      float(m["loss"])))
        if not widest or (xs.shape[1], xs.shape[0]) > (
                widest[0].shape[1], widest[0].shape[0]):
            widest[:] = (xs, xlens, ys, ylens)
        if not most or (xs.shape[0], xs.shape[1]) > (
                most[0].shape[0], most[0].shape[1]):
            most[:] = (xs, xlens, ys, ylens)
        return m

    def timed_save(*a, **kw):
        t = time.perf_counter()
        path = orig_save(*a, **kw)
        saves.append((time.perf_counter() - t, os.path.getsize(path)))
        return path

    runs = []
    with mock.patch.object(TrainStep, "__call__", timed_call), \
            mock.patch.object(cli_train, "save_checkpoint", timed_save):
        for resume in ((), ("--resume", f"{exp}/ckpt.epoch-2",
                            "--n_epochs", "3")):
            steps.clear()
            torch.cuda.reset_peak_memory_stats()
            sync()
            reset_launches()
            t = time.perf_counter()
            cli_train.main(["--config", str(ROOT / CLI_CONF)] + data +
                           list(CLI_OVERRIDES) + list(resume))
            sync()
            wall = time.perf_counter() - t
            counts = launches()
            emitted = [s for s in steps if s[1]]
            # one optimizer step: the microsteps of its cycle
            cycles, cur = [], 0.0
            for s in steps:
                cur += s[0]
                if s[1]:
                    cycles.append(cur)
                    cur = 0.0
            run = {"wall_s": wall, "microsteps": len(steps),
                   "optimizer_steps": len(emitted),
                   "microstep_s": [s[0] for s in steps],
                   "microstep_utts": [s[3] for s in steps],
                   "microstep_loss": [s[4] for s in steps],
                   "ms_per_optimizer_step": 1e3 * sum(cycles) /
                   max(len(cycles), 1),
                   "frames_per_s": sum(s[2] for s in steps) /
                   sum(s[0] for s in steps),
                   # without the run's first cycle (its first microstep
                   # meets each new shape's library set-up)
                   "ms_per_optimizer_step_after_first": 1e3 * sum(
                       cycles[1:]) / max(len(cycles) - 1, 1),
                   "frames_per_s_after_first": sum(
                       s[2] for s in steps[2:]) / sum(
                       s[0] for s in steps[2:]),
                   "launches": counts,
                   "peak_mem_bytes": torch.cuda.max_memory_allocated()}
            runs.append(run)
            log(f"[7] train CLI{' (resumed)' if resume else ''}: "
                f"{run['microsteps']} microsteps, "
                f"{run['optimizer_steps']} optimizer steps, "
                f"{run['ms_per_optimizer_step']:.1f} ms per optimizer "
                f"step ({run['ms_per_optimizer_step_after_first']:.1f} "
                f"after the first), {run['frames_per_s']:.0f} frames/s "
                f"({run['frames_per_s_after_first']:.0f}), wall "
                f"{wall:.1f} s, peak mem {run['peak_mem_bytes']} B")
            log(f"[7]   microstep losses "
                f"{['%.3f' % x for x in run['microstep_loss']]}")
            log(f"[7]   launches: {counts}")
            expect(all(map(math.isfinite, run["microstep_loss"])),
                   f"train CLI losses {run['microstep_loss']}")
            for name in CLI_TRAIN_KERNELS:
                expect(counts[name] > 0,
                       f"{name} never launched in the train CLI")
            expect(counts["rel_attention_bwd"] == 0,
                   "the bf16 train CLI launched the float32 K1b")
    out["train"], out["train_resumed"] = runs
    out["checkpoint_save_s"] = [s for s, _ in saves]
    out["checkpoint_bytes"] = saves[-1][1]
    log(f"[7] checkpoints: {saves[-1][1]} B each, saved in "
        f"{['%.2f' % s for s, _ in saves]} s")
    # the epochs' mean train and dev losses, as history.csv keeps them
    with open(f"{exp}/history.csv") as f:
        history = [(int(r["epoch"]), float(r["train_loss"]),
                    float(r["dev_loss_mean"])) for r in csv.DictReader(f)]
    out["history"] = history
    log(f"[7] history.csv (epoch, train loss, dev loss): {history}")
    expect([e for e, _, _ in history] == [1, 2, 3] and all(
        math.isfinite(x) for _, *losses in history for x in losses),
        f"history.csv {history}")
    ck2 = load_checkpoint(f"{exp}/ckpt.epoch-2")
    ck3 = load_checkpoint(f"{exp}/ckpt.epoch-3")
    expect(ck3["controller"]["epoch"] == 3,
           f"resumed controller epoch {ck3['controller']['epoch']}")
    expect(ck3["optimizer"]["count"] == ck2["optimizer"]["count"] +
           runs[1]["optimizer_steps"] and
           runs[1]["optimizer_steps"] > 0,
           f"Adam count {ck2['optimizer']['count']} -> "
           f"{ck3['optimizer']['count']} over "
           f"{runs[1]['optimizer_steps']} resumed updates")
    expect(len(ck3["controller"]["topk"]) == 3,
           f"resumed controller's epochs {ck3['controller']['topk']}")
    out["adam_count"] = [ck2["optimizer"]["count"],
                         ck3["optimizer"]["count"]]
    log(f"[7] resumed: controller epoch 2 -> 3, Adam count "
        f"{out['adam_count'][0]} -> {out['adam_count'][1]}")
    del ck2, ck3

    # the widest microbatch and the one of most utterances on the trained
    # model, kernels vs plain: in float32 by phase 6's rule, at bf16 by 6b's
    model, _, _ = cli_eval.load_model_for_eval(SimpleNamespace(
        recog_model=f"{exp}/ckpt.epoch-3", recog_n_average=1))
    for key, kept in (("widest", widest), ("most_utterances", most)):
        if key != "widest" and kept[0].shape == widest[0].shape:
            continue
        batch = tuple(kept)
        log(f"[7] microbatch ({key}) held to the plain versions: B "
            f"{batch[0].shape[0]} x {batch[0].shape[1]} frames, U "
            f"{batch[2].shape[1]}")
        hold, plain32 = phase_train_parity(torch, model, batch, tag="7")
        hold_bf16 = phase_train_parity_bf16(torch, model, batch, plain32,
                                            tag="7")
        out[f"train_parity_{key}"] = {
            "shape": [list(batch[0].shape), list(batch[2].shape)],
            "float32": hold, "bfloat16": hold_bf16}
        del batch, plain32
    del model
    widest.clear()
    most.clear()
    torch.cuda.empty_cache()

    lm_dir = recipe_lm(root)
    torch.cuda.reset_peak_memory_stats()
    sync()
    reset_launches()
    t = time.perf_counter()
    res = cli_eval.main(["--recog_model", exp, "--recog_sets",
                         corpus["test"], "--recog_lm", lm_dir,
                         "--recog_dir", str(root / "decode")] +
                        list(CLI_EVAL))
    sync()
    wall = time.perf_counter() - t
    counts = launches()
    (m,) = res.values()
    audio_s = sum(int(line.split("\t")[3]) for line in
                  Path(corpus["test"]).read_text().splitlines()[1:]) \
        * FRAME_SEC
    hyps = (root / "decode" / "test" / "hyp.trn").read_text()
    out["eval"] = {**m, "wall_s": wall, "launches": counts,
                   "wall_per_utt_s": m["rtf"] * audio_s / m["n_utts"],
                   "hyp_tokens": [len(h.rsplit(" (", 1)[0].split())
                                  for h in hyps.splitlines()],
                   "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    log(f"[7] eval CLI: RTF {m['rtf']:.4f}, "
        f"{out['eval']['wall_per_utt_s']:.2f} s of decoding per "
        f"utterance, wall {wall:.1f} s (with loading), hypothesis "
        f"lengths {out['eval']['hyp_tokens']}")
    log(f"[7]   WER {m['wer']:.2f} / CER {m['cer']:.2f} over "
        f"{m['n_utts']} utterances (random weights: the error rates "
        f"only show that the pipeline ran)")
    log(f"[7]   launches: {counts}")
    expect(m["n_utts"] == CLI_UTTS["test"], f"{m['n_utts']} utterances")
    for name in CLI_EVAL_KERNELS:
        expect(counts[name] > 0, f"{name} never launched in the eval CLI")
    return out


# Phase 7b: the North star's reference conf through the train CLI, at full
# width and depth in float32 (the conf has no train_dtype), with scheduled
# sampling (ss_prob 0.2) and the switch to SGD. The overrides are the run's
# length, the word unit of phase 7 (the same corpus), and a switch point
# early enough to exercise: epoch 1 trains noam-Adam, epoch 2 plain SGD.
SS_CONF = "examples/librispeech/conf/asr/transformer/" \
    "conformer_kernel15_clamp10_hie_subsample8_las_long_ln_large.yaml"
SS_OVERRIDES = ("--n_epochs", "2", "--accum_grad_n_steps", "2",
                "--unit", "word", "--convert_to_sgd_epoch", "1")
SS_PROB, SGD_LR, CLIP = 0.2, 1e-4, 5.0
SS_TRAIN_KERNELS = ("rel_attention", "rel_attention_bwd", "las_step",
                    "las_scan", "las_scan_bwd", "ctc_loss", "ctc_loss_bwd")
# fed tokens where the kernels' pass 1 and the plain one's may part: an
# argmax over two logits that K2's rounding (KERNEL_ATOL) can swap; at most
# one in this many valid positions
FED_TIES = 1000


def plain_workspace(*args):
    """A ``LasStepWorkspace`` whose steps take ``las_step_ref`` on the card
    (the workspace's CPU path): pass 1 with K2's plain version."""
    from neural_sp_tpu_torch.ops.kernels.las_step import LasStepWorkspace
    ws = LasStepWorkspace(*args)
    ws._lib = None
    return ws


def sgd_step_error(torch, before: dict, after: dict, grads: dict):
    """How far an update lies from SGD's: (the relative distance of the
    gradient's global norm taken in float32, as the step takes it, from
    the norm summed in float64; the largest |p_after - (p_before - SGD_LR
    * clip(g))| over every element, in f32 spacings at p_after), the clip
    as optax takes it (g / |g| * CLIP when |g| >= CLIP) with the float32
    norm."""
    from neural_sp_tpu_torch.trainers.optimizer import global_norm
    norm32 = global_norm(list(grads.values()))
    norm64 = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    worst = 0.0
    for name, g in grads.items():
        g = torch.where(norm32 >= CLIP, g / norm32 * CLIP, g)
        want = before[name] + (-SGD_LR) * g
        got = after[name]
        ulp = torch.nextafter(got.abs(), torch.full_like(got, float("inf"))) \
            - got.abs()
        worst = max(worst, float(((got - want).abs() / ulp).max()))
    return float((norm32.double() - norm64).abs() / norm64), worst


def phase_sampled_cli(torch, root: Path, corpus: dict) -> dict:
    """7b: ``bin.asr.train.main`` on ``SS_CONF`` (``SS_OVERRIDES``; phase
    7's corpus), counts zeroed just before and read just after: K1 / K1b,
    K2 (pass 1), K3 / K3b (pass 2) and K4 must run. Checks: every loss
    finite; the share of sampled positions among the valid ones within 4
    binomial standard deviations of ss_prob (the share of fed tokens that
    differ from the label is reported); epoch 1 Adam with 2 accumulated
    microsteps, epoch 2 SGD emitting at every microstep, and its first
    update -SGD_LR times the clipped gradient to within one f32 spacing of
    each parameter; the checkpoint after the switch holds SGD's state and a
    controller that no longer decays. Then the widest microbatch (frames,
    then utterances), on the epoch-2 weights with sampling on, in train()
    with one generator seed: the kernels (K2 in pass 1, K3 / K3b in pass 2,
    K1 / K1b, K4) against the plain versions, the loss and every gradient
    leaf at phase 6's float32 tolerance (pass 2 over the kernels' fed
    tokens; the plain pass 1's tokens may part from them only at ties)."""
    import csv
    import math
    from types import SimpleNamespace
    from neural_sp_tpu_torch.bin.asr import eval as cli_eval
    from neural_sp_tpu_torch.bin.asr import train as cli_train
    from neural_sp_tpu_torch.models.decoders import las
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    from neural_sp_tpu_torch.parallel.mesh import TrainStep
    from neural_sp_tpu_torch.trainers.checkpoint import load_checkpoint
    from neural_sp_tpu_torch.trainers.optimizer import SGD
    sync = torch.cuda.synchronize
    exp = str(root / "exp_sampled")
    data = ["--train_set", corpus["train"], "--dev_set", corpus["dev"],
            "--dict", corpus["dict"], "--model_save_dir", exp]
    out = {"conf": SS_CONF, "overrides": list(SS_OVERRIDES)}
    steps, widest, sampled, sgd_check = [], [], [], {}
    orig_call = TrainStep.__call__
    orig_fed = las.RNNDecoder.fed_tokens

    def watched_call(self, xs, xlens, ys, ylens, *a, **kw):
        is_sgd = isinstance(self.opt, SGD)
        first_sgd = is_sgd and not sgd_check
        if first_sgd:
            before = {n: p.detach().clone()
                      for n, p in self.model.named_parameters()}
        sync()
        t = time.perf_counter()
        m = orig_call(self, xs, xlens, ys, ylens, *a, **kw)
        sync()
        steps.append((time.perf_counter() - t, bool(m["emitted"]),
                      is_sgd, float(m["loss"]), int(xlens.sum())))
        if first_sgd:
            named = dict(self.model.named_parameters())
            sgd_check["norm_rel_err"], sgd_check["ulps"] = sgd_step_error(
                torch, before, {n: p.detach() for n, p in named.items()},
                {n: p.grad for n, p in named.items()})
            del before
        if not widest or (xs.shape[1], xs.shape[0]) > (
                widest[0].shape[1], widest[0].shape[0]):
            widest[:] = (xs, xlens, ys, ylens)
        return m

    def watched_fed(self, ys_in, kc, values, klens, masks):
        fed = orig_fed(self, ys_in, kc, values, klens, masks)
        valid = ys_in != las.PAD
        sampled.append((int(valid.sum()), int(masks.sample[valid].sum()),
                        int((fed != ys_in)[valid].sum())))
        return fed

    torch.cuda.reset_peak_memory_stats()
    sync()
    reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(TrainStep, "__call__", watched_call), \
            mock.patch.object(las.RNNDecoder, "fed_tokens", watched_fed):
        cli_train.main(["--config", str(ROOT / SS_CONF)] + data +
                       list(SS_OVERRIDES))
    sync()
    wall = time.perf_counter() - t0
    counts = launches()
    out["launches"] = counts
    log(f"[7b] train CLI on {SS_CONF}: {len(steps)} microsteps, wall "
        f"{wall:.1f} s, peak mem {torch.cuda.max_memory_allocated()} B")
    log(f"[7b]   launches: {counts}")
    for name in SS_TRAIN_KERNELS:
        expect(counts[name] > 0, f"{name} never launched in phase 7b")
    losses = [x[3] for x in steps]
    log(f"[7b]   microstep losses {['%.3f' % x for x in losses]}")
    expect(all(map(math.isfinite, losses)), f"7b losses {losses}")
    with open(f"{exp}/history.csv") as f:
        history = [(int(r["epoch"]), float(r["train_loss"]),
                    float(r["dev_loss_mean"])) for r in csv.DictReader(f)]
    expect([e for e, _, _ in history] == [1, 2] and all(
        math.isfinite(x) for _, *ls in history for x in ls),
        f"7b history.csv {history}")
    # the sampling: its share of the valid positions, binomially
    n_valid = sum(x[0] for x in sampled)
    n_sampled = sum(x[1] for x in sampled)
    n_fed = sum(x[2] for x in sampled)
    share = n_sampled / n_valid
    sd = math.sqrt(SS_PROB * (1 - SS_PROB) / n_valid)
    out["sampling"] = {"microsteps": len(sampled), "valid": n_valid,
                       "sampled_share": share, "binomial_sd": sd,
                       "fed_not_label_share": n_fed / n_valid}
    log(f"[7b]   sampled {n_sampled} of {n_valid} valid positions "
        f"({share:.4f}; ss_prob {SS_PROB}, 4 sd = {4 * sd:.4f}); fed token "
        f"not the label at {n_fed / n_valid:.4f} of them")
    expect(len(sampled) == len(steps), "a microstep ran without pass 1")
    expect(abs(share - SS_PROB) <= 4 * sd, f"sampled share {share}")
    # the optimizers: Adam with accumulation, then SGD at every microstep
    epoch1 = [x for x in steps if not x[2]]
    epoch2 = [x for x in steps if x[2]]
    expect(epoch1 and epoch2 and all(x[1] for x in epoch2) and
           [x[1] for x in epoch1] == [i % 2 == 1 for i in range(len(epoch1))],
           f"7b emitted (Adam, accumulating 2): {[x[1] for x in epoch1]}; "
           f"SGD: {[x[1] for x in epoch2]}")
    out["sgd_first_update"] = sgd_check
    log(f"[7b]   epoch 1: {len(epoch1)} microsteps of Adam; epoch 2: "
        f"{len(epoch2)} of SGD, its first update {sgd_check['ulps']:.3f} "
        f"f32 spacings from -{SGD_LR} x the clipped gradient at most (the "
        f"float32 norm {sgd_check['norm_rel_err']:.2e} from the float64 "
        f"one)")
    expect(sgd_check["ulps"] <= 1.0, "the SGD update")
    # float32 sums of 105 M squares, leaf by leaf: rounding to 1e-4 at most
    expect(sgd_check["norm_rel_err"] <= 1e-4, "the gradient's global norm")
    ck = load_checkpoint(f"{exp}/ckpt.epoch-2")
    ctl = ck["controller"]
    expect(ck["optimizer"] == {"optimizer": "sgd"} and
           ctl["decay_type"] == "no" and ctl["lr"] == SGD_LR,
           f"checkpoint after the switch: {ck['optimizer']} {ctl}")
    del ck
    out.update(history=history, wall_s=wall, microsteps=len(steps),
               microstep_s=[x[0] for x in steps], microstep_loss=losses,
               frames_per_s=sum(x[4] for x in steps) / sum(
                   x[0] for x in steps),
               peak_mem_bytes=torch.cuda.max_memory_allocated())

    # the widest microbatch, kernels against the plain versions, sampling on
    model, _, _ = cli_eval.load_model_for_eval(SimpleNamespace(
        recog_model=f"{exp}/ckpt.epoch-2", recog_n_average=1))
    model.dec_fwd.step.ss_prob = SS_PROB
    batch = tuple(widest)
    widest.clear()
    log(f"[7b] microbatch held to the plain versions with sampling on: B "
        f"{batch[0].shape[0]} x {batch[0].shape[1]} frames, U "
        f"{batch[2].shape[1]}")
    fed_seen = []

    def keep_fed(self, *args):
        fed_seen.append(orig_fed(self, *args))
        return fed_seen[-1]

    with mock.patch.object(las.RNNDecoder, "fed_tokens", keep_fed):
        loss, grads = train_microstep(torch, model, batch)
    kernel_fed = fed_seen[0]

    def plain_fed(self, *args):
        with mock.patch.object(las, "LasStepWorkspace", plain_workspace):
            fed_seen.append(orig_fed(self, *args))
        return kernel_fed

    with mock.patch.object(las.RNNDecoder, "fed_tokens", plain_fed):
        loss_ref, grads_ref = train_microstep(torch, model, batch,
                                              plain=True)
    valid = (kernel_fed != las.PAD) | (fed_seen[1] != las.PAD)
    parted = int((kernel_fed != fed_seen[1])[valid].sum())
    log(f"[7b]   pass 1, K2 against its plain version: {parted} of "
        f"{int(valid.sum())} fed tokens differ")
    expect(parted * FED_TIES <= int(valid.sum()),
           f"pass 1's fed tokens: {parted} differ")
    out["train_parity"] = hold_microstep(loss, grads, loss_ref, grads_ref,
                                         "7b")
    out["train_parity"]["fed_tokens_parted"] = parted
    del model, batch
    torch.cuda.empty_cache()
    return out


def train_microstep(torch, model, batch, plain=False):
    """(loss, {leaf: gradient}) of one train() microstep in float32 from a
    generator of seed SEED, through the kernels or, with ``plain``, the
    plain versions patched in (as ``eval_microstep``)."""
    from contextlib import ExitStack
    from neural_sp_tpu_torch.parallel.mesh import (compute_loss,
                                                   deterministic_cudnn)
    model.train()
    model.zero_grad(set_to_none=True)
    with ExitStack() as stack:
        if plain:
            for target, name, value in plain_patches(torch):
                stack.enter_context(mock.patch.object(target, name, value))
        stack.enter_context(deterministic_cudnn())
        loss, _ = compute_loss(model, None, *batch,
                               torch.Generator().manual_seed(SEED))
        loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def phase_sampling_times(torch, model, batch) -> dict:
    """At phase 5's shape (float32, train()), one microstep (forward and
    backward) with ss_prob SS_PROB and one at 0, in turns (S Z Z S S Z Z
    S), each read apart with a synchronise; then pass 1 alone (the
    ``fed_tokens`` call of a sampled microstep, its inputs recorded) under
    torch.profiler: its device busy time and the kernels it launches."""
    from torch.profiler import ProfilerActivity, profile
    from neural_sp_tpu_torch.models.decoders import las
    from neural_sp_tpu_torch.ops.kernels import las_step
    from neural_sp_tpu_torch.parallel.mesh import (compute_loss,
                                                   deterministic_cudnn)
    dec = model.dec_fwd
    model.train()
    gen = torch.Generator().manual_seed(SEED)

    def microstep(ss):
        dec.step.ss_prob = ss
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with deterministic_cudnn():        # as the train step runs
            loss, _ = compute_loss(model, None, *batch, gen)
            loss.backward()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    microstep(SS_PROB)
    microstep(0.0)                          # warm-up, both paths
    readings = {"ss": [], "teacher_forced": []}
    for ss in (SS_PROB, 0.0, 0.0, SS_PROB, SS_PROB, 0.0, 0.0, SS_PROB):
        readings["ss" if ss else "teacher_forced"].append(microstep(ss))
    seen = []
    orig = las.RNNDecoder.fed_tokens

    def record(self, *args):
        seen.append(args)
        return orig(self, *args)

    dec.step.ss_prob = SS_PROB
    with mock.patch.object(las.RNNDecoder, "fed_tokens", record):
        with torch.no_grad():
            compute_loss(model, None, *batch, gen)
    before = las_step.launches
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        dec.fed_tokens(*seen[0])
        torch.cuda.synchronize()
    k2_calls = las_step.launches - before
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, last = 0.0, float("-inf")
    for start, end in spans:
        if end > last:
            busy += end - max(start, last)
            last = end
    dec.step.ss_prob = 0.0
    model.zero_grad(set_to_none=True)
    out = {**readings, "pass1_device_ms": busy / 1e3,
           "pass1_kernel_launches": len(spans), "pass1_k2_calls": k2_calls}
    mean = {k: sum(v) / len(v) for k, v in readings.items()}
    log(f"[5s] microstep at B={TRAIN_B} x {TRAIN_FRAMES} frames, f32, in "
        f"turns: ss_prob {SS_PROB} {['%.1f' % x for x in readings['ss']]} "
        f"ms, ss_prob 0 {['%.1f' % x for x in readings['teacher_forced']]} "
        f"ms (means {mean['ss']:.1f} / {mean['teacher_forced']:.1f}); pass 1 "
        f"alone {busy / 1e3:.3f} ms of device time, {len(spans)} kernels, "
        f"{k2_calls} K2 steps")
    expect(k2_calls == batch[2].shape[1] + 1, f"pass 1: {k2_calls} K2 steps")
    return out


# Phase 8: the LibriSpeech recipe's BLSTM-LAS (``BLSTM_CONF``,
# ``configs.librispeech_blstm_las_args``) at full width: the conv front end
# (two 32-channel 3x3 blocks, each pooling (2, 2)), BLSTM-512 layers with
# the directions concatenated (D = 1024), the LSTM-1024 LAS with location
# attention, CTC 0.3; float32. The RNN layers run cuDNN. Its depth is cut
# from the conf's 5 BLSTM layers to RNN_DEPTH (phase 9's too), so that the
# whole script keeps within its time limit as phase 11 joins it. The
# overrides are that depth, the run's length and the word unit of phase 7
# (the same corpus).
RNN_DEPTH = 1
BLSTM_CONF = "examples/librispeech/conf/asr/blstm_las.yaml"
BLSTM_OVERRIDES = ("--n_epochs", "2", "--unit", "word", "--enc_n_layers",
                   str(RNN_DEPTH))
BLSTM_D = 1024
# the kernels the BLSTM-LAS trains through (K2 in scheduled sampling's
# pass 1), and those it must never launch: it has no self-attention
BLSTM_TRAIN_KERNELS = ("las_step", "las_scan", "las_scan_bwd", "ctc_loss",
                       "ctc_loss_bwd")
NOT_ON_RNN_PATH = ("rel_attention", "rel_attention_bwd",
                   "rel_attention_bf16", "rel_attention_bwd_bf16")
# cuDNN's LSTM against the layer's written-out loop through the whole
# encoder (5 layers, 2 directions, up to 400 steps; TF32 off): float32 sums
# in other orders, carried through every layer and step. Set between
# readings on an H100 (tools/rnn_times.py, phase 3's batch shape): 5.2e-8
# to 5.6e-8 in float32; 5.2e-5 to 6.1e-5 with cuDNN's TF32 on, the control
# that phase 8b reads again and that must exceed the limit. The outputs are
# LSTM states, bounded by 1 in magnitude.
RNN_ENCODER_ATOL = 2e-6
# the cuDNN RNN operators of a profiled microstep (forward and backward)
CUDNN_RNN_OPS = ("aten::_cudnn_rnn", "aten::_cudnn_rnn_backward")


def blstm_model(torch):
    from neural_sp_tpu_torch.configs import librispeech_blstm_las_args
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.utils.init_params import init_params
    args = librispeech_blstm_las_args()
    args.enc_n_layers = RNN_DEPTH
    model = build_speech2text(args)   # on the card
    init_params(model, SEED)
    return model.eval()


def phase_blstm_kernels(torch, rng) -> dict:
    """8a: K2, K3, K3b and K4 at the BLSTM-LAS's shapes (D = 1024, T up to
    500), each against its plain version at phase 2's and 2b's
    tolerances, with CUDA-event times and bounds: K2 at N = 10 (beam 10)
    and N = 32 with ``keep`` (scheduled sampling's pass 1) at T = 400; K3
    and K3b at B = 32, U+1 = 101, ragged T up to 500; K4 at B = 32, T =
    500, U = 100, V = 10,000."""
    res = {"las_step": {"max_abs_err": 0.0, "shapes": []}}
    for n, keep in ((10, False), (32, True)):
        shape = k2_case(torch, rng, n, 400, BLSTM_D, keep=keep, tag="8a")
        row = res["las_step"]
        row["max_abs_err"] = max(row["max_abs_err"], shape["max_abs_err"])
        row["shapes"].append(shape)
        if n == 10:
            row.update(library_ms=None, **{
                k: v for k, v in shape.items()
                if k not in ("shape", "keep", "max_abs_err")})
    record = kernel_recorder(res, "8a")
    las_scan_case(torch, rng, record, TRAIN_B, 101, 500, BLSTM_D,
                  [500 - 9 * i for i in range(TRAIN_B)], tag="8a")
    ctc_case(torch, rng, record, TRAIN_B, 500, TRAIN_U, 10000, tag="8a")
    torch.cuda.empty_cache()
    return res


def phase_blstm_serve(torch, model, xs, xlens) -> dict:
    """8b: phase 3's utterances through the BLSTM-LAS: beam 10 + CTC 0.3
    and greedy (counts zeroed before, read after: K2 must run, K1 / K1b
    must not), the encoder's time, one profiled beam request; the cuDNN
    encoder against the written-out loop (RNN_ENCODER_ATOL), and the best
    hypothesis replayed through K2 against the plain decode step."""
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
    from neural_sp_tpu_torch.models.modules.recurrent import RNNLayer
    out, counts = phase_serve(torch, model, xs, xlens,
                              ("beam10_ctc0.3", "greedy"), tag="8b")
    best = out.pop("best_hyp0")
    out["launches"] = counts
    expect(counts["las_step"] > 0, "K2 never launched serving the BLSTM")
    expect(all(counts[k] == 0 for k in NOT_ON_RNN_PATH),
           f"K1 / K1b launched on the BLSTM path: {counts}")
    beam = Speech2TextSession(model, DecodeConfig(**SERVED["beam10_ctc0.3"]))
    t0 = time.perf_counter()
    eouts = beam.encode(xs, xlens)
    torch.cuda.synchronize()
    out["encode_batch_s"] = time.perf_counter() - t0
    with mock.patch.object(RNNLayer, "forward", RNNLayer.forward_ref):
        t0 = time.perf_counter()
        eouts_ref = beam.encode(xs, xlens)
        torch.cuda.synchronize()
        out["encode_batch_loop_s"] = time.perf_counter() - t0
    e, el = eouts["ys"]["xs"], eouts["ys"]["xlens"]
    expect(bool(torch.isfinite(e).all()), "BLSTM encoder output not finite")
    expect(tuple(e.shape) == (len(UTT_FRAMES), max(UTT_FRAMES) // 4,
                              BLSTM_D), f"encoder output {tuple(e.shape)}")
    # the control: the same cuDNN encoder with TF32 on
    torch.backends.cudnn.allow_tf32 = True
    try:
        e_tf32 = beam.encode(xs, xlens)["ys"]["xs"]
    finally:
        torch.backends.cudnn.allow_tf32 = False
    out["encoder_max_abs_err"] = max_err(e, eouts_ref["ys"]["xs"])
    out["encoder_tf32_max_abs_err"] = max_err(e_tf32, eouts_ref["ys"]["xs"])
    log(f"[8b] encoder {tuple(e.shape)}, lens {el.tolist()}: "
        f"{out['encode_batch_s']:.4f} s (cuDNN), "
        f"{out['encode_batch_loop_s']:.4f} s (the written-out loop); cuDNN "
        f"vs the loop max_abs_err {out['encoder_max_abs_err']:.3e} "
        f"(limit {RNN_ENCODER_ATOL:.0e}), with TF32 on "
        f"{out['encoder_tf32_max_abs_err']:.3e}")
    expect(out["encoder_max_abs_err"] <= RNN_ENCODER_ATOL,
           f"cuDNN encoder vs its loop: {out['encoder_max_abs_err']}")
    expect(out["encoder_tf32_max_abs_err"] > RNN_ENCODER_ATOL,
           f"the TF32 control is within {RNN_ENCODER_ATOL}: the limit cannot "
           f"tell TF32 from float32")
    out["replay_max_abs_err"], out["k2_launches_per_decode_step"] = \
        replay_against_plain(torch, model.dec_fwd, e[:1], el[:1], best,
                             tag="8b")
    n = UTT_FRAMES[0]
    out["beam10_ctc0.3_one_utt"] = profiled(
        torch, f"BLSTM beam 10 + CTC 0.3, the {n}-frame utterance",
        lambda: beam.decode(xs[:1, :n], xlens[:1]), tag="8b")
    return out


def phase_blstm_cli(torch, root: Path, corpus: dict) -> dict:
    """8c and 8d: ``bin.asr.train.main`` on ``BLSTM_CONF`` (``BLSTM_
    OVERRIDES``, phase 7's corpus) and ``bin.asr.eval.main`` as the
    recipe's stage 5 (``CLI_EVAL``, the recipe's LM), counts zeroed around
    each: K2 (pass 1), K3, K3b and K4 must run in training, K2 in
    evaluation, K1 / K1b in neither. Every loss finite; the sampled share
    within 4 binomial standard deviations of ss_prob. A profiled train()
    microstep on the widest microbatch (the cuDNN RNN operators' share of
    its device time); then on the trained weights that microbatch in
    eval(), kernels against the plain versions (phase 6's rule), and one
    train() microstep twice from one seed: the same bits."""
    import csv
    import math
    import os
    from types import SimpleNamespace
    from neural_sp_tpu_torch.bin.asr import eval as cli_eval
    from neural_sp_tpu_torch.bin.asr import train as cli_train
    from neural_sp_tpu_torch.models.decoders import las
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    from neural_sp_tpu_torch.parallel.mesh import (TrainStep, compute_loss,
                                                   deterministic_cudnn)
    sync = torch.cuda.synchronize
    exp = str(root / "exp_blstm")
    data = ["--train_set", corpus["train"], "--dev_set", corpus["dev"],
            "--dict", corpus["dict"], "--model_save_dir", exp]
    out = {"conf": BLSTM_CONF, "overrides": list(BLSTM_OVERRIDES)}
    steps, saves, widest, sampled = [], [], [], []
    orig_call, orig_save = TrainStep.__call__, cli_train.save_checkpoint
    orig_fed = las.RNNDecoder.fed_tokens
    orig_build = cli_train.build_speech2text
    n_params = []

    def timed_call(self, xs, xlens, ys, ylens, *a, **kw):
        sync()
        t = time.perf_counter()
        m = orig_call(self, xs, xlens, ys, ylens, *a, **kw)
        sync()
        steps.append((time.perf_counter() - t, bool(m["emitted"]),
                      int(xlens.sum()), float(m["loss"])))
        if not widest or (xs.shape[1], xs.shape[0]) > (
                widest[0].shape[1], widest[0].shape[0]):
            widest[:] = (xs, xlens, ys, ylens)
        return m

    def timed_save(*a, **kw):
        t = time.perf_counter()
        path = orig_save(*a, **kw)
        saves.append((time.perf_counter() - t, os.path.getsize(path)))
        return path

    def watched_fed(self, ys_in, kc, values, klens, masks):
        fed = orig_fed(self, ys_in, kc, values, klens, masks)
        valid = ys_in != las.PAD
        sampled.append((int(valid.sum()), int(masks.sample[valid].sum())))
        return fed

    def counted_build(args, device=None):
        model = orig_build(args, device=device)
        n_params.append(sum(p.numel() for p in model.parameters()))
        return model

    torch.cuda.reset_peak_memory_stats()
    # PyTorch's default, as a user's process starts: the CLI must turn
    # cuDNN's TF32 off itself, the conf being float32
    torch.backends.cudnn.allow_tf32 = True
    sync()
    reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(TrainStep, "__call__", timed_call), \
            mock.patch.object(cli_train, "save_checkpoint", timed_save), \
            mock.patch.object(las.RNNDecoder, "fed_tokens", watched_fed), \
            mock.patch.object(cli_train, "build_speech2text", counted_build):
        cli_train.main(["--config", str(ROOT / BLSTM_CONF)] + data +
                       list(BLSTM_OVERRIDES))
    sync()
    wall = time.perf_counter() - t0
    expect(not torch.backends.cudnn.allow_tf32,
           "the train CLI left cuDNN's TF32 on for a float32 conf")
    counts = launches()
    losses = [s[3] for s in steps]
    train = {"wall_s": wall, "parameters": n_params[0],
             "microsteps": len(steps),
             "optimizer_steps": sum(s[1] for s in steps),
             "microstep_s": [s[0] for s in steps], "microstep_loss": losses,
             # Adam without accumulation: every microstep is an update
             "ms_per_optimizer_step": 1e3 * sum(s[0] for s in steps) /
             max(sum(s[1] for s in steps), 1),
             "frames_per_s": sum(s[2] for s in steps) /
             sum(s[0] for s in steps),
             "launches": counts,
             "peak_mem_bytes": torch.cuda.max_memory_allocated(),
             "checkpoint_bytes": saves[-1][1],
             "checkpoint_save_s": [x for x, _ in saves]}
    out["train"] = train
    log(f"[8c] train CLI on {BLSTM_CONF}: {n_params[0]} parameters, "
        f"{len(steps)} microsteps ({train['optimizer_steps']} updates), "
        f"{train['ms_per_optimizer_step']:.1f} ms per optimizer step, "
        f"{train['frames_per_s']:.0f} frames/s, wall {wall:.1f} s, peak mem "
        f"{train['peak_mem_bytes']} B, checkpoints {saves[-1][1]} B")
    log(f"[8c]   microstep losses {['%.3f' % x for x in losses]}; "
        f"microsteps {['%.3f' % s[0] for s in steps]} s")
    log(f"[8c]   launches: {counts}")
    for name in BLSTM_TRAIN_KERNELS:
        expect(counts[name] > 0, f"{name} never launched in phase 8c")
    expect(all(counts[k] == 0 for k in NOT_ON_RNN_PATH),
           f"K1 / K1b launched training the BLSTM: {counts}")
    expect(all(map(math.isfinite, losses)), f"8c losses {losses}")
    with open(f"{exp}/history.csv") as f:
        history = [(int(r["epoch"]), float(r["train_loss"]),
                    float(r["dev_loss_mean"])) for r in csv.DictReader(f)]
    out["history"] = history
    log(f"[8c] history.csv (epoch, train loss, dev loss): {history}")
    expect([e for e, _, _ in history] == [1, 2] and all(
        math.isfinite(x) for _, *ls in history for x in ls),
        f"8c history.csv {history}")
    n_valid = sum(x[0] for x in sampled)
    share = sum(x[1] for x in sampled) / n_valid
    sd = math.sqrt(SS_PROB * (1 - SS_PROB) / n_valid)
    out["sampling"] = {"valid": n_valid, "sampled_share": share,
                       "binomial_sd": sd}
    log(f"[8c]   sampled share {share:.4f} of {n_valid} valid positions "
        f"(ss_prob {SS_PROB}, 4 sd = {4 * sd:.4f})")
    expect(len(sampled) == len(steps), "a microstep ran without pass 1")
    expect(abs(share - SS_PROB) <= 4 * sd, f"sampled share {share}")

    # the eval CLI as the recipe's stage 5
    lm_dir = recipe_lm(root)
    torch.cuda.reset_peak_memory_stats()
    torch.backends.cudnn.allow_tf32 = True      # as for the train CLI
    sync()
    reset_launches()
    t = time.perf_counter()
    res = cli_eval.main(["--recog_model", exp, "--recog_sets",
                         corpus["test"], "--recog_lm", lm_dir,
                         "--recog_dir", str(root / "decode_blstm")] +
                        list(CLI_EVAL))
    sync()
    wall = time.perf_counter() - t
    expect(not torch.backends.cudnn.allow_tf32,
           "the eval CLI left cuDNN's TF32 on for a float32 model")
    counts = launches()
    (m,) = res.values()
    out["eval"] = {**m, "wall_s": wall, "launches": counts,
                   "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    log(f"[8c] eval CLI: RTF {m['rtf']:.4f}, wall {wall:.1f} s (with "
        f"loading), WER {m['wer']:.2f} over {m['n_utts']} utterances "
        f"(random weights); launches {counts}")
    expect(m["n_utts"] == CLI_UTTS["test"], f"{m['n_utts']} utterances")
    expect(counts["las_step"] > 0, "K2 never launched in the eval CLI")
    expect(all(counts[k] == 0 for k in NOT_ON_RNN_PATH),
           f"K1 / K1b launched evaluating the BLSTM: {counts}")

    # one profiled train() microstep on the widest microbatch, the trained
    # weights
    model, _, _ = cli_eval.load_model_for_eval(SimpleNamespace(
        recog_model=f"{exp}/ckpt.epoch-2", recog_n_average=1))
    batch = tuple(widest)
    widest.clear()
    model.dec_fwd.step.ss_prob = SS_PROB
    gen = torch.Generator().manual_seed(SEED)

    def microstep():
        model.train()
        model.zero_grad(set_to_none=True)
        with deterministic_cudnn():       # as the train step runs
            loss, _ = compute_loss(model, None, *batch, gen)
            loss.backward()

    microstep()                           # warm-up
    sync()
    prof = profiled(torch, f"BLSTM train() microstep, B "
                    f"{batch[0].shape[0]} x {batch[0].shape[1]} frames",
                    microstep, ops=CUDNN_RNN_OPS, tag="8c")
    if "device_busy_s" in prof:
        prof["cudnn_rnn_share"] = prof["ops_device_ms"] / 1e3 / \
            prof["device_busy_s"]
        log(f"[8c]   cuDNN RNN operators {prof['ops_device_ms']:.3f} ms of "
            f"device time, {prof['cudnn_rnn_share']:.4f} of the busy time")
    out["profiled_microstep"] = prof

    # 8d: the same microbatch held to the plain versions, and determinism
    model.dec_fwd.step.ss_prob = 0.0
    log(f"[8d] microbatch held to the plain versions: B "
        f"{batch[0].shape[0]} x {batch[0].shape[1]} frames, U "
        f"{batch[2].shape[1]}")
    out["train_parity"], _ = phase_train_parity(torch, model, batch,
                                                tag="8d")
    model.dec_fwd.step.ss_prob = SS_PROB
    out["determinism"] = phase_determinism(torch, model, batch, bf16=False,
                                           phase="8d")
    del model, batch
    torch.cuda.empty_cache()
    return out


def phase_blstm(torch, rng, root: Path, corpus: dict, xs, xlens) -> dict:
    """8: the BLSTM-LAS, its kernels at its shapes, served, trained and
    evaluated through the CLIs; each path's launches counted from zero."""
    t = time.perf_counter()
    out = {"kernels": phase_blstm_kernels(torch, rng)}
    model = blstm_model(torch)
    out["parameters"] = sum(p.numel() for p in model.parameters())
    log(f"[8b] BLSTM-LAS: {out['parameters']} parameters on the card")
    out["serve"] = phase_blstm_serve(torch, model, xs, xlens)
    del model
    torch.cuda.empty_cache()
    out["cli"] = phase_blstm_cli(torch, root, corpus)
    out["phase_wall_s"] = time.perf_counter() - t
    log(f"[8] phase 8 wall {out['phase_wall_s']:.1f} s")
    return out


# Phase 9: the LibriSpeech recipe's UniLSTM-MoChA (``MOCHA_CONF``,
# ``configs.librispeech_lstm_mocha_args``) at full width, its depth cut as
# phase 8's (``RNN_DEPTH``): the conv front end, unidirectional LSTM-1024
# layers (cuDNN; the conf has 5), the LSTM-1024
# LAS decoder with MoChA (chunk 4, additive energies, attn_dim 512, init_r
# -4, noise std 1.0, quantity loss 0.1), CTC 0.3 with fc 512; float32.
# MoChA has no kernel (the JAX package computes it in plain JAX): K2, K3
# and K3b fuse location attention and must not run, nor K1 / K1b; K4 runs
# in training. The overrides are the run's length and phase 7's word unit
# (the same corpus).
MOCHA_CONF = "examples/librispeech/conf/asr/mocha/lstm_mocha.yaml"
MOCHA_SYNC_CONF = "examples/librispeech/conf/asr/mocha/lstm_mocha_ctc_sync.yaml"
MOCHA_OVERRIDES = ("--n_epochs", "2", "--unit", "word", "--enc_n_layers",
                   str(RNN_DEPTH))
MOCHA_D = 1024
MOCHA_TRAIN_KERNELS = ("ctc_loss", "ctc_loss_bwd")
NOT_ON_MOCHA_PATH = NOT_ON_RNN_PATH + ("las_step", "las_scan",
                                      "las_scan_bwd")
# 9b: the labels of the four served utterances (T 175-400 after the x4
# front end)
MOCHA_U = (40, 60, 80, 100)
# a hard decision (a boundary energy against 0, a greedy argmax against the
# runner-up) that rounding may flip: the float64 run and the card's are
# compared up to the first decision of a row with less margin than this
DECISION_MARGIN = 1e-3
# 9b's greedy runs on the seeded weights plus seeded normal noise of this
# std: at the initial weights the decoder's logits are nearly flat (on the
# H100 every row's top-2 gap fell under DECISION_MARGIN from the second
# step on), so no decision there is one that rounding could not flip
GREEDY_NOISE = 0.05


def mocha_args(args=None):
    """``args`` (the LibriSpeech LSTM-MoChA's by default) with the encoder
    cut to RNN_DEPTH layers."""
    from neural_sp_tpu_torch.configs import librispeech_lstm_mocha_args
    args = args or librispeech_lstm_mocha_args()
    args.enc_n_layers = RNN_DEPTH
    return args


def mocha_model(torch, args=None):
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.utils.init_params import init_params
    model = build_speech2text(mocha_args(args))
    init_params(model, SEED)
    return model.eval()


def mocha_labels(torch, rng, vocab: int):
    """Labels [4, 100] (PAD past MOCHA_U) from ``rng``, ids in [4, vocab)."""
    import numpy as np
    from neural_sp_tpu_torch import PAD
    ys = np.full((len(MOCHA_U), max(MOCHA_U)), PAD, np.int64)
    for b, u in enumerate(MOCHA_U):
        ys[b, :u] = rng.integers(4, vocab, u)
    return torch.from_numpy(ys), torch.tensor(MOCHA_U)


def phase_mocha_serve(torch, model, xs, xlens) -> dict:
    """9a: phase 3's utterances through the LSTM-MoChA: beam 10 + CTC 0.3
    and greedy (counts zeroed before, read after: K1, K1b, K2, K3 and K3b
    must not run), the encoder's time, one profiled beam request (device
    time per decode step, idle share)."""
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
    from neural_sp_tpu_torch.models.decoders.las import DecodeLoop
    out, counts = phase_serve(torch, model, xs, xlens,
                              ("beam10_ctc0.3", "greedy"), tag="9a")
    out.pop("best_hyp0")
    out["launches"] = counts
    expect(all(counts[k] == 0 for k in NOT_ON_MOCHA_PATH),
           f"K1 / K1b / K2 / K3 / K3b launched serving MoChA: {counts}")
    beam = Speech2TextSession(model, DecodeConfig(**SERVED["beam10_ctc0.3"]))
    t0 = time.perf_counter()
    eouts = beam.encode(xs, xlens)
    torch.cuda.synchronize()
    out["encode_batch_s"] = time.perf_counter() - t0
    e = eouts["ys"]["xs"]
    expect(bool(torch.isfinite(e).all()), "MoChA encoder output not finite")
    expect(tuple(e.shape) == (len(UTT_FRAMES), max(UTT_FRAMES) // 4,
                              MOCHA_D), f"encoder output {tuple(e.shape)}")
    log(f"[9a] encoder {tuple(e.shape)}: {out['encode_batch_s']:.4f} s")
    n = UTT_FRAMES[0]
    steps = DecodeLoop.steps
    prof = profiled(torch, f"MoChA beam 10 + CTC 0.3, the {n}-frame "
                    f"utterance", lambda: beam.decode(xs[:1, :n], xlens[:1]),
                    tag="9a")
    prof["decode_steps"] = DecodeLoop.steps - steps
    if "device_busy_s" in prof:
        prof["device_ms_per_decode_step"] = \
            prof["device_busy_s"] * 1e3 / max(prof["decode_steps"], 1)
        log(f"[9a]   {prof['decode_steps']} decode steps, "
            f"{prof['device_ms_per_decode_step']:.4f} ms of device time each")
    out["beam10_ctc0.3_one_utt"] = prof
    return out


def mocha_microstep(torch, model, batch, seed=SEED):
    """One train() microstep from a generator of seed ``seed``: (loss,
    {leaf: gradient as float64 on the host}, scalar observations)."""
    from neural_sp_tpu_torch.parallel.mesh import (compute_loss,
                                                   deterministic_cudnn)
    model.train()
    model.zero_grad(set_to_none=True)
    with deterministic_cudnn():         # as the train step runs
        loss, obs = compute_loss(model, None, *batch,
                                 torch.Generator().manual_seed(seed))
        loss.backward()
    grads = {n: p.grad.detach().double().cpu()
             for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads, {
        k: float(v.detach()) for k, v in obs.items()
        if torch.is_tensor(v) and v.ndim == 0}


def mocha_greedy(torch, model, xs, xlens):
    """Greedy decoding of the batch, each decision's margin recorded:
    (tokens [B, L] on the host, margins [steps, B]: per row the least of
    the top-2 logit gap and every monotonic energy's distance from 0 that
    the boundary search read)."""
    from neural_sp_tpu_torch.models.decoders import las
    from neural_sp_tpu_torch.models.modules import mocha
    real_hard, real_step = mocha.hard_monotonic_attention, \
        las.MochaDecodeLoop.step
    energy, margins = [], []

    def hard(e, alpha_prev, eps_wait=-1):
        t = e.shape[-1]
        idx = torch.arange(t, device=e.device)
        start = torch.where(alpha_prev.sum(-1) > 0, alpha_prev.argmax(-1), 0)
        fire = (e >= 0) & (idx >= start[..., None])
        first = torch.where(fire, idx, t).amin(-1)
        read = (idx >= start[..., None]) & (idx <= first[..., None]) & \
            (e > -1e30)
        energy.append(torch.where(read, e.abs(), torch.full_like(e, 1e30))
                      .amin(-1).amin(-1))
        return real_hard(e, alpha_prev, eps_wait)

    def step(self, y, parent=None):
        logits, aw = real_step(self, y, parent)
        top2 = logits.float().topk(2, -1).values
        margins.append(torch.minimum(top2[:, 0] - top2[:, 1],
                                     energy.pop().to(top2.dtype)))
        return logits, aw

    with mock.patch.object(mocha, "hard_monotonic_attention", hard), \
            mock.patch.object(las.MochaDecodeLoop, "step", step), \
            torch.inference_mode():
        e = model.encode(xs, xlens)[0]["ys"]
        toks, _ = model.dec_fwd.greedy_scan(e["xs"], e["xlens"],
                                            e["xs"].shape[1])
    return toks.cpu(), torch.stack(margins).double().cpu()


def phase_mocha_hold(torch, model, xs, xlens) -> dict:
    """9b: one train() microstep of the card's model held to the same
    microstep on the CPU in float64 (same weights, inputs and generator
    seed; dropout and the energies' noise on): the loss to LOSS_RTOL, each
    gradient leaf to GRAD_RTOL of its own max and at least GRAD_FLOOR of
    the largest gradient (9b's rule, beside the constants), on phase 3's
    utterances and on a second draw of inputs, labels and generator seed.
    A control on each: the card's microstep again with cuBLAS's and
    cuDNN's TF32 on must break that rule. Then greedy decoding of the
    batch on both with the weights moved by GREEDY_NOISE (the card's model
    keeps them), the tokens identical up to each row's first decision with
    less than DECISION_MARGIN."""
    import numpy as np
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    xs_t = torch.from_numpy(xs)
    xl_t = torch.from_numpy(xlens)
    dev = next(model.parameters()).device
    cpu = build_speech2text(mocha_args(), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu.double()
    out = {}
    for case, seed in (("served", SEED), ("second_draw", SEED + 1)):
        # the served utterances and labels, then a second draw of both
        x, xl = (xs_t, xl_t) if case == "served" else \
            map(torch.from_numpy, utterances(np.random.default_rng(seed)))
        ys, ylens = mocha_labels(torch, np.random.default_rng(seed + 9),
                                 model.dec_fwd.vocab)
        on_card = tuple(v.to(dev) for v in (x, xl, ys, ylens))
        t0 = time.perf_counter()
        loss, grads, obs = mocha_microstep(torch, model, on_card, seed)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loss_ref, grads_ref, obs_ref = mocha_microstep(
            torch, cpu, (x.double(), xl, ys, ylens), seed)
        cpu_s = time.perf_counter() - t0
        log(f"[9b] {case} (seed {seed}): train() microstep B {len(MOCHA_U)} "
            f"x {x.shape[1]} frames, U {list(MOCHA_U)}: card {card_s:.2f} s, "
            f"CPU float64 {cpu_s:.2f} s; card {obs}; CPU {obs_ref}")
        expect(all(np.isfinite(v) for v in obs.values()), f"9b losses {obs}")
        held = hold_microstep(loss, grads, loss_ref, grads_ref, "9b",
                              floor=True)
        out[case] = {"seed": seed, "card_s": card_s, "cpu_float64_s": cpu_s,
                     "obs": obs, "obs_float64": obs_ref, "microstep": held}
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            loss_c, grads_c, _ = mocha_microstep(torch, model, on_card, seed)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        ctl = microstep_errors(loss_c, grads_c, loss_ref, grads_ref,
                               floor=True)
        leaves = ctl.pop("leaves")
        worst = max(leaves, key=lambda n: leaves[n][0])
        ctl.update(worst_grad=leaves[worst][0], worst_grad_leaf=worst,
                   at_the_float32_worst_leaf=leaves[held["worst_grad_leaf"]],
                   largest_err_of_g_max=max(v[2] for v in leaves.values()),
                   leaves_past_tolerance=sum(v[0] > 1 for v in
                                             leaves.values()))
        out[case]["tf32_control"] = ctl
        log(f"[9b] TF32 control: loss rel {ctl['loss_rel_err']:.2e}, worst "
            f"leaf {worst} {ctl['worst_grad']:.3f} of its tolerance, "
            f"{ctl['leaves_past_tolerance']} of {len(leaves)} leaves past "
            f"it; at {held['worst_grad_leaf']} "
            f"{ctl['at_the_float32_worst_leaf'][0]:.3f}")
        # the readings the floor is set from: phase 6's rule without it
        bare = {}
        for run, g in (("float32", grads), ("tf32", grads_c)):
            lv = microstep_errors(loss, g, loss_ref, grads_ref)["leaves"]
            name = max(lv, key=lambda n: lv[n][0])
            bare[run] = (name, lv[name][0])
        out[case]["without_floor"] = bare
        log(f"[9b] phase 6's rule without the floor, worst leaf and its "
            f"share: {bare}")
        expect(ctl["loss_rel_err"] > LOSS_RTOL or ctl["worst_grad"] > 1.0,
               "9b's rule passed a card microstep with TF32 on")
    # greedy on both, each decision's margin from the card's run, on the
    # weights moved by GREEDY_NOISE
    g = torch.Generator().manual_seed(SEED + 11)
    moved = {k: v.cpu() + GREEDY_NOISE * torch.randn(v.shape, generator=g)
             for k, v in model.state_dict().items()}
    model.load_state_dict(moved)
    cpu.load_state_dict(moved)
    model.eval()
    cpu.eval()
    toks, margins = mocha_greedy(torch, model, xs_t.to(dev), xl_t.to(dev))
    toks_ref, _ = mocha_greedy(torch, cpu, xs_t.double(), xl_t)
    compared, cut = [], []
    for b in range(toks.shape[0]):
        low = (margins[:, b] < DECISION_MARGIN).nonzero()
        n = int(low[0]) if len(low) else toks.shape[1]
        n = min(n, toks.shape[1], toks_ref.shape[1])
        compared.append(n)
        cut.append(bool(len(low)))
        expect(torch.equal(toks[b, :n], toks_ref[b, :n]),
               f"9b greedy row {b}: the card's tokens part from the float64 "
               f"run's within {n} decisions of margin")
    out["greedy"] = {"decisions_compared": compared, "cut_by_margin": cut,
                     "least_margin": float(margins.min()),
                     "steps": int(margins.shape[0])}
    log(f"[9b] greedy: tokens identical over {compared} decisions per row "
        f"(cut at a decision under {DECISION_MARGIN}: {cut}; least margin "
        f"{float(margins.min()):.3e} over {margins.shape[0]} steps)")
    del cpu
    return out


def phase_mocha_cli(torch, root: Path, corpus: dict) -> dict:
    """9c and 9d: ``bin.asr.train.main`` on ``MOCHA_CONF`` (``MOCHA_
    OVERRIDES``, phase 7's corpus) and ``bin.asr.eval.main`` as the recipe's
    stage 5 (``CLI_EVAL``, the recipe's LM), each started with cuDNN's TF32
    on and bound to turn it off, counts zeroed around each: K4 must run in
    training, K1, K1b, K2, K3 and K3b in neither. Every loss (the quantity
    loss too) finite. A profiled train() microstep on the widest microbatch
    (the cuDNN RNN operators' share), and the MoChA decoder's forward and
    backward alone under the profiler (its device time and operations);
    then that microbatch on the trained weights, K4 against its plain
    version (phase 6's rule), and one train() microstep twice from one
    seed, the noise on: the same bits."""
    import csv
    import math
    import os
    from types import SimpleNamespace
    from neural_sp_tpu_torch.bin.asr import eval as cli_eval
    from neural_sp_tpu_torch.bin.asr import train as cli_train
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    from neural_sp_tpu_torch.parallel.mesh import (TrainStep,
                                                   deterministic_cudnn)
    sync = torch.cuda.synchronize
    exp = str(root / "exp_mocha")
    data = ["--train_set", corpus["train"], "--dev_set", corpus["dev"],
            "--dict", corpus["dict"], "--model_save_dir", exp]
    out = {"conf": MOCHA_CONF, "overrides": list(MOCHA_OVERRIDES)}
    steps, widest, n_params = [], [], []
    orig_call, orig_build = TrainStep.__call__, cli_train.build_speech2text

    def timed_call(self, xs, xlens, ys, ylens, *a, **kw):
        sync()
        t = time.perf_counter()
        m = orig_call(self, xs, xlens, ys, ylens, *a, **kw)
        sync()
        steps.append((time.perf_counter() - t, bool(m["emitted"]),
                      int(xlens.sum()), float(m["loss"]),
                      float(m["loss_quantity"])))
        if not widest or (xs.shape[1], xs.shape[0]) > (
                widest[0].shape[1], widest[0].shape[0]):
            widest[:] = (xs, xlens, ys, ylens)
        return m

    def counted_build(args, device=None):
        model = orig_build(args, device=device)
        n_params.append(sum(p.numel() for p in model.parameters()))
        return model

    torch.cuda.reset_peak_memory_stats()
    torch.backends.cudnn.allow_tf32 = True     # PyTorch's default
    sync()
    reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(TrainStep, "__call__", timed_call), \
            mock.patch.object(cli_train, "build_speech2text", counted_build):
        cli_train.main(["--config", str(ROOT / MOCHA_CONF)] + data +
                       list(MOCHA_OVERRIDES))
    sync()
    wall = time.perf_counter() - t0
    expect(not torch.backends.cudnn.allow_tf32,
           "the train CLI left cuDNN's TF32 on for a float32 conf")
    counts = launches()
    losses = [s[3] for s in steps] + [s[4] for s in steps]
    train = {"wall_s": wall, "parameters": n_params[0],
             "microsteps": len(steps),
             "optimizer_steps": sum(s[1] for s in steps),
             "microstep_s": [s[0] for s in steps],
             "microstep_loss": [s[3] for s in steps],
             "microstep_loss_quantity": [s[4] for s in steps],
             "ms_per_optimizer_step": 1e3 * sum(s[0] for s in steps) /
             max(sum(s[1] for s in steps), 1),
             "frames_per_s": sum(s[2] for s in steps) /
             sum(s[0] for s in steps),
             "launches": counts,
             "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    out["train"] = train
    log(f"[9c] train CLI on {MOCHA_CONF}: {n_params[0]} parameters, "
        f"{len(steps)} microsteps ({train['optimizer_steps']} updates), "
        f"{train['ms_per_optimizer_step']:.1f} ms per optimizer step, "
        f"{train['frames_per_s']:.0f} frames/s, wall {wall:.1f} s, peak mem "
        f"{train['peak_mem_bytes']} B")
    log(f"[9c]   microstep losses {['%.3f' % s[3] for s in steps]}, "
        f"quantity {['%.3f' % s[4] for s in steps]}; microsteps "
        f"{['%.3f' % s[0] for s in steps]} s")
    log(f"[9c]   launches: {counts}")
    for name in MOCHA_TRAIN_KERNELS:
        expect(counts[name] > 0, f"{name} never launched in phase 9c")
    expect(all(counts[k] == 0 for k in NOT_ON_MOCHA_PATH),
           f"K1 / K1b / K2 / K3 / K3b launched training MoChA: {counts}")
    expect(all(map(math.isfinite, losses)), f"9c losses {losses}")
    with open(f"{exp}/history.csv") as f:
        history = [(int(r["epoch"]), float(r["train_loss"]),
                    float(r["train_loss_quantity"]),
                    float(r["dev_loss_mean"])) for r in csv.DictReader(f)]
    out["history"] = history
    log(f"[9c] history.csv (epoch, train loss, train quantity loss, dev "
        f"loss): {history}")
    expect([e for e, *_ in history] == [1, 2] and all(
        math.isfinite(x) for _, *ls in history for x in ls),
        f"9c history.csv {history}")

    # the eval CLI as the recipe's stage 5
    lm_dir = recipe_lm(root)
    torch.cuda.reset_peak_memory_stats()
    torch.backends.cudnn.allow_tf32 = True      # as for the train CLI
    sync()
    reset_launches()
    t = time.perf_counter()
    res = cli_eval.main(["--recog_model", exp, "--recog_sets",
                         corpus["test"], "--recog_lm", lm_dir,
                         "--recog_dir", str(root / "decode_mocha")] +
                        list(CLI_EVAL))
    sync()
    wall = time.perf_counter() - t
    expect(not torch.backends.cudnn.allow_tf32,
           "the eval CLI left cuDNN's TF32 on for a float32 model")
    counts = launches()
    (m,) = res.values()
    out["eval"] = {**m, "wall_s": wall, "launches": counts,
                   "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    log(f"[9c] eval CLI: RTF {m['rtf']:.4f}, wall {wall:.1f} s (with "
        f"loading), WER {m['wer']:.2f} over {m['n_utts']} utterances "
        f"(random weights); launches {counts}")
    expect(m["n_utts"] == CLI_UTTS["test"], f"{m['n_utts']} utterances")
    expect(all(counts[k] == 0 for k in NOT_ON_MOCHA_PATH),
           f"K1 / K1b / K2 / K3 / K3b launched evaluating MoChA: {counts}")

    # a profiled train() microstep on the widest microbatch, the trained
    # weights; then the MoChA decoder alone
    model, _, _ = cli_eval.load_model_for_eval(SimpleNamespace(
        recog_model=f"{exp}/ckpt.epoch-2", recog_n_average=1))
    batch = tuple(widest)
    widest.clear()

    def microstep():
        model.train()
        model.zero_grad(set_to_none=True)
        with deterministic_cudnn():       # as the train step runs
            loss, _ = model(*batch, torch.Generator().manual_seed(SEED))
            loss.backward()

    microstep()                           # warm-up
    sync()
    prof = profiled(torch, f"MoChA train() microstep, B "
                    f"{batch[0].shape[0]} x {batch[0].shape[1]} frames, U "
                    f"{batch[2].shape[1]}", microstep, ops=CUDNN_RNN_OPS,
                    tag="9c")
    with torch.no_grad():
        model.eval()
        enc = model.encoder(batch[0], batch[1])["ys"]

    def decoder():
        model.train()
        model.zero_grad(set_to_none=True)
        ex = enc["xs"].detach().requires_grad_()
        loss, _ = model.dec_fwd(ex, enc["xlens"], batch[2], batch[3],
                                torch.Generator().manual_seed(SEED))
        loss.backward()

    decoder()
    sync()
    prof_dec = profiled(torch, "the MoChA decoder's forward and backward "
                        "(its loop, readout and losses)", decoder, tag="9c")
    if "device_busy_s" in prof:
        prof["cudnn_rnn_share"] = prof["ops_device_ms"] / 1e3 / \
            prof["device_busy_s"]
        log(f"[9c]   cuDNN RNN operators {prof['ops_device_ms']:.3f} ms of "
            f"device time, {prof['cudnn_rnn_share']:.4f} of the busy time")
        if "device_busy_s" in prof_dec:
            prof["mocha_decoder_share"] = prof_dec["device_busy_s"] / \
                prof["device_busy_s"]
            log(f"[9c]   the MoChA decoder alone: "
                f"{prof_dec['device_busy_s'] * 1e3:.3f} ms of device time in "
                f"{prof_dec['device_events']} device operations, "
                f"{prof['mocha_decoder_share']:.4f} of the microstep's busy "
                f"time")
    out["profiled_microstep"] = prof
    out["profiled_decoder"] = prof_dec

    # 9d: the same microbatch held to the plain versions, and determinism
    log(f"[9d] microbatch held to the plain versions: B "
        f"{batch[0].shape[0]} x {batch[0].shape[1]} frames, U "
        f"{batch[2].shape[1]}")
    out["train_parity"], _ = phase_train_parity(torch, model, batch,
                                                tag="9d")
    out["determinism"] = phase_determinism(torch, model, batch, bf16=False,
                                           phase="9d")
    del model, batch
    torch.cuda.empty_cache()
    return out


def phase_mocha_sync(torch, xs, xlens) -> dict:
    """9e: one train() microstep of the ``ctc_sync`` conf's model at full
    width: the trigger points it computed on the card identical to the
    forced alignment on the CPU of the same log-probabilities (best paths
    too), and ``loss_latency`` finite."""
    import math
    import numpy as np
    from neural_sp_tpu_torch.bin.args import parse_args_train
    from neural_sp_tpu_torch.models.decoders import ctc as ctc_head
    from neural_sp_tpu_torch.ops.ctc import ctc_forced_align
    args = parse_args_train(["--config", str(ROOT / MOCHA_SYNC_CONF)])
    args.vocab = CLI_VOCAB
    model = mocha_model(torch, args)
    ys, ylens = mocha_labels(torch, np.random.default_rng(SEED + 10),
                             CLI_VOCAB)
    dev = next(model.parameters()).device
    seen = []

    def spy(*a, **kw):
        seen.append((a, ctc_forced_align(*a, **kw)))
        return seen[-1][1]

    t0 = time.perf_counter()
    with mock.patch.object(ctc_head, "ctc_forced_align", spy):
        _, _, obs = mocha_microstep(torch, model, (
            torch.from_numpy(xs).to(dev), torch.from_numpy(xlens).to(dev),
            ys.to(dev), ylens.to(dev)))
    wall = time.perf_counter() - t0
    expect(len(seen) == 1, f"{len(seen)} forced alignments in a microstep")
    (lp, labels, lens, label_lens), (trig, paths) = seen[0]
    trig_ref, paths_ref = ctc_forced_align(lp.cpu(), labels.cpu(),
                                           lens.cpu(), label_lens.cpu())
    out = {"wall_s": wall, "obs": obs,
           "trigger_points_equal": bool(torch.equal(trig.cpu(), trig_ref)),
           "best_paths_equal": bool(torch.equal(paths.cpu(), paths_ref))}
    log(f"[9e] ctc_sync microstep {wall:.2f} s: {obs}; trigger points "
        f"{'==' if out['trigger_points_equal'] else '!='} the CPU's, best "
        f"paths {'==' if out['best_paths_equal'] else '!='}")
    expect(out["trigger_points_equal"] and out["best_paths_equal"],
           "9e forced alignment on the card differs from the CPU's")
    expect("loss_latency" in obs and math.isfinite(obs["loss_latency"]),
           f"9e loss_latency {obs}")
    del model
    torch.cuda.empty_cache()
    return out


def phase_mocha(torch, root: Path, corpus: dict, xs, xlens) -> dict:
    """9: the LSTM-MoChA served, held to float64 on the CPU, trained and
    evaluated through the CLIs, and its ctc_sync variant; each path's
    launches counted from zero."""
    t = time.perf_counter()
    model = mocha_model(torch)
    out = {"parameters": sum(p.numel() for p in model.parameters())}
    log(f"[9a] LSTM-MoChA: {out['parameters']} parameters on the card")
    out["serve"] = phase_mocha_serve(torch, model, xs, xlens)
    out["hold"] = phase_mocha_hold(torch, model, xs, xlens)
    del model
    torch.cuda.empty_cache()
    out["cli"] = phase_mocha_cli(torch, root, corpus)
    out["ctc_sync"] = phase_mocha_sync(torch, xs, xlens)
    out["phase_wall_s"] = time.perf_counter() - t
    log(f"[9] phase 9 wall {out['phase_wall_s']:.1f} s")
    return out


# Phase 10: the LibriSpeech recipe's Transformer (``XF_CONF``,
# ``configs.librispeech_transformer_args``: the conv front end x4, 12
# transformer encoder blocks and 6 decoder blocks of d 256 / 4 heads /
# d_ff 2048, CTC 0.3 with fc 512; 35,838,144 parameters) and its offline
# MMA variant (``XF_MMA_CONF``, ``librispeech_transformer_mma_args``: conv
# x8, MMA from decoder layer 4, 4 x 4 heads, chunk 16), float32, at full
# width and depth. No kernel of the repo is theirs (the JAX package
# computes the transformer and MMA in plain JAX): K4 runs in training, K1,
# K1b, K2, K3 and K3b nowhere. The CLI overrides are the run's length and
# phase 7's word unit (the same corpus, 2 microsteps an epoch): the
# Transformer keeps the conf's accumulation (8), so 4 epochs make one
# update; the MMA conf (2-3 s a microstep) accumulates 2 over one epoch.
# Each run must make at least one optimizer update.
XF_CONF = "examples/librispeech/conf/asr/transformer/transformer.yaml"
XF_MMA_CONF = "examples/librispeech/conf/asr/mma/offline/" \
    "transformer_mma_subsample8_ma4H_ca4H_w16_from4L.yaml"
# Depth cuts (the script's time limit): phase 10 runs the transformer
# encoders at 4 of their 12 layers, the transformer decoder at 2 of its 6
# and the MMA decoder at 4 of 6 (MMA from the 4th: one MMA layer of the
# conf's three); phase 11 the uni-Conformer at 8 (which keeps its two
# interlayer max_pools, so its frame rate stays the conf's) and the
# streaming conf's encoder at 4; the served models, the CPU copies their
# holds compare with and the CLIs alike. 11e's LC-Transformer-MMA keeps
# its depth: cut to 4 + 4 its hold read 1.027 of 9b's rule.
XF_DEPTH = {
    "librispeech_transformer_args": dict(enc_n_layers=4, dec_n_layers=2),
    "librispeech_transformer_mma_args": dict(enc_n_layers=4,
                                             dec_n_layers=4),
    "librispeech_uni_conformer_mocha_args": dict(enc_n_layers=8),
    "uni_conformer_mocha_streaming_args": dict(enc_n_layers=4)}


def depth_flags(make: str) -> tuple:
    """XF_DEPTH's cut of ``configs.<make>`` as CLI flags."""
    return tuple(x for k, v in XF_DEPTH.get(make, {}).items()
                 for x in (f"--{k}", str(v)))


XF_OVERRIDES = ("--n_epochs", "4", "--unit", "word") + \
    depth_flags("librispeech_transformer_args")
XF_MMA_OVERRIDES = ("--n_epochs", "1", "--accum_grad_n_steps", "2",
                    "--unit", "word") + \
    depth_flags("librispeech_transformer_mma_args")
XF_D = 256
XF_SERVED = {"beam10_ctc0.3": dict(beam_width=10, ctc_weight=0.3),
             "beam1": dict(beam_width=1)}
# 10a: the decode loop's incremental logits against the teacher-forced
# forward's on the same tokens, max |err| / max |logit|: float32 sums in
# other orders (one query against the cache, a causal [U, U] product)
XF_STEP_RTOL = 1e-4
# 10b / 10d: each ReLU FFN's pre-activations on the card against the CPU's
# float64 ones, max |err| / the layer's max |pre-activation|; a ReLU mask
# may flip only where a pre-activation lies within that error of 0
XF_PRE_RTOL = 1e-4
# the K4 kernels' names in a profile (csrc/ctc_loss.cu)
K4_KERNEL_NAMES = ("ctc_alpha", "ctc_beta")


def xf_args(make: str):
    """``configs.<make>()`` cut to its XF_DEPTH."""
    from neural_sp_tpu_torch import configs
    args = getattr(configs, make)()
    for name, value in XF_DEPTH.get(make, {}).items():
        setattr(args, name, value)
    return args


def xf_model(torch, make: str):
    """The seeded model of ``xf_args(make)`` on the card, eval()."""
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.utils.init_params import init_params
    model = build_speech2text(xf_args(make))
    init_params(model, SEED)
    return model.eval()


def phase_xf_serve(torch, model, xs, xlens, names, tag) -> dict:
    """10a / 10d: phase 3's utterances through the sessions ``names`` of
    ``XF_SERVED`` (counts zeroed around them: no kernel of the repo runs),
    the encoder's time, one profiled beam 10 + CTC request (device time
    per decode step, idle share), and the decode loop's incremental logits
    against the teacher-forced forward on the first utterance's best
    hypothesis and on 100 seeded tokens (``XF_STEP_RTOL``)."""
    import numpy as np
    from neural_sp_tpu_torch import EOS
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
    from neural_sp_tpu_torch.models.decoders.las import DecodeLoop
    out, counts = phase_serve(torch, model, xs, xlens, names, tag=tag,
                              table=XF_SERVED)
    hyp = out.pop("best_hyp0")
    out["launches"] = counts
    expect(not any(counts.values()),
           f"a kernel of the repo launched serving the transformer: {counts}")
    beam = Speech2TextSession(model, DecodeConfig(**XF_SERVED[
        "beam10_ctc0.3"]))
    t0 = time.perf_counter()
    eouts = beam.encode(xs, xlens)
    torch.cuda.synchronize()
    out["encode_batch_s"] = time.perf_counter() - t0
    e, el = eouts["ys"]["xs"], eouts["ys"]["xlens"]
    factor = max(UTT_FRAMES) // e.shape[1]
    expect(bool(torch.isfinite(e).all()), "encoder output not finite")
    expect(tuple(e.shape) == (len(UTT_FRAMES), max(UTT_FRAMES) // factor,
                              XF_D), f"encoder output {tuple(e.shape)}")
    log(f"[{tag}] encoder {tuple(e.shape)} (x{factor}): "
        f"{out['encode_batch_s']:.4f} s")
    n = UTT_FRAMES[0]
    steps = DecodeLoop.steps
    prof = profiled(torch, f"beam 10 + CTC 0.3, the {n}-frame utterance",
                    lambda: beam.decode(xs[:1, :n], xlens[:1]), tag=tag,
                    cpu=False)
    prof["decode_steps"] = DecodeLoop.steps - steps
    if "device_busy_s" in prof:
        prof["device_ms_per_decode_step"] = \
            prof["device_busy_s"] * 1e3 / max(prof["decode_steps"], 1)
        log(f"[{tag}]   {prof['decode_steps']} decode steps, "
            f"{prof['device_ms_per_decode_step']:.4f} ms of device time each")
    out["beam10_ctc0.3_one_utt"] = prof
    # the caches: each step's logits against the teacher-forced pass
    dec = model.dec_fwd
    rng = np.random.default_rng(SEED + 12)
    gaps = {}
    with torch.inference_mode():
        for what, toks in (("best_hypothesis", [EOS] + hyp),
                           ("seeded_100", [EOS] + list(
                               rng.integers(4, dec.vocab, 99)))):
            ys_in = torch.tensor([toks], device=e.device)
            loop = dec.decode_loop(e[:1], el[:1])
            inc = torch.stack([loop.step(ys_in[:, i])[0]
                               for i in range(ys_in.shape[1])], 1)
            h, _ = dec._hidden(e[:1], el[:1], ys_in, None, "hard")
            tf = dec.output(dec.norm_out(h))
            gaps[what] = {"steps": len(toks), "rel_gap": float(
                (inc - tf).abs().max() / tf.abs().max())}
    out["incremental_vs_teacher_forced"] = gaps
    log(f"[{tag}] decode steps against the teacher-forced logits (max |err| "
        f"/ max |logit|): {gaps}")
    expect(all(g["rel_gap"] <= XF_STEP_RTOL for g in gaps.values()),
           f"{tag}: incremental logits part from the teacher-forced ones")
    return out


def dropout_off(torch, model) -> list:
    """Every dropout rate of ``model`` to 0; returns what to restore."""
    from neural_sp_tpu_torch.ops.dropout import Dropout
    saved = [(m, m.rate) for m in model.modules() if isinstance(m, Dropout)]
    for m, _ in saved:
        m.rate = 0.0
    return saved


def xf_beam1(torch, model, xs, xlens):
    """Beam 1 (the transformer's beam, JAX's dispatch) of each utterance,
    each decision's margin recorded: (hypotheses, per utterance the
    margins [steps]: the top-2 logit gap, and where the top token is eos
    also its distance from the eos threshold)."""
    import numpy as np
    from neural_sp_tpu_torch import EOS
    from neural_sp_tpu_torch.models.decoders import transformer as tdec
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
    sess = Speech2TextSession(model, DecodeConfig(beam_width=1))
    real_step = tdec.TransformerDecodeLoop.step
    margins = []

    def step(self, y, parent=None):
        logits, aw = real_step(self, y, parent)
        lp = torch.log_softmax(logits.double(), -1)[0]
        top2 = lp.topk(2).values
        m = float(top2[0] - top2[1])
        if int(lp.argmax()) == EOS:
            best = float(torch.cat([lp[:EOS], lp[EOS + 1:]]).max())
            m = min(m, abs(float(lp[EOS]) - sess.conf.eos_threshold * best))
        margins[-1].append(m)
        return logits, aw

    hyps = []
    with mock.patch.object(tdec.TransformerDecodeLoop, "step", step), \
            torch.inference_mode():
        e = model.encode(xs, xlens)[0]["ys"]
        for b in range(xs.shape[0]):
            margins.append([])
            hyps.append(sess._beam_one(
                e["xs"][b:b + 1], e["xlens"][b:b + 1])[0])
    return hyps, [np.asarray(m) for m in margins]


def relu_ffns(torch, model) -> dict:
    """{name: FFN} of ``model``'s feed-forward blocks with ReLU (the
    transformer blocks' ``transformer_ffn_activation``)."""
    from neural_sp_tpu_torch.models.modules.feed_forward import FFN
    return {n: m for n, m in model.named_modules()
            if isinstance(m, FFN) and m.act is torch.nn.functional.relu}


def keep_pre_activations(ffns: dict, kept: dict) -> list:
    """Forward hooks that keep each FFN's pre-activation (its ``w1``'s
    output, detached) of the calls that follow; returns the handles."""
    return [m.w1.register_forward_hook(
        lambda mod, inp, o, n=n: kept.__setitem__(n, o.detach()))
        for n, m in ffns.items()]


def hold_relu_pinned(torch, cpu, card_pre: dict, ref_pre: dict, batch,
                     loss, grads, tag) -> dict:
    """The hold's worst leaves sit behind ReLU: a mask flips where a
    pre-activation lies within float32's error of 0, and the gradient
    through it jumps. Per ReLU FFN the card's pre-activations against the
    float64 CPU's (``XF_PRE_RTOL`` of the layer's max) and the positions
    whose sign differs; then the CPU microstep again with each ReLU's mask
    pinned to the card's (the same as its own at every other position),
    and the card's microstep held to that by 9b's rule."""
    ffns = relu_ffns(torch, cpu)
    pins, flips, errs = {}, {}, {}
    for n in ffns:
        c, r = card_pre[n].double().cpu(), ref_pre[n]
        pins[n] = (c > 0).double()
        flips[n] = int(((c > 0) != (r > 0)).sum())
        errs[n] = float((c - r).abs().max() / r.abs().max())
    worst_layer = max(errs, key=errs.get)
    n_pos = sum(p.numel() for p in pins.values())
    log(f"[{tag}] ReLU masks: {sum(flips.values())} of {n_pos} "
        f"pre-activations flip sign between the card and float64, in "
        f"{sum(f > 0 for f in flips.values())} of {len(ffns)} FFNs "
        f"({ {n: f for n, f in flips.items() if f} }); the largest "
        f"pre-activation error {errs[worst_layer]:.2e} of its layer's max "
        f"({worst_layer})")
    expect(errs[worst_layer] <= XF_PRE_RTOL,
           f"{tag}: {worst_layer}'s pre-activations part from float64 by "
           f"{errs[worst_layer]:.2e} of their max")
    saved = {n: m.act for n, m in ffns.items()}
    for n, m in ffns.items():
        m.act = lambda x, keep=pins[n]: x * keep
    try:
        loss_p, grads_p, _ = mocha_microstep(torch, cpu, batch)
    finally:
        for n, m in ffns.items():
            m.act = saved[n]
    e = microstep_errors(loss, grads, loss_p, grads_p, floor=True)
    leaves = e["leaves"]
    ranked = sorted(leaves, key=lambda k: -leaves[k][0])
    log(f"[{tag}] held to float64 with the card's ReLU masks: loss rel "
        f"{e['loss_rel_err']:.2e}; worst leaves " + ", ".join(
            f"{k} {leaves[k][0]:.3f}" for k in ranked[:3]) +
        " of their tolerance")
    expect(e["loss_rel_err"] <= LOSS_RTOL and leaves[ranked[0]][0] <= 1.0,
           f"{tag}: the microstep held to float64 with the card's ReLU "
           f"masks breaks 9b's rule")
    return {"flips": flips, "pre_activations": n_pos,
            "pre_rel_err": errs, "pinned_loss_rel_err": e["loss_rel_err"],
            "pinned_worst_grad": leaves[ranked[0]][0],
            "pinned_worst_grad_leaf": ranked[0],
            "pinned_worst_leaves": {k: leaves[k] for k in ranked[:6]}}


def phase_xf_hold(torch, model, xs, xlens, make: str, tag: str,
                  beam1: bool) -> dict:
    """10b / 10d: one train() microstep at B = 4 (phase 3's utterances, U
    40-100, SpecAugment as the conf's; dropout off, MMA's noise off) on the
    card held to the same microstep on the CPU in float64 by phase 9b's
    rule, a TF32 control outside it, and the cause of its worst leaves
    shown (``hold_relu_pinned``); with ``beam1``, beam 1 on both with
    the weights moved by GREEDY_NOISE (the two shorter utterances), the
    tokens identical up to each utterance's first decision under
    DECISION_MARGIN; then (dropout on)
    one train() microstep twice: the same bits."""
    import numpy as np
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    dev = next(model.parameters()).device
    cpu = build_speech2text(xf_args(make), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu.double()
    saved = dropout_off(torch, model) + dropout_off(torch, cpu)
    mochas = [b.src_mma.mocha for m in (model, cpu) for b in
              m.dec_fwd.blocks if b.mma]
    for attn in mochas:
        attn.noise_std = 0.0
    xs_t, xl_t = torch.from_numpy(xs), torch.from_numpy(xlens)
    ys, ylens = mocha_labels(torch, np.random.default_rng(SEED + 9),
                             model.dec_fwd.vocab)
    on_card = tuple(v.to(dev) for v in (xs_t, xl_t, ys, ylens))
    on_cpu = (xs_t.double(), xl_t, ys, ylens)
    card_pre, ref_pre = {}, {}
    hooks = keep_pre_activations(relu_ffns(torch, model), card_pre)
    t0 = time.perf_counter()
    loss, grads, obs = mocha_microstep(torch, model, on_card)
    card_s = time.perf_counter() - t0
    hooks += keep_pre_activations(relu_ffns(torch, cpu), ref_pre)
    t0 = time.perf_counter()
    loss_ref, grads_ref, obs_ref = mocha_microstep(torch, cpu, on_cpu)
    cpu_s = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    log(f"[{tag}] train() microstep B {len(MOCHA_U)} x {xs.shape[1]} frames, "
        f"U {list(MOCHA_U)}, dropout off: card {card_s:.2f} s, CPU float64 "
        f"{cpu_s:.2f} s; card {obs}; CPU {obs_ref}")
    expect(all(np.isfinite(v) for v in obs.values()), f"{tag} losses {obs}")
    held = hold_microstep(loss, grads, loss_ref, grads_ref, tag, floor=True)
    out = {"card_s": card_s, "cpu_float64_s": cpu_s, "obs": obs,
           "obs_float64": obs_ref, "microstep": held}
    out["relu_pinned"] = hold_relu_pinned(torch, cpu, card_pre, ref_pre,
                                          on_cpu, loss, grads, tag)
    del card_pre, ref_pre
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        loss_c, grads_c, _ = mocha_microstep(torch, model, on_card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ctl = microstep_errors(loss_c, grads_c, loss_ref, grads_ref, floor=True)
    leaves = ctl.pop("leaves")
    worst = max(leaves, key=lambda n: leaves[n][0])
    ctl.update(worst_grad=leaves[worst][0], worst_grad_leaf=worst,
               leaves_past_tolerance=sum(v[0] > 1 for v in leaves.values()))
    out["tf32_control"] = ctl
    log(f"[{tag}] TF32 control: loss rel {ctl['loss_rel_err']:.2e}, worst "
        f"leaf {worst} {ctl['worst_grad']:.3f} of its tolerance, "
        f"{ctl['leaves_past_tolerance']} of {len(leaves)} leaves past it")
    expect(ctl["loss_rel_err"] > LOSS_RTOL or ctl["worst_grad"] > 1.0,
           f"{tag}'s rule passed a card microstep with TF32 on")
    if beam1:
        g = torch.Generator().manual_seed(SEED + 11)
        kept = {k: v.clone() for k, v in model.state_dict().items()}
        moved = {k: v.cpu() + GREEDY_NOISE * torch.randn(v.shape, generator=g)
                 for k, v in kept.items()}
        model.load_state_dict(moved)
        cpu.load_state_dict(moved)
        model.eval()
        cpu.eval()
        # the two shorter utterances (175 and 250 decisions)
        toks, margins = xf_beam1(torch, model, xs_t[:2].to(dev),
                                 xl_t[:2].to(dev))
        toks_ref, _ = xf_beam1(torch, cpu, xs_t[:2].double(), xl_t[:2])
        model.load_state_dict(kept)
        compared, cut = [], []
        for b, (hyp, ref, m) in enumerate(zip(toks, toks_ref, margins)):
            low = np.nonzero(m < DECISION_MARGIN)[0]
            n = int(low[0]) if len(low) else len(m)
            n = min(n, len(hyp), len(ref))
            compared.append(n)
            cut.append(bool(len(low)))
            expect(hyp[:n] == ref[:n],
                   f"{tag} beam 1, utterance {b}: the card's tokens part "
                   f"from the float64 run's within {n} decisions of margin")
        out["beam1"] = {"decisions_compared": compared,
                        "cut_by_margin": cut,
                        "hyp_lens": [len(h) for h in toks],
                        "least_margin": float(min(m.min() for m in margins))}
        log(f"[{tag}] beam 1: tokens identical over {compared} decisions "
            f"(cut at a decision under {DECISION_MARGIN}: {cut}; hyp lens "
            f"{out['beam1']['hyp_lens']})")
    del cpu
    for m, rate in saved:
        m.rate = rate
    for attn in mochas:
        attn.noise_std = 1.0
    out["determinism"] = phase_determinism(torch, model, on_card, bf16=False,
                                           phase=tag)
    model.eval()
    return out


def phase_xf_cli(torch, root: Path, corpus: dict, conf: str, overrides,
                 tag: str, profile_microstep: bool = True) -> dict:
    """10c / 10d: ``bin.asr.train.main`` on ``conf`` (``overrides``, phase
    7's corpus) and ``bin.asr.eval.main`` as the recipe's stage 5
    (``CLI_EVAL``, the recipe's LM), counts zeroed around each: K4 must run
    in training, K1, K1b, K2, K3 and K3b in neither; every loss finite; at
    least one optimizer update, timed as the sum of its cycle's microsteps
    (the update inside the last), and every weight leaf of the last
    checkpoint moved from the CLI's initial weights. On
    the widest microbatch a train() microstep's wall and, with
    ``profile_microstep``, its device-only profile (busy and idle time,
    the top kernels, K4's share), and the decoder's forward and backward
    alone under the profiler (its device time and operations)."""
    import csv
    import math
    import os
    from types import SimpleNamespace
    from neural_sp_tpu_torch.bin.asr import eval as cli_eval
    from neural_sp_tpu_torch.bin.asr import train as cli_train
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    from neural_sp_tpu_torch.parallel.mesh import (TrainStep,
                                                   deterministic_cudnn)
    from neural_sp_tpu_torch.trainers import checkpoint
    sync = torch.cuda.synchronize
    name = Path(conf).stem
    exp = str(root / f"exp_{name}")
    data = ["--train_set", corpus["train"], "--dev_set", corpus["dev"],
            "--dict", corpus["dict"], "--model_save_dir", exp]
    out = {"conf": conf, "overrides": list(overrides)}
    steps, widest, n_params, saves, initial = [], [], [], [], {}
    orig_call, orig_build = TrainStep.__call__, cli_train.build_speech2text
    orig_save, orig_init = checkpoint.save_checkpoint, cli_train.init_params

    def timed_call(self, xs, xlens, ys, ylens, *a, **kw):
        sync()
        t = time.perf_counter()
        m = orig_call(self, xs, xlens, ys, ylens, *a, **kw)
        sync()
        steps.append((time.perf_counter() - t, bool(m["emitted"]),
                      int(xlens.sum()), float(m["loss"])))
        if not widest or (xs.shape[1], xs.shape[0]) > (
                widest[0].shape[1], widest[0].shape[0]):
            widest[:] = (xs, xlens, ys, ylens)
        return m

    def counted_build(args, device=None):
        model = orig_build(args, device=device)
        n_params.append(sum(p.numel() for p in model.parameters()))
        out["accum_grad_n_steps"] = args.accum_grad_n_steps
        return model

    def timed_save(*a, **kw):
        t = time.perf_counter()
        path = orig_save(*a, **kw)
        saves.append((time.perf_counter() - t, os.path.getsize(path)))
        return path

    def kept_init(model, seed):
        model = orig_init(model, seed)
        initial.update({k: v.detach().clone()
                        for k, v in model.named_parameters()})
        return model

    torch.cuda.reset_peak_memory_stats()
    sync()
    reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(TrainStep, "__call__", timed_call), \
            mock.patch.object(cli_train, "build_speech2text", counted_build), \
            mock.patch.object(cli_train, "save_checkpoint", timed_save), \
            mock.patch.object(cli_train, "init_params", kept_init):
        cli_train.main(["--config", str(ROOT / conf)] + data +
                       list(overrides))
    sync()
    wall = time.perf_counter() - t0
    counts = launches()
    accum = out["accum_grad_n_steps"]
    micro_s = [s[0] for s in steps]
    # one optimizer step: the microsteps of its cycle, the update inside
    # the last (as phase 7)
    cycles, cur = [], 0.0
    for s in steps:
        cur += s[0]
        if s[1]:
            cycles.append(cur)
            cur = 0.0
    train = {"wall_s": wall, "parameters": n_params[0],
             "microsteps": len(steps), "optimizer_steps": len(cycles),
             "microstep_s": micro_s, "microstep_loss": [s[3] for s in steps],
             "ms_per_optimizer_step": 1e3 * sum(cycles) /
             max(len(cycles), 1),
             "frames_per_s": sum(s[2] for s in steps) / sum(micro_s),
             "launches": counts,
             "peak_mem_bytes": torch.cuda.max_memory_allocated(),
             "checkpoint_bytes": saves[-1][1],
             "checkpoint_save_s": [s[0] for s in saves]}
    out["train"] = train
    log(f"[{tag}] train CLI on {conf}: {n_params[0]} parameters, "
        f"{len(steps)} microsteps ({train['optimizer_steps']} updates at "
        f"accumulation {accum}), {train['ms_per_optimizer_step']:.1f} ms per "
        f"optimizer step (the sum of its cycle's {accum} microsteps), "
        f"{train['frames_per_s']:.0f} frames/s, wall {wall:.1f} s, peak mem "
        f"{train['peak_mem_bytes']} B, checkpoint {saves[-1][1]} B in "
        f"{saves[-1][0]:.2f} s")
    log(f"[{tag}]   microstep losses {['%.3f' % s[3] for s in steps]}; "
        f"microsteps {['%.3f' % s[0] for s in steps]} s; launches {counts}")
    for k in ("ctc_loss", "ctc_loss_bwd"):
        expect(counts[k] > 0, f"{k} never launched in phase {tag}")
    expect(all(counts[k] == 0 for k in NOT_ON_MOCHA_PATH),
           f"K1 / K1b / K2 / K3 / K3b launched training: {counts}")
    expect(all(math.isfinite(s[3]) for s in steps), f"{tag} losses {steps}")
    expect(train["optimizer_steps"] >= 1,
           f"{tag}: the train CLI made no optimizer update "
           f"({len(steps)} microsteps at accumulation {accum})")
    with open(f"{exp}/history.csv") as f:
        history = [(int(r["epoch"]), float(r["train_loss"]),
                    float(r["dev_loss_mean"])) for r in csv.DictReader(f)]
    out["history"] = history
    log(f"[{tag}] history.csv (epoch, train loss, dev loss): {history}")
    expect(len(history) >= 1 and all(
        math.isfinite(x) for _, *ls in history for x in ls),
        f"{tag} history.csv {history}")

    lm_dir = recipe_lm(root)
    torch.cuda.reset_peak_memory_stats()
    sync()
    reset_launches()
    t = time.perf_counter()
    res = cli_eval.main(["--recog_model", exp, "--recog_sets",
                         corpus["test"], "--recog_lm", lm_dir,
                         "--recog_dir", str(root / f"decode_{name}")] +
                        list(CLI_EVAL))
    sync()
    wall = time.perf_counter() - t
    counts = launches()
    (m,) = res.values()
    out["eval"] = {**m, "wall_s": wall, "launches": counts,
                   "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    log(f"[{tag}] eval CLI: RTF {m['rtf']:.4f}, wall {wall:.1f} s (with "
        f"loading), WER {m['wer']:.2f} over {m['n_utts']} utterances "
        f"(random weights); launches {counts}")
    expect(m["n_utts"] == CLI_UTTS["test"], f"{m['n_utts']} utterances")
    expect(not any(counts.values()),
           f"a kernel of the repo launched evaluating: {counts}")

    # a profiled train() microstep on the widest microbatch, the trained
    # weights; then the decoder alone
    epoch = history[-1][0]
    model, _, _ = cli_eval.load_model_for_eval(SimpleNamespace(
        recog_model=f"{exp}/ckpt.epoch-{epoch}", recog_n_average=1))
    batch = tuple(widest)
    widest.clear()
    # the update reached the weights: each leaf of the last checkpoint
    # against the CLI's initial weights
    with torch.no_grad():
        moved = {n: float((p - initial[n].to(p.device)).abs().max())
                 for n, p in model.named_parameters()}
    initial.clear()
    still = sorted(n for n, d in moved.items() if d == 0)
    train["leaves_moved"] = len(moved) - len(still)
    train["largest_weight_change"] = max(moved.values())
    log(f"[{tag}] the checkpoint of epoch {epoch} against the initial "
        f"weights: {len(moved) - len(still)} of {len(moved)} leaves moved, "
        f"the largest change {max(moved.values()):.3e}"
        + (f"; unmoved: {still[:6]}" if still else ""))
    expect(not still, f"{tag}: leaves the update left unmoved: {still[:6]}")

    def microstep():
        model.train()
        model.zero_grad(set_to_none=True)
        with deterministic_cudnn():       # as the train step runs
            loss, _ = model(*batch, torch.Generator().manual_seed(SEED))
            loss.backward()

    microstep()                           # warm-up
    sync()
    t = time.perf_counter()
    microstep()
    sync()
    what = f"train() microstep, B {batch[0].shape[0]} x " \
        f"{batch[0].shape[1]} frames, U {batch[2].shape[1]}"
    prof = {"wall_s": time.perf_counter() - t}
    log(f"[{tag}] {what}: wall {prof['wall_s']:.3f} s")
    if profile_microstep:
        prof = profiled(torch, what, microstep, tag=tag,
                        kernels=K4_KERNEL_NAMES, cpu=False)
    with torch.no_grad():
        model.eval()
        enc = model.encoder(batch[0], batch[1])["ys"]

    def decoder():
        model.train()
        model.zero_grad(set_to_none=True)
        ex = enc["xs"].detach().requires_grad_()
        loss, _ = model.dec_fwd(ex, enc["xlens"], batch[2], batch[3],
                                torch.Generator().manual_seed(SEED))
        loss.backward()

    decoder()
    sync()
    prof_dec = profiled(torch, "the decoder's forward and backward (its "
                        "loss)", decoder, tag=tag, cpu=False)
    if "device_busy_s" in prof:
        prof["k4_share"] = prof["kernels_device_ms"] / 1e3 / \
            prof["device_busy_s"]
        log(f"[{tag}]   K4 {prof['kernels_device_ms']:.3f} ms of device "
            f"time, {prof['k4_share']:.4f} of the busy time")
    if "device_busy_s" in prof_dec:
        share = prof_dec["device_busy_s"] / prof["device_busy_s"] \
            if "device_busy_s" in prof else None
        prof["decoder_share"] = share
        log(f"[{tag}]   the decoder alone: "
            f"{prof_dec['device_busy_s'] * 1e3:.3f} ms of device time in "
            f"{prof_dec['device_events']} device operations"
            + (f", {share:.4f} of the microstep's busy time"
               if share is not None else ""))
    out["profiled_microstep"] = prof
    out["profiled_decoder"] = prof_dec
    del model, batch, enc
    torch.cuda.empty_cache()
    return out


def phase_transformer(torch, root: Path, corpus: dict, xs, xlens) -> dict:
    """10: the LibriSpeech Transformer served (10a), held to float64 on the
    CPU (10b), trained and evaluated through the CLIs (10c); its MMA
    variant served, held and through the CLIs (10d); each path's launches
    counted from zero."""
    t = time.perf_counter()
    walls = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        result = fn(*a, **kw)
        walls[name] = time.perf_counter() - t0
        log(f"[{name}] wall {walls[name]:.1f} s")
        return result

    out = {}
    model = xf_model(torch, "librispeech_transformer_args")
    out["parameters"] = sum(p.numel() for p in model.parameters())
    log(f"[10a] LibriSpeech Transformer: {out['parameters']} parameters on "
        f"the card")
    out["serve"] = timed("10a", phase_xf_serve, torch, model, xs, xlens,
                         tuple(XF_SERVED), "10a")
    out["hold"] = timed("10b", phase_xf_hold, torch, model, xs, xlens,
                        "librispeech_transformer_args", "10b", beam1=True)
    del model
    torch.cuda.empty_cache()
    out["cli"] = timed("10c", phase_xf_cli, torch, root, corpus, XF_CONF,
                       XF_OVERRIDES, "10c")
    model = xf_model(torch, "librispeech_transformer_mma_args")
    mma = {"parameters": sum(p.numel() for p in model.parameters())}
    log(f"[10d] LibriSpeech Transformer-MMA: {mma['parameters']} parameters "
        f"on the card")
    mma["serve"] = timed("10d serve", phase_xf_serve, torch, model, xs,
                         xlens, ("beam10_ctc0.3",), "10d")
    mma["hold"] = timed("10d hold", phase_xf_hold, torch, model, xs, xlens,
                        "librispeech_transformer_mma_args", "10d",
                        beam1=False)
    del model
    torch.cuda.empty_cache()
    # the MMA decoder's profile alone: a whole microstep's trace holds
    # ~120,000 device operations, which take about a minute to read
    mma["cli"] = timed("10d CLIs", phase_xf_cli, torch, root, corpus,
                       XF_MMA_CONF, XF_MMA_OVERRIDES, "10d",
                       profile_microstep=False)
    out["mma"] = mma
    out["phase_wall_s"] = time.perf_counter() - t
    out["sub_phase_wall_s"] = walls
    log(f"[10] phase 10 wall {out['phase_wall_s']:.1f} s")
    return out


# ---- phase 11: the unidirectional and latency-controlled encoders -------
UNI_CONF = "examples/librispeech/conf/asr/mocha/uni_conformer_kernel7_" \
    "clamp10_hie_subsample8_mocha_ln_stableemit0.2_qua0.2.yaml"
STREAM_CONF = "examples/librispeech/conf/asr/uni_conformer_mocha_" \
    "streaming.yaml"
LC_CONF = "examples/librispeech/conf/asr/mma/streaming/lc_transformer_mma_" \
    "subsample8_ma4H_ca4H_w16_from4L_64_128_64.yaml"
# 10d's override: one epoch at accumulation 2, so that phase 7's 64
# utterances give an optimizer update (the confs' 16 and 8 give none)
STREAM_OVERRIDES = ("--n_epochs", "1", "--accum_grad_n_steps", "2",
                    "--unit", "word")
STREAM_EVAL = CLI_EVAL + ("--recog_streaming", "true")
# K1's window for the unidirectional encoder (causal_mask), and the
# streaming conf's chunks in encoder frames: left 64, current 32, right 0
# input frames over its x4 front end
CAUSAL_WINDOW = (-1, 1, 0)
STREAM_WINDOW = (16, 8, 0)
# the device phase 11 puts its inputs on
DEVICE = "cuda"
# 11d: the streaming conf's whole microstep (MoChA decoder on) against the
# same microstep in float64 on the CPU. No float32 run holds it to 9b's
# rule, JAX's included (ROADMAP C29, tests/test_torch_mocha_rounding.py:
# JAX's float32 gradients lie 0.8-85 times their norm from its float64
# ones, 2.8 on the geometric mean of four draws). The loss stays near:
# every float32 reading, of either package, on the card or the CPU, came
# within 8.1e-3 of float64 (PERF.md), so the card's may lie at most this
# far ...
WHOLE_LOSS_RTOL = 3e-2
# ... and the median over gradient leaves of |g - g64| / |g64| at most this
# multiple of the CPU float32 microstep's on the same inputs (the card's
# read 2.0 and 0.075 of it on H100 runs, PERF.md)
WHOLE_GRAD_MULT = 100.0
# 11d: the streamed encoder against the offline chunk-before-conv forward,
# max |err| / max |output|: float32 sums in other orders (the block's
# queries against the cached keys through K1 with the offset, the offline
# rows through K1 with the chunk window), as JAX's streaming test holds
# its two forwards
STREAM_RTOL = 1e-4


def window_bias(torch, p, klens, tk: int, window=None, key_start: int = 0):
    """K1's rel-PE bias and key mask with a window (or against cached keys:
    p's Tq rows the last of Tk) as one additive [B, H, Tq, Tk] mask for the
    library yardstick, in p's type: p[b, h, i, min(|i + Tk - Tq - j|, R-1)]
    on allowed keys, finfo(f32).min / 2 on the others (a row with none
    softmaxes to uniform weights, as K1's). Rows padded to a multiple of
    16 elements, the alignment the efficient kernel takes."""
    from neural_sp_tpu_torch.ops.masks import window_mask
    b, h, tq, r = p.shape
    i = torch.arange(tq, device=p.device) + (tk - tq)
    j = torch.arange(tk, device=p.device)
    idx = (i[:, None] - j[None, :]).abs().clamp(max=r - 1)
    bias = torch.empty((b, h, tq, -(-tk // 16) * 16), device=p.device,
                       dtype=p.dtype)[..., :tk]
    bias.copy_(torch.gather(p, -1, idx.expand(b, h, tq, tk)))
    ok = window_mask(klens, tq, tk, window, key_start, p.device)[:, None]
    return bias.masked_fill_(~ok, torch.finfo(torch.float32).min / 2)


def window_case(torch, rng, b, h, tt, dk, r, kl, window, tag: str,
                bwd: bool = True, bf16: bool = False, tq: int | None = None,
                key_start: int = 0, dropout=None) -> dict:
    """K1 with ``window`` (or ``tq`` queries against ``tt`` keys, the first
    ``key_start`` masked; with ``dropout`` = (rate, key words) of the
    attention probabilities) and, with ``bwd``, K1b, on seeded inputs,
    held to their plain versions (float32: KERNEL_ATOL for o,
    TRAIN_KERNEL_TOL of the max for K1b's outputs; bf16: BF16_KERNEL_TOL
    of the plain bf16 max and at most BF16_VS_F32_RATIO times the plain
    bf16 version's error against the plain float32 version), timed in
    turns with efficient SDPA given the bias and the window as one mask
    (and its autograd backward; with dropout, SDPA's ``dropout_p`` at the
    same rate, its own mask: the same work, so its error is taken
    without), beside the plain version's time and the bound of the
    window's work."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_bwd, rel_attention_bwd_cost, rel_attention_bwd_ref,
        rel_attention_cost, rel_attention_fwd, rel_attention_ref)
    dev = torch.device(DEVICE)
    dt = torch.bfloat16 if bf16 else torch.float32
    tq = tt if tq is None else tq

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            "float32")).to(dev).to(dt)

    q = t(b, h, tq, dk, scale=dk ** -0.5)
    k, v = t(b, h, tt, dk), t(b, h, tt, dk)
    p = t(b, h, tq, r, scale=dk ** -0.5)
    klens = torch.tensor(kl, dtype=torch.int32, device=dev)
    fwd = (q, k, v, p, klens, window, key_start, dropout)
    rate = dropout[0] if dropout else 0.0
    what = f"B={b} H={h} Tq={tq} Tk={tt} dk={dk} R={r} window={window} " \
        f"key_start={key_start} klens={kl if len(kl) <= 4 else '...'} " \
        f"dropout={rate} {'bf16' if bf16 else 'f32'}"
    o, m, l = rel_attention_fwd(*fwd)
    want = rel_attention_ref(*fwd)
    undropped = rel_attention_ref(*fwd[:-1]) if dropout else want
    row = {"shape": what}
    if bf16:
        f32 = (*(x.float() for x in (q, k, v, p)), klens, window, key_start)
        want32 = rel_attention_ref(*f32)
        err = rel_err(o, want)
        ratio = max_err(o.float(), want32) / max(
            max_err(want.float(), want32), 1e-30)
        expect(err <= BF16_KERNEL_TOL, f"[{tag}] K1 {what}: error {err}")
        expect(ratio <= BF16_VS_F32_RATIO,
               f"[{tag}] K1 {what}: {ratio:.3f}x the plain bf16 error")
        row.update(max_abs_err=err, vs_f32_ratio=ratio)
    else:
        err = max_err(o, want)
        expect(err <= KERNEL_ATOL, f"[{tag}] K1 {what}: error {err}")
        row["max_abs_err"] = err
    bias = window_bias(torch, p, klens, tt, window, key_start)
    with efficient_sdpa():
        lib_err = rel_err(sdpa(q, k, v, attn_mask=bias, scale=1.0),
                          undropped)
        ms, lib_ms = timed_pair(lambda: rel_attention_fwd(*fwd), lambda: sdpa(
            q, k, v, attn_mask=bias, scale=1.0, dropout_p=rate))
    expect(lib_err <= (BF16_KERNEL_TOL if bf16 else YARDSTICK_RTOL),
           f"[{tag}] K1 yardstick {what}: error {lib_err}")
    row.update(ms=ms, plain_ms=cuda_ms(lambda: rel_attention_ref(*fwd),
                                       iters=5),
               library_ms=lib_ms, library_err=lib_err,
               **roofline(rel_attention_cost(
                   b, h, tq, dk, r, kl, elem=2 if bf16 else 4,
                   window=window, tk=tt, key_start=key_start), bf16=bf16))
    log(f"[{tag}] K1 {what}: error {row['max_abs_err']:.3e}  kernel "
        f"{ms:.4f} ms  plain {row['plain_ms']:.4f} ms  library (SDPA, "
        f"efficient, the window in its mask) {lib_ms:.4f} ms (its error "
        f"{lib_err:.2e})  bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    out = {"fwd": row}
    if not bwd:
        return out
    do = t(b, h, tq, dk)
    args = (q, k, v, p, klens, o, m, l, do, window, dropout)
    got = rel_attention_bwd(*args)
    want = rel_attention_bwd_ref(*args)
    err = max(rel_err(x, y) for x, y in zip(got, want))
    brow = {"shape": what, "max_abs_err": err}
    if bf16:
        want32 = rel_attention_bwd_ref(*f32[:5], o.float(), m, l, do.float(),
                                       window)
        ratio = max(max_err(x.float(), z) / max(max_err(y.float(), z), 1e-30)
                    for x, y, z in zip(got, want, want32))
        expect(err <= BF16_KERNEL_TOL, f"[{tag}] K1b {what}: error {err}")
        expect(ratio <= BF16_VS_F32_RATIO,
               f"[{tag}] K1b {what}: {ratio:.3f}x the plain bf16 error")
        brow["vs_f32_ratio"] = ratio
    else:
        expect(err <= TRAIN_KERNEL_TOL["rel_attention_bwd"],
               f"[{tag}] K1b {what}: error {err}")
    again = rel_attention_bwd(*args)
    expect(all(torch.equal(x, y) for x, y in zip(got, again)),
           f"[{tag}] K1b {what}: not the same bits twice")
    bias.requires_grad_()
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    with efficient_sdpa():
        lib_out = sdpa(*leaves, attn_mask=bias, scale=1.0, dropout_p=rate)

        def lib_grads():
            return torch.autograd.grad(lib_out, (*leaves, bias), do,
                                       retain_graph=True)

        ms, lib_ms = timed_pair(lambda: rel_attention_bwd(*args), lib_grads,
                                iters=10)
    brow.update(ms=ms, plain_ms=cuda_ms(lambda: rel_attention_bwd_ref(*args),
                                        iters=3),
                library_ms=lib_ms, **roofline(rel_attention_bwd_cost(
                    b, h, tq, dk, r, kl, elem=2 if bf16 else 4,
                    window=window, tk=tt), bf16=bf16))
    log(f"[{tag}] K1b {what}: error {err:.3e} of the plain max  kernel "
        f"{ms:.4f} ms  plain {brow['plain_ms']:.4f} ms  library (SDPA "
        f"backward, the window in its mask; dp's buckets not summed) "
        f"{lib_ms:.4f} ms  bound {brow['bound_ms']:.4f} ms "
        f"({brow['bound_by']})")
    out["bwd"] = brow
    return out


def phase_window_kernels(torch, rng) -> dict:
    """11a / 11d: K1 and K1b with the paths' windows at their shapes.
    11a, the uni-Conformer (H 4, dk 64, R 11; its conv x2 and two
    max_pools leave T = 800 / 400 / 200 of phase 3's 1600 frames): the
    causal window at B 4 (the served batch, ragged) and B 32 (a training
    batch, ragged), K1b with it at B 32, and both bf16 entries at B 32, T
    800. 11d, the streaming conf (conv x4: T = 400; R = T unclamped): the
    chunk window (16, 8, 0) at B 4 and B 32 with a row of klen 10, whose
    pad queries from frame 32 on have no allowed key, f32 and bf16; then
    a streaming block's 8 queries against 24 keys (16 cached) with 0, 8
    and 16 of the cache's slots empty, R = 24."""
    import numpy as np
    out = {}
    h, dk, r = 4, 64, 11
    causal = []
    for tt in (800, 400, 200):
        kl4 = [tt, tt - tt // 4, tt // 2, tt // 3 + 1]
        causal.append(window_case(torch, rng, 4, h, tt, dk, r, kl4,
                                  CAUSAL_WINDOW, "11a", bwd=False))
        kl32 = np.maximum(tt - (np.arange(32) * tt) // 64, 1).tolist()
        causal.append(window_case(torch, rng, 32, h, tt, dk, r, kl32,
                                  CAUSAL_WINDOW, "11a"))
    kl32 = np.maximum(800 - (np.arange(32) * 800) // 64, 1).tolist()
    causal.append(window_case(torch, rng, 32, h, 800, dk, r, kl32,
                              CAUSAL_WINDOW, "11a", bf16=True))
    out["causal"] = causal
    chunk = []
    tt = 400
    for b, kl in ((4, [400, 325, 10, 175]),
                  (32, np.maximum(400 - (np.arange(32) * 400) // 40,
                                  10).tolist())):
        for bf16 in (False, True):
            chunk.append(window_case(torch, rng, b, h, tt, dk, tt, kl,
                                     STREAM_WINDOW, "11d", bf16=bf16))
    out["chunk"] = chunk
    offset = []
    for key_start in (16, 8, 0):
        for bf16 in (False, True):
            offset.append(window_case(torch, rng, 1, h, 24, dk, 24, [24],
                                      None, "11d", bwd=False, bf16=bf16,
                                      tq=8, key_start=key_start))
    out["offset"] = offset
    return out


def hold_with_control(torch, model, cpu, on_card, on_cpu, tag: str,
                      kernels: tuple) -> dict:
    """One train() microstep of ``model`` on the card held to the same
    microstep of ``cpu`` (its float64 copy) by 9b's rule, ``kernels``
    launched in the card's microstep, and a TF32 control that must break
    the rule."""
    import numpy as np
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    reset_launches()
    t0 = time.perf_counter()
    loss, grads, obs = mocha_microstep(torch, model, on_card)
    card_s = time.perf_counter() - t0
    counts = launches()
    t0 = time.perf_counter()
    loss_ref, grads_ref, obs_ref = mocha_microstep(torch, cpu, on_cpu)
    cpu_s = time.perf_counter() - t0
    log(f"[{tag}] train() microstep B {len(MOCHA_U)} x "
        f"{on_card[0].shape[1]} frames, U {list(MOCHA_U)}: card "
        f"{card_s:.2f} s, CPU float64 {cpu_s:.2f} s; card {obs}; CPU "
        f"{obs_ref}; launches {counts}")
    expect(all(np.isfinite(v) for v in obs.values()), f"{tag} losses {obs}")
    for name in kernels:
        expect(counts[name] > 0, f"{name} never launched in {tag}'s "
               f"microstep: {counts}")
    held = hold_microstep(loss, grads, loss_ref, grads_ref, tag, floor=True)
    out = {"card_s": card_s, "cpu_float64_s": cpu_s, "obs": obs,
           "obs_float64": obs_ref, "microstep": held, "launches": counts}
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        loss_c, grads_c, _ = mocha_microstep(torch, model, on_card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ctl = microstep_errors(loss_c, grads_c, loss_ref, grads_ref, floor=True)
    leaves = ctl.pop("leaves")
    worst = max(leaves, key=lambda n: leaves[n][0])
    ctl.update(worst_grad=leaves[worst][0], worst_grad_leaf=worst,
               leaves_past_tolerance=sum(v[0] > 1 for v in leaves.values()))
    out["tf32_control"] = ctl
    log(f"[{tag}] TF32 control: loss rel {ctl['loss_rel_err']:.2e}, worst "
        f"leaf {worst} {ctl['worst_grad']:.3f} of its tolerance, "
        f"{ctl['leaves_past_tolerance']} of {len(leaves)} leaves past it")
    expect(ctl["loss_rel_err"] > LOSS_RTOL or ctl["worst_grad"] > 1.0,
           f"{tag}'s rule passed a card microstep with TF32 on")
    return out


def uni_hold(torch, model, xs, xlens, make: str, tag: str,
             decoder_apart: bool = False) -> dict:
    """11b / 11d: one train() microstep at B = 4 (phase 3's utterances, U
    40-100; dropout and MoChA's noise on, as 9b) on the card held to the
    same microstep on the CPU in float64 (``hold_with_control``); K1 and
    K1b with the window and K4 must run. With ``decoder_apart`` (11d: the
    streaming conf, whose MoChA decoder makes a float32 microstep's loss
    and gradients rounding, in the JAX package too: ROADMAP C29) the
    whole microstep's loss must lie within WHOLE_LOSS_RTOL of float64 and
    its gradients' median distance from float64 within WHOLE_GRAD_MULT
    times that of the same microstep on the CPU in float32, and 9b's rule
    holds the microstep of the encoder and the CTC head (``ctc_weight`` 1:
    the decoder does not run), which carries every kernel of the path."""
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    import numpy as np
    dev = next(model.parameters()).device
    cpu = build_speech2text(xf_args(make), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x, xl = torch.from_numpy(xs), torch.from_numpy(xlens)
    ys, ylens = mocha_labels(torch, np.random.default_rng(SEED + 9),
                             model.dec_fwd.vocab)
    on_card = tuple(v.to(dev) for v in (x, xl, ys, ylens))
    on_cpu = (x.double(), xl, ys, ylens)
    window = ("rel_attention_window", "rel_attention_bwd_window",
              "ctc_loss", "ctc_loss_bwd")
    if not decoder_apart:
        cpu.double()
        out = hold_with_control(torch, model, cpu, on_card, on_cpu, tag,
                                window)
        model.eval()
        return out
    loss, grads, obs = mocha_microstep(torch, model, on_card)
    loss32, grads32, _ = mocha_microstep(torch, cpu, (x, xl, ys, ylens))
    cpu.double()
    loss_ref, grads_ref, obs_ref = mocha_microstep(torch, cpu, on_cpu)

    def dist(g):
        return {n: float((g[n] - grads_ref[n]).norm() /
                         max(float(grads_ref[n].norm()), 1e-30))
                for n in grads_ref if not n.endswith(ZERO_GRAD_LEAF)}

    d_card, d_cpu32 = dist(grads), dist(grads32)
    loss_err = abs(loss - loss_ref) / abs(loss_ref)
    whole = {"loss_rel_err": loss_err,
             "loss_rel_err_cpu_float32": abs(loss32 - loss_ref) /
             abs(loss_ref), "obs": obs, "obs_float64": obs_ref,
             "median_leaf_rel_dist": float(np.median(list(d_card.values()))),
             "median_leaf_rel_dist_cpu_float32": float(np.median(list(
                 d_cpu32.values()))),
             "max_leaf_rel_dist": max(d_card.values()),
             "max_leaf_rel_dist_cpu_float32": max(d_cpu32.values())}
    log(f"[{tag}] the whole microstep (MoChA decoder on): loss rel "
        f"{loss_err:.2e} of float64 (CPU float32 "
        f"{whole['loss_rel_err_cpu_float32']:.2e}); per leaf |g - g64| / "
        f"|g64|, median {whole['median_leaf_rel_dist']:.3e} / max "
        f"{whole['max_leaf_rel_dist']:.3e} on the card, "
        f"{whole['median_leaf_rel_dist_cpu_float32']:.3e} / "
        f"{whole['max_leaf_rel_dist_cpu_float32']:.3e} for the CPU in "
        f"float32 (ROADMAP C29)")
    expect(all(bool(torch.isfinite(g).all()) for gs in (grads, grads32)
               for g in gs.values()), f"{tag}: a gradient not finite")
    expect(loss_err <= WHOLE_LOSS_RTOL, f"{tag}: the whole microstep's loss "
           f"{loss_err:.2e} of float64, past {WHOLE_LOSS_RTOL}")
    expect(whole["median_leaf_rel_dist"] <= WHOLE_GRAD_MULT *
           whole["median_leaf_rel_dist_cpu_float32"],
           f"{tag}: the whole microstep's gradients "
           f"{whole['median_leaf_rel_dist']:.3e} from float64 (median), past "
           f"{WHOLE_GRAD_MULT} x the CPU float32's "
           f"{whole['median_leaf_rel_dist_cpu_float32']:.3e}")
    for m in (model, cpu):
        m.ctc_weight = 1.0
    try:
        out = hold_with_control(torch, model, cpu, on_card, on_cpu,
                                f"{tag} encoder + CTC", window)
    finally:
        for m in (model, cpu):
            m.ctc_weight = xf_args(make).ctc_weight
    out["whole_microstep"] = whole
    model.eval()
    return out


def stream_cli(torch, root: Path, corpus: dict, conf: str, tag: str,
               train: bool, evals: dict, train_kernels: tuple,
               model=None, lm: bool = True, depth: tuple = ()) -> dict:
    """11c / 11d / 11e: with ``train``, ``bin.asr.train.main`` on ``conf``
    (``STREAM_OVERRIDES``, phase 7's corpus), counts zeroed around it:
    ``train_kernels`` must run, every loss must be finite, at least one
    optimizer update, every weight leaf of its checkpoint moved from the
    CLI's initial weights; without, ``model``'s weights saved with the
    conf as the train CLI leaves them (a conf that cannot train through
    the CLI). Then ``bin.asr.eval.main`` with each argument list of
    ``evals`` (counts zeroed around each), with the recipe's LM unless
    ``lm`` is off; ``depth``: the conf's depth cut as CLI flags."""
    import math
    from types import SimpleNamespace
    from neural_sp_tpu_torch.bin.args import parse_args_train, save_config
    from neural_sp_tpu_torch.bin.asr import eval as cli_eval
    from neural_sp_tpu_torch.bin.asr import train as cli_train
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    from neural_sp_tpu_torch.parallel.mesh import TrainStep
    from neural_sp_tpu_torch.trainers.checkpoint import save_checkpoint
    sync = torch.cuda.synchronize
    name = Path(conf).stem
    exp = str(root / f"exp_{name}")
    data = ["--train_set", corpus["train"], "--dev_set", corpus["dev"],
            "--dict", corpus["dict"], "--model_save_dir", exp]
    out = {"conf": conf}
    if train:
        steps, initial = [], {}
        orig_call, orig_init = TrainStep.__call__, cli_train.init_params

        def timed_call(self, *a, **kw):
            sync()
            t = time.perf_counter()
            m = orig_call(self, *a, **kw)
            sync()
            steps.append((time.perf_counter() - t, bool(m["emitted"]),
                          float(m["loss"])))
            return m

        def kept_init(model, seed):
            model = orig_init(model, seed)
            initial.update({k: v.detach().clone()
                            for k, v in model.named_parameters()})
            return model

        reset_launches()
        t0 = time.perf_counter()
        with mock.patch.object(TrainStep, "__call__", timed_call), \
                mock.patch.object(cli_train, "init_params", kept_init):
            cli_train.main(["--config", str(ROOT / conf)] + data +
                           list(STREAM_OVERRIDES) + list(depth))
        sync()
        wall = time.perf_counter() - t0
        counts = launches()
        cycles, cur = [], 0.0
        for s in steps:
            cur += s[0]
            if s[1]:
                cycles.append(cur)
                cur = 0.0
        trained, _, _ = cli_eval.load_model_for_eval(SimpleNamespace(
            recog_model=exp, recog_n_average=1))
        with torch.no_grad():
            moved = {n: float((p - initial[n].to(p.device)).abs().max())
                     for n, p in trained.named_parameters()}
        del trained
        still = sorted(n for n, d in moved.items() if d == 0)
        out["train"] = {
            "wall_s": wall, "microsteps": len(steps),
            "optimizer_steps": len(cycles),
            "ms_per_optimizer_step": 1e3 * sum(cycles) / max(len(cycles), 1),
            "microstep_loss": [s[2] for s in steps], "launches": counts,
            "leaves_moved": len(moved) - len(still),
            "largest_weight_change": max(moved.values())}
        log(f"[{tag}] train CLI on {conf}: {len(steps)} microsteps, "
            f"{len(cycles)} updates, "
            f"{out['train']['ms_per_optimizer_step']:.1f} ms per optimizer "
            f"step, wall {wall:.1f} s; {len(moved) - len(still)} of "
            f"{len(moved)} leaves moved (largest "
            f"{max(moved.values()):.3e}); launches {counts}")
        for k in train_kernels:
            expect(counts[k] > 0, f"{k} never launched in {tag}'s train CLI")
        expect(all(math.isfinite(s[2]) for s in steps), f"{tag} {steps}")
        expect(len(cycles) >= 1, f"{tag}: no optimizer update")
        expect(not still, f"{tag}: leaves the update left unmoved: "
               f"{still[:6]}")
    else:
        args = parse_args_train(["--config", str(ROOT / conf)] + data +
                                list(STREAM_OVERRIDES) + list(depth))
        args.vocab = CLI_VOCAB
        save_checkpoint(exp, 1, model.state_dict())
        save_config(vars(args), str(Path(exp) / "conf.yml"))
        out["train"] = None
    lm_args = ["--recog_lm", recipe_lm(root)] if lm else []
    for what, extra in evals.items():
        reset_launches()
        t = time.perf_counter()
        res = cli_eval.main(["--recog_model", exp, "--recog_sets",
                             corpus["test"], "--recog_dir",
                             str(root / f"decode_{name}_{what}")] + lm_args +
                            list(extra))
        sync()
        wall = time.perf_counter() - t
        counts = launches()
        (m,) = res.values()
        out[f"eval_{what}"] = {**m, "wall_s": wall, "launches": counts}
        log(f"[{tag}] eval CLI {what}: RTF {m['rtf']:.4f}, wall {wall:.1f} s "
            f"(with loading), WER {m['wer']:.2f} over {m['n_utts']} "
            f"utterances (random weights); {m}; launches {counts}")
        expect(m["n_utts"] == CLI_UTTS["test"], f"{m['n_utts']} utterances")
    return out


def stream_against_offline(torch, model, xs, xlens) -> dict:
    """11d: each utterance cut to whole 32-frame blocks, streamed block by
    block through ``streaming_step`` (K1 against the cached keys) and held
    to the offline mask-mode forward of the same weights with the CNN run
    per chunk (``unidirectional`` off: JAX's chunk-before-conv path, which
    its streaming is designed to equal; the conf's own offline forward
    runs the CNN over the whole utterance, ROADMAP C27), within
    STREAM_RTOL of the largest output; the gap to the conf's own offline
    forward is logged beside it."""
    from neural_sp_tpu_torch.frontends.streaming import StreamingDriver
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    enc = model.encoder
    total, hop = enc.block_input_frames()
    out = {"utterances": []}
    reset_launches()
    with torch.inference_mode():
        for i, n in enumerate(xlens):
            n = int(n) // hop * hop
            x = torch.from_numpy(xs[i:i + 1, :n]).to(DEVICE)
            cache, blocks = enc.init_stream_cache(1), []
            t0 = time.perf_counter()
            for blk, _, _ in StreamingDriver(xs[i, :n], total, hop, 0):
                o, cache = enc.streaming_step(
                    torch.from_numpy(blk).to(DEVICE)[None], cache)
                blocks.append(o)
            stream = torch.cat(blocks, 1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            full = torch.tensor([n], device=x.device)
            enc.unidirectional = False
            try:
                chunked = enc(x, full)["ys"]["xs"]
            finally:
                enc.unidirectional = True
            own = enc(x, full)["ys"]["xs"]
            scale = float(chunked.abs().max())
            err = float((stream - chunked).abs().max()) / scale
            gap = float((stream - own).abs().max()) / scale
            row = {"frames": n, "blocks": len(blocks), "rel_err": err,
                   "gap_to_uni_offline": gap, "stream_wall_s": wall,
                   "wall_ms_per_block": wall * 1e3 / len(blocks)}
            out["utterances"].append(row)
            log(f"[11d] streamed {n} frames in {len(blocks)} blocks "
                f"({row['wall_ms_per_block']:.2f} ms of wall each): against "
                f"the chunk-before-conv offline forward {err:.2e} of its "
                f"max; against the conf's own offline forward {gap:.2e} "
                f"(C27)")
            expect(err <= STREAM_RTOL, f"11d streamed encoder: {err}")
    out["launches"] = launches()
    expect(out["launches"]["rel_attention_offset"] > 0,
           "K1 never ran against cached keys in streaming_step")
    return out


def stream_decode(torch, model, xs, xlens) -> dict:
    """11d: ``decode_streaming`` (the block-synchronous MoChA beam 10 +
    CTC 0.3) of phase 3's utterances, one at a time; counts zeroed around
    them (K1 against cached keys must run): RTF, wall per block, resets,
    commits and each hypothesis's boundaries."""
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    sess = Speech2TextSession(model, DecodeConfig(beam_width=10,
                                                  ctc_weight=0.3))
    hop = model.encoder.block_input_frames()[1]
    sess.decode_streaming(xs[0, :4 * hop])        # warm-up, not counted
    reset_launches()
    rows = []
    t0 = time.perf_counter()
    for i, n in enumerate(xlens):
        t = time.perf_counter()
        hyp, stats = sess.decode_streaming(xs[i, :int(n)])
        wall = time.perf_counter() - t
        n_blocks = -(-int(n) // hop)
        rows.append({"frames": int(n), "hyp_len": len(hyp), "wall_s": wall,
                     "wall_ms_per_block": wall * 1e3 / n_blocks,
                     "rtf": stats["rtf"], "n_resets": stats["n_resets"],
                     "boundaries": len(stats.get("boundaries", [])),
                     "n_out_frames": stats.get("n_out_frames")})
        expect(all(isinstance(y, int) and 0 <= y < model.dec_fwd.vocab
                   for y in hyp), f"11d streaming hypothesis {hyp}")
        log(f"[11d] decode_streaming {n} frames: hyp len {len(hyp)}, RTF "
            f"{stats['rtf']:.4f}, {rows[-1]['wall_ms_per_block']:.1f} ms "
            f"of wall per block, resets {stats['n_resets']}")
    wall = time.perf_counter() - t0
    counts = launches()
    log(f"[11d] decode_streaming of {len(xlens)} utterances: wall "
        f"{wall:.2f} s, RTF {wall / (float(sum(xlens)) * FRAME_SEC):.4f}; "
        f"launches {counts}")
    expect(counts["rel_attention_offset"] > 0,
           "K1 never ran against cached keys in decode_streaming")
    return {"utterances": rows, "wall_s": wall, "launches": counts,
            "rtf": wall / (float(sum(xlens)) * FRAME_SEC)}


def phase_streaming(torch, rng, root: Path, corpus: dict, xs,
                    xlens) -> dict:
    """11: the unidirectional and latency-controlled encoders. K1 / K1b with
    the paths' windows (``phase_window_kernels``); (11a) the LibriSpeech
    uni-Conformer-MoChA (``UNI_CONF``) served, beam 10 + CTC 0.3 and
    greedy, counts zeroed around them (K1 with the causal window must run;
    K2, K3, K3b must not); (11b) its microstep held to float64 (K1b with
    the window); (11c) its train CLI (one update) and the eval CLI as
    stage 5; (11d) the repo's streaming conf (``STREAM_CONF``, mask mode):
    the streamed encoder against the offline one, a microstep held,
    ``decode_streaming`` of the 4 utterances and the eval CLI with
    ``--recog_streaming true`` on its seeded weights; (11e) the LibriSpeech
    LC-Transformer-MMA (``LC_CONF``, reshape mode): a microstep held (as
    10d), the train CLI (one update) and the eval CLI offline and
    streaming (JAX's dispatch: the CTC block-synchronous beam, C26)."""
    t = time.perf_counter()
    walls = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        result = fn(*a, **kw)
        walls[name] = time.perf_counter() - t0
        log(f"[{name}] wall {walls[name]:.1f} s")
        return result

    out = {"kernels": timed("11 kernels", phase_window_kernels, torch, rng)}
    model = xf_model(torch, "librispeech_uni_conformer_mocha_args")
    out["parameters"] = sum(p.numel() for p in model.parameters())
    log(f"[11a] LibriSpeech uni-Conformer-MoChA: {out['parameters']} "
        f"parameters on the card")
    served, counts = timed("11a", phase_serve, torch, model, xs, xlens,
                           ("beam10_ctc0.3", "greedy"), tag="11a")
    served.pop("best_hyp0")
    served["launches"] = counts
    expect(counts["rel_attention_window"] > 0 and counts["rel_attention"] > 0,
           f"K1 with the causal window never launched serving: {counts}")
    expect(all(counts[k] == 0 for k in ("las_step", "las_scan",
                                        "las_scan_bwd", "rel_attention_bwd")),
           f"K1b / K2 / K3 / K3b launched serving: {counts}")
    out["serve"] = served
    out["hold"] = timed("11b", uni_hold, torch, model, xs, xlens,
                        "librispeech_uni_conformer_mocha_args", "11b")
    del model
    torch.cuda.empty_cache()
    uni_train = ("rel_attention", "rel_attention_window", "rel_attention_bwd",
                 "rel_attention_bwd_window", "ctc_loss", "ctc_loss_bwd")
    out["cli"] = timed("11c", stream_cli, torch, root, corpus, UNI_CONF,
                       "11c", True, {"offline": CLI_EVAL}, uni_train,
                       depth=depth_flags(
                           "librispeech_uni_conformer_mocha_args"))
    expect(out["cli"]["eval_offline"]["launches"]["rel_attention_window"] > 0,
           "K1 with the causal window never launched in the eval CLI")

    model = xf_model(torch, "uni_conformer_mocha_streaming_args")
    stream = {"parameters": sum(p.numel() for p in model.parameters())}
    log(f"[11d] the streaming uni-Conformer-MoChA: {stream['parameters']} "
        f"parameters on the card")
    stream["against_offline"] = timed("11d offline", stream_against_offline,
                                      torch, model, xs, xlens)
    stream["hold"] = timed("11d hold", uni_hold, torch, model, xs, xlens,
                           "uni_conformer_mocha_streaming_args", "11d",
                           decoder_apart=True)
    stream["decode"] = timed("11d decode", stream_decode, torch, model, xs,
                             xlens)
    stream["cli"] = timed("11d CLI", stream_cli, torch, root, corpus,
                          STREAM_CONF, "11d", False,
                          {"streaming": STREAM_EVAL}, (), model=model,
                          depth=depth_flags(
                              "uni_conformer_mocha_streaming_args"))
    expect(stream["cli"]["eval_streaming"]["launches"][
        "rel_attention_offset"] > 0,
        "K1 never ran against cached keys in the streaming eval CLI")
    out["stream"] = stream
    del model
    torch.cuda.empty_cache()

    model = xf_model(torch, "librispeech_lc_transformer_mma_args")
    lc = {"parameters": sum(p.numel() for p in model.parameters())}
    log(f"[11e] LibriSpeech LC-Transformer-MMA: {lc['parameters']} "
        f"parameters on the card")
    lc["hold"] = timed("11e hold", phase_xf_hold, torch, model, xs, xlens,
                       "librispeech_lc_transformer_mma_args", "11e",
                       beam1=False)
    del model
    torch.cuda.empty_cache()
    lc["cli"] = timed("11e CLIs", stream_cli, torch, root, corpus, LC_CONF,
                      "11e", True, {"offline": CLI_EVAL,
                                    "streaming": STREAM_EVAL},
                      ("ctc_loss", "ctc_loss_bwd"))
    out["lc"] = lc
    out["phase_wall_s"] = time.perf_counter() - t
    out["sub_phase_wall_s"] = walls
    log(f"[11] phase 11 wall {out['phase_wall_s']:.1f} s")
    return out


# ---- phase 12: the LC-BLSTM with its streaming, and the RNN transducer ---
# 12a: the LibriSpeech recipe's LC-BLSTM-RNN-T (``RNNT_CONF``: conv x4,
# 5 LC-BLSTM-512 layers summed, chunk 40 / 40 (the conf's
# lc_chunk_size_left read as the current chunk, ROADMAP C13), a 2-layer
# LSTM-1024 prediction net, the joint of 1024 (JAX's transducer_joint_dim
# default, dec_n_units), CTC 0.3 with fc 512) at full width and depth over
# V = 1,000 (the conf's bpe1k), float32. 12b: the LC-BLSTM-MoChA
# (``LC_MOCHA_CONF``, 16 confs' shape) at RNN_DEPTH over phase 7's V.
RNNT_CONF = "examples/librispeech/conf/asr/transducer/" \
    "lcblstm_rnnt_chunk4040_bpe1k.yaml"
LC_MOCHA_CONF = "examples/librispeech/conf/asr/mocha/" \
    "lcblstm_mocha_chunk4040.yaml"
RNNT_VOCAB = 1000          # the 4 reserved ids and 996 words
RNNT_SERVED = {"beam10_tsd": dict(beam_width=10),
               "greedy": dict(beam_width=1)}
# the eval CLI: beam 10 (tsd) offline, and streaming (mono); no LM (the
# transducer's searches read none)
RNNT_EVAL = {"beam10": ("--recog_beam_width", "10", "--recog_n_average",
                        "2"),
             "streaming": ("--recog_beam_width", "10", "--recog_n_average",
                           "2", "--recog_streaming", "true")}
RNNT_TRAIN_KERNELS = ("rnnt_loss", "rnnt_loss_bwd", "ctc_loss",
                      "ctc_loss_bwd")
# K5 at the recipe's shape (B 32, T 400 after the x4 front end, U 200) and
# ragged (a row of U 0, a row of T 1, U > T)
RNNT_KERNEL_SHAPES = ((32, 400, 200, [400] * 32, [200] * 32),
                      (8, 120, 60, [120, 1, 77, 30, 5, 120, 64, 2],
                       [60, 0, 33, 59, 0, 1, 60, 2]),
                      (3, 10, 40, [10, 4, 1], [40, 13, 7]))


def rnnt_case(torch, rng, record, b, tt, uu, tl, ul, tag="12") -> dict:
    """K5 forward and backward at B, T, U (two moves' log-probs about -log
    V with unit spread, emit NEG_INF past each row's U) against its plain
    float64 twin, with CUDA-event times and the bound; at the first shape
    also the plain recurrence in float32 (JAX's precision) against the
    float64 twin, what K5's float64 values buy."""
    import numpy as np
    from neural_sp_tpu_torch.ops.kernels.rnnt_loss import (
        NEG_INF, rnnt_bwd_cost, rnnt_cost, rnnt_forward_alphas,
        rnnt_loss_bwd, rnnt_loss_bwd_ref, rnnt_loss_fwd)
    dev = torch.device("cuda")

    def draw(*shape):
        return torch.from_numpy((rng.standard_normal(shape) - np.log(
            RNNT_VOCAB)).astype("float32")).to(dev)

    tlen = torch.tensor(tl, dtype=torch.int32, device=dev)
    ulen = torch.tensor(ul, dtype=torch.int32, device=dev)
    emit = draw(b, tt, uu)
    emit = torch.where(torch.arange(uu, device=dev)[None, None] <
                       ulen[:, None, None], emit,
                       torch.full_like(emit, NEG_INF))
    args = (draw(b, tt, uu + 1), emit, tlen, ulen)
    g = torch.linspace(0.5, 1.5, b, device=dev)
    nll, al = rnnt_loss_fwd(*args)
    nll_r, al_r = rnnt_forward_alphas(*args)
    gb, ge = rnnt_loss_bwd(*args, al, g)
    gb_r, ge_r = rnnt_loss_bwd_ref(*args, al_r, g)
    err = max(rel_err(nll, nll_r), rel_err(gb, gb_r), rel_err(ge, ge_r),
              *(rel_err(a, b) for a, b in zip(
                  rnnt_loss_bwd(*args, al_r, g), (gb_r, ge_r))))
    fwd_ms = cuda_ms(lambda: rnnt_loss_fwd(*args))
    bwd_ms = cuda_ms(lambda: rnnt_loss_bwd(*args, al, g))
    fwd_ref = cuda_ms(lambda: rnnt_forward_alphas(*args), iters=2, warmup=1)
    bwd_ref = cuda_ms(lambda: rnnt_loss_bwd_ref(*args, al_r, g), iters=2,
                      warmup=1)
    fwd_cost = rnnt_cost(b, tt, uu, tl, ul)
    bwd_cost = rnnt_bwd_cost(b, tt, uu, tl, ul)
    extra = {}
    if tt == RNNT_KERNEL_SHAPES[0][1]:
        nll32, al32 = rnnt_forward_alphas(*args, dtype=torch.float32)
        g32 = rnnt_loss_bwd_ref(*args, al32, g, dtype=torch.float32)
        extra = {"f32_recurrence_nll_err": rel_err(nll32, nll_r),
                 "f32_recurrence_grad_err": max(
                     rel_err(g32[0], gb_r), rel_err(g32[1], ge_r))}
        log(f"[{tag}] the plain recurrence in float32 (JAX's) against "
            f"float64: nll {extra['f32_recurrence_nll_err']:.3e}, gradient "
            f"{extra['f32_recurrence_grad_err']:.3e} of the reference's max")
    log(f"[{tag}] rnnt_loss forward kernel {fwd_ms:.4f} ms plain "
        f"{fwd_ref:.4f} ms; backward kernel {bwd_ms:.4f} ms plain "
        f"{bwd_ref:.4f} ms")
    record("rnnt_loss", err, fwd_ms + bwd_ms, fwd_ref + bwd_ref,
           f"forward + backward B={b} T={tt} U={uu}", library_ms=None,
           **roofline((fwd_cost[0] + bwd_cost[0], fwd_cost[1] + bwd_cost[1]),
                      simt=True),
           fwd_bound_ms=roofline(fwd_cost, simt=True)["bound_ms"],
           bwd_bound_ms=roofline(bwd_cost, simt=True)["bound_ms"],
           fwd_ms=fwd_ms, fwd_plain_ms=fwd_ref, bwd_ms=bwd_ms,
           bwd_plain_ms=bwd_ref, **extra)


def lc_args(conf: str, vocab: int, depth: int | None = None):
    from neural_sp_tpu_torch.bin.args import parse_args_train
    args = parse_args_train(["--config", str(ROOT / conf)])
    args.vocab, args.input_dim = vocab, 80
    if depth is not None:
        args.enc_n_layers = depth
    return args


def lc_model(torch, args):
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.utils.init_params import init_params
    model = build_speech2text(args)      # on the card
    init_params(model, SEED)
    return model.eval()


def energy_pre_activations(torch, record: list, card_pre=None,
                           flips=None):
    """A stand-in for MoChA's additive energy (``modules/mocha.py::
    _energy``, ``v . relu(k + q)``) that keeps each call's pre-activation
    k + q in ``record``; with ``card_pre`` (the card's, in call order) it
    computes the energy with the card's ReLU masks instead of its own and
    adds to ``flips`` the positions whose sign differs and the largest
    pre-activation error of a call, relative to its largest value."""
    def energy(m, key_cache, query):
        bs, t, _ = key_cache.shape
        k = key_cache.view(bs, t, m.n_heads, m.adim)
        q = m.w_query(query).view(bs, 1, m.n_heads, m.adim)
        pre = k + q
        if card_pre is None:
            record.append(pre.detach())
            return torch.einsum("ha,btha->bht", m.v, torch.relu(pre))
        card = card_pre[len(record)].to(pre)
        record.append(None)
        mine = pre.detach()
        flips["positions"] += int(((card > 0) != (mine > 0)).sum())
        flips["pre_rel_err"] = max(flips["pre_rel_err"], float(
            (card - mine).abs().max() / mine.abs().max()))
        return torch.einsum("ha,btha->bht", m.v,
                            pre * (card > 0).to(pre.dtype))
    return energy


def hold_to_float64(torch, model, args, xs, xlens, tag) -> dict:
    """A B = 4 train() microstep of the card's model (phase 3's utterances,
    MOCHA_U labels, dropout on) held to the same microstep on the CPU in
    float64 by 9b's rule, with a TF32 control that must break it
    (``hold_with_control``; K5 and K4 must run in the transducer's).

    With a MoChA decoder the float32 microstep rounds, on the CPU as on
    the card (ROADMAP C29): so, as 11d, the whole microstep's loss must lie
    within WHOLE_LOSS_RTOL of float64 and its gradients' median distance
    from float64 within WHOLE_GRAD_MULT times the CPU float32 microstep's,
    and 9b's rule, with its control, holds the microstep of the encoder
    and the CTC head (``ctc_weight`` 1), which carries every kernel of the
    path. Beside it the readings of 9b's rule on the whole microstep: the
    card's and the CPU float32's against float64, and the card's against
    float64 with the card's ReLU masks of MoChA's additive energies pinned
    (phase 10's method), with the masks that flip and the largest
    pre-activation error (within XF_PRE_RTOL of each call's max)."""
    import numpy as np
    from neural_sp_tpu_torch.models.modules import mocha as mocha_module
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    dev = next(model.parameters()).device
    ys, ylens = mocha_labels(torch, np.random.default_rng(SEED + 9),
                             args.vocab)
    x, xl = torch.from_numpy(xs), torch.from_numpy(xlens)
    on_card = tuple(v.to(dev) for v in (x, xl, ys, ylens))
    on_cpu = (x.double(), xl, ys, ylens)
    cpu = build_speech2text(args, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    if getattr(model.dec_fwd, "attn_type", "") != "mocha":
        cpu.double()
        return hold_with_control(torch, model, cpu, on_card, on_cpu, tag,
                                 RNNT_TRAIN_KERNELS)
    card_pre: list = []
    reset_launches()
    with mock.patch.object(mocha_module, "_energy", energy_pre_activations(
            torch, card_pre)):
        loss, grads, obs = mocha_microstep(torch, model, on_card)
    counts = launches()
    loss32, grads32, _ = mocha_microstep(torch, cpu, (x, xl, ys, ylens))
    cpu.double()
    t0 = time.perf_counter()
    loss_ref, grads_ref, obs_ref = mocha_microstep(torch, cpu, on_cpu)
    cpu_s = time.perf_counter() - t0
    flips = {"positions": 0, "pre_rel_err": 0.0}
    with mock.patch.object(mocha_module, "_energy", energy_pre_activations(
            torch, [], card_pre, flips)):
        loss_p, grads_p, _ = mocha_microstep(torch, cpu, on_cpu)
    flips["pre_activations"] = sum(p.numel() for p in card_pre)
    del card_pre

    def rule(lo, gr, lo_ref, gr_ref):
        """9b's rule's reading: (worst leaf, its share of the tolerance)."""
        e = microstep_errors(lo, gr, lo_ref, gr_ref, floor=True)
        worst = max(e["leaves"], key=lambda n: e["leaves"][n][0])
        return {"loss_rel_err": e["loss_rel_err"], "worst_grad_leaf": worst,
                "worst_grad": e["leaves"][worst][0]}

    def dist(g):
        return {n: float((g[n] - grads_ref[n]).norm() /
                         max(float(grads_ref[n].norm()), 1e-30))
                for n in grads_ref}

    d_card, d_cpu32 = dist(grads), dist(grads32)
    whole = {"loss_rel_err": abs(loss - loss_ref) / abs(loss_ref),
             "loss_rel_err_cpu_float32": abs(loss32 - loss_ref) /
             abs(loss_ref),
             "median_leaf_rel_dist": float(np.median(list(d_card.values()))),
             "median_leaf_rel_dist_cpu_float32": float(np.median(list(
                 d_cpu32.values()))),
             "rule_9b": rule(loss, grads, loss_ref, grads_ref),
             "rule_9b_cpu_float32": rule(loss32, grads32, loss_ref,
                                         grads_ref),
             "rule_9b_pinned": rule(loss, grads, loss_p, grads_p),
             "energy_relu": flips, "obs": obs, "obs_float64": obs_ref,
             "cpu_float64_s": cpu_s, "launches": counts}
    log(f"[{tag}] the whole microstep (MoChA on): loss rel "
        f"{whole['loss_rel_err']:.2e} of float64 (CPU float32 "
        f"{whole['loss_rel_err_cpu_float32']:.2e}); median leaf |g - g64| / "
        f"|g64| {whole['median_leaf_rel_dist']:.3e} on the card, "
        f"{whole['median_leaf_rel_dist_cpu_float32']:.3e} for the CPU in "
        f"float32; 9b's rule, worst leaf: card {whole['rule_9b']}, CPU "
        f"float32 {whole['rule_9b_cpu_float32']}, card against float64 with "
        f"the card's energy ReLU masks {whole['rule_9b_pinned']}; "
        f"{flips['positions']} of {flips['pre_activations']} energy "
        f"pre-activations flip sign, the largest pre-activation error "
        f"{flips['pre_rel_err']:.2e} of its call's max (ROADMAP C29)")
    expect(all(bool(torch.isfinite(g).all()) for gs in (grads, grads32)
               for g in gs.values()), f"{tag}: a gradient not finite")
    expect(flips["pre_rel_err"] <= XF_PRE_RTOL,
           f"{tag}: the MoChA energies' pre-activations part from float64 "
           f"by {flips['pre_rel_err']:.2e} of their max")
    expect(whole["loss_rel_err"] <= WHOLE_LOSS_RTOL,
           f"{tag}: the whole microstep's loss {whole['loss_rel_err']:.2e} "
           f"of float64, past {WHOLE_LOSS_RTOL}")
    expect(whole["median_leaf_rel_dist"] <= WHOLE_GRAD_MULT *
           whole["median_leaf_rel_dist_cpu_float32"],
           f"{tag}: the whole microstep's gradients "
           f"{whole['median_leaf_rel_dist']:.3e} from float64 (median), past "
           f"{WHOLE_GRAD_MULT} x the CPU float32's")
    ctc_weight = model.ctc_weight
    for m in (model, cpu):
        m.ctc_weight = 1.0
    try:
        out = hold_with_control(torch, model, cpu, on_card, on_cpu,
                                f"{tag} encoder + CTC",
                                ("ctc_loss", "ctc_loss_bwd"))
    finally:
        for m in (model, cpu):
            m.ctc_weight = ctc_weight
    model.eval()
    out["whole_microstep"] = whole
    out["launches"] = counts
    return out


def lc_stream_decode(torch, model, conf: dict, xs, xlens, tag,
                     attention_beam: bool = False) -> dict:
    """``decode_streaming`` of phase 3's utterances one at a time, counts
    zeroed around them: RTF, wall per block, resets, commits. The MoChA
    block-synchronous beam must run only where ``attention_beam`` (JAX's
    dispatch: never with an RNN encoder, ROADMAP C30)."""
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    sess = Speech2TextSession(model, DecodeConfig(**conf))
    hop = model.encoder.block_input_frames()[1]
    attention = []
    real = Speech2TextSession.decode_streaming_attention

    def spy(self, *a, **kw):
        attention.append(1)
        return real(self, *a, **kw)

    with mock.patch.object(Speech2TextSession, "decode_streaming_attention",
                           spy):
        sess.decode_streaming(xs[0, :3 * hop])    # warm-up, not counted
        reset_launches()
        rows = []
        t0 = time.perf_counter()
        for i, n in enumerate(xlens):
            t = time.perf_counter()
            hyp, stats = sess.decode_streaming(xs[i, :int(n)])
            wall = time.perf_counter() - t
            n_blocks = -(-int(n) // hop)
            rows.append({"frames": int(n), "hyp_len": len(hyp),
                         "wall_s": wall,
                         "wall_ms_per_block": wall * 1e3 / n_blocks,
                         "rtf": stats["rtf"],
                         "n_resets": stats["n_resets"],
                         "commits": len(stats.get("commits", []))})
            expect(all(isinstance(y, int) and 0 <= y < model.dec_fwd.vocab
                       for y in hyp), f"{tag} streaming hypothesis {hyp}")
            log(f"[{tag}] decode_streaming {n} frames ({n_blocks} blocks of "
                f"{hop}): hyp len {len(hyp)}, RTF {stats['rtf']:.4f}, "
                f"{rows[-1]['wall_ms_per_block']:.1f} ms of wall per block, "
                f"resets {stats['n_resets']}")
        wall = time.perf_counter() - t0
    counts = launches()
    expect(bool(attention) == attention_beam,
           f"{tag}: the MoChA streaming beam ran {len(attention)} times")
    log(f"[{tag}] decode_streaming of {len(xlens)} utterances: wall "
        f"{wall:.2f} s; launches {counts}")
    return {"utterances": rows, "wall_s": wall, "launches": counts,
            "rtf": wall / (float(sum(xlens)) * FRAME_SEC)}


def lc_encoder_against_loop(torch, model, args, xs, xlens, tag) -> dict:
    """The LC-BLSTM encoder on cuDNN against its layers' written-out loops
    (``forward_ref``) on phase 3's utterances, within RNN_ENCODER_ATOL, and
    the same cuDNN encoder with TF32 on as the control that must exceed
    it; then the streamed encoder (``streaming_step`` over the 1600-frame
    utterance's blocks, the carries chained) on the card against the same
    chain on the CPU port (float32), outputs and carries within
    RNN_ENCODER_ATOL. Each layer's two directions must each hold their
    weights in a cuDNN buffer of their own (the buffer begins with the
    direction's first weight), so that no call copies them."""
    from neural_sp_tpu_torch.frontends.streaming import StreamingDriver
    from neural_sp_tpu_torch.models.encoders.rnn import LCBLSTMLayer
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    dev = next(model.parameters()).device
    for name, m in model.named_modules():
        if isinstance(m, LCBLSTMLayer):
            for d in (0, 4):
                ws = m.lstm._flat_weights[d:d + 4]
                base = ws[0].untyped_storage().data_ptr()
                expect(ws[0].data_ptr() == base and all(
                    w.untyped_storage().data_ptr() == base for w in ws),
                    f"{tag}: {name}'s {('forward', 'backward')[d // 4]} "
                    f"direction's weights do not begin a buffer of their "
                    f"own: cuDNN copies them at every call")
    x = torch.from_numpy(xs).to(dev)
    xl = torch.from_numpy(xlens).to(dev)
    out = {}
    with torch.inference_mode():
        t0 = time.perf_counter()
        e = model.encode(x, xl)[0]["ys"]["xs"]
        torch.cuda.synchronize()
        out["encode_batch_s"] = time.perf_counter() - t0
        with mock.patch.object(LCBLSTMLayer, "forward",
                               LCBLSTMLayer.forward_ref):
            t0 = time.perf_counter()
            e_ref = model.encode(x, xl)[0]["ys"]["xs"]
            torch.cuda.synchronize()
            out["encode_batch_loop_s"] = time.perf_counter() - t0
        torch.backends.cudnn.allow_tf32 = True
        try:
            e_tf32 = model.encode(x, xl)[0]["ys"]["xs"]
        finally:
            torch.backends.cudnn.allow_tf32 = False
    expect(bool(torch.isfinite(e).all()), f"{tag} encoder output not finite")
    out["encoder_max_abs_err"] = max_err(e, e_ref)
    out["encoder_tf32_max_abs_err"] = max_err(e_tf32, e_ref)
    log(f"[{tag}] LC-BLSTM encoder {tuple(e.shape)}: "
        f"{out['encode_batch_s']:.4f} s (cuDNN), "
        f"{out['encode_batch_loop_s']:.4f} s (the written-out loops); cuDNN "
        f"vs the loops max_abs_err {out['encoder_max_abs_err']:.3e} (limit "
        f"{RNN_ENCODER_ATOL:.0e}), with TF32 on "
        f"{out['encoder_tf32_max_abs_err']:.3e}")
    expect(out["encoder_max_abs_err"] <= RNN_ENCODER_ATOL,
           f"{tag} cuDNN LC-BLSTM vs its loops: {out['encoder_max_abs_err']}")
    expect(out["encoder_tf32_max_abs_err"] > RNN_ENCODER_ATOL,
           f"{tag}: the TF32 control is within {RNN_ENCODER_ATOL}")
    # the streamed encoder: the card's chain against the CPU port's
    cpu = build_speech2text(args, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu.eval()
    enc = model.encoder
    total, hop = enc.block_input_frames()
    n = int(xlens[-1])
    carry = carry_ref = None
    errs, carry_errs = [], []
    with torch.inference_mode():
        for blk, _, _ in StreamingDriver(xs[-1, :n], total, hop,
                                         enc.stream_geometry()[1]):
            b = torch.from_numpy(blk)[None]
            o, carry = enc.streaming_step(b.to(dev), carry)
            o_ref, carry_ref = cpu.encoder.streaming_step(b, carry_ref)
            errs.append(max_err(o.cpu(), o_ref))
            carry_errs.append(max(
                max_err(a.cpu(), r) for layer, layer_ref in zip(
                    carry, carry_ref) for a, r in zip(layer, layer_ref)))
    del cpu
    out["stream_blocks"] = len(errs)
    out["stream_max_abs_err"] = max(errs)
    out["stream_carry_max_abs_err"] = max(carry_errs)
    log(f"[{tag}] streaming_step over {len(errs)} blocks of {total} input "
        f"frames ({n} frames): the card against the CPU port max_abs_err "
        f"{max(errs):.3e} (outputs), {max(carry_errs):.3e} (carries)")
    expect(max(errs) <= RNN_ENCODER_ATOL and
           max(carry_errs) <= RNN_ENCODER_ATOL,
           f"{tag} streaming_step chain: card vs CPU {max(errs)} / "
           f"{max(carry_errs)}")
    return out


def phase_transducer(torch, rng, root: Path, xs, xlens) -> dict:
    """12: K5 against its twin (``RNNT_KERNEL_SHAPES``); (12a) the
    LC-BLSTM-RNN-T (``RNNT_CONF``, V 1,000) serves phase 3's utterances,
    greedy and beam 10 (tsd), and streams each through ``decode_streaming``
    (the mono beam), counts zeroed around each (no kernel of the port
    serves it: cuDNN and PyTorch ops); its encoder held to the written-out
    loops and its ``streaming_step`` chain to the CPU port's; a B = 4
    microstep held to float64 by 9b's rule (K5 and K4 must run); the train
    CLI for one epoch (one update) on a V = 1,000 corpus, the eval CLI with
    beam 10 and streaming. (12b) the LC-BLSTM-MoChA (``LC_MOCHA_CONF``, at
    RNN_DEPTH, V 10,000) served (beam 10 + CTC 0.3, greedy), streamed (the
    CTC block-synchronous beam: JAX's dispatch for an RNN encoder, C30)
    and its microstep held as 11d's (``hold_to_float64``). Walls per
    sub-phase."""
    t = time.perf_counter()
    walls = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        result = fn(*a, **kw)
        walls[name] = time.perf_counter() - t0
        log(f"[{name}] wall {walls[name]:.1f} s")
        return result

    def kernels():
        res = {}
        record = kernel_recorder(res, "12")
        for shape in RNNT_KERNEL_SHAPES:
            rnnt_case(torch, rng, record, *shape)
        return res

    out = {"kernels": timed("12 kernels", kernels)}
    args = lc_args(RNNT_CONF, RNNT_VOCAB)
    model = lc_model(torch, args)
    out["parameters"] = sum(p.numel() for p in model.parameters())
    log(f"[12a] LibriSpeech LC-BLSTM-RNN-T: {out['parameters']} parameters "
        f"on the card (V {RNNT_VOCAB})")
    served, counts = timed("12a serve", phase_serve, torch, model, xs, xlens,
                           tuple(RNNT_SERVED), tag="12a", table=RNNT_SERVED)
    served["launches"] = counts
    expect(not any(counts.values()),
           f"a kernel launched serving the transducer: {counts}")
    out["serve"] = served
    out["stream"] = timed("12a stream", lc_stream_decode, torch, model,
                          dict(beam_width=10), xs, xlens, "12a")
    out["encoder"] = timed("12a encoder", lc_encoder_against_loop, torch,
                           model, args, xs, xlens, "12a")
    out["hold"] = timed("12a hold", hold_to_float64, torch, model, args, xs,
                        xlens, "12a")
    for name in RNNT_TRAIN_KERNELS:
        expect(out["hold"]["launches"][name] > 0,
               f"{name} never launched in 12a's microstep")
    # K5's launches per microstep: 12a's held microstep is one, its counts
    # zeroed just before it
    out["k5_per_step"] = {name: out["hold"]["launches"][name]
                          for name in ("rnnt_loss", "rnnt_loss_bwd")}
    del model
    torch.cuda.empty_cache()
    corpus = synth_corpus(root / "data_v1000", CLI_UTTS, RNNT_VOCAB)
    out["cli"] = timed("12a CLIs", stream_cli, torch, root, corpus,
                       RNNT_CONF, "12a", True, RNNT_EVAL, RNNT_TRAIN_KERNELS,
                       lm=False)
    # and the train CLI's backward launches per microstep (its forward
    # ones count the dev batch's too)
    train = out["cli"]["train"]
    out["k5_per_step"]["rnnt_loss_bwd_cli"] = \
        train["launches"]["rnnt_loss_bwd"] / train["microsteps"]
    log(f"[12a] K5 launches per microstep: {out['k5_per_step']}")
    expect(all(v == 1 for v in out["k5_per_step"].values()),
           f"12a: K5 launched other than once per microstep and direction: "
           f"{out['k5_per_step']}")

    args_b = lc_args(LC_MOCHA_CONF, CLI_VOCAB, RNN_DEPTH)
    model = lc_model(torch, args_b)
    mocha = {"parameters": sum(p.numel() for p in model.parameters())}
    log(f"[12b] LC-BLSTM-MoChA at {RNN_DEPTH} of 5 layers: "
        f"{mocha['parameters']} parameters on the card")
    served, counts = timed("12b serve", phase_serve, torch, model, xs, xlens,
                           ("beam10_ctc0.3", "greedy"), tag="12b")
    served.pop("best_hyp0")
    served["launches"] = counts
    mocha["serve"] = served
    mocha["stream"] = timed("12b stream", lc_stream_decode, torch, model,
                            dict(beam_width=10, ctc_weight=0.3), xs, xlens,
                            "12b")
    mocha["hold"] = timed("12b hold", hold_to_float64, torch, model, args_b,
                          xs, xlens, "12b")
    del model
    torch.cuda.empty_cache()
    out["mocha"] = mocha
    cli = out["cli"]
    paths = [out["serve"]["launches"], out["stream"]["launches"],
             out["hold"]["launches"], cli["train"]["launches"],
             cli["eval_beam10"]["launches"], cli["eval_streaming"]["launches"],
             mocha["serve"]["launches"], mocha["stream"]["launches"],
             mocha["hold"]["launches"]]
    out["launches"] = {name: sum(p[name] for p in paths)
                       for name in paths[0]}
    log(f"[12] launches on phase 12's path: {out['launches']}")
    expect(all(out["launches"][k] == 0 for k in NOT_ON_MOCHA_PATH),
           f"K1 / K1b / K2 / K3 / K3b launched on phase 12's path")
    for name in RNNT_TRAIN_KERNELS:
        expect(out["launches"][name] > 0,
               f"{name} never launched on phase 12's path")
    out["phase_wall_s"] = time.perf_counter() - t
    out["sub_phase_wall_s"] = walls
    log(f"[12] phase 12 wall {out['phase_wall_s']:.1f} s")
    return out


# Phase 13: the language-model stage of the recipes (stage 3 trains an LM
# with the LM train CLI, stage 5 decodes with it) through the port's LM
# CLIs, at the recipe confs' full width and depth in float32, on a
# synthesized text corpus over phase 7's 10k-word dictionary.
LM_XL_CONF = "examples/swbd/conf/lm/transformer_xl.yaml"
LM_CONFS = {"transformer": "examples/swbd/conf/lm/transformerlm.yaml",
            "gated_conv": "examples/wsj/conf/lm/gated_convlm.yaml",
            "rnnlm": "examples/librispeech/conf/lm/rnnlm_6L.yaml"}
# rows of 90-110 words: the train set gives the XL (B 24, bptt 200) 9
# windows, the Transformer LM (B 32) 7, the GCNN (B 50) 5 and rnnlm_6L
# (B 128) 2; the dev set the XL 2 windows
LM_TEXT_ROWS = {"train": 440, "dev": 100}
LM_TRAIN = ("--n_epochs", "1", "--unit", "word", "--print_step", "1")
LM_CACHE = ("--recog_n_caches", "100")
# 13k: K1 / K1b at the XL's training shape: B 24, H 8, a 200-token
# segment against 200 tokens of memory and its own 200 keys (the causal
# window), dk 64, R = Tk (unclamped); with the recipes' dropout_att 0.1 on
# given key words
LM_K_SHAPE = dict(b=24, h=8, tq=200, tt=400, dk=64, r=400)
LM_DROPOUT = (0.1, (0x2545F491, 0x9E3779B9))
XL_ZERO_GRAD_LEAF = ".self_attn.w_key.bias"
# the counters the XL's train CLI must move: K1 / K1b with dropout in its
# training windows, K1 over the memory without dropout in its dev windows
# (K1b without dropout over the memory runs on no recipe's path: every XL
# conf sets dropout_att)
XL_KERNELS = ("rel_attention", "rel_attention_offset",
              "rel_attention_dropout", "rel_attention_bwd",
              "rel_attention_bwd_dropout")


def synth_text(root: Path, rows: dict, dict_path: str, seed: int = 1
               ) -> dict:
    """Text TSVs (utt_id, speaker, text, token_id) of ``rows`` rows of
    90-110 words each, drawn uniformly from ``dict_path``'s words."""
    import numpy as np
    rng = np.random.default_rng(seed)
    words = [line.split()[0] for line in
             Path(dict_path).read_text().splitlines()]
    root.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, n in rows.items():
        lines = ["utt_id\tspeaker\ttext\ttoken_id"]
        for i in range(n):
            ids = rng.integers(0, len(words), int(rng.integers(90, 111)))
            lines.append("\t".join((
                f"{name}_{i:04d}", f"spk{i % 4}",
                " ".join(words[j] for j in ids),
                " ".join(str(j + 4) for j in ids))))
        paths[name] = str(root / f"{name}.tsv")
        Path(paths[name]).write_text("\n".join(lines) + "\n")
    return paths


def phase_lm_kernels(torch, rng) -> dict:
    """13k: K1 and K1b over the XL's memory (``LM_K_SHAPE``, the causal
    window, Tq 200 < Tk 400), without and with dropout of the attention
    probabilities, each against its plain version (KERNEL_ATOL,
    TRAIN_KERNEL_TOL), timed in turns with efficient SDPA (its dropout_p
    at the same rate) and its backward, with the bound of the window's
    work (``window_case``)."""
    s = LM_K_SHAPE
    kl = [s["tt"]] * s["b"]
    return {name: window_case(torch, rng, s["b"], s["h"], s["tt"], s["dk"],
                              s["r"], kl, CAUSAL_WINDOW, "13k", tq=s["tq"],
                              dropout=drop)
            for name, drop in (("memory", None), ("dropout", LM_DROPOUT))}


def lm_args(conf: str, vocab: int):
    from types import SimpleNamespace
    import yaml
    return SimpleNamespace(**yaml.safe_load((ROOT / conf).read_text()),
                           vocab=vocab)


def xl_microstep(torch, lm, xi, xo, mems, seed=None, plain=False,
                 kept=None, pins=None):
    """(loss, {leaf: gradient}) of one window with the memories ``mems``,
    in the mode ``lm`` is in (``train()``: dropout keys from a generator
    seeded ``seed``), through K1 / K1b or, with ``plain``, their plain
    versions patched in; each ReLU FFN's pre-activation kept in ``kept``,
    and with ``pins`` its ReLU mask pinned to ``pins[name]``."""
    from contextlib import ExitStack
    from neural_sp_tpu_torch.models.modules import \
        relative_multihead_attention as rma
    lm.zero_grad(set_to_none=True)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    ffns = relu_ffns(torch, lm)
    with ExitStack() as stack:
        if plain:
            stack.enter_context(mock.patch.object(
                rma, "rel_attention", plain_rel_attention(torch)))
        if kept is not None:
            for handle in keep_pre_activations(ffns, kept):
                stack.callback(handle.remove)
        for n, m in ffns.items() if pins is not None else ():
            stack.enter_context(mock.patch.object(
                m, "act", lambda x, keep=pins[n]: x * keep))
        loss, _, _ = lm(xi, xo, mems, gen)
        loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in lm.named_parameters()}
    lm.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def phase_xl_hold(torch, rng) -> dict:
    """13a: the swbd Transformer-XL conf at full width and depth (seeded,
    V 10,000): a window with the memory of the window before it (K1 / K1b
    at Tq 200 < Tk 400), its loss and every gradient through the kernels
    against the same with the plain versions patched in, in ``eval()``
    mode and in ``train()`` mode (dropout on, the same generator seed, so
    the same masks on both sides). The FFNs' ReLU masks flip where a
    pre-activation lies within float32's error of 0, and a flipped
    position moves its w1 row's gradient by a token's share (the first
    run on the card: 4.8 of phase 6's rule at ``ff.w1``, the loss the
    same bits). So, as 10b, the pre-activations of the two runs must
    agree within ``XF_PRE_RTOL`` of their layer's max, the unpinned
    reading is logged, and the plain microstep is run again with every
    ReLU mask pinned to the kernels' run's and held to it by phase 6's
    rule."""
    from neural_sp_tpu_torch.models.lm.build import build_lm
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    from neural_sp_tpu_torch.utils.init_params import init_params
    args = lm_args(LM_XL_CONF, CLI_VOCAB)
    lm = init_params(build_lm(args), SEED + 5)
    out = {"parameters": sum(p.numel() for p in lm.parameters())}
    log(f"[13a] swbd Transformer-XL: {out['parameters']} parameters on the "
        f"card")

    def window():
        return tuple(torch.from_numpy(rng.integers(
            4, CLI_VOCAB, (args.batch_size, args.bptt))).to(DEVICE)
            for _ in range(2))
    with torch.no_grad():
        lm.eval()
        _, mems, _ = lm(*window())
    xi, xo = window()
    for mode, seed in (("eval", None), ("train", SEED)):
        lm.train(mode == "train")
        reset_launches()
        kept, kept_ref = {}, {}
        loss, grads = xl_microstep(torch, lm, xi, xo, mems, seed, kept=kept)
        torch.cuda.synchronize()
        counts = launches()
        unpinned = microstep_errors(loss, grads, *xl_microstep(
            torch, lm, xi, xo, mems, seed, plain=True, kept=kept_ref),
            zero_leaf=XL_ZERO_GRAD_LEAF)
        worst = max(unpinned["leaves"].items(), key=lambda kv: kv[1][0])
        flips = {n: int(((kept[n] > 0) != (kept_ref[n] > 0)).sum())
                 for n in kept}
        pre_err = max(float((kept[n] - kept_ref[n]).abs().max()
                            / kept_ref[n].abs().max()) for n in kept)
        log(f"[13a {mode}] unpinned: loss rel {unpinned['loss_rel_err']:.2e},"
            f" worst leaf {worst[0]} {worst[1][0]:.3f} of phase 6's rule; "
            f"{sum(flips.values())} of "
            f"{sum(k.numel() for k in kept.values())} ReLU pre-activations "
            f"flip sign, the largest pre-activation error {pre_err:.2e} of "
            f"its layer's max")
        expect(pre_err <= XF_PRE_RTOL, f"13a {mode}: pre-activations part "
               f"by {pre_err:.2e} of their max")
        pins = {n: (k > 0).to(k.dtype) for n, k in kept.items()}
        loss_ref, grads_ref = xl_microstep(torch, lm, xi, xo, mems, seed,
                                           plain=True, pins=pins)
        expect(launches() == counts, "13a: a kernel launched in the plain "
               "microstep")
        held = hold_microstep(loss, grads, loss_ref, grads_ref,
                              f"13a {mode}", zero_leaf=XL_ZERO_GRAD_LEAF)
        held.update(unpinned_worst_grad=worst[1][0],
                    unpinned_worst_grad_leaf=worst[0],
                    unpinned_loss_rel_err=unpinned["loss_rel_err"],
                    relu_flips=sum(flips.values()), pre_rel_err=pre_err)
        del kept, kept_ref, pins
        # with dropout every launch is the dropout instantiation's, without
        # it the one over the memory
        on, off = ("dropout", "offset") if mode == "train" else \
            ("offset", "dropout")
        for name in ("rel_attention", "rel_attention_bwd"):
            for counter, n in ((name, args.n_layers),
                               (f"{name}_{on}", args.n_layers),
                               (f"{name}_{off}", 0)):
                expect(counts[counter] == n, f"13a {mode}: {counter} "
                       f"launched {counts[counter]} times")
        out[mode] = {**held, "launches": counts}
    del lm, grads, grads_ref
    torch.cuda.empty_cache()
    return out


def lm_cli(torch, root: Path, text: dict, dict_path: str, name: str,
           conf: str, resume: bool = False, cache: bool = False) -> dict:
    """The LM train CLI on ``conf`` for one epoch (and with ``resume`` a
    second, resumed from the first's checkpoint), then the eval CLI on the
    dev set (and with ``cache`` again with the cache model), counts zeroed
    around each run; the dev and eval PPLs finite."""
    import csv
    import math
    from neural_sp_tpu_torch.bin.lm import eval as lm_eval
    from neural_sp_tpu_torch.bin.lm import train as lm_train
    from neural_sp_tpu_torch.datasets.lm import LMDataset
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    args = lm_args(conf, CLI_VOCAB)
    exp = str(root / f"lm_{name}")
    data = ["--train_set", text["train"], "--dev_set", text["dev"],
            "--dict", dict_path, "--model_save_dir", exp]
    windows = len(LMDataset(text["train"], dict_path, "word",
                            batch_size=args.batch_size, bptt=args.bptt))
    out = {"conf": conf, "train_windows": windows,
           "dev_windows": len(LMDataset(text["dev"], dict_path, "word",
                                        batch_size=args.batch_size,
                                        bptt=args.bptt))}

    def run(what, fn, argv):
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        res = fn(argv)
        torch.cuda.synchronize()
        out[what] = {"wall_s": time.perf_counter() - t,
                     "launches": launches()}
        return res

    run("train", lm_train.main, ["--config", str(ROOT / conf)] + data
        + list(LM_TRAIN))
    if resume:
        run("resumed", lm_train.main, [
            "--config", f"{exp}/conf.yml", "--n_epochs", "2", "--resume",
            f"{exp}/ckpt.epoch-1"] + data)
    with open(f"{exp}/history.csv") as f:
        history = [(int(r["epoch"]), float(r["train_loss"]),
                    float(r["dev_ppl"])) for r in csv.DictReader(f)]
    expect([e for e, _, _ in history] == ([1, 2] if resume else [1]),
           f"13 {name}: epochs {history}")
    expect(all(math.isfinite(x) for _, loss, ppl in history
               for x in (loss, ppl)), f"13 {name}: history {history}")
    out["history"] = history
    for what, extra in (("eval", ()), ("eval_cache", LM_CACHE)):
        if what == "eval_cache" and not cache:
            continue
        (res,) = run(what, lm_eval.main, [
            "--recog_model", exp, "--recog_sets", text["dev"]]
            + list(extra)).values()
        expect(math.isfinite(res["ppl"]), f"13 {name} {what}: {res}")
        out[what].update(res)
    step_s = out["train"]["wall_s"] / windows
    log(f"[13] {name} ({conf}): {windows} train windows, "
        f"{out['train']['wall_s']:.1f} s with the build and dev set "
        f"({step_s:.3f} s per window), history (epoch, train loss, dev "
        f"ppl) {history}, eval PPL {out['eval']['ppl']:.1f}"
        + (f", with the cache {out['eval_cache']['ppl']:.1f}" if cache
           else ""))
    return out


def phase_lm(torch, rng, root: Path, corpus: dict) -> dict:
    """13: the LM stage. 13k the kernels over the XL's memory; 13a the
    swbd Transformer-XL held to the plain versions, then through both LM
    CLIs (one epoch, a resumed second, the eval CLI with and without the
    cache model): K1 and K1b against the memory and with dropout must run
    in training, K1 against the memory in evaluation; 13b the swbd
    Transformer LM, the WSJ GCNN-14B and LibriSpeech's rnnlm_6L through
    both CLIs (no kernel of the repo on their paths); 13c phase 7's trained
    model decoded by the ASR eval CLI as stage 5 with 13a's XL as its LM
    (beam 10 + CTC 0.3 + LM 0.5, length norm, 2 averaged epochs): K1
    against the growing memory, one query per step."""
    from neural_sp_tpu_torch.bin.asr import eval as cli_eval
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    walls = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        result = fn(*a, **kw)
        walls[name] = time.perf_counter() - t0
        log(f"[{name}] wall {walls[name]:.1f} s")
        return result

    out = {"kernels": timed("13k", phase_lm_kernels, torch, rng)}
    out["hold"] = timed("13a hold", phase_xl_hold, torch, rng)
    text = synth_text(root / "lm_text", LM_TEXT_ROWS, corpus["dict"])
    xl = timed("13a CLIs", lm_cli, torch, root, text, corpus["dict"],
               "transformer_xl", LM_XL_CONF, resume=True, cache=True)
    for run in ("train", "resumed"):
        for name in XL_KERNELS:
            expect(xl[run]["launches"][name] > 0,
                   f"13a {run}: {name} never launched")
    for run in ("eval", "eval_cache"):
        expect(xl[run]["launches"]["rel_attention_offset"] > 0,
               f"13a {run}: K1 never launched against the memory")
        expect(xl[run]["launches"]["rel_attention_dropout"] == 0,
               f"13a {run}: dropout in evaluation")
    out["transformer_xl"] = xl
    for name, conf in LM_CONFS.items():
        res = timed(f"13b {name}", lm_cli, torch, root, text, corpus["dict"],
                    name, conf)
        for run in ("train", "eval"):
            expect(not any(res[run]["launches"].values()),
                   f"13b {name} {run}: a kernel launched: "
                   f"{res[run]['launches']}")
        out[name] = res
        torch.cuda.empty_cache()

    def fusion():
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        res = cli_eval.main([
            "--recog_model", str(root / "exp"), "--recog_sets",
            corpus["test"], "--recog_lm", str(root / "lm_transformer_xl"),
            "--recog_dir", str(root / "decode_xl")] + list(CLI_EVAL))
        torch.cuda.synchronize()
        (m,) = res.values()
        hyps = (root / "decode_xl" / "test" / "hyp.trn").read_text()
        return {**m, "wall_s": time.perf_counter() - t,
                "launches": launches(),
                "hyp_tokens": [len(h.rsplit(" (", 1)[0].split())
                               for h in hyps.splitlines()]}
    fused = timed("13c", fusion)
    log(f"[13c] eval CLI with the XL LM: RTF {fused['rtf']:.4f}, wall "
        f"{fused['wall_s']:.1f} s, hypothesis lengths {fused['hyp_tokens']}, "
        f"launches {fused['launches']}")
    expect(fused["n_utts"] == CLI_UTTS["test"], f"13c: {fused['n_utts']}")
    for name in ("rel_attention_offset", "las_step"):
        expect(fused["launches"][name] > 0, f"13c: {name} never launched")
    out["fusion"] = fused
    paths = [xl[r]["launches"] for r in ("train", "resumed", "eval",
                                         "eval_cache")] + \
        [out[n][r]["launches"] for n in LM_CONFS for r in ("train", "eval")] \
        + [fused["launches"]]
    out["launches"] = {name: sum(p[name] for p in paths) for name in paths[0]}
    out["walls_s"] = walls
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (PACKAGE / "ops" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {PACKAGE} not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    walls = {}
    clock = [time.perf_counter()]

    def wall(name: str) -> None:
        """The wall since the last phase ended, logged on its own line."""
        now = time.perf_counter()
        walls[name] = now - clock[0]
        clock[0] = now
        log(f"[{name}] phase {name} wall {walls[name]:.1f} s")

    build_sec = phase_build()
    wall("1")
    rng = np.random.default_rng(SEED)
    kernels = phase_kernels(torch, rng)
    wall("2")
    model = flagship_model(torch)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[3] flagship faithful model: {n_params} parameters on the card")
    xs, xlens = utterances(rng)
    served, counts = phase_serve(torch, model, xs, xlens)
    launches = {k: counts[k] for k in ("rel_attention", "las_step")}
    expect(all(v > 0 for v in launches.values()),
           f"a kernel of the path never launched: {launches}")
    breakdown = phase_breakdown(torch, model, xs, xlens)
    wall("3")
    served_lm, lm_launches = phase_serve_lm(torch, model, xs, xlens)
    wall("3c")
    # K1's and K2's launches: the served requests of phases 3 and 3c
    launches = {k: n + lm_launches[k] for k, n in launches.items()}
    enc_err, dec_err, k2_per_step = phase_twins(torch, model, xs, xlens,
                                                served["best_hyp0"])
    wall("4")
    train_kernels = phase_train_kernels(torch, rng)
    kernels["rel_attention"]["shapes"] += train_kernels.pop(
        "rel_attention_train_shapes")
    kernels.update(train_kernels)
    kernels.update(phase_train_kernels_bf16(torch, rng))
    wall("2b")
    batch = train_batch(torch, rng)
    trained, train_launches = phase_train(torch, model, batch)
    trained_bf16, bf16_launches = phase_train(torch, model, batch,
                                              "bfloat16")
    wall("5")
    parity, plain32 = phase_train_parity(torch, model, batch)
    parity["determinism"] = phase_determinism(torch, model, batch)
    parity_bf16 = phase_train_parity_bf16(torch, model, batch, plain32)
    del plain32
    parity["fixed_batch_losses"] = phase_fit(torch, model, batch)
    parity_bf16["fixed_batch_losses"] = phase_fit(
        torch, model, batch, torch.bfloat16, tag="6b")
    wall("6")
    sampling_times = phase_sampling_times(torch, model, batch)
    wall("5s")
    del model, batch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="nsp_cli_") as tmp:
        root = Path(tmp)
        t = time.perf_counter()
        corpus = synth_corpus(root / "data", CLI_UTTS, CLI_VOCAB)
        corpus_s = time.perf_counter() - t
        t = time.perf_counter()
        cli = phase_cli(torch, root, corpus)
        cli.update(corpus_s=corpus_s, phase_wall_s=time.perf_counter() - t)
        wall("7")
        sampled_cli = phase_sampled_cli(torch, root, corpus)
        wall("7b")
        blstm = phase_blstm(torch, rng, root, corpus, xs, xlens)
        wall("8")
        mocha = phase_mocha(torch, root, corpus, xs, xlens)
        wall("9")
        xformer = phase_transformer(torch, root, corpus, xs, xlens)
        wall("10")
        streaming = phase_streaming(torch, rng, root, corpus, xs, xlens)
        wall("11")
        rnnt = phase_transducer(torch, rng, root, xs, xlens)
        wall("12")
        lm = phase_lm(torch, rng, root, corpus)
        wall("13")
    log(f"phase walls (s): {json.dumps(walls)}; total "
        f"{sum(walls.values()):.1f} s")
    # each kernel's launches from the main path it belongs to: the served
    # requests (K1, K2), the float32 training run (K1b, K3, K3b, K4) or
    # the bf16 training run (K1's and K1b's bf16 entries)
    bf16_names = TRAIN_KERNELS["bfloat16"]
    launches = {**train_launches, **launches,
                **{name: bf16_launches[name] for name in bf16_names}}
    # per encode (K1), per decode step (K2), per training microstep (the
    # rest)
    microsteps = 3 * ACCUM
    per_step = {name: n / microsteps for name, n in train_launches.items()}
    per_step.update({name: bf16_launches[name] / microsteps
                     for name in bf16_names},
                    rel_attention=breakdown["k1_launches_per_encode"],
                    las_step=k2_per_step)

    csrc = "neural_sp_tpu_torch/ops/kernels/csrc/"
    srcs = {"rel_attention": (
        csrc + "rel_attention.cu",
        "neural_sp_tpu/ops/rel_attention_pallas.py:61 (583dfc4~1)"),
        "rel_attention_bwd": (
        csrc + "rel_attention_bwd.cu",
        "neural_sp_tpu/ops/rel_attention_pallas.py:82 (583dfc4~1)"),
        "rel_attention_bf16": (
        csrc + "rel_attention.cu",
        "neural_sp_tpu/ops/rel_attention_pallas.py:61 (583dfc4~1)"),
        "rel_attention_bwd_bf16": (
        csrc + "rel_attention_bwd.cu",
        "neural_sp_tpu/ops/rel_attention_pallas.py:82 (583dfc4~1)"),
        "las_step": (
        csrc + "las_step.cu",
        "neural_sp_tpu/ops/las_scan_pallas.py:74 (63255ae~1)"),
        "las_scan": (
        csrc + "las_step.cu",
        "neural_sp_tpu/ops/las_scan_pallas.py:74 (63255ae~1)"),
        "las_scan_bwd": (
        csrc + "las_scan.cu",
        "neural_sp_tpu/ops/las_scan_pallas.py:154 (63255ae~1)"),
        "ctc_loss": (
        csrc + "ctc_loss.cu",
        "neural_sp_tpu/ops/ctc_pallas.py:39 and :120 (63255ae~1)")}
    details = {"card": card, "build_s": build_sec,
               "encoder_max_abs_err": enc_err,
               "decoder_max_abs_err": dec_err,
               "serve": {k: v for k, v in served.items() if k != "best_hyp0"},
               "serve_lm": served_lm,
               "breakdown": breakdown, "train": trained,
               "train_bf16": {**trained_bf16, "launches": bf16_launches},
               "train_parity": parity, "train_parity_bf16": parity_bf16,
               "sampling_times": sampling_times, "cli": cli,
               "cli_sampled": {**sampled_cli, "phase_wall_s": walls["7b"]},
               "blstm": blstm, "mocha": mocha,
               "transformer": xformer, "streaming": streaming,
               "transducer": rnnt, "lm": lm, "kernels": kernels,
               "phase_walls_s": walls}
    log(json.dumps(details))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "simt_bound_ms", "library_err", "peak_flops")
    entries = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "launches_per_step": per_step[name],
         **{key: kernels[name].get(key) for key in keys}}
        for name, (src, rep) in srcs.items()]
    # K2: its time is the workspace form's (the decode loops'); beside it
    # the checked call's and the kernels one step launches; in training,
    # scheduled sampling's pass 1 steps it U+1 times per microstep
    next(e for e in entries if e["name"] == "las_step").update(
        checked_call_ms=kernels["las_step"]["checked_call_ms"],
        kernels_per_step=kernels["las_step"]["kernels_per_step"],
        train_launches_per_microstep=sampling_times["pass1_k2_calls"])
    # K4's ms are forward + backward; its backward entry point counts apart
    next(e for e in entries if e["name"] == "ctc_loss")["bwd_launches"] = \
        launches["ctc_loss_bwd"]
    # phase 7's paths, each counted from zero: the train CLI, its resumed
    # epoch and the eval CLI
    cli_runs = {"train": cli["train"], "train_resumed": cli["train_resumed"],
                "eval": cli["eval"], "train_sampled": sampled_cli,
                "train_blstm": blstm["cli"]["train"],
                "eval_blstm": blstm["cli"]["eval"]}
    for e in entries:
        e["cli_launches"] = {k: r["launches"][e["name"]]
                             for k, r in cli_runs.items()}
    next(e for e in entries if e["name"] == "ctc_loss")[
        "cli_bwd_launches"] = {k: r["launches"]["ctc_loss_bwd"]
                               for k, r in cli_runs.items()}
    # K3, K3b: the kernels the per-step chain launched per call in the
    # training run; K3b: the wrapper's work after the loop (phase 2b)
    next(e for e in entries if e["name"] == "las_scan").update(
        kernel_launches_per_call=trained[
            "las_scan_kernel_launches_per_call"])
    next(e for e in entries if e["name"] == "las_scan_bwd").update(
        kernel_launches_per_call=trained[
            "las_scan_bwd_kernel_launches_per_call"],
        outside_ms=kernels["las_scan_bwd"]["outside_ms"])
    # K3, K3b at bf16 compute: the casts at their boundary
    for name in ("las_scan", "las_scan_bwd"):
        next(e for e in entries if e["name"] == name)[
            "bf16_boundary_cast_ms"] = kernels[name]["bf16_boundary_cast_ms"]
    # K1 / K1b bf16: their error against the plain float32 version, as a
    # multiple of the plain bf16 version's
    for name in bf16_names:
        next(e for e in entries if e["name"] == name)["vs_f32_ratio"] = max(
            row["vs_f32_ratio"] for row in kernels[name]["shapes"])
    # phase 8, the BLSTM-LAS: its main path's launches (the served
    # requests, the train CLI, the eval CLI, each counted from zero) and
    # the kernels at its shapes (K2 at N = 10 and T = 400, K3 / K3b at T up
    # to 500, K4 at T = 500; D = 1024)
    paths8 = (blstm["serve"]["launches"], blstm["cli"]["train"]["launches"],
              blstm["cli"]["eval"]["launches"])
    for e in entries:
        e["blstm_launches"] = sum(p[e["name"]] for p in paths8)
        row = blstm["kernels"].get(e["name"])
        if row is not None:
            e["blstm"] = {"shape": row.get("shapes", [{}])[0].get("shape"),
                          **{key: row.get(key) for key in keys}}
    # phase 9, the LSTM-MoChA: its main path's launches (the served
    # requests, the train CLI, the eval CLI, the ctc_sync microstep is not
    # counted): K4 alone
    paths9 = (mocha["serve"]["launches"], mocha["cli"]["train"]["launches"],
              mocha["cli"]["eval"]["launches"])
    for e in entries:
        e["mocha_launches"] = sum(p[e["name"]] for p in paths9)
    # phase 10, the Transformer and its MMA variant: their main paths'
    # launches (the served requests, the train CLIs, the eval CLIs): K4
    # alone, in training
    paths10 = (xformer["serve"]["launches"],
               xformer["cli"]["train"]["launches"],
               xformer["cli"]["eval"]["launches"],
               xformer["mma"]["serve"]["launches"],
               xformer["mma"]["cli"]["train"]["launches"],
               xformer["mma"]["cli"]["eval"]["launches"])
    for e in entries:
        e["transformer_launches"] = sum(p[e["name"]] for p in paths10)
    next(e for e in entries if e["name"] == "ctc_loss")[
        "transformer_bwd_launches"] = sum(p["ctc_loss_bwd"] for p in paths10)
    # phase 11, the streaming encoders: their main paths' launches (11a's
    # served requests, 11b's microstep, 11c's CLIs; 11d's streamed encoder,
    # microstep, decode_streaming and streaming eval CLI; 11e's microstep
    # and CLIs)
    cli11 = [streaming[k] for k in ("cli",)] + [streaming["stream"]["cli"],
                                               streaming["lc"]["cli"]]
    paths11 = [streaming["serve"]["launches"],
               streaming["hold"]["launches"],
               streaming["stream"]["against_offline"]["launches"],
               streaming["stream"]["hold"]["launches"],
               streaming["stream"]["decode"]["launches"]] + \
        [c["train"]["launches"] for c in cli11 if c["train"]] + \
        [v["launches"] for c in cli11 for k, v in c.items()
         if k.startswith("eval_")]
    streaming_launches = {name: sum(p[name] for p in paths11)
                          for name in paths11[0]}
    for e in entries:
        e["streaming_launches"] = streaming_launches[e["name"]]
    next(e for e in entries if e["name"] == "ctc_loss")[
        "streaming_bwd_launches"] = streaming_launches["ctc_loss_bwd"]
    # K1 / K1b with a window, and K1 against cached keys: the same sources
    # and entries, timed at phase 11's shapes (K1: the served batch, B 4,
    # T 800, causal; K1b: a training batch, B 32, T 800, causal; K1 against
    # cached keys: a streaming block, 8 queries against a full cache of 16
    # and the block)
    win = streaming["kernels"]
    rows11 = {"rel_attention_window": (
        "rel_attention", next(c["fwd"] for c in win["causal"]
                              if "B=4 " in c["fwd"]["shape"]
                              and "Tk=800" in c["fwd"]["shape"])),
        "rel_attention_bwd_window": (
        "rel_attention_bwd", next(c["bwd"] for c in win["causal"]
                                  if "bwd" in c and "B=32 " in c["bwd"][
                                      "shape"] and "Tk=800" in c["bwd"][
                                      "shape"] and "f32" in c["bwd"][
                                      "shape"])),
        "rel_attention_offset": (
        "rel_attention", next(c["fwd"] for c in win["offset"]
                              if "key_start=0 " in c["fwd"]["shape"]
                              and "f32" in c["fwd"]["shape"]))}
    for name, (base, row) in rows11.items():
        src, rep = srcs[base]
        cases = [c[part] for group in win.values() for c in group
                 for part in ("fwd", "bwd") if part in c
                 and (part == "bwd") == (base == "rel_attention_bwd")
                 and ("Tq=8 " in c[part]["shape"]) ==
                 (name == "rel_attention_offset")]
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": streaming_launches[name],
            **{key: row.get(key) for key in keys if key != "max_abs_err"},
            "max_abs_err": max(c["max_abs_err"] for c in cases
                               if "f32" in c["shape"]),
            "max_abs_err_bf16": max(c["max_abs_err"] for c in cases
                                    if "bf16" in c["shape"]),
            "shape": row["shape"]})
    for e in entries[-3:]:
        expect(e["launches"] > 0, f"{e['name']} never launched on phase "
               f"11's path")
    # phase 12, the LC-BLSTM-RNN-T and the LC-BLSTM-MoChA: their main
    # paths' launches (12a's served and streamed requests, microstep and
    # CLIs; 12b's served and streamed requests and microstep): K4 and K5
    for e in entries:
        e["transducer_launches"] = rnnt["launches"][e["name"]]
    # K5, the transducer's lattice loss: its row at the recipe's shape
    # (B 32, T 400, U 200), forward + backward; launches on phase 12's path
    k5 = rnnt["kernels"]["rnnt_loss"]
    entries.append({
        "name": "rnnt_loss", "route": "cuda", "source": csrc + "rnnt_loss.cu",
        "replaces": "neural_sp_tpu/ops/rnnt.py:119 (rnnt_alphas_from_pair, "
                    "plain JAX; upstream's warp_rnnt)",
        "launches": rnnt["launches"]["rnnt_loss"],
        "launches_per_step": rnnt["k5_per_step"]["rnnt_loss"],
        "bwd_launches_per_step": rnnt["k5_per_step"]["rnnt_loss_bwd"],
        **{key: k5.get(key) for key in keys},
        "bwd_launches": rnnt["launches"]["rnnt_loss_bwd"],
        "transducer_launches": rnnt["launches"]["rnnt_loss"],
        "shape": k5["shapes"][0]["shape"],
        "f32_recurrence_grad_err": k5.get("f32_recurrence_grad_err")})
    expect(entries[-1]["launches"] > 0, "K5 never launched on phase 12's "
           "path")
    # phase 13, the LM stage: its main paths' launches (13a's and 13b's
    # train and eval CLIs, 13c's fused eval CLI; 13a's held microsteps are
    # not counted); K1 / K1b over the XL's memory without dropout and with
    # dropout, each row its own instantiation's counter: the same sources
    # and entries, timed at 13k's shape, launched on phase 13's path, and
    # per training microstep as 13a's held one (``train()``, dropout on)
    # launched them. Training launches only the dropout instantiations
    # (every XL conf sets dropout_att), so K1b without dropout over the
    # memory launches on no path of the phase (0; held in 13k and by the
    # card's tests), and K1 without dropout over the memory in evaluation
    # only (its launches per dev window of the XL's eval CLI, whose first
    # window has no memory yet)
    for e in entries:
        e["lm_launches"] = lm["launches"][e["name"]]
    per_step = lm["hold"]["train"]["launches"]
    xl = lm["transformer_xl"]
    rows13 = {"rel_attention_memory": (
        "rel_attention", lm["kernels"]["memory"]["fwd"],
        "rel_attention_offset"),
        "rel_attention_dropout": (
        "rel_attention", lm["kernels"]["dropout"]["fwd"],
        "rel_attention_dropout"),
        "rel_attention_bwd_memory": (
        "rel_attention_bwd", lm["kernels"]["memory"]["bwd"],
        "rel_attention_bwd_offset"),
        "rel_attention_bwd_dropout": (
        "rel_attention_bwd", lm["kernels"]["dropout"]["bwd"],
        "rel_attention_bwd_dropout")}
    for name, (base, row, counter) in rows13.items():
        src, rep = srcs[base]
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": lm["launches"][counter],
            "launches_per_step": per_step[counter],
            **{key: row.get(key) for key in keys}, "shape": row["shape"]})
        if name != "rel_attention_bwd_memory":
            expect(entries[-1]["launches"] > 0,
                   f"{name} never launched on phase 13's path")
    entries[-4]["launches_per_eval_window"] = (
        xl["eval"]["launches"]["rel_attention_offset"] / xl["dev_windows"])
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
