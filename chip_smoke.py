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
     8 heads, d_ff 2048, bptt 200, mem_len 200, B 24; full width, depth
     cut to LM_XL_DEPTH, 46,107,648 parameters uncut): a window against
     the memory of the
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
     one query per step against the growing memory.
  14-16. MTL (14), attention dropout, TDS and the ``ci_test`` confs (15),
     trigger points (16): each function's docstring.
  17. MBR training, the relative transformer, bf16 attention dropout,
     ``resolving_unk`` (``phase_slice21``): (17k) K1 / K1b at R = T and
     their bf16 dropout instantiations, K3 / K3b at MBR's B.N rows and K2
     in its beam; (17a) the MBR conf through the train CLI with sub-step
     checkpoints and a resume, its n-best and microstep held to the CPU
     port, phase 8's BLSTM-LAS with MBR (its n-best's sequence scores
     through K3 / K3b held to the plain versions by phase 6's rule, then
     its MBR microstep); (17b) the timit relative transformer's microstep
     and CLIs; (17c) a bf16 microstep with ``dropout_att``; (17d)
     ``eval_word(resolving_unk=True)`` over 14a's model, its attention
     made to advance a frame a step, against the CPU port, with <unk>
     resolved at several peak frames. Each phase's wall is printed on a line
     of its own; the host-bound beams and eval CLIs run on fewer
     utterances (``HOST_UTTS``, ``EVAL_UTTS``) for the time limit.

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
CLI); phases 14-17's paths the same way, with rows of their own for each
instantiation they time (phase 17's: ``add_slice21_rows``). Prints the
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
import os
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


T_START = time.perf_counter()


def log(msg: str) -> None:
    """msg on a line of its own, after the seconds since the start."""
    print(f"{time.perf_counter() - T_START:7.1f} {msg}", flush=True)


# every sub-phase's wall, printed together at the end (``timed``)
SUB_WALLS: dict = {}


def timed(name: str, fn, *a, **kw):
    """fn(*a, **kw), its wall logged and kept in SUB_WALLS[name]."""
    t0 = time.perf_counter()
    result = fn(*a, **kw)
    SUB_WALLS[name] = time.perf_counter() - t0
    log(f"[{name}] wall {SUB_WALLS[name]:.1f} s")
    return result


def walls_since(mark: int) -> dict:
    """The sub-phase walls kept since SUB_WALLS held ``mark`` entries: a
    phase's own, read at its end."""
    return dict(list(SUB_WALLS.items())[mark:])


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


# ---- CPU references in a worker process ----------------------------------
# The holds of phases 9b, 11b, 11d, 11f, 12a, 12b, 16b and 18c compare the
# card's microstep with the same microstep on the CPU (float64, and float32
# where a gate reads it). Those CPU microsteps depend on nothing the card
# computes: the models are seeded (``init_params`` draws on the CPU in a
# fixed order, so one seed gives the card's weights) and the inputs are
# phase 3's utterances and seeded labels, which each hold and the worker
# take from one place (``reference_spec``). So a worker process, started
# once phase 3's beam step is timed (``start_references``), computes them
# while the card runs the phases before, each job writing its results to a
# file; a hold waits for its job only where it compares (``cpu_ref``). The
# worker's threads are REF_THREADS of the host's cores.
REF_THREADS = 4
REF_TAGS = ("9b", "11b", "11d", "12a", "12b", "16b", "18c")
REFS = None          # the CpuReferences of this run (``start_references``)


def reference_spec(torch, tag: str, xs, xlens) -> dict:
    """Hold ``tag``'s inputs and CPU reference, the one place the hold and
    the worker take them from: the model's ``args`` and ``seed`` (the
    card's model is the same seeded one), ``batch`` (x, xl, ys, ylens on
    the CPU in float32, what the hold gives the card; 16b's trigger points
    in ``trigger_points``) and the worker's ``runs`` by key (each a dtype,
    its batch and what else ``reference_job`` reads: a generator seed,
    labels, a ``ctc_weight``; or, kind "greedy", ``mocha_greedy`` on the
    weights moved by GREEDY_NOISE from ``noise_seed``)."""
    import numpy as np
    x, xl = torch.from_numpy(xs), torch.from_numpy(xlens)
    hx, hxl = map(torch.from_numpy, host_cut(xs, xlens))

    def labelled(vocab, bx, bxl, seed=SEED):
        ys, ylens = mocha_labels(torch, np.random.default_rng(seed + 9),
                                 vocab, len(bxl))
        return (bx, bxl, ys, ylens)

    def runs(batch, dtypes, **extra):
        """{key: run} of ``tag`` in each dtype ("float64 ctc": float64 with
        ``ctc_weight`` 1, the encoder and CTC head alone)."""
        return {f"{tag} {dt}": {"dtype": dt.split()[0], "batch": batch,
                                **extra, **({"ctc_weight": 1.0}
                                            if dt.endswith("ctc") else {})}
                for dt in dtypes}

    apart = ("float32", "float64", "float64 ctc")
    if tag == "9b":
        # the served utterances and labels, a second draw of both, and
        # greedy on the moved weights
        args = mocha_args()
        batch = labelled(args.vocab, x, xl)
        second = labelled(args.vocab, *map(torch.from_numpy, utterances(
            np.random.default_rng(SEED + 1))), SEED + 1)
        return {"args": args, "seed": SEED, "batch": batch, "runs": {
            "9b served": {"dtype": "float64", "batch": batch, "seed": SEED},
            "9b second_draw": {"dtype": "float64", "batch": second,
                               "seed": SEED + 1},
            "9b greedy": {"kind": "greedy", "dtype": "float64",
                          "noise_seed": SEED + 11, "batch": (x, xl)}}}
    if tag in ("11b", "11d", "18c"):
        make = {"11b": "librispeech_uni_conformer_mocha_args",
                "11d": "uni_conformer_mocha_streaming_args",
                "18c": XF_MMA_MAKE}[tag]
        args = xf_args(make)
        batch = labelled(args.vocab, *((hx, hxl) if tag == "18c"
                                       else (x, xl)))
        return {"args": args, "seed": SEED, "batch": batch, "runs": runs(
            batch, ("float64",) if tag == "11b" else apart)}
    if tag in ("12a", "12b"):
        args = lc_args(RNNT_CONF, RNNT_VOCAB) if tag == "12a" else \
            lc_args(LC_MOCHA_CONF, CLI_VOCAB, RNN_DEPTH)
        batch = labelled(args.vocab, *((hx, hxl) if tag == "12a"
                                       else (x, xl)))
        return {"args": args, "seed": SEED, "batch": batch, "runs": runs(
            batch, ("float64",) if tag == "12a" else apart)}
    if tag == "16b":
        # the MinLT conf's LSTM-MoChA with trigger points
        args, batch, tp = latency_batch(torch, xs, xlens)
        labels = {"labels": {"trigger_points": tp}}
        return {"args": args, "seed": SEED, "batch": batch,
                "trigger_points": tp, "runs": {
                    **runs(batch, ("float32", "float64"), **labels),
                    **{f"16b float64 ctc {w}": {
                        "dtype": "float64", "batch": batch, "ctc_weight": w,
                        **labels} for w in (0.0, 1.0)}}}
    raise KeyError(tag)


def reference_job(spec: dict, path: str) -> str:
    """In the worker: the model ``spec["args"]`` seeded ``spec["seed"]`` on
    the CPU, then each run of ``spec["runs"]`` (``reference_spec``'s),
    saved to ``path`` by key."""
    import torch
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.utils.init_params import init_params
    torch.set_num_threads(REF_THREADS)
    model = init_params(build_speech2text(spec["args"], device="cpu"),
                        spec["seed"])
    state32 = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}
    for key, run in spec["runs"].items():
        dt = torch.float64 if run["dtype"] == "float64" else torch.float32
        model.to(dt)
        if run.get("kind") == "greedy":
            g = torch.Generator().manual_seed(run["noise_seed"])
            model.load_state_dict({
                k: v + GREEDY_NOISE * torch.randn(v.shape, generator=g)
                for k, v in state32.items()})
            model.eval()
            x, xl = run["batch"]
            out[key] = mocha_greedy(torch, model, x.to(dt), xl)[0]
            continue
        if "ctc_weight" in run:
            model.ctc_weight = run["ctc_weight"]
        batch = tuple(x.to(dt) if x.is_floating_point() else x
                      for x in run["batch"])
        out[key] = mocha_microstep(torch, model, batch,
                                   run.get("seed", SEED),
                                   **run.get("labels", {}))
    torch.save(out, path)
    return path


def _reference_worker_init(root: str, cores: list) -> None:
    if root not in sys.path:
        sys.path.insert(0, root)
    if cores:
        os.sched_setaffinity(0, cores)


class CpuReferences:
    """The worker process and its jobs (``reference_spec``'s, in REF_TAGS'
    order), each a future of its results file in a temporary directory of
    its own; ``take(key)`` waits for the job that computes ``key`` and
    returns that result; ``close`` stops the worker and removes the
    directory. The worker runs on the last REF_THREADS of this process's
    cores."""

    def __init__(self, jobs: list):
        import concurrent.futures
        import multiprocessing
        self.dir = tempfile.TemporaryDirectory(prefix="nsp_refs_")
        out_dir = Path(self.dir.name)
        cores = sorted(os.sched_getaffinity(0))
        self.pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"),
            initializer=_reference_worker_init,
            initargs=(str(ROOT), cores[-REF_THREADS:]))
        self.jobs, self.loaded, self.waited = {}, {}, {}
        for i, spec in enumerate(jobs):
            future = self.pool.submit(reference_job, spec,
                                      str(out_dir / f"ref_{i}.pt"))
            for key in spec["runs"]:
                self.jobs[key] = future

    def take(self, key: str):
        import torch
        future = self.jobs[key]
        t0 = time.perf_counter()
        path = future.result()
        self.waited[key] = time.perf_counter() - t0
        if path not in self.loaded:
            self.loaded[path] = torch.load(path)
            Path(path).unlink()
        log(f"[refs] {key}: waited {self.waited[key]:.1f} s for the worker")
        return self.loaded[path][key]

    def close(self) -> None:
        procs = list(self.pool._processes.values())
        self.pool.shutdown(wait=False, cancel_futures=True)
        for proc in procs:
            proc.terminate()
            proc.join()
        self.dir.cleanup()


def start_references(torch, xs, xlens, tags=REF_TAGS) -> None:
    """The worker, computing the CPU references of ``tags``' holds on phase
    3's utterances; a phase driven alone starts it for its own tags."""
    global REFS
    REFS = CpuReferences([reference_spec(torch, tag, xs, xlens)
                          for tag in tags])


def cpu_ref(key: str):
    """The worker's CPU reference ``key`` (``start_references``)."""
    expect(REFS is not None and key in REFS.jobs,
           f"no reference worker computes {key}")
    return REFS.take(key)


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


def k2_case(torch, rng, n, tt, d, keep=False, tag="2", att=False,
            widths=(1024, 512, 10, 201), n_p=0):
    """K2 at N rows, T frames, encoder width d and ``widths`` (H, A, C, K),
    with a dropout scale ``keep`` (rate 0.1) or none, with ``att`` the
    attention weights' dropout scale [N, T] (rate 0.1; scheduled
    sampling's pass 1 with dropout_att), and with ``n_p`` the decoder's
    projection of that width (its p held too): both forms of the
    wrapper (the checked, allocating call and the workspace a decode loop
    steps through), without and with a beam's reorder, against the plain
    version (KERNEL_ATOL), the two forms equal bit for bit; CUDA-event
    times of the workspace form, the checked call and the plain version,
    and the bound; with ``att`` also the workspace form's time without
    the mask, in turns with it (``no_mask_ms``)."""
    from neural_sp_tpu_torch.ops.kernels import las_step, las_step_ref
    from neural_sp_tpu_torch.ops.kernels.las_step import (LasStepWorkspace,
                                                          las_step_cost)
    dev = torch.device("cuda")
    hd, a, c, kw = widths

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype("float32")).to(dev)

    keep = (torch.from_numpy((rng.random((n, hd)) >= 0.1).astype(
        "float32")) / 0.9).to(dev) if keep else None
    am = (torch.from_numpy((rng.random((n, tt)) >= 0.1).astype(
        "float32")) / 0.9).to(dev) if att else None
    aw_prev = torch.softmax(t(n, tt, scale=3.0), -1)
    args = (t(n, 4 * hd, scale=0.5), t(n, d), t(n, hd, scale=0.5),
            t(n, hd), aw_prev, t(d, 4 * hd, scale=(d + hd) ** -0.5),
            t(hd, 4 * hd, scale=(d + hd) ** -0.5), t(4 * hd, scale=0.1),
            t(a, n_p or hd, scale=(n_p or hd) ** -0.5),
            t(c, kw, scale=kw ** -0.5), t(a, c, scale=c ** -0.5),
            t(a, scale=a ** -0.5), t(n, tt, a), t(n, tt, d),
            torch.tensor([tt - 3 * i for i in range(n)],
                         dtype=torch.int32, device=dev))
    proj = (t(n_p, hd, scale=hd ** -0.5), t(n_p, scale=0.3)) if n_p else None
    ws = LasStepWorkspace(*args[5:], proj=proj)
    parent = torch.from_numpy(
        rng.integers(0, n, n).astype("int32")).to(dev)
    err = 0.0
    for par in (None, parent):
        refs = las_step_ref(*args, parent=par, keep=keep, att_keep=am,
                            proj=proj)
        outs = las_step(*args, parent=par, keep=keep, att_keep=am,
                        proj=proj)
        ws.load_carry(*args[1:5])
        ws.eg.copy_(args[0])
        if par is not None:
            ws.parent.copy_(par)
        stepped = ws.step(use_parent=par is not None, keep=keep, att_keep=am)
        if proj is not None:
            stepped = (*stepped, ws.p)
        expect(len(outs) == len(refs) == (5 if n_p else 4),
               f"K2 N={n}: {len(outs)} outputs")
        err = max(err, *(max_err(x, y) for x, y in zip(outs, refs)))
        expect(all(torch.equal(x, y) for x, y in zip(stepped, outs)),
               f"K2 N={n} T={tt} D={d}: the workspace form differs from "
               f"the call")
    per_step = las_step.kernels_per_step
    extra = {}
    if att:
        ms, extra["no_mask_ms"] = timed_pair(
            lambda: ws.step(use_parent=True, keep=keep, att_keep=am),
            lambda: ws.step(use_parent=True, keep=keep), iters=200)
    else:
        ms = cuda_ms(lambda: ws.step(use_parent=True, keep=keep), iters=200)
    call_ms = cuda_ms(lambda: las_step(*args, parent=parent, keep=keep,
                                       att_keep=am, proj=proj), iters=200)
    ref_ms = cuda_ms(lambda: las_step_ref(*args, parent=parent, keep=keep,
                                          att_keep=am, proj=proj))
    bound = roofline(las_step_cost(n, tt, hd, d, a, c, kw,
                                   args[-1].tolist(), att, n_p))
    log(f"[{tag}] K2 las_step N={n} T={tt} H={hd} D={d} A={a} C={c} K={kw}"
        f"{f' P={n_p}' if n_p else ''}"
        f"{' with keep' if keep is not None else ''}"
        f"{' and the attention mask' if att else ''}: "
        f"max_abs_err {err:.3e}  kernel {ms:.4f} ms through its "
        f"workspace, {call_ms:.4f} ms as a checked call, {per_step} "
        f"kernels per step  twin {ref_ms:.4f} ms  bound "
        f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    expect(err <= KERNEL_ATOL,
           f"K2 N={n} T={tt} D={d}: error {err} > {KERNEL_ATOL}")
    return {"shape": f"N={n} T={tt}" + (f" D={d}" if d != 512 else "")
            + (f" H={hd} A={a} P={n_p}" if n_p else "")
            + (" attention dropout 0.1" if att else ""),
            "keep": keep is not None, "max_abs_err": err, "ms": ms,
            "checked_call_ms": call_ms, "kernels_per_step": per_step,
            "plain_ms": ref_ms, **extra, **bound}


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


# Cuts of the host-bound sub-phases (the script's time limit): phases
# 3c, 8b, 9a, 10a, 10d, 11a and 12b serve the first HOST_UTTS of the
# utterances (the shorter ones), and 12a's float64 hold takes them
# (``host_cut``; the holds with MoChA or MMA keep all four: on fewer,
# 9b's second draw read 1.385 of its rule, float32 MoChA's rounding,
# C29); the eval CLIs of phases 10, 11, 13c and 14-17 decode the first
# EVAL_UTTS of their test sets (``eval_set``); phases 3 and 7 serve and
# decode all of theirs
HOST_UTTS = 2
EVAL_UTTS = 2


def host_cut(xs, xlens) -> tuple:
    """The first HOST_UTTS utterances, their frames cut to the longest."""
    n = HOST_UTTS
    return xs[:n, :int(max(xlens[:n]))], xlens[:n]


def eval_set(corpus: dict) -> str:
    """The first EVAL_UTTS utterances of ``corpus``'s test set, a TSV
    beside it (written once)."""
    path = Path(corpus["test"]).with_name("test_eval.tsv")
    if not path.exists():
        rows = Path(corpus["test"]).read_text().splitlines()
        path.write_text("\n".join(rows[:EVAL_UTTS + 1]) + "\n")
    return str(path)


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
        expect(len(hyps) == len(xlens) and all(
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
    """Phase 3c: serve the utterances (main: the first HOST_UTTS of phase
    3's) with the RNNLM, (a) the LibriSpeech
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
        expect(len(hyps) == len(xlens) and all(
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


def las_scan_case(torch, rng, record, b, u, tt, d, kl, tag="2b", att=False,
                  widths=(1024, 512, 10, 201), n_p=0):
    """K3 and K3b at B rows, U steps, T frames, encoder width d and
    ``widths`` (H, A, C, K), klens ``kl``, dropout keep-masks at rate 0.1;
    with ``att`` the attention weights' dropout scale [U, B, T] at rate
    0.1 too; with ``n_p`` the decoder's projection of that width (K3's p
    and K3b's dW_p, db_p held too) against their plain versions, with
    CUDA-event times, bounds, K3's
    and K3b's kernel launches per call and the time of K3b's wrapper's
    work after its kernel loop; with ``att`` also each kernel's time
    without the mask on the same inputs, in turns with the masked call
    (``no_mask_ms``); returns (args, backward args, K3's plain outputs,
    K3b's outputs)."""
    from neural_sp_tpu_torch.ops.kernels.las_scan import (
        las_scan, las_scan_bwd, las_scan_bwd_chain, las_scan_bwd_cost,
        las_scan_bwd_finish, las_scan_bwd_ref, las_scan_cost, las_scan_ref)
    dev = torch.device("cuda")
    hd, a, c, kw = widths

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype("float32")).to(dev)

    rate = 0.1
    keep = (torch.from_numpy((rng.random((u, b, hd)) >= rate).astype(
        "float32")) / (1 - rate)).to(dev)
    args = (t(u, b, 4 * hd, scale=0.5), t(d, 4 * hd, scale=(d + hd) ** -0.5),
            t(hd, 4 * hd, scale=(d + hd) ** -0.5), t(4 * hd, scale=0.1),
            t(a, n_p or hd, scale=(n_p or hd) ** -0.5),
            t(c, kw, scale=kw ** -0.5), t(a, c, scale=c ** -0.5),
            t(a, scale=a ** -0.5), t(b, tt, a), t(b, tt, d),
            torch.tensor(kl, dtype=torch.int32, device=dev), keep)
    am = (torch.from_numpy((rng.random((u, b, tt)) >= rate).astype(
        "float32")) / (1 - rate)).to(dev) if att else None
    proj = (t(n_p, hd, scale=hd ** -0.5), t(n_p, scale=0.3)) if n_p else None
    outs = las_scan(*args, am, proj)
    refs = las_scan_ref(*args, am, proj)
    expect(len(outs) == len(refs) == (7 if n_p else 6),
           f"K3 {len(outs)} outputs")
    what = f"B={b} U={u} T={tt} H={hd} D={d} A={a} C={c} K={kw}" + (
        f" P={n_p}" if n_p else "") + (" attention dropout 0.1" if att else "")
    log(f"[{tag}] las_scan: {las_scan.kernel_launches_per_call} kernel "
        f"launches per call")
    extra = {}
    if att:
        ms, extra["no_mask_ms"] = timed_pair(
            lambda: las_scan(*args, am, proj), lambda: las_scan(
                *args, None, proj), iters=5)
    else:
        ms = cuda_ms(lambda: las_scan(*args, None, proj), iters=5, warmup=1)
    # no single PyTorch call computes the scan (cuDNN's LSTM has no
    # attention fed back into its input): no library yardstick
    record("las_scan", max(rel_err(x, y) for x, y in zip(outs, refs)), ms,
           cuda_ms(lambda: las_scan_ref(*args, am, proj), iters=5, warmup=1),
           what, library_ms=None, **extra,
           **roofline(las_scan_cost(u, b, tt, hd, d, a, c, kw, kl, att,
                                    n_p)))
    del outs
    w_ctx, w_h, _, w_q, conv_w, w_f, v, kc, values, klt, keep = args[1:]
    bargs = (w_ctx, w_h, w_q, conv_w, w_f, v, kc, values, klt, keep,
             *refs[:6], t(u, b, hd), t(u, b, d))
    # with the projection: W_p, K3's p and its gradient
    popt = (proj[0], refs[6], t(u, b, n_p)) if n_p else ()
    got = las_scan_bwd(*bargs, am, *popt)
    want = las_scan_bwd_ref(*bargs, am, *popt)
    expect(len(got) == len(want) == (12 if n_p else 10),
           f"K3b {len(got)} gradients")
    # the wrapper's work after the kernel loop (weight-gradient and
    # dvalues products, partial sums), timed alone on the loop's outputs
    h, _, _, _, aw, ctx = refs[:6]
    raw = las_scan_bwd_chain(*bargs, am, *popt)
    dpre = raw[7] if n_p else None
    outside_ms = cuda_ms(lambda: las_scan_bwd_finish(
        h, ctx, keep, aw, *raw[:7], am, refs[6] if n_p else None, dpre),
        iters=5, warmup=1)
    log(f"[{tag}] las_scan_bwd: {las_scan_bwd.kernel_launches_per_call} "
        f"kernel launches per call; the work after the loop "
        f"{outside_ms:.4f} ms")
    extra = {}
    if att:
        ms, extra["no_mask_ms"] = timed_pair(
            lambda: las_scan_bwd(*bargs, am, *popt),
            lambda: las_scan_bwd(*bargs, None, *popt), iters=5)
    else:
        ms = cuda_ms(lambda: las_scan_bwd(*bargs, None, *popt), iters=5,
                     warmup=1)
    record("las_scan_bwd", max(rel_err(x, y) for x, y in zip(got, want)),
           ms, cuda_ms(lambda: las_scan_bwd_ref(*bargs, am, *popt), iters=5,
                       warmup=1),
           what, library_ms=None, outside_ms=outside_ms, **extra,
           **roofline(las_scan_bwd_cost(u, b, tt, hd, d, a, c, kw, kl,
                                        att, n_p)))
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
    ``LASScan``, in float32 at every compute dtype, cast at its boundary
    (the attention dropout scale and the decoder's projection too); in
    float64 given float64 (17a's float64 reference)."""

    @staticmethod
    def apply(eg, w_ctx, w_h, bias, w_q, conv_w, w_f, v, kc, values, klens,
              keep, att_keep=None, w_p=None, b_p=None):
        import torch
        from neural_sp_tpu_torch.ops.kernels.las_scan import las_scan_ref
        dt = torch.promote_types(eg.dtype, torch.float32)

        def cast(x):
            return None if x is None else x.to(dt)

        def tm(x):
            return None if x is None else cast(x).transpose(0, 1)

        proj = None if w_p is None else (cast(w_p), cast(b_p))
        outs = las_scan_ref(
            tm(eg), *(cast(x) for x in (
                w_ctx, w_h, bias, w_q, conv_w, w_f, v, kc, values)),
            klens, tm(keep), tm(att_keep), proj)
        return tuple(x.transpose(0, 1).to(eg.dtype)
                     for x in (outs[0], outs[5], outs[4], *outs[6:]))


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
    (``plain_rel_attention``), K3 / K3b (``PlainLASScan``), K4 and K5
    (autograd through their plain forwards)."""
    from neural_sp_tpu_torch.models.decoders import las
    from neural_sp_tpu_torch.models.modules import \
        relative_multihead_attention as rma
    from neural_sp_tpu_torch.ops import ctc, rnnt
    from neural_sp_tpu_torch.ops.kernels.ctc_loss import ctc_forward_alphas
    from neural_sp_tpu_torch.ops.kernels.rnnt_loss import rnnt_forward_alphas
    return ((rma, "rel_attention", plain_rel_attention(torch)),
            (las, "LASScan", PlainLASScan),
            (ctc, "ctc_nll", lambda *a: ctc_forward_alphas(*a)[0]),
            (rnnt, "rnnt_nll", lambda *a: rnnt_forward_alphas(*a)[0]))


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


def phase_train_parity_bf16(torch, model, batch, plain32, tag="6b",
                            microstep=None):
    """6b: one eval() microstep at bf16 compute through the kernels against
    the same microstep with the plain versions patched in (both bf16): each
    quantity's distance from phase 6's plain float32 microstep
    (``plain32``) held to BF16_PATH_FACTOR times the plain bf16
    microstep's, in the L2 norm, plus phase 6's float32 tolerance in that
    norm (``path_rule``). ``microstep(compute_dtype, plain) -> (loss,
    gradients)`` replaces the eval() microstep (17c: a train() one on
    pinned masks)."""
    bf = torch.bfloat16
    if microstep is None:
        def microstep(dtype, plain):
            return eval_microstep(torch, model, batch, dtype, plain=plain)
    out = path_rule(torch, *microstep(bf, False), *microstep(bf, True),
                    *plain32, tag, ("bf16", "plain bf16", "plain f32"))
    out["loss_plain_bf16"] = out.pop("loss_plain")
    out["loss_plain_f32"] = out.pop("loss_ref")
    return out


def path_rule(torch, loss, grads, loss_p, grads_p, loss_ref, grads_ref,
              tag: str, names: tuple, zero_leaf: str = ZERO_GRAD_LEAF
              ) -> dict:
    """6b's rule, where a microstep's rounding is the function's own: the
    kernels' microstep (loss, grads) no farther from a reference (loss_ref,
    grads_ref) than BF16_PATH_FACTOR times the plain versions' same
    microstep (loss_p, grads_p) is, in the L2 norm per leaf, plus phase 6's
    float32 tolerance in that norm (``zero_leaf``'s leaves GRAD_FLOOR of
    the largest gradient). ``names``: how the log calls the three runs."""
    run, plain, ref = names
    g_max = max(float(g.abs().max()) for g in grads_ref.values())
    loss_tol = BF16_PATH_FACTOR * abs(loss_p - loss_ref) + \
        LOSS_RTOL * abs(loss_ref)
    norm = torch.linalg.vector_norm
    leaves = {}
    for name, g in grads.items():
        gp, gr = grads_p[name], grads_ref[name]
        per_element = GRAD_FLOOR * g_max if name.endswith(zero_leaf) \
            else GRAD_RTOL * float(gr.abs().max())
        floor = per_element * gr.numel() ** 0.5
        plain_cost = float(norm(gp - gr))
        tol = BF16_PATH_FACTOR * plain_cost + floor
        err = float(norm(g - gr))
        leaves[name] = (err / tol if err else 0.0, err, plain_cost,
                        float(norm(g - gp)))
    ranked = sorted(leaves.items(), key=lambda kv: -kv[1][0])
    log(f"[{tag}] {run} loss kernels {loss:.6f} {plain} {loss_p:.6f} {ref} "
        f"{loss_ref:.6f}: |kernels - {ref}| {abs(loss - loss_ref):.3e} "
        f"against a tolerance of {loss_tol:.3e}")
    for name, (share, err, cost, between) in ranked[:6]:
        log(f"[{tag}]   {name}: {share:.3f} of its tolerance (|kernels - "
            f"{ref}| {err:.3e}, |{plain} - {ref}| {cost:.3e}, |kernels - "
            f"{plain}| {between:.3e}, L2)")
    worst_name, (worst, _, _, _) = ranked[0]
    expect(abs(loss - loss_ref) <= loss_tol,
           f"{tag} loss {loss} vs {ref} {loss_ref} ({plain} {loss_p})")
    expect(worst <= 1.0, f"{tag} gradient {worst_name} outside tolerance")
    return {"loss": loss, "loss_plain": loss_p, "loss_ref": loss_ref,
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
    out["train_parity"], _ = hold_sampled(torch, model, batch, "7b")
    del model, batch
    torch.cuda.empty_cache()
    return out


def hold_sampled(torch, model, batch, tag: str):
    """A train() microstep with scheduled sampling on ``batch``, through the
    kernels (launches counted from zero) and through the plain versions,
    one generator seed (the same dropout, attention and sampling masks):
    pass 2 of the plain microstep over the kernels' fed tokens (the plain
    pass 1's may part from them only at ties: at most one in FED_TIES),
    held by phase 6's rule. Returns (the held readings with
    ``fed_tokens_parted``, the kernels' launches in their microstep)."""
    from neural_sp_tpu_torch.models.decoders import las
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    orig_fed = las.RNNDecoder.fed_tokens
    fed_seen = []

    def keep_fed(self, *args):
        fed_seen.append(orig_fed(self, *args))
        return fed_seen[-1]

    reset_launches()
    with mock.patch.object(las.RNNDecoder, "fed_tokens", keep_fed):
        loss, grads = train_microstep(torch, model, batch)
    torch.cuda.synchronize()
    counts = launches()
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
    log(f"[{tag}]   pass 1, K2 against its plain version: {parted} of "
        f"{int(valid.sum())} fed tokens differ")
    expect(parted * FED_TIES <= int(valid.sum()),
           f"{tag}: pass 1's fed tokens: {parted} differ")
    held = hold_microstep(loss, grads, loss_ref, grads_ref, tag)
    held["fed_tokens_parted"] = parted
    return held, counts


def train_microstep(torch, model, batch, plain=False, **sub_labels):
    """(loss, {leaf: gradient}) of one train() microstep in float32 from a
    generator of seed SEED, through the kernels or, with ``plain``, the
    plain versions patched in (as ``eval_microstep``); ``sub_labels`` the
    sub-tasks' labels (phase 14)."""
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
                               torch.Generator().manual_seed(SEED),
                               **sub_labels)
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
    out, counts = phase_serve(torch, model, xs[:HOST_UTTS],
                              xlens[:HOST_UTTS], ("beam10_ctc0.3", "greedy"),
                              tag="8b")
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
    out = {"kernels": timed("8a", phase_blstm_kernels, torch, rng)}
    model = blstm_model(torch)
    out["parameters"] = sum(p.numel() for p in model.parameters())
    log(f"[8b] BLSTM-LAS: {out['parameters']} parameters on the card")
    out["serve"] = timed("8b", phase_blstm_serve, torch, model, xs, xlens)
    del model
    torch.cuda.empty_cache()
    out["cli"] = timed("8c-8d", phase_blstm_cli, torch, root, corpus)
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


def mocha_labels(torch, rng, vocab: int, rows: int = len(MOCHA_U)):
    """Labels [4, 100] (PAD past MOCHA_U) from ``rng``, ids in [4, vocab);
    the first ``rows`` of them."""
    import numpy as np
    from neural_sp_tpu_torch import PAD
    ys = np.full((len(MOCHA_U), max(MOCHA_U)), PAD, np.int64)
    for b, u in enumerate(MOCHA_U):
        ys[b, :u] = rng.integers(4, vocab, u)
    return torch.from_numpy(ys[:rows]), torch.tensor(MOCHA_U[:rows])


def phase_mocha_serve(torch, model, xs, xlens) -> dict:
    """9a: phase 3's utterances through the LSTM-MoChA: beam 10 + CTC 0.3
    and greedy (counts zeroed before, read after: K1, K1b, K2, K3 and K3b
    must not run), the encoder's time, one profiled beam request (device
    time per decode step, idle share)."""
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
    from neural_sp_tpu_torch.models.decoders.las import DecodeLoop
    out, counts = phase_serve(torch, model, xs[:HOST_UTTS],
                              xlens[:HOST_UTTS], ("beam10_ctc0.3", "greedy"),
                              tag="9a")
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


def mocha_microstep(torch, model, batch, seed=SEED, compute_dtype=None,
                    plain=False, **labels):
    """One train() microstep from a generator of seed ``seed`` under
    ``compute_dtype`` (None: the model's own), through the kernels or,
    with ``plain``, the plain versions patched in, with ``labels`` (the
    trigger points): (loss, {leaf: gradient as float64 on the host},
    scalar observations)."""
    from contextlib import ExitStack
    from neural_sp_tpu_torch.parallel.mesh import (compute_loss,
                                                   deterministic_cudnn)
    model.train()
    model.zero_grad(set_to_none=True)
    with ExitStack() as stack:
        if plain:
            for target, name, value in plain_patches(torch):
                stack.enter_context(mock.patch.object(target, name, value))
        stack.enter_context(deterministic_cudnn())   # as the step runs
        loss, obs = compute_loss(model, compute_dtype, *batch,
                                 torch.Generator().manual_seed(seed),
                                 **labels)
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
    dev = next(model.parameters()).device
    spec = reference_spec(torch, "9b", xs, xlens)
    out = {}
    for case in ("served", "second_draw"):
        # the served utterances and labels, then a second draw of both
        run = spec["runs"][f"9b {case}"]
        seed, x = run["seed"], run["batch"][0]
        on_card = tuple(v.to(dev) for v in run["batch"])
        t0 = time.perf_counter()
        loss, grads, obs = mocha_microstep(torch, model, on_card, seed)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loss_ref, grads_ref, obs_ref = cpu_ref(f"9b {case}")
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
    greedy = spec["runs"]["9b greedy"]
    g = torch.Generator().manual_seed(greedy["noise_seed"])
    model.load_state_dict({
        k: v.cpu() + GREEDY_NOISE * torch.randn(v.shape, generator=g)
        for k, v in model.state_dict().items()})
    model.eval()
    toks, margins = mocha_greedy(torch, model,
                                 *(v.to(dev) for v in greedy["batch"]))
    toks_ref = cpu_ref("9b greedy")
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
    out["serve"] = timed("9a", phase_mocha_serve, torch, model, xs, xlens)
    out["hold"] = timed("9b", phase_mocha_hold, torch, model, xs, xlens)
    del model
    torch.cuda.empty_cache()
    out["cli"] = timed("9c-9d", phase_mocha_cli, torch, root, corpus)
    out["ctc_sync"] = timed("9e", phase_mocha_sync, torch, xs, xlens)
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
    out, counts = phase_serve(torch, model, xs[:HOST_UTTS],
                              xlens[:HOST_UTTS], names, tag=tag,
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
                             model.dec_fwd.vocab, len(xlens))
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
    log(f"[{tag}] train() microstep B {xs.shape[0]} x {xs.shape[1]} frames, "
        f"U {ylens.tolist()}, dropout off: card {card_s:.2f} s, CPU float64 "
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
                         eval_set(corpus), "--recog_lm", lm_dir,
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
    expect(m["n_utts"] == EVAL_UTTS, f"{m['n_utts']} utterances")
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
    mark = len(SUB_WALLS)

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
    out["sub_phase_wall_s"] = walls_since(mark)
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
    window's work. A head width below 16 reaches SDPA zero-padded to 16,
    as K1 pads it (the same function; the outputs sliced back)."""
    import torch.nn.functional as F
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
        f32 = (*(x.float() for x in (q, k, v, p)), klens, window, key_start,
               dropout)
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
    lq, lk, lv = (F.pad(x, (0, 16 - dk)) if dk < 16 else x
                  for x in (q, k, v))
    with efficient_sdpa():
        lib_err = rel_err(sdpa(lq, lk, lv, attn_mask=bias,
                               scale=1.0)[..., :dk], undropped)
        ms, lib_ms = timed_pair(lambda: rel_attention_fwd(*fwd), lambda: sdpa(
            lq, lk, lv, attn_mask=bias, scale=1.0, dropout_p=rate))
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
                                       window, dropout)
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
    leaves = [x.detach().requires_grad_() for x in (lq, lk, lv)]
    ldo = F.pad(do, (0, 16 - dk)) if dk < 16 else do
    with efficient_sdpa():
        lib_out = sdpa(*leaves, attn_mask=bias, scale=1.0, dropout_p=rate)

        def lib_grads():
            return torch.autograd.grad(lib_out, (*leaves, bias), ldo,
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


def hold_with_control(torch, model, on_card, tag: str, kernels: tuple,
                      ref_key: str) -> dict:
    """One train() microstep of ``model`` on the card held to the same
    microstep on the CPU in float64 (the worker's ``ref_key``) by 9b's
    rule, ``kernels`` launched in the card's microstep, and a TF32 control
    that must break the rule."""
    import numpy as np
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    reset_launches()
    t0 = time.perf_counter()
    loss, grads, obs = mocha_microstep(torch, model, on_card)
    card_s = time.perf_counter() - t0
    counts = launches()
    t0 = time.perf_counter()
    loss_ref, grads_ref, obs_ref = cpu_ref(ref_key)
    cpu_s = time.perf_counter() - t0
    log(f"[{tag}] train() microstep B {on_card[0].shape[0]} x "
        f"{on_card[0].shape[1]} frames, U {on_card[3].tolist()}: card "
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


def whole_microstep_readings(torch, tag: str, card, cpu32, cpu64) -> dict:
    """A whole microstep whose float32 MoChA rounds (ROADMAP C29) against
    the CPU's float64 one, each run as (loss, {leaf: gradient}, obs): the
    loss's relative error and, per leaf, |g - g64| / |g64| (median and
    max), of the card's float32 run and of the CPU's (``cpu32``), logged;
    every gradient finite. Returns the readings."""
    import numpy as np
    (loss, grads, obs), (loss32, grads32) = card, cpu32[:2]
    loss_ref, grads_ref, obs_ref = cpu64

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
    return whole


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
    dev = next(model.parameters()).device
    on_card = tuple(v.to(dev) for v in reference_spec(
        torch, tag, xs, xlens)["batch"])
    window = ("rel_attention_window", "rel_attention_bwd_window",
              "ctc_loss", "ctc_loss_bwd")
    if not decoder_apart:
        out = hold_with_control(torch, model, on_card, tag, window,
                                f"{tag} float64")
        model.eval()
        return out
    loss, grads, obs = mocha_microstep(torch, model, on_card)
    loss32, grads32, _ = cpu_ref(f"{tag} float32")
    loss_ref, grads_ref, obs_ref = cpu_ref(f"{tag} float64")
    whole = whole_microstep_readings(torch, tag, (loss, grads, obs),
                                     (loss32, grads32),
                                     (loss_ref, grads_ref, obs_ref))
    expect(whole["loss_rel_err"] <= WHOLE_LOSS_RTOL, f"{tag}: the whole "
           f"microstep's loss {whole['loss_rel_err']:.2e} of float64, past "
           f"{WHOLE_LOSS_RTOL}")
    expect(whole["median_leaf_rel_dist"] <= WHOLE_GRAD_MULT *
           whole["median_leaf_rel_dist_cpu_float32"],
           f"{tag}: the whole microstep's gradients "
           f"{whole['median_leaf_rel_dist']:.3e} from float64 (median), past "
           f"{WHOLE_GRAD_MULT} x the CPU float32's "
           f"{whole['median_leaf_rel_dist_cpu_float32']:.3e}")
    model.ctc_weight = 1.0
    try:
        out = hold_with_control(torch, model, on_card,
                                f"{tag} encoder + CTC", window,
                                f"{tag} float64 ctc")
    finally:
        model.ctc_weight = xf_args(make).ctc_weight
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
                             eval_set(corpus), "--recog_dir",
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
        expect(m["n_utts"] == EVAL_UTTS, f"{m['n_utts']} utterances")
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
    mark = len(SUB_WALLS)

    out = {"kernels": timed("11 kernels", phase_window_kernels, torch, rng)}
    model = xf_model(torch, "librispeech_uni_conformer_mocha_args")
    out["parameters"] = sum(p.numel() for p in model.parameters())
    log(f"[11a] LibriSpeech uni-Conformer-MoChA: {out['parameters']} "
        f"parameters on the card")
    served, counts = timed("11a", phase_serve, torch, model,
                           xs[:HOST_UTTS], xlens[:HOST_UTTS],
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
    out["sub_phase_wall_s"] = walls_since(mark)
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


def hold_to_float64(torch, model, xs, xlens, tag) -> dict:
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
    spec = reference_spec(torch, tag, xs, xlens)
    on_card = tuple(v.to(dev) for v in spec["batch"])
    if getattr(model.dec_fwd, "attn_type", "") != "mocha":
        return hold_with_control(torch, model, on_card, tag,
                                 RNNT_TRAIN_KERNELS, f"{tag} float64")
    card_pre: list = []
    reset_launches()
    with mock.patch.object(mocha_module, "_energy", energy_pre_activations(
            torch, card_pre)):
        loss, grads, obs = mocha_microstep(torch, model, on_card)
    counts = launches()
    loss32, grads32, _ = cpu_ref(f"{tag} float32")
    t0 = time.perf_counter()
    loss_ref, grads_ref, obs_ref = cpu_ref(f"{tag} float64")
    cpu_s = time.perf_counter() - t0
    # the float64 microstep again here, with the card's energy ReLU masks
    cpu = build_speech2text(spec["args"], device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu.double()
    on_cpu = tuple(v.double() if v.is_floating_point() else v
                   for v in spec["batch"])
    flips = {"positions": 0, "pre_rel_err": 0.0}
    with mock.patch.object(mocha_module, "_energy", energy_pre_activations(
            torch, [], card_pre, flips)):
        loss_p, grads_p, _ = mocha_microstep(torch, cpu, on_cpu)
    flips["pre_activations"] = sum(p.numel() for p in card_pre)
    del card_pre, cpu

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
    model.ctc_weight = 1.0
    try:
        out = hold_with_control(torch, model, on_card,
                                f"{tag} encoder + CTC",
                                ("ctc_loss", "ctc_loss_bwd"),
                                f"{tag} float64 ctc")
    finally:
        model.ctc_weight = ctc_weight
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
    mark = len(SUB_WALLS)

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
    out["hold"] = timed("12a hold", hold_to_float64, torch, model, xs,
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
    served, counts = timed("12b serve", phase_serve, torch, model,
                           xs[:HOST_UTTS], xlens[:HOST_UTTS],
                           ("beam10_ctc0.3", "greedy"), tag="12b")
    served.pop("best_hyp0")
    served["launches"] = counts
    mocha["serve"] = served
    mocha["stream"] = timed("12b stream", lc_stream_decode, torch, model,
                            dict(beam_width=10, ctc_weight=0.3), xs, xlens,
                            "12b")
    mocha["hold"] = timed("12b hold", hold_to_float64, torch, model, xs,
                          xlens, "12b")
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
    out["sub_phase_wall_s"] = walls_since(mark)
    log(f"[12] phase 12 wall {out['phase_wall_s']:.1f} s")
    return out


# Phase 13: the language-model stage of the recipes (stage 3 trains an LM
# with the LM train CLI, stage 5 decodes with it) through the port's LM
# CLIs, at the recipe confs' full width and depth in float32, on a
# synthesized text corpus over phase 7's 10k-word dictionary.
LM_XL_CONF = "examples/swbd/conf/lm/transformer_xl.yaml"
# the XL's depth cut for the script's time limit (PR 18: 12 -> 6 layers;
# its width, bptt and memory as the conf's)
LM_XL_DEPTH = 6
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
    """``conf``'s args with ``vocab``; the XL's at LM_XL_DEPTH."""
    from types import SimpleNamespace
    import yaml
    args = SimpleNamespace(**yaml.safe_load((ROOT / conf).read_text()),
                           vocab=vocab)
    if conf == LM_XL_CONF:
        args.n_layers = LM_XL_DEPTH
    return args


def xl_microstep(torch, lm, xi, xo, mems, seed=None, plain=False,
                 kept=None, pins=None, compute_dtype=None):
    """(loss, {leaf: gradient}) of one window with the memories ``mems``,
    in the mode ``lm`` is in (``train()``: dropout keys from a generator
    seeded ``seed``), under ``compute_dtype`` (the LM train CLI's
    ``window_loss``), through K1 / K1b or, with ``plain``, their plain
    versions patched in; each ReLU FFN's pre-activation kept in ``kept``,
    and with ``pins`` its ReLU mask pinned to ``pins[name]``."""
    from contextlib import ExitStack
    from neural_sp_tpu_torch.bin.lm.train import window_loss
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
        loss, _, _ = window_loss(lm, compute_dtype, xi, xo, mems, gen)
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
           conf: str, resume: bool = False, cache: bool = False,
           extra: tuple = ()) -> dict:
    """The LM train CLI on ``conf`` for one epoch (``extra`` its flags
    too; and with ``resume`` a second, resumed from the first's
    checkpoint), then the eval CLI on the dev set (and with ``cache`` again
    with the cache model), counts zeroed around each run; the dev and eval
    PPLs finite."""
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

    depth = ["--n_layers", str(LM_XL_DEPTH)] if conf == LM_XL_CONF else []
    run("train", lm_train.main, ["--config", str(ROOT / conf)] + data
        + list(LM_TRAIN) + depth + list(extra))
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
    mark = len(SUB_WALLS)

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
    out["text"] = text
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
        test = eval_set(corpus)
        res = cli_eval.main([
            "--recog_model", str(root / "exp"), "--recog_sets",
            test, "--recog_lm", str(root / "lm_transformer_xl"),
            "--recog_dir", str(root / "decode_xl")] + list(CLI_EVAL))
        torch.cuda.synchronize()
        (m,) = res.values()
        hyps = (root / "decode_xl" / Path(test).stem / "hyp.trn").read_text()
        return {**m, "wall_s": time.perf_counter() - t,
                "launches": launches(),
                "hyp_tokens": [len(h.rsplit(" (", 1)[0].split())
                               for h in hyps.splitlines()]}
    fused = timed("13c", fusion)
    log(f"[13c] eval CLI with the XL LM: RTF {fused['rtf']:.4f}, wall "
        f"{fused['wall_s']:.1f} s, hypothesis lengths {fused['hyp_tokens']}, "
        f"launches {fused['launches']}")
    expect(fused["n_utts"] == EVAL_UTTS, f"13c: {fused['n_utts']}")
    for name in ("rel_attention_offset", "las_step"):
        expect(fused["launches"][name] > 0, f"13c: {name} never launched")
    out["fusion"] = fused
    paths = [xl[r]["launches"] for r in ("train", "resumed", "eval",
                                         "eval_cache")] + \
        [out[n][r]["launches"] for n in LM_CONFS for r in ("train", "eval")] \
        + [fused["launches"]]
    out["launches"] = {name: sum(p[name] for p in paths) for name in paths[0]}
    out["walls_s"] = walls_since(mark)
    return out


# ---- phase 11f: bf16 training with MoChA, the repo's streaming conf ------
# The train CLI on STREAM_CONF as written (``train_dtype: bfloat16``; MoChA's
# alignment in float32 inside the bf16 step, ROADMAP C39) at XF_DEPTH over
# phase 7's corpus, its streaming eval CLI, and one bf16 train() microstep
# held to the same microstep on the CPU in float64: the encoder + CTC part
# by phase 6b's rule (the plain versions' bf16 microstep on the card as the
# measure of bf16's cost), the whole microstep by 11d's gates (C29).
STREAM_BF16_KERNELS = ("rel_attention_bf16", "rel_attention_bwd_bf16",
                       "rel_attention_window", "rel_attention_bwd_window",
                       "ctc_loss", "ctc_loss_bwd")


def bf16_against_float64(torch, model, on_card, tag, ref: str,
                         kernels=("rel_attention_bf16",
                                  "rel_attention_bwd_bf16")) -> dict:
    """11f: the bf16 microstep (train(), one seed) of ``model`` on the card
    against the CPU's float64 one: the whole microstep by WHOLE_LOSS_RTOL /
    WHOLE_GRAD_MULT, with the plain versions' bf16 microstep on the card as
    the yardstick (11d's, the CPU's float32 microstep, lies 3e-7 from
    float64 on the median leaf, where bf16's 8-bit mantissa puts any bf16
    microstep near 1e-2; it is logged beside), then with ``ctc_weight`` 1
    (the encoder and the CTC head: every kernel
    of the path) each leaf's distance from float64 within
    BF16_PATH_FACTOR times the plain versions' bf16 microstep's plus phase
    6's float32 tolerance (6b's rule, float64 in place of the plain
    float32 microstep); every loss finite, each of ``kernels`` launched in
    the microstep. The CPU microsteps are the worker's ``ref`` ones (11f:
    11d's, the same model and batch)."""
    import numpy as np
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    bf = torch.bfloat16
    reset_launches()
    loss, grads, obs = mocha_microstep(torch, model, on_card,
                                       compute_dtype=bf)
    counts = launches()
    loss16, grads16, _ = mocha_microstep(torch, model, on_card,
                                         compute_dtype=bf, plain=True)
    loss32, grads32, _ = cpu_ref(f"{ref} float32")
    loss64, grads64, obs64 = cpu_ref(f"{ref} float64")
    expect(all(np.isfinite(v) for v in obs.values()), f"{tag} losses {obs}")
    for name in kernels:
        expect(counts[name] > 0, f"{name} never launched in {tag}'s bf16 "
               f"microstep: {counts}")

    def dist(g):
        return {n: float((g[n] - grads64[n]).norm() /
                         max(float(grads64[n].norm()), 1e-30))
                for n in grads64 if not n.endswith(ZERO_GRAD_LEAF)}

    d_card, d_plain16, d_cpu32 = dist(grads), dist(grads16), dist(grads32)
    med = lambda d: float(np.median(list(d.values())))  # noqa: E731
    whole = {"loss_rel_err": abs(loss - loss64) / abs(loss64),
             "loss_rel_err_plain_bf16": abs(loss16 - loss64) / abs(loss64),
             "loss_rel_err_cpu_float32": abs(loss32 - loss64) / abs(loss64),
             "obs": obs, "obs_float64": obs64,
             "median_leaf_rel_dist": med(d_card),
             "median_leaf_rel_dist_plain_bf16": med(d_plain16),
             "median_leaf_rel_dist_cpu_float32": med(d_cpu32),
             "max_leaf_rel_dist": max(d_card.values()),
             "max_leaf_rel_dist_plain_bf16": max(d_plain16.values()),
             "launches": counts}
    log(f"[{tag}] the whole bf16 microstep: loss rel "
        f"{whole['loss_rel_err']:.2e} of float64 (plain bf16 "
        f"{whole['loss_rel_err_plain_bf16']:.2e}, CPU float32 "
        f"{whole['loss_rel_err_cpu_float32']:.2e}); median leaf |g - g64| /"
        f" |g64| {whole['median_leaf_rel_dist']:.3e} (plain bf16 "
        f"{whole['median_leaf_rel_dist_plain_bf16']:.3e}, CPU float32 "
        f"{whole['median_leaf_rel_dist_cpu_float32']:.3e}), max "
        f"{whole['max_leaf_rel_dist']:.3e} (plain bf16 "
        f"{whole['max_leaf_rel_dist_plain_bf16']:.3e}); {obs}; launches "
        f"{counts}")
    expect(whole["loss_rel_err"] <= WHOLE_LOSS_RTOL,
           f"{tag}: the bf16 microstep's loss {whole['loss_rel_err']:.2e} "
           f"of float64")
    expect(whole["median_leaf_rel_dist"] <= WHOLE_GRAD_MULT *
           whole["median_leaf_rel_dist_plain_bf16"],
           f"{tag}: the bf16 microstep's gradients, median "
           f"{whole['median_leaf_rel_dist']:.3e} from float64")
    weight = model.ctc_weight
    model.set_weights(ctc_weight=1.0)
    try:
        loss, grads, _ = mocha_microstep(torch, model, on_card,
                                         compute_dtype=bf)
        loss16, grads16, _ = mocha_microstep(torch, model, on_card,
                                             compute_dtype=bf, plain=True)
        loss64, grads64, _ = cpu_ref(f"{ref} float64 ctc")
    finally:
        model.set_weights(ctc_weight=weight)
    g_max = max(float(g.abs().max()) for g in grads64.values())
    leaves = {}
    for name, g in grads.items():
        ref, ref16 = grads64[name], grads16[name]
        per_element = GRAD_FLOOR * g_max if name.endswith(ZERO_GRAD_LEAF) \
            else GRAD_RTOL * float(ref.abs().max())
        cost = float((ref16 - ref).norm())
        tol = BF16_PATH_FACTOR * cost + per_element * ref.numel() ** 0.5
        err = float((g - ref).norm())
        leaves[name] = (err / tol if err else 0.0, err, cost)
    ranked = sorted(leaves.items(), key=lambda kv: -kv[1][0])
    loss_tol = BF16_PATH_FACTOR * abs(loss16 - loss64) + \
        LOSS_RTOL * abs(loss64)
    log(f"[{tag}] encoder + CTC at bf16: loss kernels {loss:.6f} plain bf16 "
        f"{loss16:.6f} float64 {loss64:.6f} (tolerance {loss_tol:.3e})")
    for name, (share, err, cost) in ranked[:4]:
        log(f"[{tag}]   {name}: {share:.3f} of its tolerance (|kernels - "
            f"f64| {err:.3e}, |plain bf16 - f64| {cost:.3e}, L2)")
    expect(abs(loss - loss64) <= loss_tol, f"{tag} encoder + CTC loss")
    expect(ranked[0][1][0] <= 1.0, f"{tag} encoder + CTC gradient "
           f"{ranked[0][0]} outside tolerance")
    return {"whole_microstep": whole, "encoder_ctc": {
        "loss": loss, "loss_plain_bf16": loss16, "loss_float64": loss64,
        "worst_grad": ranked[0][1][0], "worst_grad_leaf": ranked[0][0],
        "worst_leaves": dict(ranked[:4])}}


def phase_stream_bf16(torch, root: Path, corpus: dict, xs, xlens) -> dict:
    """11f: the streaming conf trained at its own bf16 through the train
    CLI (one epoch, accumulation 2, at XF_DEPTH: the bf16 entries of K1 /
    K1b with the chunk window must run), evaluated with
    ``--recog_streaming`` on its checkpoint, and its bf16 microstep held
    (``bf16_against_float64``)."""
    from neural_sp_tpu_torch.bin.args import load_config
    make = "uni_conformer_mocha_streaming_args"
    t0 = time.perf_counter()
    out = {"cli": stream_cli(torch, root, corpus, STREAM_CONF, "11f", True,
                             {"streaming": STREAM_EVAL}, STREAM_BF16_KERNELS,
                             lm=False, depth=depth_flags(make))}
    conf = load_config(str(root / f"exp_{Path(STREAM_CONF).stem}" /
                           "conf.yml"))
    expect(conf["train_dtype"] == "bfloat16", f"11f: {conf['train_dtype']}")
    expect(out["cli"]["eval_streaming"]["launches"][
        "rel_attention_offset"] > 0,
        "K1 never ran against cached keys in 11f's streaming eval CLI")
    out["cli_wall_s"] = time.perf_counter() - t0
    model = xf_model(torch, make)
    on_card = tuple(v.to(DEVICE) for v in reference_spec(
        torch, "11d", xs, xlens)["batch"])
    out["hold"] = bf16_against_float64(torch, model, on_card, "11f", "11d")
    out["launches"] = {k: out["cli"]["train"]["launches"][k] +
                       out["cli"]["eval_streaming"]["launches"][k] +
                       out["hold"]["whole_microstep"]["launches"][k]
                       for k in out["cli"]["train"]["launches"]}
    # every K1 launch of the path has the chunk window: the bf16 ones of
    # the training microsteps, the float32 ones of the dev loss
    train = out["cli"]["train"]["launches"]
    expect(train["rel_attention_window"] == train["rel_attention_bf16"] +
           train["rel_attention"], f"11f launches {train}")
    del model
    torch.cuda.empty_cache()
    out["phase_wall_s"] = time.perf_counter() - t0
    return out


# ---- phase 14: hierarchical multi-task training ---------------------------
# 14a: the AISHELL hierarchical Conformer-LAS (MTL_CONF: 12 conformer
# layers of d 256 / 4 heads / d_ff 1024, max_pools after layers 4 and 8, a
# CTC-only sub1 head tapped after layer 6 (T / 4), LSTM-1024 LAS, CTC 0.3
# with fc 512, ss_prob 0.2), float32 (the conf sets no train_dtype), full
# width and depth. 14b: the SWBD three-task BLSTM-LAS (MTL3_CONF: BLSTM-512
# summed, taps after layers 4 and 3 with task-specific layers, two CTC
# sub-heads, LSTM-1024 LAS, no main CTC), full width, depth 6 -> 4 (both
# taps kept). Both over MTL_UTTS utterances whose transcripts are short
# enough that every row's characters fit the deepest tap's CTC limit,
# words (V 10,000) for the main task and characters for the sub-tasks.
MTL_CONF = "examples/aishell/conf/asr/conformer_kernel15_clamp10_hie_" \
    "subsample8_las_ln_2mtl.yaml"
MTL3_CONF = "examples/swbd/conf/asr/blstm_las_3mtl.yaml"
MTL3_DEPTH = ("--enc_n_layers", "4")
# the AISHELL conf's parameters at vocab 10,000 for every task, as the JAX
# package counts them (tests/test_torch_mtl.py::test_mtl_recipe_conf_builds)
MTL_PARAMS = 51104170
MTL_UTTS = {"train": 64, "dev": 8, "test": 4}
MTL_WORDS = (2, 6)         # words per transcript: <= 35 characters
MTL_OVERRIDES = ("--n_epochs", "2", "--accum_grad_n_steps", "2",
                 "--unit", "word")
MTL_EVAL = ("--recog_beam_width", "10", "--recog_ctc_weight", "0.3",
            "--recog_n_average", "2")
MTL_TRAIN_KERNELS = ("rel_attention", "rel_attention_bwd", "las_step",
                     "las_scan", "las_scan_bwd", "ctc_loss", "ctc_loss_bwd")
MTL3_TRAIN_KERNELS = ("las_step", "las_scan", "las_scan_bwd", "ctc_loss",
                      "ctc_loss_bwd")


def mtl_corpus(root: Path, utts: dict) -> dict:
    """``synth_corpus``'s shape with transcripts of MTL_WORDS words over
    CLI_VOCAB's dictionary and a character dictionary of their text (its
    words are ``w`` and four digits)."""
    import numpy as np
    rng = np.random.default_rng(1)
    words = [f"w{i:04d}" for i in range(CLI_VOCAB - 4)]
    (root / "feat").mkdir(parents=True, exist_ok=True)
    paths = {"dict": str(root / "dict_word.txt"),
             "dict_char": str(root / "dict_char.txt")}
    (root / "dict_word.txt").write_text(
        "".join(f"{w} {i + 4}\n" for i, w in enumerate(words)))
    (root / "dict_char.txt").write_text("".join(
        f"{c} {i + 4}\n" for i, c in enumerate(["<space>", "w"] +
                                               [str(d) for d in range(10)])))
    for name, n in utts.items():
        rows = ["utt_id\tspeaker\tfeat_path\txlen\txdim\ttext\ttoken_id"
                "\tylen\tydim"]
        for i in range(n):
            t = int(rng.integers(700, 1601))
            path = root / "feat" / f"{name}_{i:03d}.npy"
            np.save(path, rng.standard_normal((t, 80)).astype("float32"))
            ids = rng.integers(0, CLI_VOCAB - 4,
                               int(rng.integers(*MTL_WORDS)))
            rows.append("\t".join((
                f"{name}_{i:03d}", f"spk{i % 4}", str(path), str(t), "80",
                " ".join(words[j] for j in ids),
                " ".join(str(j + 4) for j in ids), str(len(ids)),
                str(CLI_VOCAB))))
        paths[name] = str(root / f"{name}.tsv")
        Path(paths[name]).write_text("\n".join(rows) + "\n")
    return paths


def phase_mtl_kernels(torch, rng) -> dict:
    """14a's kernels at its shapes against their plain versions, with
    times, bounds and library yardsticks: K1 / K1b at d 256 (H 4, dk 64,
    R 11) over B 16 rows at T 800 / 400 / 200 (the three encoder depths of
    a 1600-frame microbatch), K2 in sampling's pass 1 (N 32, T 200, D 256,
    keep), K3 / K3b (B 16, U 31, T 200, D 256) and K4 on the sub1 CTC at
    the tap's T 400 over the character vocabulary (V 16)."""
    import numpy as np
    from neural_sp_tpu_torch.ops.kernels import rel_attention
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_bwd, rel_attention_bwd_cost, rel_attention_bwd_ref,
        rel_attention_cost, rel_attention_fwd, rel_attention_ref)
    dev = torch.device("cuda")

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype("float32")).to(dev)

    res = {}
    record = kernel_recorder(res, "14a")
    b, h, dk, r = 16, 4, 64, 11
    for tt in (800, 400, 200):
        q, k, v = t(b, h, tt, dk, scale=dk ** -0.5), t(b, h, tt, dk), \
            t(b, h, tt, dk)
        p = t(b, h, tt, r, scale=dk ** -0.5)
        kl = np.maximum(tt - (np.arange(b) * tt) // (2 * b), 1).tolist()
        klens = torch.tensor(kl, dtype=torch.int32, device=dev)
        args = (q, k, v, p, klens)
        what = f"B={b} H={h} T={tt} dk={dk} R={r} ragged"
        err = max_err(rel_attention(*args), rel_attention_ref(*args))
        expect(err <= KERNEL_ATOL, f"K1 {what}: error {err}")
        yard = rel_attention_yardstick(torch, args, rel_attention, what,
                                       phase="14a")
        row = res.setdefault("rel_attention", {"max_abs_err": 0.0,
                                               "shapes": []})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        shape = {"shape": what, "ms": yard["kernel_ms"],
                 "plain_ms": cuda_ms(lambda: rel_attention_ref(*args),
                                     iters=5), **yard,
                 **roofline(rel_attention_cost(b, h, tt, dk, r, kl))}
        row["shapes"].append(shape)
        if "ms" not in row:
            row.update({k_: v_ for k_, v_ in shape.items()
                        if k_ != "shape"})
        o, m, l = rel_attention_fwd(*args)
        bargs = (q, k, v, p, klens, o, m, l, t(b, h, tt, dk))
        got, want = rel_attention_bwd(*bargs), rel_attention_bwd_ref(*bargs)
        yard = rel_attention_bwd_yardstick(torch, bargs, rel_attention_bwd,
                                           what)
        record("rel_attention_bwd",
               max(rel_err(x, y) for x, y in zip(got, want)),
               yard["kernel_ms"],
               cuda_ms(lambda: rel_attention_bwd_ref(*bargs), iters=5),
               what, **yard,
               **roofline(rel_attention_bwd_cost(b, h, tt, dk, r, kl)))
        del got, want, bargs, args, o, m, l
    res["las_step"] = k2_case(torch, rng, 32, 200, 256, keep=True,
                              tag="14a")
    res["las_step"]["library_ms"] = None
    las_scan_case(torch, rng, record, b, 31, 200, 256,
                  [200 - 5 * i for i in range(b)], tag="14a")
    ctc_case(torch, rng, record, b, 400, 150, 16, tag="14a")
    return res


def tap_fits(torch, model, loader, device) -> int:
    """The train set's batches through the encoder up to the sub1 tap: each
    row's characters (one blank between repeats) must fit the tap's
    frames, so that no sub1 CTC row is infeasible (and zeroed by
    ``zero_infinity``). Returns the smallest slack in frames."""
    slack = []
    with torch.no_grad():
        for batch in loader:
            xs = torch.from_numpy(batch["xs"]).to(device)
            xl = torch.from_numpy(batch["xlens"]).to(device)
            tap = model.encoder(xs, xl, task="ys_sub1")["ys_sub1"]["xlens"]
            for i, n in enumerate(batch["ylens_sub1"].tolist()):
                y = batch["ys_sub1"][i, :n]
                need = n + int((y[1:] == y[:-1]).sum())
                slack.append(int(tap[i]) - need)
    return min(slack)


def cli_run(torch, root: Path, corpus: dict, conf: str, tag: str,
            flags: tuple, train_kernels: tuple, eval_kernels: tuple = (),
            eval_flags: tuple = (), resume: str = "",
            dev_finite: bool = False, evaluate: bool = True) -> dict:
    """``bin.asr.train.main`` on ``conf`` over ``corpus`` (``flags``, into
    ``exp_<tag>``, ``out["exp"]``), counts zeroed around it: each
    microstep's losses (random state passing's steps too), the step's
    sub-task each trained (from the CLI's log, with ``mtl_per_batch``) and
    the dev losses; then (without ``resume``, with ``evaluate``)
    ``bin.asr.eval.main`` on the test set (``eval_flags``), counts zeroed
    around it. Every microstep's loss finite (with
    ``dev_finite`` every dev loss too), ``train_kernels`` /
    ``eval_kernels`` launched, each test utterance decoded."""
    import csv
    import logging
    import math
    from neural_sp_tpu_torch.bin.asr import eval as cli_eval
    from neural_sp_tpu_torch.bin.asr import train as cli_train
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    from neural_sp_tpu_torch.parallel.mesh import TrainStep
    exp = str(root / f"exp_{tag}")
    argv = ["--config", str(ROOT / conf), "--train_set", corpus["train"],
            "--dev_set", corpus["dev"], "--dict", corpus["dict"],
            "--model_save_dir", exp] + list(flags)
    if resume:
        argv += ["--resume", f"{exp}/{resume}"]
    steps, tasks = [], []
    orig_update = TrainStep.update

    def counted(self, *a, **kw):
        m, rest = orig_update(self, *a, **kw)
        steps.append({k: float(v) for k, v in m.items()
                      if k.startswith("loss")})
        return m, rest

    class Tasks(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if ": task " in msg:
                tasks.append(int(msg.rsplit(" ", 1)[1]))

    handler = Tasks()
    logging.getLogger(cli_train.__name__).addHandler(handler)
    reset_launches()
    t0 = time.perf_counter()
    try:
        with mock.patch.object(TrainStep, "update", counted):
            cli_train.main(argv)
    finally:
        logging.getLogger(cli_train.__name__).removeHandler(handler)
    torch.cuda.synchronize()
    with open(f"{exp}/history.csv") as f:
        dev = [float(r["dev_loss_mean"]) for r in csv.DictReader(f)]
    out = {"exp": exp,
           "train": {"wall_s": time.perf_counter() - t0,
                     "microsteps": len(steps), "losses": steps,
                     "tasks": tasks, "dev_loss": dev, "launches": launches()}}
    log(f"[{tag}] train CLI {conf} {' '.join(flags)}"
        f"{' resumed' if resume else ''}: {len(steps)} microsteps in "
        f"{out['train']['wall_s']:.1f} s; tasks {tasks}; losses "
        f"{['%.3f' % x['loss'] for x in steps[:4]]}.., last microstep "
        f"{steps[-1] if steps else None}; dev loss {dev}; launches "
        f"{out['train']['launches']}")
    expect(steps and all(math.isfinite(v) for x in steps
                         for v in x.values()), f"{tag}: a loss not finite")
    expect(not dev_finite or all(map(math.isfinite, dev)),
           f"{tag}: a dev loss not finite")
    for k in train_kernels:
        expect(out["train"]["launches"][k] > 0,
               f"{k} never launched in {tag}'s train CLI")
    if resume or not evaluate:
        return out
    reset_launches()
    t0 = time.perf_counter()
    test = eval_set(corpus)
    res = cli_eval.main(["--recog_model", exp, "--recog_sets", test,
                         "--recog_dir", str(root / f"decode_{tag}")] +
                        list(eval_flags))
    torch.cuda.synchronize()
    (m,) = res.values()
    out["eval"] = {**m, "wall_s": time.perf_counter() - t0,
                   "launches": launches()}
    log(f"[{tag}] eval CLI ({' '.join(eval_flags)}): RTF {m['rtf']:.4f}, "
        f"WER {m['wer']:.2f} over {m['n_utts']} utterances (random "
        f"weights); launches {out['eval']['launches']}")
    with open(test) as f:
        n_test = sum(1 for line in f if line.strip()) - 1    # a header
    expect(m["n_utts"] == n_test, f"{tag}: {m['n_utts']} of {n_test}")
    for k in eval_kernels:
        expect(out["eval"]["launches"][k] > 0,
               f"{k} never launched in {tag}'s eval CLI")
    return out


def mtl_hold(torch, exp: str, corpus: dict, tag: str) -> dict:
    """One train() microstep of the trained model (its checkpoint) on the
    train set's first batch, the sub labels included, through the kernels
    against the plain versions by phase 6's rule (every sub head and tap
    leaf among the gradients; sampling off: pass 1's K2 is held alone,
    phase_mtl_kernels), and the microstep profiled (the kernels' device
    time)."""
    from types import SimpleNamespace
    from neural_sp_tpu_torch.bin.asr import eval as cli_eval
    from neural_sp_tpu_torch.datasets.asr.build import build_dataloader
    model, targs, _ = cli_eval.load_model_for_eval(SimpleNamespace(
        recog_model=exp, recog_n_average=1))
    for dec in (model.dec_fwd, model.dec_fwd_sub1, model.dec_fwd_sub2):
        if dec is not None:
            dec.step.ss_prob = 0.0
    loader = build_dataloader(
        corpus["train"], corpus["dict"], unit="word", batch_size=8,
        dict_path_sub1=corpus["dict_char"],
        dict_path_sub2=corpus["dict_char"] if getattr(
            targs, "enc_n_layers_sub2", 0) else None)
    batch = next(iter(loader))
    dev = next(model.parameters()).device
    main = tuple(torch.from_numpy(batch[k]).to(dev)
                 for k in ("xs", "xlens", "ys", "ylens"))
    sub = {k: torch.from_numpy(batch[k]).to(dev) for k in batch
           if "_sub" in k}
    loss, grads = train_microstep(torch, model, main, **sub)
    loss_ref, grads_ref = train_microstep(torch, model, main, plain=True,
                                          **sub)
    leaves = [n for n in grads if "sub" in n]
    expect(any(n.startswith("ctc_sub1") for n in leaves),
           f"{tag}: no sub1 CTC leaf in the microstep")
    out = hold_microstep(loss, grads, loss_ref, grads_ref, tag)
    out["profile"] = profiled(
        torch, f"{tag} train() microstep B {main[0].shape[0]} x "
        f"{main[0].shape[1]} frames", lambda: train_microstep(
            torch, model, main, **sub), tag=tag,
        kernels=("rel_att", "las_", "ctc_alpha", "ctc_beta"))
    out["sub_leaves"] = len(leaves)
    out["slack_frames"] = tap_fits(torch, model, loader, dev)
    log(f"[{tag}] {len(leaves)} sub-task leaves held; the sub1 tap's "
        f"frames exceed every row's CTC need by {out['slack_frames']} at "
        f"least")
    expect(out["slack_frames"] >= 0, f"{tag}: a sub1 CTC row is infeasible")
    del model
    torch.cuda.empty_cache()
    return out


def phase_mtl(torch, rng, root: Path) -> dict:
    """14: 14a (the AISHELL hierarchical Conformer-LAS at full width and
    depth: its kernels at its shapes, the conf's parameter count at vocab
    10,000, the train CLI for 2 epochs at accumulation 2, the eval CLI,
    a microstep held); 14b (the SWBD three-task BLSTM-LAS at MTL3_DEPTH:
    the train CLI for one epoch, then a second resumed with
    ``mtl_per_batch``, whose tasks must rotate main, sub1, sub2; the eval
    CLI; a microstep held)."""
    from neural_sp_tpu_torch.bin.args import parse_args_train
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    t0 = time.perf_counter()
    mark = len(SUB_WALLS)
    corpus = mtl_corpus(root / "data_mtl", MTL_UTTS)
    out = {"kernels": timed("14 kernels", phase_mtl_kernels, torch, rng)}
    args = parse_args_train(["--config", str(ROOT / MTL_CONF)])
    args.vocab = CLI_VOCAB
    with torch.device("meta"):
        n = sum(p.numel() for p in build_speech2text(
            args, device="meta").parameters())
    log(f"[14a] {MTL_CONF}: {n} parameters at vocab {CLI_VOCAB} (the JAX "
        f"package's count {MTL_PARAMS})")
    expect(n == MTL_PARAMS, f"14a: {n} parameters")
    out["parameters"] = n
    subs = ("--dict_sub1", corpus["dict_char"], "--dict_sub2",
            corpus["dict_char"])

    def aishell():
        a = cli_run(torch, root, corpus, MTL_CONF, "14a", MTL_OVERRIDES +
                    subs, MTL_TRAIN_KERNELS, ("rel_attention", "las_step"),
                    MTL_EVAL)
        a["hold"] = mtl_hold(torch, a["exp"], corpus, "14a")
        return a

    a = timed("14a", aishell)
    b = timed("14b", mtl_swbd, torch, root, corpus, subs)
    walls = walls_since(mark)
    out.update(aishell=a, swbd=b, sub_phase_wall_s=walls, corpus=corpus,
               phase_wall_s=time.perf_counter() - t0)
    out["launches"] = {k: sum(p[k] for p in (
        a["train"]["launches"], a["eval"]["launches"],
        b["train"]["launches"], b["eval"]["launches"],
        b["per_batch"]["launches"])) for k in a["train"]["launches"]}
    log(f"[14] walls {walls}; launches on the MTL paths {out['launches']}")
    return out


def mtl_swbd(torch, root: Path, corpus: dict, subs: tuple) -> dict:
    """14b: the SWBD three-task conf through the CLIs, then resumed with
    ``mtl_per_batch`` (the tasks must rotate), and a microstep held."""
    flags = ("--n_epochs", "1", "--unit", "word") + MTL3_DEPTH
    b = cli_run(torch, root, corpus, MTL3_CONF, "14b", flags + subs,
                MTL3_TRAIN_KERNELS, ("las_step",), MTL_EVAL)
    b["per_batch"] = cli_run(torch, root, corpus, MTL3_CONF, "14b",
                             ("--n_epochs", "2", "--unit", "word",
                              "--mtl_per_batch", "true") + MTL3_DEPTH + subs,
                             MTL3_TRAIN_KERNELS,
                             resume="ckpt.epoch-1")["train"]
    tasks = b["per_batch"]["tasks"]
    log(f"[14b] mtl_per_batch: the task of each step {tasks}")
    expect(tasks == [i % 3 for i in range(len(tasks))] and len(tasks) >= 3,
           f"14b tasks {tasks}")
    for s, task in zip(b["per_batch"]["losses"], tasks):
        keys = {k for k in s if k != "loss"}
        want = ({"loss_att"}, {"loss_ctc_sub1"}, {"loss_ctc_sub2"})[task]
        expect(keys >= want and not keys & ({"loss_ctc_sub1",
                                             "loss_ctc_sub2", "loss_att"} -
                                            want),
               f"14b task {task} trained {keys}")
    b["hold"] = mtl_hold(torch, b["exp"], corpus, "14b")
    return b



# ------------------------------------------------------------- phase 15
# attention dropout (dropout_att) through K1 / K1b, K2 / K3 / K3b; the
# TDS and gated-conv encoders; the ci_test confs
ATT_RATE = 0.1
ATT_TRAIN_KERNELS = ("rel_attention_dropout", "rel_attention_bwd_dropout",
                     "las_step_dropout", "las_scan_dropout",
                     "las_scan_bwd_dropout", "ctc_loss", "ctc_loss_bwd")
# 15k: K1 / K1b padded from the ci_test conformer's head width (d_model 8
# over 4 heads), at a training batch of its shape, with its dropout
NARROW = dict(b=32, h=4, tt=400, dk=2)
TDS_CONF = "examples/wsj/conf/asr/tds_encoder.yaml"
GLU_CONF = "examples/wsj/conf/asr/glu_encoder.yaml"
# the WSJ confs as JAX's builder reads them (C41, C42), at vocab 10,000
TDS_PARAMS, GLU_PARAMS = 31584554, 13398254
TDS_TRAIN_KERNELS = ("las_scan", "las_scan_bwd")
# the ci_test LAS decoders' widths (H 16, A 16, encoder output D 8, the
# projection P 8; C 10, K 201), their batch of 1 over 15c's longest
# utterance (CI_FRAMES: 800 frames, 200 after the BLSTM encoder's
# subsampling by 4; 100 words and <eos>)
CI_LAS = dict(b=1, u=101, tt=200, d=8, widths=(16, 16, 10, 201), n_p=8)
CI_LAS_KERNELS = ("las_step_dropout", "las_step_proj", "las_scan_dropout",
                  "las_scan_proj", "las_scan_bwd_dropout",
                  "las_scan_bwd_proj", "ctc_loss", "ctc_loss_bwd")
CI_CONFS = {"blstm_las": CI_LAS_KERNELS,
            "conformer": ("rel_attention_padded", "rel_attention_dropout",
                          "rel_attention_bwd_padded",
                          "rel_attention_bwd_dropout", "ctc_loss",
                          "ctc_loss_bwd"),
            "tds_las": CI_LAS_KERNELS}
CI_EVAL_KERNELS = {"blstm_las": ("las_step_proj",),
                   "conformer": ("rel_attention_padded",),
                   "tds_las": ("las_step_proj",)}
CI_UTTS = {"train": 16, "dev": 4, "test": 4}
CI_FRAMES = (300, 800)
GREEDY_EVAL = ("--recog_beam_width", "1")


def phase_att_kernels(torch, rng) -> dict:
    """15k: K3 / K3b with the attention weights' dropout scale at 2b's
    shape (B 32, U+1 101, T 188, D 512) and at phase 8's (T ragged to 500,
    D 1024), each against its plain version (TRAIN_KERNEL_TOL) and timed
    in turns with the same call without the mask; K2 with the LSTM
    output's keep and the attention mask (scheduled sampling's pass 1, N
    32, T 188), against its plain version (KERNEL_ATOL), timed in turns
    without the mask; K1 / K1b at the ci_test conformer's head width dk 2
    (zero-padded to 16 inside the wrapper) with dropout 0.1, against their
    plain versions at that width (``window_case``); the decoder's
    projection (``res["proj"]``): K3 / K3b with the attention mask and K2
    in pass 1 at the ci_test LAS decoders' widths (CI_LAS) and at 2b's
    shape with P 512, against the plain versions (the same tolerances)."""
    res = {}
    record = kernel_recorder(res, "15k")
    las_scan_case(torch, rng, record, TRAIN_B, 101, 188, 512,
                  [188 - 3 * i for i in range(TRAIN_B)], tag="15k", att=True)
    las_scan_case(torch, rng, record, TRAIN_B, 101, 500, BLSTM_D,
                  [500 - 9 * i for i in range(TRAIN_B)], tag="15k", att=True)
    res["las_step"] = k2_case(torch, rng, 32, 188, 512, keep=True,
                              tag="15k", att=True)
    proj = res["proj"] = {}
    record_p = kernel_recorder(proj, "15k")
    ci = CI_LAS
    las_scan_case(torch, rng, record_p, ci["b"], ci["u"], ci["tt"], ci["d"],
                  [ci["tt"]] * ci["b"], tag="15k", att=True,
                  widths=ci["widths"], n_p=ci["n_p"])
    las_scan_case(torch, rng, record_p, TRAIN_B, 101, 188, 512,
                  [188 - 3 * i for i in range(TRAIN_B)], tag="15k", att=True,
                  n_p=512)
    shapes = [k2_case(torch, rng, ci["b"], ci["tt"], ci["d"], keep=True,
                      tag="15k", att=True, widths=ci["widths"],
                      n_p=ci["n_p"]),
              k2_case(torch, rng, TRAIN_B, 188, 512, keep=True, tag="15k",
                      att=True, n_p=512)]
    proj["las_step"] = {**shapes[0], "shapes": shapes, "max_abs_err": max(
        sh["max_abs_err"] for sh in shapes)}
    n = NARROW
    res["narrow"] = window_case(
        torch, rng, n["b"], n["h"], n["tt"], n["dk"], n["tt"],
        [n["tt"] - 7 * i for i in range(n["b"])], None, "15k",
        dropout=(ATT_RATE, (0x9E3779B9, 0x7F4A7C15)))
    torch.cuda.empty_cache()
    return res


def phase_att_flagship(torch, rng) -> dict:
    """15a: the North star's conf (SS_CONF: f32, ss_prob 0.2) with
    dropout_att 0.1 at full width and depth, seeded, one train() microstep
    at phase 5's B 32 x 1500, counts zeroed before it and read after: K1
    / K1b with dropout, K2 in pass 1 with the attention mask, K3 / K3b
    with it and K4 must run. Its loss and every gradient leaf against the
    same microstep through the plain versions on the card (the same
    generator seed: the same dropout, attention and sampling masks; pass 2
    over the kernels' fed tokens, the plain pass 1's may part from them
    only at ties), by phase 6's rule."""
    from neural_sp_tpu_torch.bin.args import parse_args_train
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.utils.init_params import init_params
    args = parse_args_train(["--config", str(ROOT / SS_CONF)])
    args.vocab = CLI_VOCAB
    args.dropout_att = ATT_RATE
    model = init_params(build_speech2text(args), SEED + 15)
    expect(model.dec_fwd.step.drop_att.rate == ATT_RATE and all(
        b.mha.dropout == ATT_RATE for b in model.encoder.blocks),
        "15a: dropout_att did not reach the attention")
    batch = train_batch(torch, rng)
    held, counts = hold_sampled(torch, model, batch, "15a")
    log(f"[15a] {SS_CONF} with dropout_att {ATT_RATE}: a train() microstep "
        f"at B {TRAIN_B} x {TRAIN_FRAMES}; launches {counts}")
    for name in ATT_TRAIN_KERNELS:
        expect(counts[name] > 0, f"{name} never launched in 15a")
    del model, batch
    torch.cuda.empty_cache()
    return {"launches": counts, "hold": held}


def phase_wsj_tds(torch, root: Path, corpus: dict) -> dict:
    """15b: the WSJ TDS-LAS conf at its full width as JAX's builder reads
    it (C41: 6 layers of 21-frame kernels; the conf's parameter count at
    vocab 10,000 against the JAX package's), one epoch of phase 7's corpus
    through the train CLI at ``--unit word`` (K3 / K3b), then the eval CLI
    greedy (K2); the GLU conf built on the meta device at the JAX
    package's count (C42: 3 layers of 100:3)."""
    from neural_sp_tpu_torch.bin.args import parse_args_train
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    out = {}
    for conf, want in ((TDS_CONF, TDS_PARAMS), (GLU_CONF, GLU_PARAMS)):
        args = parse_args_train(["--config", str(ROOT / conf)])
        args.vocab = CLI_VOCAB
        with torch.device("meta"):
            n = sum(p.numel() for p in build_speech2text(
                args, device="meta").parameters())
        log(f"[15b] {conf}: {n} parameters at vocab {CLI_VOCAB} (the JAX "
            f"package's count {want})")
        expect(n == want, f"15b {conf}: {n} parameters")
        out[Path(conf).stem + "_parameters"] = n
    out.update(cli_run(torch, root, corpus, TDS_CONF, "15b",
                       ("--n_epochs", "1", "--unit", "word"),
                       TDS_TRAIN_KERNELS, ("las_step",), GREEDY_EVAL,
                       dev_finite=True))
    return out


def phase_ci_test(torch, root: Path) -> dict:
    """15c: the ci_test BLSTM-LAS, Conformer and TDS-LAS confs as written
    (every dropout 0.1 with the attention's, scheduled sampling 0.1 in
    the LAS ones, the LAS projections of 8, the Conformer's heads of width
    2) through the train CLI for one epoch (``--eval_start_epoch 1`` for a
    dev loss) and the eval CLI greedy, on a corpus of its own (CI_UTTS of
    CI_FRAMES frames): each path's kernels launched."""
    corpus = synth_corpus(root / "data_ci", CI_UTTS, CLI_VOCAB, CI_FRAMES)
    out = {}
    for name, kernels in CI_CONFS.items():
        out[name] = cli_run(
            torch, root, corpus, f"examples/ci_test/conf/asr/{name}.yaml",
            f"15c_{name}", ("--n_epochs", "1", "--eval_start_epoch", "1",
                            "--unit", "word"), kernels,
            CI_EVAL_KERNELS[name], GREEDY_EVAL, dev_finite=True)
    return out


def phase_att(torch, rng, root: Path, corpus: dict) -> dict:
    """15: 15k (K1 / K1b padded from dk 2, K2 / K3 / K3b with the attention
    mask at their shapes), 15a (the flagship with dropout_att, a microstep
    held), 15b (the WSJ TDS conf through the CLIs, the GLU conf built),
    15c (three ci_test confs through the CLIs). Returns each sub-phase's
    results, their walls and the launches on the phase's paths (15a's
    microstep, 15b's and 15c's CLIs)."""
    out, mark, tag = {}, len(SUB_WALLS), "15"
    for key, run in (("kernels", lambda: phase_att_kernels(torch, rng)),
                     ("flagship", lambda: phase_att_flagship(torch, rng)),
                     ("tds", lambda: phase_wsj_tds(torch, root, corpus)),
                     ("ci_test", lambda: phase_ci_test(torch, root))):
        out[key] = timed(f"{tag} {key}", run)
    paths = [out["flagship"]["launches"], out["tds"]["train"]["launches"],
             out["tds"]["eval"]["launches"]] + \
        [r[k]["launches"] for r in out["ci_test"].values()
         for k in ("train", "eval")]
    out["launches"] = {k: sum(p[k] for p in paths) for k in paths[0]}
    out["sub_phase_wall_s"] = walls = walls_since(mark)
    log(f"[15] walls {walls}; launches on the phase's paths "
        f"{out['launches']}")
    return out


def add_att_rows(entries, srcs, keys, att):
    """Phase 15 in the ``kernels`` line: every row's launches on its paths
    (``att_launches``), then rows for K3 / K3b with the attention mask
    (2b's and phase 8's shapes, ``no_mask_ms`` beside), K2 with it (pass
    1), K3 / K3b / K2 with the decoder's projection (the ci_test LAS
    widths, then 2b's shape at P 512), and K1 / K1b padded from dk 2 with
    dropout, each launched on phase 15's paths."""
    for e in entries:
        e["att_launches"] = att["launches"].get(e["name"], 0)
    k = att["kernels"]
    rows = [("las_scan_att", "las_scan", k["las_scan"], "las_scan_dropout"),
            ("las_scan_bwd_att", "las_scan_bwd", k["las_scan_bwd"],
             "las_scan_bwd_dropout"),
            ("las_step_att", "las_step", k["las_step"], "las_step_dropout"),
            ("las_scan_proj", "las_scan", k["proj"]["las_scan"],
             "las_scan_proj"),
            ("las_scan_bwd_proj", "las_scan_bwd", k["proj"]["las_scan_bwd"],
             "las_scan_bwd_proj"),
            ("las_step_proj", "las_step", k["proj"]["las_step"],
             "las_step_proj"),
            ("rel_attention_padded", "rel_attention", k["narrow"]["fwd"],
             "rel_attention_padded"),
            ("rel_attention_bwd_padded", "rel_attention_bwd",
             k["narrow"]["bwd"], "rel_attention_bwd_padded")]
    for name, base, row, counter in rows:
        src, rep = srcs[base]
        shapes = row.get("shapes", [row])
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": att["launches"][counter],
            **{key: row.get(key) for key in keys},
            "shape": shapes[0]["shape"],
            "no_mask_ms": shapes[0].get("no_mask_ms"),
            "other_shapes": [{x: sh.get(x) for x in (
                "shape", "ms", "no_mask_ms", "plain_ms", "bound_ms",
                "bound_by")} for sh in shapes[1:]],
            "path": "15 (attention dropout, the TDS and ci_test confs)"})
        expect(entries[-1]["launches"] > 0, f"{name} never launched on "
               f"15's paths")


def add_new_path_rows(entries, srcs, keys, streaming, stream_bf16, mtl):
    """Phases 11f and 14 in the ``kernels`` line: every row's launches on
    the bf16 MoChA path (``bf16_mocha_launches``: 11f's train and
    streaming eval CLIs and its held microstep) and on the MTL paths
    (``mtl_launches``: 14a's and 14b's train and eval CLIs); then rows for
    their shapes: K1 / K1b's bf16 entries with the streaming conf's chunk
    window (timed in phase 11 at B 32, T 400, launched on 11f's path), and
    14a's K1 / K1b at d 256, K2 in pass 1 and K3 / K3b at D 256, K4 on the
    sub1 CTC at the tap's T 400 (launched on 14's paths)."""
    for e in entries:
        e["bf16_mocha_launches"] = stream_bf16["launches"].get(e["name"], 0)
        e["mtl_launches"] = mtl["launches"].get(e["name"], 0)
    win = streaming["kernels"]["chunk"]
    for name, base, part in (
            ("rel_attention_bf16_window", "rel_attention_bf16", "fwd"),
            ("rel_attention_bwd_bf16_window", "rel_attention_bwd_bf16",
             "bwd")):
        row = next(c[part] for c in win if part in c and "B=32 " in
                   c[part]["shape"] and "bf16" in c[part]["shape"])
        src, rep = srcs[base]
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": stream_bf16["launches"][base],
            **{key: row.get(key) for key in keys}, "shape": row["shape"],
            "path": "11f (the streaming conf at bf16)"})
        expect(entries[-1]["launches"] > 0, f"{name} never launched on "
               f"11f's path")
    k = mtl["kernels"]
    for name, base, row in (
            ("rel_attention_mtl", "rel_attention", k["rel_attention"]),
            ("rel_attention_bwd_mtl", "rel_attention_bwd",
             k["rel_attention_bwd"]),
            ("las_step_mtl", "las_step", k["las_step"]),
            ("las_scan_mtl", "las_scan", k["las_scan"]),
            ("las_scan_bwd_mtl", "las_scan_bwd", k["las_scan_bwd"]),
            ("ctc_loss_sub1", "ctc_loss", k["ctc_loss"])):
        src, rep = srcs[base]
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": mtl["launches"][base],
            **{key: row.get(key) for key in keys},
            "shape": row.get("shape") or row["shapes"][0]["shape"],
            "path": "14 (the MTL confs)"})
        if base == "ctc_loss":
            entries[-1]["bwd_launches"] = mtl["launches"]["ctc_loss_bwd"]
        expect(entries[-1]["launches"] > 0, f"{name} never launched on "
               f"14's paths")


# ------------------------------------------------------------- phase 16
# trigger points: triggered attention through K2 / K3 / K3b's additive
# instantiations, MoChA's MinLT and DeCoT latency training from word
# alignments, random state passing
TRIG_CONF = "examples/tedlium/conf/asr/blstm_triggered_attention.yaml"
MINLT_CONF = "examples/librispeech/conf/asr/mocha/lstm_mocha_minlt.yaml"
DECOT_CONF = "examples/librispeech/conf/asr/mocha/lstm_mocha_decot16.yaml"
RSP_CONF = "examples/tedlium/conf/asr/mocha/lstm_mocha_rsp_enc.yaml"
# the triggered conf's parameters at vocab 10,000 (the JAX package's count
# for the same model built with attn_type "triggered": C44)
TRIG_PARAMS = 53061056
# the triggered conf's decoder at its training shape: B 32, U+1 101 steps,
# T ragged to 400 after the x4 front end, D 512 (the BLSTM's two
# directions summed), H 1024, A 512; and 2b's (T 188)
TRIG_SCAN = dict(b=32, u=101, tt=400, d=512)
TRIG_LOOKAHEAD = 2     # the conf's trigger lookahead (JAX's default)
TRIG_TRAIN_KERNELS = ("las_step_add", "las_scan_add", "las_scan_window",
                      "las_scan_bwd_add", "las_scan_bwd_window", "ctc_loss",
                      "ctc_loss_bwd")
TRIG_EVAL_KERNELS = ("las_step_add",)
# 16b's held microstep: phase 3's utterances cut to 400 frames (100 after
# the x4 front end), these label counts, the last row without alignment
LATENCY_FRAMES, LATENCY_U = 400, (10, 15, 20, 25)


def trigger_lengths(torch, kl, u: int, tt: int):
    """A window per step as a CTC alignment gives it: step s of row b
    triggers at frame (s + 1) kl[b] / u (monotone), the window the frames
    up to that plus TRIG_LOOKAHEAD, as a length: min(kl, trig + 1) [U, B]
    int32 on the card."""
    kl_t = torch.tensor(kl, dtype=torch.int32)
    steps = torch.arange(1, u + 1)[:, None]
    trig = torch.clamp(steps * kl_t[None] // u + TRIG_LOOKAHEAD, max=tt - 1)
    return torch.minimum(kl_t[None], trig + 1).to(
        torch.int32).contiguous().cuda()


def additive_scan_case(torch, rng, record, b, u, tt, d, kl, window: bool,
                       tag="16k"):
    """K3 and K3b's additive instantiations (conv_w, w_f None) at B rows, U
    steps, T frames, encoder width d (H 1024, A 512), klens ``kl``, with
    ``window`` a length per step (``trigger_lengths``), the LSTM output's
    dropout keep at rate 0.1 and no attention dropout (the triggered
    conf's dropout_att 0): against their plain versions
    (TRAIN_KERNEL_TOL), each timed in turns with the location
    instantiation (C 10, K 201) at the same shapes over all of klens
    (``location_ms``), with bounds from the cost functions (C = K = 0)."""
    from neural_sp_tpu_torch.ops.kernels.las_scan import (
        las_scan, las_scan_bwd, las_scan_bwd_cost, las_scan_bwd_ref,
        las_scan_cost, las_scan_ref)
    dev = torch.device("cuda")
    hd, a, c, kw = 1024, 512, 10, 201

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype("float32")).to(dev)

    keep = (torch.from_numpy((rng.random((u, b, hd)) >= 0.1).astype(
        "float32")) / 0.9).to(dev)
    klens = torch.tensor(kl, dtype=torch.int32, device=dev)
    lens = trigger_lengths(torch, kl, u, tt) if window else klens
    eg, w_ctx, w_h, bias = (t(u, b, 4 * hd, scale=0.5),
                            t(d, 4 * hd, scale=(d + hd) ** -0.5),
                            t(hd, 4 * hd, scale=(d + hd) ** -0.5),
                            t(4 * hd, scale=0.1))
    w_q, conv_w, w_f, v = (t(a, hd, scale=hd ** -0.5),
                           t(c, kw, scale=kw ** -0.5),
                           t(a, c, scale=c ** -0.5), t(a, scale=a ** -0.5))
    kc, values = t(b, tt, a), t(b, tt, d)
    args = (eg, w_ctx, w_h, bias, w_q, None, None, v, kc, values, lens, keep)
    loc = (eg, w_ctx, w_h, bias, w_q, conv_w, w_f, v, kc, values, klens, keep)
    outs = las_scan(*args)
    refs = las_scan_ref(*args)
    what = f"additive B={b} U={u} T={tt} H={hd} D={d} A={a}" + (
        " windowed" if window else "")
    ms, loc_ms = timed_pair(lambda: las_scan(*args),
                            lambda: las_scan(*loc), iters=5)
    record("las_scan", max(rel_err(x, y) for x, y in zip(outs, refs)), ms,
           cuda_ms(lambda: las_scan_ref(*args), iters=3, warmup=1), what,
           library_ms=None, location_ms=loc_ms,
           kernel_launches_per_call=las_scan.kernel_launches_per_call,
           **roofline(las_scan_cost(u, b, tt, hd, d, a, 0, 0,
                                    lens.tolist())))
    del outs
    grads_out = (t(u, b, hd), t(u, b, d))
    bargs = (w_ctx, w_h, w_q, None, None, v, kc, values, lens, keep,
             *refs[:6], *grads_out)
    loc_saved = las_scan(*loc)
    lbargs = (w_ctx, w_h, w_q, conv_w, w_f, v, kc, values, klens, keep,
              *loc_saved, *grads_out)
    got = las_scan_bwd(*bargs)
    want = las_scan_bwd_ref(*bargs)
    expect(got[5] is None and got[6] is None and want[5] is None,
           "K3b additive: a location gradient")
    err = max(rel_err(x, y) for x, y in zip(got, want) if y is not None)
    ms, loc_ms = timed_pair(lambda: las_scan_bwd(*bargs),
                            lambda: las_scan_bwd(*lbargs), iters=5)
    record("las_scan_bwd", err, ms,
           cuda_ms(lambda: las_scan_bwd_ref(*bargs), iters=3, warmup=1),
           what, library_ms=None, location_ms=loc_ms,
           kernel_launches_per_call=las_scan_bwd.kernel_launches_per_call,
           **roofline(las_scan_bwd_cost(u, b, tt, hd, d, a, 0, 0,
                                        lens.tolist())))


def additive_k2_case(torch, rng, n, tt, d, window: bool, tag="16k"):
    """K2's additive instantiation at N rows, T frames, encoder width d
    (H 1024, A 512): serving (``window`` False: every valid frame, no
    dropout) or scheduled sampling's pass 1 (``window``: the LSTM output's
    keep at rate 0.1 and one step's window of ``trigger_lengths`` as
    klens); both forms (the checked call and the workspace), without and
    with a beam's reorder, against the plain version (KERNEL_ATOL), the
    two forms equal bit for bit; the workspace form timed in turns with
    the location instantiation's over all of klens (``location_ms``)."""
    from neural_sp_tpu_torch.ops.kernels import las_step, las_step_ref
    from neural_sp_tpu_torch.ops.kernels.las_step import (LasStepWorkspace,
                                                          las_step_cost)
    dev = torch.device("cuda")
    hd, a, c, kw = 1024, 512, 10, 201

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype("float32")).to(dev)

    kl = [tt - 7 * i for i in range(n)]
    klens = torch.tensor(kl, dtype=torch.int32, device=dev)
    lens = trigger_lengths(torch, kl, 101, tt)[40].contiguous() if window \
        else klens
    keep = (torch.from_numpy((rng.random((n, hd)) >= 0.1).astype(
        "float32")) / 0.9).to(dev) if window else None
    carry = (t(n, d), t(n, hd, scale=0.5), t(n, hd),
             torch.softmax(t(n, tt, scale=3.0), -1))
    weights = (t(d, 4 * hd, scale=(d + hd) ** -0.5),
               t(hd, 4 * hd, scale=(d + hd) ** -0.5), t(4 * hd, scale=0.1),
               t(a, hd, scale=hd ** -0.5))
    conv_w, w_f, v = t(c, kw, scale=kw ** -0.5), t(a, c, scale=c ** -0.5), \
        t(a, scale=a ** -0.5)
    kc, values = t(n, tt, a), t(n, tt, d)
    eg = t(n, 4 * hd, scale=0.5)
    args = (eg, *carry, *weights, None, None, v, kc, values, lens)
    ws = LasStepWorkspace(*args[5:])
    ws_loc = LasStepWorkspace(*weights, conv_w, w_f, v, kc, values, klens)
    parent = torch.from_numpy(rng.integers(0, n, n).astype("int32")).to(dev)
    err = 0.0
    for par in (None, parent):
        refs = las_step_ref(*args, parent=par, keep=keep)
        outs = las_step(*args, parent=par, keep=keep)
        ws.load_carry(*carry)
        ws.eg.copy_(eg)
        if par is not None:
            ws.parent.copy_(par)
        stepped = ws.step(use_parent=par is not None, keep=keep)
        err = max(err, *(max_err(x, y) for x, y in zip(outs, refs)))
        expect(all(torch.equal(x, y) for x, y in zip(stepped, outs)),
               f"K2 additive N={n} T={tt}: the workspace form differs from "
               f"the call")
    per_step = las_step.kernels_per_step
    for w in (ws, ws_loc):
        w.eg.copy_(eg)
        w.parent.copy_(parent)
    ms, loc_ms = timed_pair(lambda: ws.step(use_parent=True, keep=keep),
                            lambda: ws_loc.step(use_parent=True, keep=keep),
                            iters=200)
    ref_ms = cuda_ms(lambda: las_step_ref(*args, parent=parent, keep=keep))
    bound = roofline(las_step_cost(n, tt, hd, d, a, 0, 0, lens.tolist()))
    shape = f"additive N={n} T={tt} D={d}" + (
        " windowed, keep (pass 1)" if window else " (serving)")
    log(f"[{tag}] K2 {shape}: max_abs_err {err:.3e}  kernel {ms:.4f} ms "
        f"through its workspace (location {loc_ms:.4f} ms in turns), "
        f"{per_step} kernels per step  twin {ref_ms:.4f} ms  bound "
        f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    expect(err <= KERNEL_ATOL, f"K2 {shape}: error {err} > {KERNEL_ATOL}")
    return {"shape": shape, "max_abs_err": err, "ms": ms,
            "location_ms": loc_ms, "kernels_per_step": per_step,
            "plain_ms": ref_ms, "library_ms": None, **bound}


def phase_trig_kernels(torch, rng) -> dict:
    """16k: K3 / K3b's additive instantiations at the triggered conf's
    training shape (TRIG_SCAN) without and with the window, and at 2b's
    (T 188) with it; K2's at 16a's beam (N TRIG_BEAM) over T 400
    (serving) and in pass 1 (N 32, T 400, a window and keep); each
    against its plain version and timed in turns with the location
    instantiation."""
    res = {}
    record = kernel_recorder(res, "16k")
    s = TRIG_SCAN
    kl = [s["tt"] - 7 * i for i in range(s["b"])]
    for window in (False, True):
        additive_scan_case(torch, rng, record, s["b"], s["u"], s["tt"],
                           s["d"], kl, window)
    additive_scan_case(torch, rng, record, TRAIN_B, 101, 188, 512,
                       [188 - 3 * i for i in range(TRAIN_B)], True)
    shapes = [additive_k2_case(torch, rng, TRIG_BEAM, 400, 512, False),
              additive_k2_case(torch, rng, 32, 400, 512, True)]
    res["las_step"] = {**shapes[0], "shapes": shapes, "max_abs_err": max(
        sh["max_abs_err"] for sh in shapes)}
    torch.cuda.empty_cache()
    return res



# 16a's eval CLI: a beam of 4 with joint CTC (the host-bound beam's wall
# is the phase's largest; K2 serves N 4 rows, as 16k times it)
TRIG_BEAM = 4
TRIG_EVAL = ("--recog_beam_width", str(TRIG_BEAM), "--recog_ctc_weight",
             "0.3")
TRIG_FLAGS = ("--n_epochs", "1", "--unit", "word", "--eval_start_epoch", "1")
LATENCY_FLAGS = ("--n_epochs", "1", "--unit", "word", "--enc_n_layers",
                 str(RNN_DEPTH))
RSP_FLAGS = ("--n_epochs", "2", "--unit", "word", "--enc_n_layers",
             str(RNN_DEPTH))


def phase_trig_conf(torch, rng, root: Path, corpus: dict) -> dict:
    """16a: the tedlium triggered-attention conf as written (C44: its
    ``triggered_attention`` read as ``triggered``) at full width and depth
    (a 5-layer BLSTM of 512 summed, the LAS decoder of 1024), seeded: a
    train() microstep at phase 5's B 32 x 1500 with scheduled sampling 0.2
    and the CTC head's trigger points, held to the plain versions by phase
    6's rule (``hold_sampled``), the forced alignment's wall in it (B8);
    then the train CLI one epoch on phase 7's corpus (V 10,000, word unit)
    and the eval CLI (TRIG_EVAL: beam 4 + CTC 0.3): K2 / K3 / K3b's
    additive instantiations, K3 / K3b with the window, K4 launched."""
    from neural_sp_tpu_torch.bin.args import parse_args_train
    from neural_sp_tpu_torch.models.decoders.ctc import CTC
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.utils.init_params import init_params
    args = parse_args_train(["--config", str(ROOT / TRIG_CONF)])
    args.vocab = CLI_VOCAB
    model = init_params(build_speech2text(args), SEED + 16)
    n_params = sum(p.numel() for p in model.parameters())
    expect(n_params == TRIG_PARAMS and model.dec_fwd.attn_type == "triggered"
           and model.dec_fwd.step.ss_prob == 0.2,
           f"16a: {n_params} parameters, {model.dec_fwd.attn_type}")
    align_s = []
    real = CTC.trigger_points

    def timed(self, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(self, *a)
        torch.cuda.synchronize()
        align_s.append(time.perf_counter() - t0)
        return out

    batch = train_batch(torch, rng)
    with mock.patch.object(CTC, "trigger_points", timed):
        held, counts = hold_sampled(torch, model, batch, "16a")
    log(f"[16a] {TRIG_CONF}: {n_params} parameters; a train() microstep at "
        f"B {TRIG_SCAN['b']} x {TRAIN_FRAMES} (T' 375): the CTC forced "
        f"alignment {[round(x * 1e3, 1) for x in align_s]} ms (kernels, "
        f"plain); launches {counts}")
    for name in TRIG_TRAIN_KERNELS:
        expect(counts[name] > 0, f"{name} never launched in 16a's microstep")
    expect(counts["las_scan"] == counts["las_scan_add"] and
           counts["las_step"] == counts["las_step_add"],
           "16a: a location instantiation launched")
    del model, batch
    torch.cuda.empty_cache()
    cli = cli_run(torch, root, corpus, TRIG_CONF, "16a", TRIG_FLAGS,
                  TRIG_TRAIN_KERNELS, TRIG_EVAL_KERNELS, TRIG_EVAL,
                  dev_finite=True)
    return {"parameters": n_params, "hold": held, "launches": counts,
            "forced_alignment_ms": [x * 1e3 for x in align_s], **cli}


def write_word_alignments(corpus: dict, root: Path) -> str:
    """Word alignments for the train and dev utterances of a corpus of
    ``synth_corpus``, in JAX's format (``dir/speaker/utt_id.txt``, a line
    ``word start end`` per word, seconds), each utterance's duration split
    evenly among its words. Returns the directory."""
    import csv
    out = root / "word_alignments"
    for split in ("train", "dev"):
        with open(corpus[split], newline="") as f:
            for r in csv.DictReader(f, delimiter="\t"):
                words = r["text"].split()
                sec = int(r["xlen"]) * FRAME_SEC
                edges = [sec * j / len(words) for j in range(len(words) + 1)]
                d = out / r["speaker"]
                d.mkdir(parents=True, exist_ok=True)
                (d / f"{r['utt_id']}.txt").write_text("".join(
                    f"{w} {edges[j]:.3f} {edges[j + 1]:.3f}\n"
                    for j, w in enumerate(words)))
    return str(out)


def latency_batch(torch, xs, xlens) -> tuple:
    """16b's model args (the MinLT conf at RNN_DEPTH, V 10,000), its batch
    (phase 3's utterances cut to LATENCY_FRAMES frames, LATENCY_U labels)
    and trigger points spread over each row's frames (-1 past its labels,
    the last row without any), all on the CPU."""
    import numpy as np
    from neural_sp_tpu_torch.bin.args import parse_args_train
    args = parse_args_train(["--config", str(ROOT / MINLT_CONF)])
    args.vocab = CLI_VOCAB
    x = torch.from_numpy(xs[:, :LATENCY_FRAMES])
    xl = torch.from_numpy(np.minimum(xlens, LATENCY_FRAMES))
    rng = np.random.default_rng(SEED + 16)
    u = max(LATENCY_U)
    ys = np.full((len(LATENCY_U), u), 3, np.int64)
    tp = np.full((len(LATENCY_U), u), -1, np.int32)
    for b, n in enumerate(LATENCY_U):
        ys[b, :n] = rng.integers(4, CLI_VOCAB, n)
        frames = int(xl[b]) // 4
        tp[b, :n] = (np.arange(1, n + 1) * (frames - 1)) // n
    tp[-1] = -1
    return mocha_args(args), (x, xl, torch.from_numpy(ys),
                              torch.tensor(LATENCY_U)), torch.from_numpy(tp)


def latency_hold(torch, xs, xlens) -> dict:
    """16b's held microstep: the MinLT conf's LSTM-MoChA (RNN_DEPTH),
    seeded, one train() microstep on phase 3's utterances cut to
    LATENCY_FRAMES frames, LATENCY_U labels and trigger points spread
    over each row's frames (-1 past its labels, the last row without
    any), carrying the latency loss, against the same microstep on the
    CPU in float64. Its float32 MoChA rounds (ROADMAP C29: where the
    cumulative product of 1 - p reaches its clip, alpha_prev / cp is
    amplified up to 1e10), and the card's scans round otherwise than the
    CPU's, so: the float32 microstep's loss and latency loss within
    WHOLE_LOSS_RTOL of float64 (its gradients' distances reported); the
    decoder's microstep (``ctc_weight`` 0: MoChA with the MinLT loss on
    the trigger points) in float64 on the card against the CPU's by 9b's
    rule, the same arithmetic, so what is held is the port's computation
    on the card and not float32's rounding; and the encoder and CTC
    head's (``ctc_weight`` 1), which carries K4, the path's kernel, in
    float32 by 9b's rule."""
    spec = reference_spec(torch, "16b", xs, xlens)
    tp = spec["trigger_points"]
    model = mocha_model(torch, spec["args"])
    dev = next(model.parameters()).device
    on_card = tuple(v.to(dev) for v in spec["batch"])
    card = mocha_microstep(torch, model, on_card, SEED,
                           trigger_points=tp.to(dev))
    cpu32 = cpu_ref("16b float32")
    cpu64 = cpu_ref("16b float64")
    obs, obs_ref = card[2], cpu64[2]
    log(f"[16b] {MINLT_CONF} at depth {RNN_DEPTH}: a train() microstep with "
        f"trigger points, card {obs}; CPU float64 {obs_ref}")
    whole = whole_microstep_readings(torch, "16b", card, cpu32, cpu64)
    whole["latency_loss_rel_err"] = abs(
        obs.get("loss_latency", 0) - obs_ref["loss_latency"]) / \
        obs_ref["loss_latency"]
    expect(obs.get("loss_latency", 0) > 0 and max(
        whole["loss_rel_err"], whole["latency_loss_rel_err"]) <=
        WHOLE_LOSS_RTOL, f"16b: the losses {obs} against float64's {obs_ref}")
    out = {"whole_microstep": whole}
    for tag, weight, double in (("decoder float64", 0.0, True),
                                ("encoder + CTC", 1.0, False)):
        model.ctc_weight = weight
        if double:
            model.double()
        batch = tuple(v.double() if v.is_floating_point() else v
                      for v in on_card) if double else on_card
        loss, grads, _ = mocha_microstep(torch, model, batch, SEED,
                                         trigger_points=tp.to(dev))
        loss_ref, grads_ref, _ = cpu_ref(f"16b float64 ctc {weight}")
        out[tag] = hold_microstep(loss, grads, loss_ref, grads_ref,
                                  f"16b {tag}", floor=True)
        model.float()
    del model
    return out


def phase_latency(torch, root: Path, corpus: dict, xs, xlens) -> dict:
    """16b: MoChA's MinLT and DeCoT (lookahead 16) LibriSpeech confs at
    RNN_DEPTH through the train CLI, one epoch on phase 7's corpus with
    ``--train_word_alignment`` / ``--dev_word_alignment`` at the
    directory ``write_word_alignments`` writes: every MinLT microstep
    carries the latency loss, every DeCoT one windows its alignment
    (``trigger_window`` called per microstep); K4 launched, no other
    kernel of the repo; then ``latency_hold``."""
    from neural_sp_tpu_torch.models.decoders.las import RNNDecoder
    align = write_word_alignments(corpus, root)
    flags = LATENCY_FLAGS + ("--train_word_alignment", align,
                             "--dev_word_alignment", align)
    out = {}
    for conf, tag in ((MINLT_CONF, "16b_minlt"), (DECOT_CONF, "16b_decot")):
        windows = []
        real = RNNDecoder.trigger_window

        def counted(self, *a):
            windows.append(a[0].shape)
            return real(self, *a)

        with mock.patch.object(RNNDecoder, "trigger_window", counted):
            run = cli_run(torch, root, corpus, conf, tag, flags,
                          MOCHA_TRAIN_KERNELS, evaluate=False)
        steps = run["train"]["losses"]
        if conf == MINLT_CONF:
            expect(all(s.get("loss_latency", 0) > 0 for s in steps),
                   f"{tag}: a microstep without the latency loss")
        else:
            expect(len(windows) == len(steps) and not any(
                "loss_latency" in s for s in steps),
                f"{tag}: {len(windows)} windows over {len(steps)} "
                f"microsteps")
        expect(all(run["train"]["launches"][k] == 0
                   for k in NOT_ON_MOCHA_PATH),
               f"{tag}: a kernel off the MoChA path launched")
        out[tag] = {**run, "windows": len(windows)}
    out["hold"] = latency_hold(torch, xs, xlens)
    return out


def phase_rsp(torch, root: Path, corpus: dict) -> dict:
    """16c: the tedlium random-state-passing conf (``rsp_prob_enc`` 0.5 as
    the rate, C16) at RNN_DEPTH through the train CLI for two epochs on
    phase 7's corpus: each step's draw, whether the carry it was handed
    came from the step before (a batch of another size starts from
    zeros) and whether it was passed on; at least one step must pass it."""
    from neural_sp_tpu_torch.parallel import mesh
    draws, steps = [], []
    real_draw, real_call = mesh.rsp_draw, mesh.RSPTrainStep.__call__

    def draw(gen, p):
        draws.append(real_draw(gen, p))
        return draws[-1]

    def call(self, carry, xs, *a, **kw):
        steps.append({"rows": int(xs.shape[0]),
                      "handed": carry is not None})
        metrics, new = real_call(self, carry, xs, *a, **kw)
        expect(len(new) == RNN_DEPTH and new[0][0].shape[0] == xs.shape[0],
               "16c: the carry's shape")
        return metrics, new

    with mock.patch.object(mesh, "rsp_draw", draw), \
            mock.patch.object(mesh.RSPTrainStep, "__call__", call):
        run = cli_run(torch, root, corpus, RSP_CONF, "16c", RSP_FLAGS,
                      MOCHA_TRAIN_KERNELS, evaluate=False)
    for s, d in zip(steps, draws):
        s["passed"] = s["handed"] and d
    log(f"[16c] {RSP_CONF}: {len(steps)} steps; draws {draws}; carry handed "
        f"{[s['handed'] for s in steps]}, passed "
        f"{[s['passed'] for s in steps]}")
    expect(len(draws) == len(steps) == len(run["train"]["losses"]) and
           any(s["passed"] for s in steps), "16c: no carry passed on")
    return {**run, "steps": steps}


def phase_trig(torch, rng, root: Path, corpus: dict, xs, xlens) -> dict:
    """16: 16k (K2 / K3 / K3b's additive instantiations, with and without
    the window), 16a (the triggered conf), 16b (MinLT and DeCoT), 16c
    (random state passing). Returns each sub-phase's results, their walls
    and the launches on the phase's paths (16a's microstep and CLIs, 16b's
    and 16c's CLIs)."""
    out, mark, tag = {}, len(SUB_WALLS), "16"
    for key, run in (("kernels", lambda: phase_trig_kernels(torch, rng)),
                     ("triggered", lambda: phase_trig_conf(torch, rng, root,
                                                           corpus)),
                     ("latency", lambda: phase_latency(torch, root, corpus,
                                                       xs, xlens)),
                     ("rsp", lambda: phase_rsp(torch, root, corpus))):
        out[key] = timed(f"{tag} {key}", run)
    trig = out["triggered"]
    paths = [trig["launches"], trig["train"]["launches"],
             trig["eval"]["launches"], out["rsp"]["train"]["launches"]] + \
        [out["latency"][k]["train"]["launches"]
         for k in ("16b_minlt", "16b_decot")]
    out["launches"] = {k: sum(p[k] for p in paths) for k in paths[0]}
    out["sub_phase_wall_s"] = walls = walls_since(mark)
    log(f"[16] walls {walls}; launches on the phase's paths "
        f"{out['launches']}")
    return out


def add_trig_rows(entries, srcs, keys, trig):
    """Phase 16 in the ``kernels`` line: every row's launches on its paths
    (``trig_launches``), then rows for K3 / K3b's additive instantiations
    at the triggered conf's shape without and with the window (each with
    the location instantiation's time at that shape, in turns,
    ``location_ms``; 2b's shape with the window in ``other_shapes``), K2's
    in serving (N TRIG_BEAM, T 400) and in pass 1 (N 32, T 400,
    windowed). A
    row's launches: its instantiation's counter on the phase's paths (K2
    in pass 1: the training paths', serving: the eval CLI's)."""
    for e in entries:
        e["trig_launches"] = trig["launches"].get(e["name"], 0)
    k = trig["kernels"]
    t = trig["triggered"]
    pass1 = t["launches"]["las_step_add"] + \
        t["train"]["launches"]["las_step_add"]
    rows = []
    for base in ("las_scan", "las_scan_bwd"):
        shapes = k[base]["shapes"]
        rows += [(f"{base}_add", base, shapes[0], [],
                  trig["launches"][f"{base}_add"]),
                 (f"{base}_add_window", base, shapes[1], shapes[2:],
                  trig["launches"][f"{base}_window"])]
    steps = k["las_step"]["shapes"]
    rows += [("las_step_add", "las_step", steps[0], [],
              t["eval"]["launches"]["las_step_add"]),
             ("las_step_add_window", "las_step", steps[1], [], pass1)]
    for name, base, row, others, launched in rows:
        src, rep = srcs[base]
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launched, **{key: row.get(key) for key in keys},
            "shape": row["shape"], "location_ms": row.get("location_ms"),
            "other_shapes": [{x: sh.get(x) for x in (
                "shape", "ms", "location_ms", "plain_ms", "bound_ms",
                "bound_by")} for sh in others],
            "path": "16 (triggered attention, MinLT / DeCoT, RSP)"})
        expect(launched > 0, f"{name} never launched on 16's paths")


# ------------------------------------------------------------- phase 17
# MBR training (SGD with weight decay, sub-step checkpoints), the
# transformer encoder with relative positions, K1 / K1b's bf16 entries
# with dropout, the MTL evaluation's resolving_unk
MBR_CONF = "examples/tedlium/conf/asr/mocha/lcblstm_mocha_chunk4040_mbr.yaml"
MBR_UTTS = {"train": 8, "dev": 2, "test": 2}
MBR_FRAMES = (200, 400)      # the conf's min_n_frames: 200
MBR_NBEST = 4                # the JAX CLI's default mbr_nbest
MBR_CE_WEIGHT = 0.01         # the conf's mbr_ce_weight
MBR_FLAGS = ("--n_epochs", "1", "--unit", "word", "--enc_n_layers",
             str(RNN_DEPTH), "--mbr_ckpt_interval", "1",
             "--eval_start_epoch", "1")
# the held microsteps' utterances and labels
MBR_HOLD_FRAMES = (240, 230, 220, 200)
MBR_HOLD_U = (30, 25, 20, 15)
# K3 / K3b at 17a's B.N rows: 4 utterances x 4 hypotheses, the n-best's
# U+1 (its hypotheses run to max_len, T') and the BLSTM-LAS's T' (240
# frames / 4), D 1024
MBR_SCAN = dict(b=16, u=61, tt=60, d=1024)
REL_CONF = "examples/timit/conf/transformer_relative.yaml"
REL_PARAMS = 35838144        # the JAX package's count at vocab 10,000
REL_B, REL_FRAMES = 32, 2000  # the conf's batch_size and max_n_frames
REL_K = dict(b=32, h=4, tt=500, dk=64)   # its encoder's K1: R = T
REL_DEPTH = ("--enc_n_layers", "4", "--dec_n_layers", "2")
REL_FLAGS = ("--n_epochs", "1", "--unit", "word") + REL_DEPTH
REL_TRAIN_KERNELS = ("rel_attention", "rel_attention_bwd", "ctc_loss",
                     "ctc_loss_bwd")
REL_EVAL = ("--recog_beam_width", "4", "--recog_ctc_weight", "0.3")
ATT_BF16_KERNELS = ("rel_attention_bf16_dropout",
                    "rel_attention_bwd_bf16_dropout")
UNK_WORDS = 4                # dev words the 17d dictionary leaves out
UNK_SHIFT = 3.0              # 17d: the decoder's <unk> logit raised by it
# 17d: the weight of the location filter's one-frame shift (the peaks of
# the trained model's attention sit on one frame)
LOC_SHIFT = 30.0
RESOLVE_UTTS = 2
RESOLVED_MIN = 3             # 17d: <unk> resolved at distinct peak frames


def rel_dropout_case(torch, rng, res, tt) -> None:
    """17k: K1 / K1b's bf16 entries with dropout ATT_RATE at the
    flagship's B32 H8 T ``tt`` dk64 R11 (ragged), on the plain version's
    own mask (the same key words): within BF16_KERNEL_TOL of the plain
    bf16 max, at most BF16_VS_F32_RATIO times the plain bf16 error against
    the plain f32 version (same mask), timed in turns with the bf16 entry
    without dropout on the same inputs (``no_dropout_ms``) and with SDPA
    at ``dropout_p`` (its own mask) as the library call."""
    import numpy as np
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_bwd, rel_attention_bwd_cost, rel_attention_bwd_ref,
        rel_attention_cost, rel_attention_fwd, rel_attention_ref)
    dev, bf = torch.device("cuda"), torch.bfloat16

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            "float32")).to(dev).to(bf)

    b, h, dk, r = TRAIN_B, 8, 64, 11
    kl = np.maximum(tt - (np.arange(b) * tt) // (2 * b), 1).tolist()
    q, k, v = t(b, h, tt, dk, scale=dk ** -0.5), t(b, h, tt, dk), \
        t(b, h, tt, dk)
    p = t(b, h, tt, r, scale=dk ** -0.5)
    klens = torch.tensor(kl, dtype=torch.int32, device=dev)
    drop = (ATT_RATE, (0x2545F491 + tt, 0x9E3779B9))
    fwd = (q, k, v, p, klens)
    fwd32 = (*(x.float() for x in (q, k, v, p)), klens)
    what = f"B={b} H={h} T={tt} dk={dk} R={r} ragged, dropout {ATT_RATE}"

    def ratio(got, plain, f32):
        return max_err(got.float(), f32) / max(max_err(plain.float(), f32),
                                               1e-30)

    o, m, l = rel_attention_fwd(*fwd, dropout=drop)
    o16 = rel_attention_ref(*fwd, dropout=drop)
    o32 = rel_attention_ref(*fwd32, dropout=drop)
    rows = {"rel_attention_bf16_dropout": (
        rel_err(o, o16), ratio(o, o16, o32),
        lambda: rel_attention_fwd(*fwd, dropout=drop),
        lambda: rel_attention_fwd(*fwd),
        lambda: rel_attention_ref(*fwd, dropout=drop),
        rel_attention_cost(b, h, tt, dk, r, kl, elem=2))}
    do = t(b, h, tt, dk)
    args = (*fwd, o, m, l, do)
    got = rel_attention_bwd(*args, dropout=drop)
    want16 = rel_attention_bwd_ref(*args, dropout=drop)
    want32 = rel_attention_bwd_ref(*fwd32, o.float(), m, l, do.float(),
                                   dropout=drop)
    o_nd, m_nd, l_nd = rel_attention_fwd(*fwd)
    rows["rel_attention_bwd_bf16_dropout"] = (
        max(rel_err(x, y) for x, y in zip(got, want16)),
        max(ratio(*xyz) for xyz in zip(got, want16, want32)),
        lambda: rel_attention_bwd(*args, dropout=drop),
        lambda: rel_attention_bwd(*fwd, o_nd, m_nd, l_nd, do),
        lambda: rel_attention_bwd_ref(*args, dropout=drop),
        rel_attention_bwd_cost(b, h, tt, dk, r, kl, elem=2))
    del got, want16, want32, o16, o32
    bias = rel_bias(torch, p, klens)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    bias_g = bias.detach().requires_grad_()
    with efficient_sdpa():
        out = sdpa(*leaves, attn_mask=bias_g, dropout_p=ATT_RATE, scale=1.0)
        libs = {"rel_attention_bf16_dropout": lambda: sdpa(
                    q, k, v, attn_mask=bias, dropout_p=ATT_RATE, scale=1.0),
                "rel_attention_bwd_bf16_dropout": lambda: torch.autograd.grad(
                    out, (*leaves, bias_g), do, retain_graph=True)}
        for name, (err, vs, kern, nodrop, plain, cost) in rows.items():
            ms, no_ms = timed_pair(kern, nodrop, iters=10)
            lib_ms = cuda_ms(libs[name], iters=10)
            row = {"shape": what, "max_abs_err": err, "vs_f32_ratio": vs,
                   "ms": ms, "no_dropout_ms": no_ms, "library_ms": lib_ms,
                   "plain_ms": cuda_ms(plain, iters=3, warmup=1),
                   **roofline(cost, bf16=True)}
            log(f"[17k] {name} {what}: error {err:.3e} of the plain bf16 "
                f"max, {vs:.3f}x the plain bf16 error against f32; kernel "
                f"{ms:.4f} ms (without dropout, in turns: {no_ms:.4f})  "
                f"plain {row['plain_ms']:.4f}  library (SDPA, dropout_p "
                f"{ATT_RATE}) {lib_ms:.4f}  bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}, bf16 peak)")
            expect(err <= BF16_KERNEL_TOL, f"17k {name} {what}: error {err}")
            expect(vs <= BF16_VS_F32_RATIO,
                   f"17k {name} {what}: {vs:.3f}x the plain bf16 error")
            r_ = res.setdefault(name, {"max_abs_err": 0.0, "shapes": []})
            r_["max_abs_err"] = max(r_["max_abs_err"], err)
            r_["shapes"].append(row)
            if tt == 750:      # the flagship's training shape, the row's
                r_.update({k_: v_ for k_, v_ in row.items()
                           if k_ not in ("shape", "max_abs_err")})
    del args, fwd, fwd32, o, m, l, do, out, leaves, bias, bias_g
    torch.cuda.empty_cache()


def phase_mbr_kernels(torch, rng) -> dict:
    """17k: K1 / K1b (float32) at the timit encoder's shape (REL_K: B32 H4
    T 500 ragged, dk 64, R = T unclamped, no window: the table past 16
    rows read through L1) against their plain versions at 1e-4, with SDPA
    (the bias as its mask) as the library call, their byte bound reading
    the [B, H, T, T] table; K1 / K1b bf16 with dropout
    (``rel_dropout_case``) at T 750 / 375 / 188; K3 / K3b at 17a's B.N
    rows (MBR_SCAN) and K2 in its beam (N MBR_NBEST, MBR_SCAN's T and
    D)."""
    import numpy as np
    from neural_sp_tpu_torch.ops.kernels import rel_attention
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_bwd, rel_attention_bwd_cost, rel_attention_bwd_ref,
        rel_attention_cost, rel_attention_fwd, rel_attention_ref)
    dev = torch.device("cuda")

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype("float32")).to(dev)

    res = {}
    record = kernel_recorder(res, "17k")
    b, h, tt, dk = (REL_K[x] for x in ("b", "h", "tt", "dk"))
    r = tt
    kl = [tt - 11 * i for i in range(b)]
    q, k, v = t(b, h, tt, dk, scale=dk ** -0.5), t(b, h, tt, dk), \
        t(b, h, tt, dk)
    p = t(b, h, tt, r, scale=dk ** -0.5)
    klens = torch.tensor(kl, dtype=torch.int32, device=dev)
    fargs = (q, k, v, p, klens)
    what = f"B={b} H={h} T={tt} dk={dk} R={r} ragged, no window"
    err = max_err(rel_attention(*fargs), rel_attention_ref(*fargs))
    expect(err <= KERNEL_ATOL, f"17k K1 {what}: error {err}")
    yard = rel_attention_yardstick(torch, fargs, rel_attention, what,
                                   phase="17k")
    res["rel_attention_unclamped"] = {
        "shape": what, "max_abs_err": err, "ms": yard["kernel_ms"],
        "plain_ms": cuda_ms(lambda: rel_attention_ref(*fargs), iters=5),
        **yard, **roofline(rel_attention_cost(b, h, tt, dk, r, kl))}
    log(f"[17k] K1 {what}: error {err:.3e}  kernel {yard['kernel_ms']:.4f} "
        f"ms  plain {res['rel_attention_unclamped']['plain_ms']:.4f}  bound "
        f"{res['rel_attention_unclamped']['bound_ms']:.4f} ms "
        f"({res['rel_attention_unclamped']['bound_by']})")
    o, m, l = rel_attention_fwd(*fargs)
    args = (*fargs, o, m, l, t(b, h, tt, dk))
    got, want = rel_attention_bwd(*args), rel_attention_bwd_ref(*args)
    err = max(rel_err(x, y) for x, y in zip(got, want))
    del got, want
    yard = rel_attention_bwd_yardstick(torch, args, rel_attention_bwd, what)
    record("rel_attention_bwd", err, yard["kernel_ms"],
           cuda_ms(lambda: rel_attention_bwd_ref(*args), iters=3),
           what, **yard, **roofline(rel_attention_bwd_cost(b, h, tt, dk, r,
                                                           kl)))
    res["rel_attention_bwd_unclamped"] = res.pop("rel_attention_bwd")
    del args, fargs, o, m, l, q, k, v, p
    torch.cuda.empty_cache()
    for tt in (750, 375, 188):
        rel_dropout_case(torch, rng, res, tt)
    s = MBR_SCAN
    las_scan_case(torch, rng, record, s["b"], s["u"], s["tt"], s["d"],
                  [s["tt"] - 5 * (i % 8) for i in range(s["b"])], tag="17k")
    res["las_step"] = k2_case(torch, rng, MBR_NBEST, s["tt"], s["d"],
                              tag="17k")
    torch.cuda.empty_cache()
    return res


def mbr_batch(rng, vocab: int = CLI_VOCAB) -> dict:
    """17a's held batch: MBR_HOLD_FRAMES utterances (numpy seeded) with
    MBR_HOLD_U random words each, as a loader's batch dict."""
    import numpy as np
    xs = np.zeros((len(MBR_HOLD_FRAMES), max(MBR_HOLD_FRAMES), 80),
                  np.float32)
    for i, n in enumerate(MBR_HOLD_FRAMES):
        xs[i, :n] = rng.standard_normal((n, 80))
    u = max(MBR_HOLD_U)
    ys = np.full((len(MBR_HOLD_U), u), 3, np.int64)
    for i, n in enumerate(MBR_HOLD_U):
        ys[i, :n] = rng.integers(4, vocab, n)
    return {"xs": xs, "xlens": np.asarray(MBR_HOLD_FRAMES, np.int64),
            "ys": ys, "ylens": np.asarray(MBR_HOLD_U, np.int64),
            "utt_ids": [f"mbr_{i}" for i in range(len(MBR_HOLD_U))],
            "text": [word_text(y[:n]) for y, n in zip(ys, MBR_HOLD_U)]}


def word_text(ids) -> str:
    """synth_corpus's words of token ids (>= 4; the reserved ids by
    number)."""
    return " ".join(f"w{int(i) - 4:04d}" if i >= 4 else f"<{int(i)}>"
                    for i in ids)


def recorded_nbest(torch, session, batch) -> tuple:
    """The MBR n-best of ``batch`` (``bin.asr.train.mbr_nbest``) through
    ``session``, each utterance's beam recorded: (the n-best's tensors
    (nbest_ys, nbest_ylens, risks, as numpy), [(n-best, the pruning
    margins, the n-best's scores)] per utterance)."""
    from neural_sp_tpu_torch.bin.asr.train import mbr_nbest
    records, real = [], session._beam_one

    def beam(e, el):
        out = real(e, el)
        records.append((out[1], list(session._last_margins),
                        list(session._last_nbest_scores)))
        return out

    session._beam_one = beam
    try:
        tensors = mbr_nbest(session, batch, word_text, MBR_NBEST)
    finally:
        del session._beam_one
    return tensors, records


def nbest_agree(card: tuple, cpu: tuple) -> dict:
    """Two runs' n-best of one utterance ((n-best, margins, scores) of
    ``recorded_nbest``) held to each other up to the card's first decision
    under DECISION_MARGIN: with none (a pruning step's margin, or two
    neighbouring final scores), the n-best lists equal; else the
    hypotheses cut to that step's tokens equal as sets."""
    nb, margins, scores = card
    close = next((i for i, x in enumerate(margins) if x < DECISION_MARGIN),
                 None)
    tied = any(a - b < DECISION_MARGIN for a, b in zip(scores, scores[1:]))
    if close is None and not tied:
        same = nb == cpu[0]
    else:
        n = close if close is not None else max(map(len, nb + cpu[0]))
        same = sorted(tuple(h[:n]) for h in nb) == \
            sorted(tuple(h[:n]) for h in cpu[0])
    return {"same": same, "first_close_step": close, "final_tie": tied,
            "least_margin": min(margins, default=float("inf"))}


def mbr_microstep(torch, model, tensors, plain=False,
                  weights=None) -> tuple:
    """One MBR microstep as the train CLI's (``Speech2Text.mbr_loss`` in
    eval(), MBR_CE_WEIGHT), through the kernels or, with ``plain``, the
    plain versions patched in; with ``weights`` [B.N], its well-conditioned
    part instead: the encoder and the main decoder's ``sequence_log_prob``
    over the B.N n-best rows (eouts repeated N times, as ``forward_mbr``),
    summed with those weights. Returns (loss, {leaf: gradient as float64
    on the host, 0 for a leaf the loss does not reach}, observations)."""
    from contextlib import ExitStack
    from neural_sp_tpu_torch.parallel.mesh import deterministic_cudnn
    model.eval()
    model.zero_grad(set_to_none=True)
    with ExitStack() as stack:
        if plain:
            for target, name, value in plain_patches(torch):
                stack.enter_context(mock.patch.object(target, name, value))
        stack.enter_context(deterministic_cudnn())
        if weights is None:
            loss, obs = model.mbr_loss(*tensors, MBR_CE_WEIGHT)
        else:
            xs, xlens, ys, yl = tensors[:4]
            bs, n, u = ys.shape
            e = model.encoder(xs, xlens)["ys"]
            lp = model.dec_fwd.sequence_log_prob(
                e["xs"].repeat_interleave(n, 0),
                e["xlens"].repeat_interleave(n, 0), ys.reshape(bs * n, u),
                yl.reshape(bs * n))
            loss = (lp * weights.to(lp)).sum()
            obs = {"lp_mean": lp.mean()}
        loss.backward()
    grads = {n: torch.zeros(p.shape, dtype=torch.float64) if p.grad is None
             else p.grad.detach().double().cpu()
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads, {k: float(v.detach())
                                         for k, v in obs.items()}


def mbr_tensors(torch, batch, nb, device, double=False) -> tuple:
    """``Speech2Text.mbr_loss``'s inputs on ``device``: the batch's
    features (float64 with ``double``), lengths and labels, the n-best's
    (nbest_ys, nbest_ylens, risks) ``nb``."""
    xs = torch.from_numpy(batch["xs"])
    xs = xs.double() if double else xs
    ys, yl, risks = (torch.from_numpy(x) for x in nb)
    return tuple(x.to(device) for x in (
        xs, torch.from_numpy(batch["xlens"]), ys, yl,
        risks.double() if double else risks, torch.from_numpy(batch["ys"]),
        torch.from_numpy(batch["ylens"])))


def mbr_las_hold(torch, rng) -> dict:
    """17a: phase 8's BLSTM-LAS (at RNN_DEPTH) with ``mbr_training``: the
    n-best of MBR_HOLD_FRAMES utterances from its beam (K2), then
    * the sequence scores of the B.N n-best rows (K3 / K3b), summed with
      fixed seeded weights, and their gradients, through the kernels held
      by phase 6's rule to the same through the plain versions;
    * one MBR microstep through the kernels (K3 / K3b over the B.N rows,
      K4 in the CE term) held by 6b's rule (``path_rule``) to the same
      microstep through the plain versions in float64 on the card, against
      the plain versions' own float32 microstep: the random weights'
      n-best scores lie within float32's rounding of each other, so the
      expected risk's gradient is rounding in float32 on any path (PERF.md
      §6, PR 21); the scores' check above is the kernels' tight one."""
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    model = blstm_model(torch)
    batch = mbr_batch(rng)
    session = Speech2TextSession(model, DecodeConfig(
        beam_width=max(MBR_NBEST, 4), n_best=MBR_NBEST))
    reset_launches()
    nb, _ = recorded_nbest(torch, session, batch)
    beam = launches()
    dev = next(model.parameters()).device
    tensors = mbr_tensors(torch, batch, nb, dev)
    rows = nb[0].shape[0] * nb[0].shape[1]
    # positive weights: a weighted teacher-forced NLL over the rows
    weights = torch.from_numpy(-(0.5 + rng.random(rows)) / rows).to(dev)
    reset_launches()
    loss_s, grads_s, obs_s = mbr_microstep(torch, model, tensors,
                                           weights=weights)
    scores = launches()
    loss_sp, grads_sp, _ = mbr_microstep(torch, model, tensors, plain=True,
                                         weights=weights)
    log(f"[17a] BLSTM-LAS sequence scores of the {rows} n-best rows, "
        f"weighted: {obs_s}; launches {scores}")
    held_scores = hold_microstep(loss_s, grads_s, loss_sp, grads_sp,
                                 "17a BLSTM-LAS scores")
    reset_launches()
    loss, grads, obs = mbr_microstep(torch, model, tensors)
    counts = launches()
    loss_p, grads_p, _ = mbr_microstep(torch, model, tensors, plain=True)
    model.double()
    loss64, grads64, _ = mbr_microstep(
        torch, model, mbr_tensors(torch, batch, nb, dev, double=True),
        plain=True)
    log(f"[17a] BLSTM-LAS MBR microstep: n-best {nb[0].shape} (B, N, U); "
        f"obs {obs}; beam launches {beam}; microstep launches {counts}")
    expect(beam["las_step"] > 0, "17a: K2 never launched in the n-best")
    for name in ("las_scan", "las_scan_bwd"):
        expect(scores[name] > 0, f"17a: {name} never launched in the "
               f"sequence scores")
    for name in ("las_scan", "las_scan_bwd", "ctc_loss", "ctc_loss_bwd"):
        expect(counts[name] > 0, f"17a: {name} never launched in the MBR "
               f"microstep")
    held = path_rule(torch, loss, grads, loss_p, grads_p, loss64, grads64,
                     "17a BLSTM-LAS", ("float32", "plain f32", "plain f64"))
    del model, session
    torch.cuda.empty_cache()
    return {"hold": held, "hold_scores": held_scores, "obs": obs,
            "obs_scores": obs_s, "nbest_shape": list(nb[0].shape),
            "beam_launches": beam, "launches": counts,
            "scores_launches": scores}


def mbr_mocha_hold(torch, rng) -> dict:
    """17a: the MBR conf's LC-BLSTM-MoChA (at RNN_DEPTH), seeded: its n-best
    of MBR_HOLD_FRAMES utterances on the card against the CPU port's on
    the same weights (``nbest_agree``), then the MBR microstep on the card
    in float64 held to the same microstep on the CPU in float64 by 9b's
    rule, and the card's float32 microstep held to the CPU's float64 by
    6b's rule against the CPU's float32 (``path_rule``: the expected
    risk's gradient is rounding in float32, see ``mbr_las_hold``); no
    kernel of the repo runs."""
    from neural_sp_tpu_torch.bin.args import parse_args_train
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    from neural_sp_tpu_torch.utils.init_params import init_params
    args = parse_args_train(["--config", str(ROOT / MBR_CONF)])
    args.vocab, args.enc_n_layers = CLI_VOCAB, RNN_DEPTH
    model = init_params(build_speech2text(args), SEED + 17).eval()
    cpu = build_speech2text(args, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu.eval()
    batch = mbr_batch(rng)
    conf = DecodeConfig(beam_width=max(MBR_NBEST, 4), n_best=MBR_NBEST)
    reset_launches()
    t0 = time.perf_counter()
    nb, card = recorded_nbest(torch, Speech2TextSession(model, conf), batch)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, ref = recorded_nbest(torch, Speech2TextSession(cpu, conf), batch)
    cpu_s = time.perf_counter() - t0
    agree = [nbest_agree(c, r) for c, r in zip(card, ref)]
    log(f"[17a] {MBR_CONF}: n-best on the card ({card_s:.1f} s) and on the "
        f"CPU ({cpu_s:.1f} s): {agree}")
    expect(all(a["same"] for a in agree), "17a: the card's n-best parts "
           "from the CPU port's before a close decision")
    dev = next(model.parameters()).device
    loss, grads, obs = mbr_microstep(torch, model,
                                     mbr_tensors(torch, batch, nb, dev))
    counts = launches()
    t0 = time.perf_counter()
    loss32, grads32, _ = mbr_microstep(
        torch, cpu, mbr_tensors(torch, batch, nb, "cpu"))
    cpu.double()
    loss_ref, grads_ref, obs_ref = mbr_microstep(
        torch, cpu, mbr_tensors(torch, batch, nb, "cpu", double=True))
    cpu_s = time.perf_counter() - t0
    model.double()
    loss64, grads64, _ = mbr_microstep(
        torch, model, mbr_tensors(torch, batch, nb, dev, double=True))
    log(f"[17a] MoChA MBR microstep: card {obs}; CPU float64 {obs_ref} "
        f"(the CPU's float32 and float64 microsteps {cpu_s:.1f} s); "
        f"launches {counts}")
    expect(all(counts[k] == 0 for k in NOT_ON_MOCHA_PATH + (
        "ctc_loss", "ctc_loss_bwd")), f"17a: a kernel ran for MoChA {counts}")
    held = hold_microstep(loss64, grads64, loss_ref, grads_ref,
                          "17a MoChA float64", floor=True)
    held32 = path_rule(torch, loss, grads, loss32, grads32, loss_ref,
                       grads_ref, "17a MoChA float32",
                       ("card f32", "CPU f32", "CPU f64"))
    del model, cpu
    torch.cuda.empty_cache()
    return {"nbest": agree, "card_nbest_s": card_s, "cpu_nbest_s": cpu_s,
            "hold_float64": held, "hold_float32": held32, "obs": obs,
            "obs_float64": obs_ref}


def phase_mbr(torch, rng, root: Path) -> dict:
    """17a: MBR training. The MBR conf (LC-BLSTM-512 summed at RNN_DEPTH,
    LSTM-1024 MoChA decoder, V 10,000, SGD with weight decay) through the
    train CLI for one MBR epoch over a seeded corpus of MBR_UTTS (2 batches
    of 4) with a checkpoint after each batch, then resumed from the second
    one for an epoch of one batch; its n-best and microstep held
    (``mbr_mocha_hold``); phase 8's BLSTM-LAS with MBR, K2 / K3 / K3b / K4
    on its path (``mbr_las_hold``)."""
    import os
    corpus = synth_corpus(root / "data_mbr", MBR_UTTS, CLI_VOCAB,
                          frames=MBR_FRAMES)
    run = cli_run(torch, root, corpus, MBR_CONF, "17a", MBR_FLAGS, (),
                  dev_finite=True, evaluate=False)
    names = sorted(d for d in os.listdir(run["exp"]) if d.startswith("ckpt"))
    log(f"[17a] checkpoints {names}")
    expect(names == ["ckpt.epoch-1", "ckpt.epoch-1-step-1",
                     "ckpt.epoch-1-step-2"] and run["train"]["microsteps"]
           == 2, f"17a: {run['train']['microsteps']} MBR steps, {names}")
    expect(all(set(s) == {"loss", "loss_mbr", "loss_ce"}
               for s in run["train"]["losses"]), "17a: not an MBR step")
    # resumed from the second sub-step for one batch of the train set
    rows = Path(corpus["train"]).read_text().splitlines()[:5]
    one = root / "data_mbr" / "train_one_batch.tsv"
    one.write_text("\n".join(rows) + "\n")
    resumed = cli_run(torch, root, {**corpus, "train": str(one)}, MBR_CONF,
                      "17a", MBR_FLAGS, (), resume="ckpt.epoch-1-step-2")
    expect(resumed["train"]["microsteps"] == 1, "17a: the resumed epoch")
    for r in (run, resumed):
        expect(all(r["train"]["launches"][k] == 0 for k in
                   NOT_ON_MOCHA_PATH), "17a: a kernel ran in MoChA's CLI")
    return {"cli": run, "resumed": resumed["train"],
            "mocha": mbr_mocha_hold(torch, rng),
            "las": mbr_las_hold(torch, rng)}


def rel_batch(torch, rng) -> tuple:
    """17b's microbatch: REL_B utterances ragged from REL_FRAMES down to
    half of it, x 80, TRAIN_U labels, on the card."""
    dev = torch.device("cuda")
    xlens = [REL_FRAMES - (REL_FRAMES // 2 * i) // REL_B
             for i in range(REL_B)]
    xs = rng.standard_normal((REL_B, REL_FRAMES, 80)).astype("float32")
    ys = rng.integers(4, CLI_VOCAB, (REL_B, TRAIN_U)).astype("int64")
    return (torch.from_numpy(xs).to(dev),
            torch.tensor(xlens, device=dev),
            torch.from_numpy(ys).to(dev),
            torch.full((REL_B,), TRAIN_U, device=dev))


def phase_relative(torch, rng, root: Path, corpus: dict) -> dict:
    """17b: the timit transformer with relative positions (REL_CONF: d 256,
    4 heads, d_ff 2048, 12 + 6 layers, CTC 0.3, V 10,000) at full width and
    depth, seeded, its parameters the JAX package's count; one eval()
    microstep at B REL_B x up to REL_FRAMES frames (K1 / K1b at R = T 500,
    K4) held to the plain versions by phase 6's rule, the plain run's ReLU
    masks pinned to the kernels' run; the train CLI one epoch on phase 7's
    corpus and the eval CLI at REL_EVAL, at REL_DEPTH."""
    from neural_sp_tpu_torch.bin.args import parse_args_train
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    from neural_sp_tpu_torch.utils.init_params import init_params
    args = parse_args_train(["--config", str(ROOT / REL_CONF)])
    args.vocab = CLI_VOCAB
    model = init_params(build_speech2text(args), SEED + 17)
    n = sum(p.numel() for p in model.parameters())
    blocks = model.encoder.blocks
    expect(n == REL_PARAMS and all(b.relative and not b.conformer and
                                   b.mha.clamp_len < 0 for b in blocks),
           f"17b: {n} parameters")
    batch = rel_batch(torch, rng)
    # the ReLU FFNs' masks of the kernels' run pinned in the plain run: a
    # mask flips where a pre-activation lies within float32's error of 0
    # (phase 10's method)
    ffns, pre, pre_plain = relu_ffns(torch, model), {}, {}
    hooks = keep_pre_activations(ffns, pre)
    reset_launches()
    loss, grads = eval_microstep(torch, model, batch)
    counts = launches()
    for h in hooks:
        h.remove()
    hooks = keep_pre_activations(ffns, pre_plain)
    saved = {k: m.act for k, m in ffns.items()}
    for k, m in ffns.items():
        m.act = lambda x, keep=(pre[k] > 0).to(pre[k].dtype): x * keep
    try:
        loss_ref, grads_ref = eval_microstep(torch, model, batch, plain=True)
    finally:
        for k, m in ffns.items():
            m.act = saved[k]
        for h in hooks:
            h.remove()
    flips = sum(int(((pre[k] > 0) != (pre_plain[k] > 0)).sum()) for k in pre)
    log(f"[17b] {REL_CONF}: {n} parameters; an eval() microstep at B "
        f"{REL_B} x {REL_FRAMES} frames; launches {counts}; {flips} of "
        f"{sum(x.numel() for x in pre.values())} ReLU pre-activations of "
        f"the plain run flip sign (its masks pinned to the kernels')")
    for name in REL_TRAIN_KERNELS:
        expect(counts[name] > 0, f"17b: {name} never launched")
    held = hold_microstep(loss, grads, loss_ref, grads_ref, "17b",
                          zero_leaf="w_key.bias")
    held["relu_flips"] = flips
    del pre, pre_plain
    del model, batch, grads, grads_ref
    torch.cuda.empty_cache()
    cli = cli_run(torch, root, corpus, REL_CONF, "17b", REL_FLAGS,
                  REL_TRAIN_KERNELS, ("rel_attention", ), REL_EVAL,
                  dev_finite=True)
    return {"parameters": n, "hold": held, "launches": counts, **cli}


def phase_att_bf16(torch, rng) -> dict:
    """17c: the North star's conf (SS_CONF) at bf16 compute with
    dropout_att ATT_RATE (sampling off), full width and depth, seeded: one
    train() microstep at phase 5's B 32 x 1500, its masks pinned by one
    generator seed in the three runs, held by phase 6b's rule (through the
    kernels at bf16 against the plain versions at bf16 and at float32):
    K1 / K1b's bf16 dropout entries run once per layer each."""
    from neural_sp_tpu_torch.bin.args import parse_args_train
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    from neural_sp_tpu_torch.utils.init_params import init_params
    args = parse_args_train(["--config", str(ROOT / SS_CONF)])
    args.vocab, args.dropout_att, args.ss_prob = CLI_VOCAB, ATT_RATE, 0.0
    model = init_params(build_speech2text(args), SEED + 17)
    batch = train_batch(torch, rng)
    counts = {}

    def microstep(dtype, plain):
        if not plain:
            reset_launches()
        loss, grads, _ = mocha_microstep(torch, model, batch, SEED + 17,
                                         dtype, plain)
        if not plain:
            counts.update(launches())
        return loss, grads

    held = phase_train_parity_bf16(torch, model, batch,
                                   microstep(None, True), "17c", microstep)
    layers = len(model.encoder.blocks)
    log(f"[17c] {SS_CONF} at bf16 with dropout_att {ATT_RATE}: launches "
        f"{counts}")
    expect(all(counts[k] == layers for k in ATT_BF16_KERNELS) and
           counts["rel_attention"] == counts["rel_attention_bwd"] == 0,
           f"17c: K1 / K1b's bf16 dropout entries {counts}")
    del model, batch
    torch.cuda.empty_cache()
    return {"hold": held, "launches": counts}


def advance_attention(torch, attn) -> None:
    """The location filter of the LAS attention ``attn`` set to move its
    peak one frame a step: conv channel 0 reads the previous weights one
    frame back (a SAME-padded cross-correlation), ``w_conv`` maps it to
    LOC_SHIFT sign(v) (the energy rises one frame past the last peak), the
    other channels off."""
    with torch.no_grad():
        w = attn.conv.weight                   # [C, 1, K]
        w.zero_()
        w[0, 0, w.shape[-1] // 2 - 1] = 1.0
        attn.w_conv.weight.zero_()
        attn.w_conv.weight[:, 0] = LOC_SHIFT * torch.sign(
            attn.v.weight.view(-1))


def blank_shift(torch, model, loader) -> tuple:
    """(shift, margin): the sub1 CTC's blank logit raised by ``shift`` puts
    a tenth to nine tenths of the valid frames of ``loader``'s utterances
    on blank, so that its best path emits at many frames (the trained
    model's emits one character at every frame, which collapses to one
    token). The shift is taken midway across the widest spacing of the
    frames' sorted gaps (best non-blank minus blank log-probability) in
    that range: no frame's argmax then lies within ``margin`` of a tie."""
    import numpy as np
    from neural_sp_tpu_torch import BLANK
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
    session = Speech2TextSession(model.eval(), DecodeConfig())
    gaps = []
    for batch in loader:
        eouts = session.encode(batch["xs"], batch["xlens"])
        tap = eouts["ys_sub1" if "ys_sub1" in eouts else "ys"]
        with torch.inference_mode():
            lp = model.ctc_sub1.log_probs(tap["xs"]).cpu()
        for row, n in zip(lp, tap["xlens"].tolist()):
            row = row[:n]
            best = torch.cat([row[:, :BLANK], row[:, BLANK + 1:]], 1)
            gaps.append((best.max(1).values - row[:, BLANK]).numpy())
    gaps = np.sort(np.concatenate(gaps))
    mid = gaps[len(gaps) // 10: 9 * len(gaps) // 10 + 1]
    i = int(np.argmax(np.diff(mid)))
    return float(mid[i] + mid[i + 1]) / 2, float(mid[i + 1] - mid[i]) / 2


def phase_resolving_unk(torch, root: Path, mtl: dict) -> dict:
    """17d: ``eval_word(resolving_unk=True)`` over 14a's trained AISHELL
    hierarchical model (word main task, char sub1 CTC) on the first
    RESOLVE_UTTS dev utterances of phase 14's corpus, through a word
    dictionary without UNK_WORDS of their words (those map to <unk>),
    beam 4 + CTC 0.3. On both sides the decoder's <unk> logit is raised by
    UNK_SHIFT (so that the beam emits it), its attention made to advance a
    frame a step (``advance_attention``: the trained model's peaks sit on
    one frame, where only an utterance's first <unk> takes characters) and
    the sub1 CTC's blank logit raised to win a share of the frames
    (``blank_shift``). Each utterance's
    resolved text and the WER on the card equal to the CPU port's on the
    same weights, up to the card's first beam decision under
    DECISION_MARGIN; on each side at least RESOLVED_MIN <unk> resolved to
    characters at distinct attention-peak frames."""
    from types import SimpleNamespace
    from neural_sp_tpu_torch import BLANK, UNK
    from neural_sp_tpu_torch.bin.asr import eval as cli_eval
    from neural_sp_tpu_torch.datasets.asr.build import build_dataloader
    from neural_sp_tpu_torch.evaluators import asr as evaluators
    from neural_sp_tpu_torch.models.decoders.decoding import (
        DecodeConfig, Speech2TextSession)
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    corpus = mtl["corpus"]
    model, targs, _ = cli_eval.load_model_for_eval(SimpleNamespace(
        recog_model=mtl["aishell"]["exp"], recog_n_average=1))
    rows = Path(corpus["dev"]).read_text().splitlines()[:RESOLVE_UTTS + 1]
    dev_tsv = root / "dev_resolve.tsv"
    dev_tsv.write_text("\n".join(rows) + "\n")
    dropped = {w for r in rows[1:] for w in r.split("\t")[5].split()[:2]}
    dropped = sorted(dropped)[:UNK_WORDS]
    word_dict = root / "dict_word_unk.txt"
    word_dict.write_text("".join(
        line + "\n" for line in Path(corpus["dict"]).read_text().splitlines()
        if line.split()[0] not in dropped))
    loader = build_dataloader(str(dev_tsv), str(word_dict), unit="word",
                              batch_size=RESOLVE_UTTS, is_test=True,
                              dict_path_sub1=corpus["dict_char"])
    shift, margin = blank_shift(torch, model, loader)
    expect(margin >= DECISION_MARGIN, f"17d: the sub1 blank shift {shift} "
           f"lies {margin} from a frame's tie")
    with torch.no_grad():
        model.dec_fwd.step.output.bias[UNK] += UNK_SHIFT
        model.ctc_sub1.output.bias[BLANK] += shift
    advance_attention(torch, model.dec_fwd.step.attn)
    cpu = build_speech2text(targs, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    conf = DecodeConfig(beam_width=4, ctc_weight=0.3)
    out = {}
    for where, m in (("card", model), ("cpu", cpu)):
        session = Speech2TextSession(m.eval(), conf)
        calls, real_resolve = [], evaluators.resolve_unk_text
        real_beam = session._beam_one

        def beam(e, el):
            res = real_beam(e, el)
            calls.append({"margins": list(session._last_margins)})
            return res

        def resolve(hyp, peaks, *a):
            text = real_resolve(hyp, peaks, *a)
            hyp = list(map(int, hyp))
            # the <unk> that took characters, and their peak frames
            took = {peaks[min(i, len(peaks) - 1)] for i, (t, w) in
                    enumerate(zip(hyp, text.split()))
                    if t == UNK and w != "<unk>"}
            calls[-1].update(hyp=hyp, peaks=list(peaks), text=text,
                             resolved_peaks=sorted(took))
            return text

        session._beam_one = beam
        t0 = time.perf_counter()
        with mock.patch.object(evaluators, "resolve_unk_text", resolve):
            res = evaluators.eval_word(session, loader, resolving_unk=True)
        out[where] = {**res, "wall_s": time.perf_counter() - t0,
                      "utts": calls,
                      "resolved": sum(len(c["resolved_peaks"])
                                      for c in calls)}
    card, ref = out["card"]["utts"], out["cpu"]["utts"]
    agree = []
    for c, r in zip(card, ref):
        close = next((i for i, x in enumerate(c["margins"])
                      if x < DECISION_MARGIN), None)
        agree.append({"same_text": c["text"] == r["text"],
                      "first_close_step": close,
                      "unk": c["hyp"].count(UNK),
                      "peak_frames": len(set(c["peaks"])),
                      "resolved_at": c["resolved_peaks"],
                      "least_margin": min(c["margins"],
                                          default=float("inf"))})
        expect(c["text"] == r["text"] or close is not None,
               f"17d: the card's resolved text {c['text']!r} against the "
               f"CPU's {r['text']!r} with no close decision")
    log(f"[17d] resolving_unk over {RESOLVE_UTTS} dev utterances (dropped "
        f"words {dropped}): card WER {out['card']['wer']:.2f} "
        f"({out['card']['wall_s']:.1f} s), CPU {out['cpu']['wer']:.2f} "
        f"({out['cpu']['wall_s']:.1f} s); sub1 blank shift {shift:.4f} "
        f"({margin:.2e} from a tie); <unk> resolved at distinct peak "
        f"frames: card {out['card']['resolved']}, CPU "
        f"{out['cpu']['resolved']}; {agree}; texts "
        f"{[c['text'][:400] for c in card]}")
    expect(out["card"]["n_utts"] == RESOLVE_UTTS and (
        out["card"]["wer"] == out["cpu"]["wer"] or any(
            a["first_close_step"] is not None for a in agree)),
        f"17d: WER {out['card']['wer']} against the CPU's "
        f"{out['cpu']['wer']}")
    expect(min(out["card"]["resolved"], out["cpu"]["resolved"]) >=
           RESOLVED_MIN, f"17d: <unk> resolved at {out['card']['resolved']} "
           f"(card) and {out['cpu']['resolved']} (CPU) distinct peak "
           f"frames, fewer than {RESOLVED_MIN}")
    del model, cpu
    torch.cuda.empty_cache()
    return {**out, "agree": agree, "dropped": dropped, "blank_shift": shift,
            "blank_margin": margin}


def phase_slice21(torch, root: Path, corpus: dict, mtl: dict) -> dict:
    """17: 17k (the kernels alone), 17a (MBR), 17b (the relative
    transformer), 17c (bf16 with attention dropout), 17d (resolving_unk),
    each drawing from a generator of its own (its data the same however
    the script's earlier phases drew). Returns each sub-phase's results,
    their walls and the launches on the phase's paths."""
    import numpy as np
    out, mark = {}, len(SUB_WALLS)

    def rng():
        return np.random.default_rng(SEED + 17)

    for key, name, run in (
            ("kernels", "17k", lambda: phase_mbr_kernels(torch, rng())),
            ("mbr", "17a", lambda: phase_mbr(torch, rng(), root)),
            ("relative", "17b", lambda: phase_relative(torch, rng(), root,
                                                       corpus)),
            ("att_bf16", "17c", lambda: phase_att_bf16(torch, rng())),
            ("resolving_unk", "17d",
             lambda: phase_resolving_unk(torch, root, mtl))):
        out[key] = timed(name, run)
    mbr, rel = out["mbr"], out["relative"]
    paths = {"17a": [mbr["las"]["beam_launches"], mbr["las"]["launches"]],
             "17b": [rel["launches"], rel["train"]["launches"],
                     rel["eval"]["launches"]],
             "17c": [out["att_bf16"]["launches"]]}
    out["launches"] = {k: {name: sum(p[name] for p in ps)
                           for name in ps[0]} for k, ps in paths.items()}
    out["sub_phase_wall_s"] = walls = walls_since(mark)
    log(f"[17] walls {walls}; launches on the phase's paths "
        f"{out['launches']}")
    return out


def add_slice21_rows(entries, srcs, keys, s21, blstm):
    """Phase 17 in the ``kernels`` line: K1 / K1b at R = T (the timit
    encoder's shape, 17b's launches), K1 / K1b's bf16 dropout entries
    (the flagship's T 750 row, the other shapes beside it; 17c's
    launches), K3 / K3b at 17a's B.N rows and K2 in its beam (17a's
    BLSTM-LAS launches), K4 in 17b's CTC (phase 8a's B32 T500 row,
    this run's; 17b's launches). Every row's launches must be above 0."""
    k, la = s21["kernels"], s21["launches"]
    rows = [("rel_attention_unclamped", "rel_attention",
             k["rel_attention_unclamped"], la["17b"]["rel_attention"]),
            ("rel_attention_bwd_unclamped", "rel_attention_bwd",
             k["rel_attention_bwd_unclamped"],
             la["17b"]["rel_attention_bwd"]),
            ("rel_attention_bf16_dropout", "rel_attention_bf16",
             k["rel_attention_bf16_dropout"],
             la["17c"]["rel_attention_bf16_dropout"]),
            ("rel_attention_bwd_bf16_dropout", "rel_attention_bwd_bf16",
             k["rel_attention_bwd_bf16_dropout"],
             la["17c"]["rel_attention_bwd_bf16_dropout"]),
            ("las_scan_mbr", "las_scan", k["las_scan"],
             la["17a"]["las_scan"]),
            ("las_scan_bwd_mbr", "las_scan_bwd", k["las_scan_bwd"],
             la["17a"]["las_scan_bwd"]),
            ("las_step_mbr", "las_step", k["las_step"],
             la["17a"]["las_step"]),
            ("ctc_loss_relative", "ctc_loss", blstm["kernels"]["ctc_loss"],
             la["17b"]["ctc_loss"])]
    for name, base, row, launched in rows:
        src, rep = srcs[base]
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launched, **{key: row.get(key) for key in keys},
            "shape": row.get("shape", (row.get("shapes") or [{}])[0].get(
                "shape")),
            "other_shapes": [{x: sh.get(x) for x in (
                "shape", "ms", "no_dropout_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "max_abs_err", "vs_f32_ratio")}
                for sh in row.get("shapes", [])[1:]],
            "path": "17 (MBR, the relative transformer, bf16 attention "
                    "dropout, resolving_unk)"})
        expect(launched > 0, f"{name} never launched on 17's paths")


# ---- phase 18: bf16 compute wherever JAX's train_dtype reaches ------------
# 18k: K1 / K1b's bf16 entries over the XL's memory (LM_K_SHAPE: the causal
# window, Tq 200 < Tk 400) with dropout, timed in turns with the float32
# dropout instantiation. 18a: the LibriSpeech BLSTM-LAS (full width and
# depth) at bf16: a B32 microstep held by 6b's rule, its device time beside
# float32's, the train CLI at RNN_DEPTH and the eval CLI, a random-state-
# passing microstep at bf16 (the whole model bf16: JAX's bf16 carry). 18b:
# the LC-BLSTM-RNN-T at bf16 by 6b's rule through K5 (its plain version
# patched in too). 18c: the offline Transformer-MMA at bf16 at XF_DEPTH,
# held as 11f. 18d: the four LM families through the LM train CLI at bf16
# over phase 13's text, and the XL's bf16 window held by 6b's rule, its
# ReLU masks pinned as 13a's. Under JAX's promotion the RNN encoders, their
# decoders and the Transformer-XL compute in float32 over bf16-rounded
# weights (ROADMAP C50): the XL's K1 / K1b at bf16 are the float32 dropout
# entries, and the bf16 entries of 18k run on no path.
BF16_FLAGS = ("--train_dtype", "bfloat16")
BLSTM_BF16_FLAGS = ("--n_epochs", "1", "--unit", "word", "--enc_n_layers",
                    str(RNN_DEPTH)) + BF16_FLAGS
BLSTM_BF16_EVAL = ("--recog_beam_width", "10", "--recog_ctc_weight", "0.3")
XF_MMA_MAKE = "librispeech_transformer_mma_args"
# the XL's K1 / K1b at bf16 compute: the float32 dropout instantiations
XL_BF16_KERNELS = ("rel_attention_dropout", "rel_attention_bwd_dropout")


def phase_bf16_lm_kernels(torch, rng) -> dict:
    """18k: K1 / K1b's bf16 entries at ``LM_K_SHAPE`` with the causal
    window, Tq < Tk and dropout LM_DROPOUT together, each against its plain
    bf16 version (``window_case``: BF16_KERNEL_TOL of its max, at most
    BF16_VS_F32_RATIO times its error against the plain float32 version on
    the same mask), timed with SDPA at ``dropout_p`` and its backward; the
    float32 dropout instantiation at the same shape (13k's); then the two
    entries timed in turns on the same values."""
    from neural_sp_tpu_torch.ops.kernels.rel_attention import (
        rel_attention_bwd, rel_attention_fwd)
    s = LM_K_SHAPE
    b, h, tq, tk, dk, r = s["b"], s["h"], s["tq"], s["tt"], s["dk"], s["r"]
    kl = [tk] * b
    out = {name: window_case(torch, rng, b, h, tk, dk, r, kl, CAUSAL_WINDOW,
                             "18k", bf16=name == "bf16", tq=tq,
                             dropout=LM_DROPOUT) for name in ("bf16", "f32")}
    dev = torch.device(DEVICE)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            "float32")).to(dev)

    f32 = (t(b, h, tq, dk, scale=dk ** -0.5), t(b, h, tk, dk),
           t(b, h, tk, dk), t(b, h, tq, r, scale=dk ** -0.5))
    do = t(b, h, tq, dk)
    klens = torch.full((b,), tk, dtype=torch.int32, device=dev)
    calls = {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        fwd = (*(x.to(dt) for x in f32), klens, CAUSAL_WINDOW, 0, LM_DROPOUT)
        o, m, l = rel_attention_fwd(*fwd)
        bwd = (*fwd[:5], o, m, l, do.to(dt), CAUSAL_WINDOW, LM_DROPOUT)
        calls[name] = (lambda a=fwd: rel_attention_fwd(*a),
                       lambda a=bwd: rel_attention_bwd(*a))
    for i, part in enumerate(("fwd", "bwd")):
        ms16, ms32 = timed_pair(calls["bf16"][i], calls["f32"][i], iters=10)
        out["bf16"][part].update(in_turns_ms=ms16, f32_in_turns_ms=ms32)
        log(f"[18k] {('K1', 'K1b')[i]} over the memory with dropout, in "
            f"turns on the same values: bf16 entry {ms16:.4f} ms, float32 "
            f"dropout instantiation {ms32:.4f} ms")
    del calls, f32, do
    torch.cuda.empty_cache()
    return out


def microstep_at(torch, model, batch, compute_dtype, plain=False,
                 carry=None, train=False):
    """(loss, {leaf: gradient}) of one microstep under ``compute_dtype``:
    ``eval()`` (or ``train()`` from a generator of seed SEED), through the
    kernels or the plain versions (``plain_patches``); with ``carry`` the
    random-state-passing loss from that encoder carry
    (``compute_loss_with_carry``)."""
    from contextlib import ExitStack
    from neural_sp_tpu_torch.parallel.mesh import (
        compute_loss, compute_loss_with_carry, deterministic_cudnn)
    model.train(train)
    model.zero_grad(set_to_none=True)
    gen = torch.Generator().manual_seed(SEED) if train else None
    with ExitStack() as stack:
        if plain:
            for target, name, value in plain_patches(torch):
                stack.enter_context(mock.patch.object(target, name, value))
        stack.enter_context(deterministic_cudnn())
        if carry is None:
            loss = compute_loss(model, compute_dtype, *batch, gen)[0]
        else:
            loss = compute_loss_with_carry(model, compute_dtype, carry,
                                           *batch, gen)[0]
        loss.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else
             p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    model.eval()
    return float(loss.detach()), grads


def bf16_path_hold(torch, model, batch, tag, **kw) -> dict:
    """6b's rule on one ``eval()`` microstep (``microstep_at``'s keywords):
    the kernels' bf16 microstep against the plain versions' float32 one,
    the plain versions' bf16 microstep the yardstick."""
    bf = torch.bfloat16
    return path_rule(torch, *microstep_at(torch, model, batch, bf, **kw),
                     *microstep_at(torch, model, batch, bf, True, **kw),
                     *microstep_at(torch, model, batch, None, True, **kw),
                     tag, ("bf16", "plain bf16", "plain f32"))


def phase_bf16_blstm(torch, rng, root: Path, corpus: dict) -> dict:
    """18a: the LibriSpeech BLSTM-LAS (``BLSTM_CONF``, full width and depth,
    seeded) at bf16: a B32 ``eval()`` microstep held by 6b's rule; one
    ``train()`` microstep (dropout, scheduled sampling) at bf16 and at
    float32, each profiled, counts zeroed around the bf16 one (K2 in pass
    1, K3, K3b and K4 must run); a random-state-passing ``eval()``
    microstep at bf16 from the encoder's carry of another batch (the pinned
    draw: passed on; the whole model bf16, JAX's bf16 carry) by 6b's rule;
    then the train CLI at ``--train_dtype bfloat16`` (RNN_DEPTH, one
    epoch) and the eval CLI over EVAL_UTTS."""
    from neural_sp_tpu_torch.configs import librispeech_blstm_las_args
    from neural_sp_tpu_torch.models.speech2text import build_speech2text
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    from neural_sp_tpu_torch.utils.init_params import init_params
    model = init_params(build_speech2text(librispeech_blstm_las_args()),
                        SEED).eval()
    out = {"parameters": sum(p.numel() for p in model.parameters())}
    batch = train_batch(torch, rng)
    out["hold"] = timed("18a hold", bf16_path_hold, torch, model, batch, "18a")
    bf = torch.bfloat16
    reset_launches()
    out["microstep_bf16"] = profiled(
        torch, "BLSTM-LAS B32 x 1500 train() microstep at bf16",
        lambda: microstep_at(torch, model, batch, bf, train=True),
        tag="18a", cpu=False)
    torch.cuda.synchronize()
    out["launches"] = launches()
    for name in BLSTM_TRAIN_KERNELS:
        expect(out["launches"][name] > 0,
               f"{name} never launched in 18a's bf16 microstep")
    out["microstep_f32"] = profiled(
        torch, "BLSTM-LAS B32 x 1500 train() microstep in float32",
        lambda: microstep_at(torch, model, batch, None, train=True),
        tag="18a", cpu=False)
    with torch.no_grad():
        other = train_batch(torch, rng)
        _, carry = model.encoder.forward_with_carry(other[0], other[1])
    out["rsp_hold"] = timed("18a rsp", bf16_path_hold, torch, model, batch,
                            "18a rsp", carry=carry)
    del model, batch, other, carry
    torch.cuda.empty_cache()
    out["cli"] = timed("18a CLIs", cli_run, torch, root, corpus, BLSTM_CONF,
                       "18a", BLSTM_BF16_FLAGS, BLSTM_TRAIN_KERNELS,
                       ("las_step",), BLSTM_BF16_EVAL)
    return out


def phase_bf16_rnnt(torch, xs, xlens) -> dict:
    """18b: the LC-BLSTM-RNN-T (``RNNT_CONF``, full width and depth,
    seeded, V 1,000) at bf16: one ``eval()`` microstep on phase 3's
    utterances and MOCHA_U labels by 6b's rule (K5's plain version patched
    in with the others), counts zeroed around the kernels' (K5 and K4 must
    run)."""
    import numpy as np
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    args = lc_args(RNNT_CONF, RNNT_VOCAB)
    model = lc_model(torch, args)
    ys, ylens = mocha_labels(torch, np.random.default_rng(SEED + 9),
                             args.vocab)
    batch = tuple(torch.from_numpy(x).to(DEVICE) if isinstance(
        x, np.ndarray) else x.to(DEVICE) for x in (xs, xlens, ys, ylens))
    reset_launches()
    microstep_at(torch, model, batch, torch.bfloat16)
    out = {"launches": launches()}
    for name in RNNT_TRAIN_KERNELS:
        expect(out["launches"][name] > 0,
               f"{name} never launched in 18b's bf16 microstep")
    out["hold"] = bf16_path_hold(torch, model, batch, "18b")
    del model
    torch.cuda.empty_cache()
    return out


def phase_bf16_mma(torch, xs, xlens) -> dict:
    """18c: the offline LibriSpeech Transformer-MMA (``XF_MMA_CONF``, full
    width, XF_DEPTH's MMA depth, seeded) at bf16: one ``train()``
    microstep on HOST_UTTS of phase 3's utterances held as 11f holds the
    streaming conf's (``bf16_against_float64``: the whole microstep by
    11d's gates, C29, the encoder + CTC by 6b's rule against float64); K4
    must run."""
    model = xf_model(torch, XF_MMA_MAKE)
    on_card = tuple(v.to(DEVICE) for v in reference_spec(
        torch, "18c", xs, xlens)["batch"])
    out = bf16_against_float64(torch, model, on_card, "18c", "18c",
                               kernels=("ctc_loss", "ctc_loss_bwd"))
    del model
    torch.cuda.empty_cache()
    return out


def phase_bf16_lm(torch, rng, root: Path, text: dict, dict_path: str
                  ) -> dict:
    """18d: the XL (``LM_XL_CONF`` at LM_XL_DEPTH, 13a's model) and its
    bf16 training window held by 6b's rule (``train()``, one generator
    seed, the memory of the window before it; the FFNs' ReLU masks of both
    plain runs pinned to the kernels' run's, as 13a): the float32 dropout
    instantiations of K1 / K1b must run (C50) and no bf16 entry; then the
    swbd Transformer-XL, LibriSpeech's rnnlm_6L, the swbd Transformer LM
    and the WSJ GCNN-14B each through the LM train CLI at ``--train_dtype
    bfloat16`` for one epoch and the eval CLI (every loss and PPL
    finite)."""
    from neural_sp_tpu_torch.models.lm.build import build_lm
    from neural_sp_tpu_torch.ops.kernels import launches, reset_launches
    from neural_sp_tpu_torch.utils.init_params import init_params
    args = lm_args(LM_XL_CONF, CLI_VOCAB)
    args.n_layers = LM_XL_DEPTH
    lm = init_params(build_lm(args), SEED + 5)

    def window():
        return tuple(torch.from_numpy(rng.integers(
            4, CLI_VOCAB, (args.batch_size, args.bptt))).to(DEVICE)
            for _ in range(2))
    with torch.no_grad():
        lm.eval()
        _, mems, _ = lm(*window())
    xi, xo = window()
    lm.train()
    kept = {}
    reset_launches()
    card = xl_microstep(torch, lm, xi, xo, mems, SEED, kept=kept,
                        compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    counts = launches()
    pins = {n: (k > 0).to(k.dtype) for n, k in kept.items()}
    plain16 = xl_microstep(torch, lm, xi, xo, mems, SEED, plain=True,
                           pins=pins, compute_dtype=torch.bfloat16)
    plain32 = xl_microstep(torch, lm, xi, xo, mems, SEED, plain=True,
                           pins=pins)
    out = {"hold": path_rule(torch, *card, *plain16, *plain32, "18d",
                             ("bf16", "plain bf16", "plain f32"),
                             zero_leaf=XL_ZERO_GRAD_LEAF),
           "hold_launches": counts}
    for name in XL_BF16_KERNELS:
        expect(counts[name] == args.n_layers,
               f"18d: {name} launched {counts[name]} times")
    for name in ("rel_attention_bf16", "rel_attention_bwd_bf16"):
        expect(counts[name] == 0, f"18d: {name} launched at the XL's bf16 "
               f"compute, which JAX runs in float32")
    del lm, mems, kept, pins, card, plain16, plain32
    torch.cuda.empty_cache()
    for name, conf in {"transformer_xl": LM_XL_CONF, **LM_CONFS}.items():
        out[name] = timed(f"18d {name}", lm_cli, torch, root, text,
                          dict_path, f"{name}_bf16", conf,
                          extra=BF16_FLAGS)
    xl = out["transformer_xl"]["train"]["launches"]
    for name in XL_BF16_KERNELS:
        expect(xl[name] > 0, f"18d: {name} never launched in the XL's bf16 "
               f"train CLI")
    out["launches"] = {k: sum(out[n]["train"]["launches"][k] +
                              out[n]["eval"]["launches"][k]
                              for n in ("transformer_xl", *LM_CONFS))
                       for k in xl}
    return out


def phase_slice22(torch, root: Path, corpus: dict, text: dict, xs,
                  xlens) -> dict:
    """18: 18k, 18a, 18b, 18c, 18d (see their functions), each drawing from
    a generator of its own. Returns each sub-phase's results and the
    launches on the phase's paths."""
    import numpy as np

    def rng():
        return np.random.default_rng(SEED + 18)

    out = {"kernels": timed("18k", phase_bf16_lm_kernels, torch, rng()),
           "blstm": timed("18a", phase_bf16_blstm, torch, rng(), root,
                          corpus),
           "rnnt": timed("18b", phase_bf16_rnnt, torch, xs, xlens),
           "mma": timed("18c", phase_bf16_mma, torch, xs, xlens),
           "lm": timed("18d", phase_bf16_lm, torch, rng(), root, text,
                       corpus["dict"])}
    a = out["blstm"]
    paths = [a["launches"], a["cli"]["train"]["launches"],
             a["cli"]["eval"]["launches"], out["rnnt"]["launches"],
             out["mma"]["whole_microstep"]["launches"],
             out["lm"]["launches"]]
    out["launches"] = {k: sum(p[k] for p in paths) for k in paths[0]}
    log(f"[18] launches on the phase's paths {out['launches']}")
    return out


def add_slice22_rows(entries, s22) -> None:
    """Phase 18 in the ``kernels`` line: each kernel's launches on 18's
    paths (``slice22_launches``), above 0 for K2, K3, K3b, K4, K5 and the
    float32 dropout instantiations of K1 / K1b (the XL at bf16, C50); and
    18k's bf16 rows over the XL's memory beside K1 / K1b's bf16 entries
    (``memory_dropout``)."""
    la = s22["launches"]
    for e in entries:
        base = e["name"]
        if base in la:
            e["slice22_launches"] = la[base]
    for name in ("las_step", "las_scan", "las_scan_bwd", "ctc_loss",
                 "rnnt_loss", *XL_BF16_KERNELS):
        expect(la[name] > 0, f"{name} never launched on 18's paths")
    k = s22["kernels"]
    for name, part in (("rel_attention_bf16", "fwd"),
                       ("rel_attention_bwd_bf16", "bwd")):
        row = k["bf16"][part]
        next(e for e in entries if e["name"] == name)["memory_dropout"] = {
            **{x: row.get(x) for x in (
                "shape", "max_abs_err", "vs_f32_ratio", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "in_turns_ms",
                "f32_in_turns_ms")},
            "launches": la[name],
            "path": "none: the XL at bf16 computes in float32 (C50)"}


def main() -> int:
    """``run``, the CPU references' worker stopped however it ends."""
    try:
        return run()
    finally:
        if REFS is not None:
            REFS.close()


def run() -> int:
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
    served, counts = timed("3a", phase_serve, torch, model, xs, xlens)
    launches = {k: counts[k] for k in ("rel_attention", "las_step")}
    expect(all(v > 0 for v in launches.values()),
           f"a kernel of the path never launched: {launches}")
    breakdown = timed("3b", phase_breakdown, torch, model, xs, xlens)
    wall("3")
    # the CPU references from here: phase 3's beam step is timed alone
    start_references(torch, xs, xlens)
    served_lm, lm_launches = phase_serve_lm(torch, model, xs[:HOST_UTTS],
                                            xlens[:HOST_UTTS])
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
        stream_bf16 = phase_stream_bf16(torch, root, corpus, xs, xlens)
        wall("11f")
        rnnt = phase_transducer(torch, rng, root, xs, xlens)
        wall("12")
        lm = phase_lm(torch, rng, root, corpus)
        wall("13")
        mtl = phase_mtl(torch, rng, root)
        wall("14")
        att = phase_att(torch, rng, root, corpus)
        wall("15")
        trig = phase_trig(torch, rng, root, corpus, xs, xlens)
        wall("16")
        s21 = phase_slice21(torch, root, corpus, mtl)
        wall("17")
        s22 = phase_slice22(torch, root, corpus, lm.pop("text"), xs, xlens)
        wall("18")
    log(f"phase walls (s): {json.dumps(walls)}; total "
        f"{sum(walls.values()):.1f} s")
    log(f"sub-phase walls (s): {json.dumps(SUB_WALLS)}")
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
        csrc + "rel_attention_bwd_bf16.cu",
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
               "transducer": rnnt, "lm": lm, "stream_bf16": stream_bf16,
               "mtl": mtl, "att": att, "trig": trig, "slice21": s21,
               "slice22": s22, "kernels": kernels,
               "phase_walls_s": walls, "sub_phase_walls_s": SUB_WALLS}
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
    add_new_path_rows(entries, srcs, keys, streaming, stream_bf16, mtl)
    add_att_rows(entries, srcs, keys, att)
    add_trig_rows(entries, srcs, keys, trig)
    add_slice21_rows(entries, srcs, keys, s21, blstm)
    add_slice22_rows(entries, s22)
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
