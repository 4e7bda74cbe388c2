#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``conformer_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port starts, builds its kernels,
serves and trains on the card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. device  - CUDA present; print the card's name and power limit;
  2. build   - nvcc builds every kernel library from csrc/, in parallel;
  3. kernels - each serving kernel against its plain PyTorch version at the
               decode shapes (B=48, T'=374, D=256, H=4) plus edge cases, in
               float32 and bfloat16; the attention kernels of training
               (forward with dropout 0.1, dq, dkv) in float32 and bfloat16
               at the training shape (B=32, T'=374) and at a ragged edge
               shape with a dynamic-chunk mask, against their plain
               versions and against autograd through the plain forward,
               the dropout keep-mask bit for bit, its keep share, and
               bitwise repeatability (at Conformer-M's widths the wide
               kernels: wgmma fed by TMA); the same at Conformer-L's
               training shape (B=32, H=8, dk=64, D=512) and M's widths
               (the wide kernels), Conformer-S's (H=4, dk=36, D=144: the
               narrow mma.sync forward, the backward on the wide kernels
               padded to dk 40), dk=32, D=136 (wide), dk=20, D=100 (both
               padded in the backward) and the 1024-wide Conformer's (H=8,
               dk=128,
               D=1024 at B=32, T'=374 and at a chunk shape B=16, Tq=16,
               Tk=528, and dk=64, D=1024: the wide kernels; there in bf16
               also at heads 8-15 of 16, the keep-mask's global head), the
               combined backward (rel_attention_bwd: dS and pd once in
               bf16) beside dq and dkv, its dK and dV the
               standalone dkv's bit for bit, every output poisoned
               with NaN first, in both dtypes, and every wrapper's
               ValueError at dk = 136; the conv block at Conformer-S's and -L's widths (D =
               144, 512 at K = 15; D = 512 at K = 31 too) and the 1024-wide
               Conformer's (D = 1024 at K = 15, 31, 32, 64; B=4, T'=374 and
               T'=9 < K-1) in both dtypes, outputs poisoned with NaN first,
               and its ValueError at D = 2064 and K = 65; each of the
               six loss kernels (simple lattice, RNN-T lattice DP, CTC DP;
               forward and backward) against its plain version in float32 at the
               training shape (B=32, T'=374, U=64, V=5002) and at a tiny
               ragged one, with edge rows (t_len 1, u_len 0, a
               bucket-padding row), the simple lattice's two also at
               U = 300 (B=2, T'=412) and on inputs whose maxima of am and lm
               lie 200 nats apart on different v (B=4, T'=374, U=64, outputs
               poisoned with NaN first), where their guard must take cells
               (and none on the random inputs), and the CTC and RNN-T DPs at long
               labels (U = 400-1100) with their wrappers' limits, the CTC DP
               at its dispatch edges (S = 31, 33, 63, 65, 511, 513; rows of
               very different lengths, t_len 1, u_len 0 and U; outputs
               poisoned with NaN first); the
               two int8 serving kernels at route B's rows (M = 48 x 374),
               route A's (374), a ragged M and
               M = 1 with an all-zero row, in float32 and bfloat16:
               int8_matmul bit for bit, int8_ffn within JAX's tolerances;
               both also at Conformer-S's and -L's widths (D / H = 144 /
               576, 512 / 2048; M = 374 and 37, outputs poisoned with NaN
               first), the FFN on its wide route at D / H = 1024 / 4096 and
               2048 / 8192 (M = 2992 and 37), the matmul refused past K =
               1024 before any launch;
               the three joint kernels (forward, bwd_xp, bwd_w; all on
               wgmma with TMA, float32 on the wide route as 3xTF32) in
               float32 and bfloat16 at (B, T', U, V) = (32, 374, 64,
               5002), (4, 412, 200, 5002) and a tiny ragged shape with edge
               rows, against their plain versions and in float32 against
               autograd through the plain forward, the forward's outputs
               (and the wide forward's partials) poisoned with NaN first,
               forward and backward bitwise repeatable; the three also at
               Conformer-S's and -L's join widths (J = 320, 640) and at J =
               1024, 896 and a ragged 700 (B=2, T'=200, U=30, V=5002; the
               wide route in float32 at every J, in bf16 the backward past
               512 and the forward past 640) in float32 and bf16 (both pred
               dtypes), outputs poisoned with NaN first, forward and
               backward bitwise repeatable;
               the fbank kernel at 48 x 15 s against its plain version with
               dither 0 and 1 and against the host fbank_numpy, its
               dither's statistics, its distance from a float64 fbank
               within 2x the plain version's, at edge shapes (N odd, T = 1,
               padded 256 and 1024, 40 mel bins) and at every window of
               1-1024 samples; times of kernel, plain version and
               library call (where none exists, labelled yardsticks: for
               the int8 kernels torch._int_mm and the float work they
               replace, for the joint the bf16 product alone, for the
               simple lattice its factored products alone by float32
               torch.matmul, for fbank torch.stft's power spectrum) beside
               the bound;
  4. serve   - Conformer-M at full width (configs/conformer_m.json, both
               kernel flags on, random weights from a seed, +6 on the joint's
               blank bias) behind the port's REST server on 127.0.0.1: three
               synthetic wav requests must answer "success", and each kernel
               wrapper must count one launch per encoder layer per request;
               then route A of int8 serving: a runner with
               decode.quantize_int8 behind the same server, two requests,
               int8_matmul 24 launches each, int8_ffn none, no int8 weight
               layout made after the first request; then fault C2: a
               runner given an .npz whose CMVN statistics differ from
               data.cmvn_path's file must serve the .npz's (its stats, and
               the tree's hypotheses);
  5. parity  - float32 kernel path vs plain path on the served weights and
               on the same weights without the blank bias, which emit on
               most frames (encoder outputs within 1e-3, identical
               hypotheses); the same for route A's int8 weights and route
               B's (both FFN matmuls int8, quantize_tree(fuse_ffn=True)),
               the plain path through the plain int8 versions (encoder
               outputs within INT8_ENC_TOL; hypotheses identical on the
               served weights, agreement >= INT8_AGREE_MIN on the
               unbiased ones); then bfloat16 decodes of 48 x 15 s, float
               and route B (int8_ffn 24 launches per batch, no weight
               layout made after the first batch): audio-seconds
               per second, token agreement with the plain path, and
               route B's agreement with the float path;
  5b. stream - streaming at full width (Conformer-M, chunk 16, both
               kernel flags on): (a) the attention forward at every
               chunk shape the stream paths run: the scheduler's and
               streaming validation's (Tq = 16, Tk = 64 + 16 and 512 + 16;
               B = 1 and 16) and a live session's, each 640 ms piece one
               chunk of its own fbank (B = 1, Tq = 14, Tk = 78, and the
               last piece of 15 s, Tq = 5, Tk = 69: odd, the bf16 kernel's
               unaligned mask pair); B = 1 with a cache length of 0, 1, 37
               or full, B = 16 mixing them; float32 and bfloat16, outputs
               poisoned with NaN first) within TOL of its plain version,
               with kernel, plain and SDPA times beside the bound; (b) f32
               streaming_greedy_search
               and the chunk-by-chunk encoder, kernel path vs plain path on
               the unbiased weights, 4 utterances, caches 512 and 64
               (encoder within 1e-3, identical hypotheses, tokens emitted);
               (c) live sessions (runner.new_session / accept_chunk) over a
               15 s wav in 640 ms pieces: f32 kernel path = plain path
               token for token, bf16 per-piece latency p50 / p95, the
               attention kernel's launches (12 a piece, counts set to 0
               just before); (d) runner.make_scheduler(16): 16 streams
               from 16 threads, a piece apart (at 15 s stream i opens
               once stream 0 has fed i pieces); f32, streams of 5 s (they
               join and leave while others run): each final transcript
               equals its B=1
               stream's; bf16, streams of 15 s: chunk latency p50 / p99,
               ticks, mean active
               slots, audio-s per wall s, launches (12 a tick). (c)-(e)
               check in f32 on the unbiased weights at STREAM_N_STEPS
               emissions a frame (the served ones emit nothing) and read
               bf16 on the served ones; (e) both
               WebSocket handlers driven in process with a stand-in socket
               (no fail reply; $final$ equals the session's or scheduler's
               transcript); (f), after the fit phase, Trainer.validate
               with decode.streaming on the fit corpus;
  5c. decode modes - the other decode modes at full width (Conformer-M,
               both kernel flags on) with the JAX bench's settings (beam 8,
               2 expansion rounds, 256 tokens; the CTC prefix beam's top_c
               16; rescoring with a random 3-layer attention decoder from a
               seed, ctc_weight 0.5, 64 tokens): (a) beam_rnnt with blank
               skip 0 and 8, greedy_ctc, prefix_beam_ctc and
               attention_rescoring, f32 kernel path vs plain path on the
               unbiased weights (the beam's joint output kernel x32,
               BEAM_SHARPEN: on the flat random joint the beam emits
               nothing), 4 utterances of 3, 7.5, 15 and 11 s
               (encoders within 1e-3, every top hypothesis identical, a
               token emitted, the share of all K rows identical printed);
               (b) bf16 at B=48 x 15 s on the bench's weights (+6 on the
               joint's blank bias, and on the CTC head's for the CTC modes
               and rescoring): ms a batch (median of 3 after a warm-up),
               audio-s/s, tokens, launches (attention 12, conv 12, nothing
               else) and the beam's host syncs a batch; (c), after the fit
               phase, ``--eval --set decode.mode=`` beam_rnnt, greedy_ctc
               and prefix_beam_ctc on the fit checkpoint (a finite WER,
               attention and conv layers x batches launches each), and
               attention_rescoring, which must raise ValueError there (the
               checkpoint has no decoder);
  5d. ref modes - the reference-parity encoder modes at Conformer-M's
               width, both encoder kernel flags on, random weights from a
               seed with BatchNorm running statistics off the identity:
               ref_batch and ref_abs with the BatchNorm conv, ref_abs and
               absolute positions with the LayerNorm conv; f32 kernel path
               vs plain path on 4 utterances of 3, 7.5, 15 and 11 s
               (encoders within 1e-3, identical hypotheses, tokens emitted),
               launches: attention 0 in every mode, conv 12 with the
               LayerNorm conv and 0 with BatchNorm; then one live f32
               session under ref_abs, kernel path = plain path token for
               token, no launch;
  6. train   - the recipe as shipped (configs/conformer_m.json: pruned
               RNN-T + CTC, the RNN-T and CTC kernel flags on, the attention
               flag off, bf16) on random weights from its seed through the
               port's Trainer: batches of 32 x 15 s random-normal features
               with 64 random labels, accum_grad 2, one warm-up step and
               three timed steps, each with a finite loss and gradient norm,
               changed weights and an unchanged pos_table; each kernel must
               count its launches per microbatch (simple lattice fwd 2 / bwd
               4 kernels, RNN-T lattice 2 / 2, CTC 1 / 1, attention 0). Then
               float32 parity of the kernel path, with the attention kernel
               on, against the plain path on one 8 x 15 s microbatch: the
               band starts and occupancy argmaxes that differ are counted
               and held to BAND_LIMITS, then the plain path runs on the
               kernel path's band: loss terms within 1e-4 relative, every
               gradient leaf within 1e-3 of its own max-abs;
  6b. train full lattice - the recipe with the full-lattice loss
               (use_pruned_loss false) and its joint through the joint
               kernels (use_pallas_joint), B=24 x 15 s, 64 labels, accum_grad
               2: one warm-up and three timed steps, each finite with
               changed weights and an unchanged pos_table, launches per
               microbatch (joint fwd 1, bwd_xp 2 and bwd_w 3 grids, RNN-T
               lattice 1 / 1, CTC 1 / 1, simple lattice 0); ms per step,
               audio-s/s, the model's TFLOP/s (train/flops.py) and share of
               the bf16 peak; then the kernel path against the plain path on
               one ragged 8 x 15 s microbatch, in float32 (losses within
               1e-4 relative, gradients within 1e-3 of max-abs) and in
               bfloat16 (FULL_PARITY_LIMITS);
  6c. train Conformer-L remat - configs/conformer_l.json at full width
               (17 layers, d=512, 8 heads, FFN 2048, join 640; pruned loss,
               bf16, model.remat and train.remat on) through the Trainer,
               CMVN cleared: (a) B=32 x 15 s, 64 labels, accum_grad 2, one
               warm-up and two timed steps with remat, then without: each
               finite with changed weights and an unchanged pos_table, ms
               per step, audio-s/s, peak memory (remat's must be lower),
               launches per microbatch as in phase 6; (b) the attention
               kernel on, dropout 0.1, float32, one 8 x 15 s microbatch:
               gradients with remat and without from the same generator
               states, PyTorch's deterministic algorithms on (losses within
               1e-6 relative, every leaf within 1e-5 of its max-abs, the
               generator in the same state after both; two runs without
               remat equal; one with the default algorithms read as the
               noise of the backward's atomic sums),
               attention forward launches 2 x 17 with remat and 17 without,
               dq and dkv 17 each; then the three attention kernels' times
               at Conformer-L's training shape (bf16, B=32, T'=374, H=8,
               D=512, dropout 0.1) beside their plain versions, SDPA and
               their bounds;
  6d. wide   - the 1024-wide Conformer: configs/conformer_l.json at
               d=1024, 8 heads of 128, FFN 4096 (Conformer XL's widths),
               4 of its 17 layers, on the attention and conv kernels' wide
               path: (a) a ModelRunner on random weights from the config's
               seed, both encoder kernel flags, bf16: decode_batch of 8 x 15
               s (ms a batch, audio-s/s, tokens, attention and conv 4
               launches a batch), then f32 kernel path vs plain path on 8 x
               15 s (encoders within 1e-3, identical hypotheses, tokens
               emitted); (b) the recipe's Trainer with the attention
               kernel (dropout 0.1, remat, bf16): a warm-up and two timed
               steps of B=8 x 15 s, 64 labels (finite, changed weights,
               launches per microbatch, ms per step, peak memory), then f32
               at dropout 0, kernel path vs plain path, under BAND_LIMITS
               and the float32 FULL_PARITY_LIMITS; (c) the attention
               kernels' times at its training shape (B=32, T'=374) and the
               conv block's at its decode shape, beside plain, SDPA and the
               bound, each beside its earlier design's time; the whole
               backward as training runs it and its kernels' device times
               (dq's kernel 1 and 2, dkv's kernel 1 and product); (d) int8
               route B (both FFN matmuls through the fused int8 FFN at D
               1024 / H 4096, its wide route): timed bf16 decodes of the
               same 8 x 15 s batch (int8_ffn 8 launches a batch, no weight
               layout made after the first), then f32 kernel path vs
               plain path under INT8_ENC_TOL;
  6e. full L - configs/conformer_l.json's full lattice in float32 (join
               640: the joint kernels' wide route), 4 layers, kernel path
               vs plain path on one ragged microbatch of 4 x 15 s under the
               float32 FULL_PARITY_LIMITS, the joint kernels launched;
  7. host    - the host audio runtime (conformer_tpu_torch/runtime/
               audio_runtime.cc) built with g++ from a clean library path
               (the compiler's first line and the build's seconds), then on
               the card machine's CPU: its fbank of 48 x 15 s synthetic wavs
               within (rtol 1e-3, atol 0.15) of fbank_numpy, fbank_batch at
               1, 2 and 8 threads equal bit for bit to the single calls,
               decode_wav within 1e-4 of the stdlib parser, resample 16 k ->
               8 k against scipy (99th percentile below 5e-3 off the edges),
               dither 0.1 repeatable in its seed and not across seeds; host
               ms (median of 5) of fbank_numpy, the native fbank and
               fbank_batch on 8 threads over that batch, and the training
               pipeline's audio-s/s (AsrDataset in train mode at the
               recipe's data settings over the fit corpus) with the native
               path on and off;
  7a. fit    - the corpus's CMVN statistics from ``python -m
               conformer_tpu_torch.tools.compute_cmvn_stats`` in a process
               of its own, then the user's command,
               ``conformer_tpu_torch.main.main`` with
               --train, on a synthetic corpus written from a seed (40 wavs
               of 2-15 s, 8 dev wavs, a 5002-piece vocab) at full
               Conformer-M width, attention and conv kernel flags on, the
               recipe's data pipeline as it stands, global CMVN from those
               statistics, features from the host runtime: 4 steps, validations at
               0 (sanity), 2 and 4, checkpoints step_2-wer_*, step_4-wer_*,
               step_4 and last, and the run's launches of every kernel as
               its steps and validation batches give them; then
               --resume_from last to step 6 and --eval (a WER). The trainer's
               metrics.jsonl must hold steps 1-6 with finite losses and
               gradient norms and finite WERs at 2, 4 and 6; a new Trainer
               restores the last checkpoint and must equal the file, its
               CMVN the statistics' (init_cmvn_from_file), and
               Trainer.validate on the dev set as an eager AsrDataset must
               give the lazy set's WER and launches; then
               the same command with the full-lattice loss and the joint
               kernels (labels padded to 200: U+1 = 201), its own
               checkpoints, 2 steps, no validation: finite losses and the
               joint kernels' launches of 2 steps x accum_grad 2; then with
               MFCC features (data.feat_type=mfcc, 40 cepstra as
               model.input_dim, CMVN cleared), 2 steps, no validation:
               finite losses and the launches of 2 steps x accum_grad 2;
  7b. wenet  - the fit's last checkpoint written as a reference / WeNet
               state dict (reference_state_dict, torch.save, .pt):
               ``main --eval --wenet_ckpt_path`` must print the WER of
               ``--eval --resume``, and a runner given the .pt must answer
               the serve phase's three requests as one given the
               checkpoint's tree, one launch of each encoder kernel per
               layer per request;
  7c. micro  - the micro model (scripts/torch_train_micro_wer.py's config:
               3 layers, d=96, 4 heads of 24, K=7, V=24, f32): (a) the
               micro corpus by the port's tool
               (conformer_tpu_torch/tools/make_micro_corpus.py) from 4
               seeded synthetic recordings of 8 s, 600 train and 80 eval
               utterances; (b) tests/fixtures/micro_trained.npz through the
               script's eval_decode_modes in all 10 modes: the encoder
               kernel flags on against off with rel_mode "decomposed" (the
               kernel path's relative bias: identical hypotheses in every
               mode, tokens emitted), and off as the script's config has it
               (the skew path reads the fixture's stored pos_table, which
               is not the sinusoid table: tokens and agreement printed);
               attention and conv 3 launches a batch, each mode encoding 5
               batches of 16; (c) two f32 training steps of the micro config
               (pruned loss, dropout 0) from one init with the RNN-T, CTC
               and attention kernel flags on, then off, on the corpus's
               first two batches (B=32, T'=69, U <= 40): losses within 1e-4
               relative, gradients within 1e-3 of each leaf's max-abs (the
               plain path on the kernel path's band; band starts that
               differ held to BAND_LIMITS), launches per step as phase 6
               counts them at 3 layers; (d) the Gradio demo's wiring
               (serve/gradio_server.build_app with a stand-in gradio
               module): the longest eval wav in 640 ms int16 pieces through
               the microphone callback, each transcript equal to
               runner.accept_chunk's on the card, then "Reset Model" ("",
               and the first piece's transcript again); then every kernel
               of (b) and (c) at the shapes they gave it, f32, outputs
               poisoned with NaN first, against its plain version, with
               kernel, plain and library times beside the bound. The
               kernels line's launches add (b)-(d)'s;
  8. parallel - (a) ``python -m conformer_tpu_torch.main --train`` on the
               fit corpus and config with ``--coordinator 127.0.0.1:<port>
               --num_processes 1 --process_id 0``: NCCL's init and the
               one-process step through main, in this process (at world
               size 1 no collective runs: the step's all-reduce, the
               rank-0 save's barrier and the pipeline's link broadcasts
               wait for two cards), 2 steps: the same losses as the fit's
               first steps and the launches of 2 steps; which collectives gloo takes on
               CUDA tensors (all_reduce, all_gather, broadcast, send/recv),
               2 ranks on this card; (b) data parallelism, 2 ranks on this
               card over gloo, Conformer-M at full width and PAR_LAYERS
               layers in f32 with both kernel flags on, no dropout, 8 x 15
               s a rank: the step's loss
               and all-reduced gradients against one process on the joined
               16 rows; (c) sequence (seq 2: T' = 374, 187 a rank) and
               pipeline parallelism (pipe 2, PAR_LAYERS / 2 layers a
               stage, 2 microbatches) on 8 x 15 s: the deterministic
               encoder output
               (attention and conv kernels) and the step's gradients against
               one process; a path whose collective gloo refuses on CUDA
               tensors is not run, and a line names it; each rank's launches
               of its step and forward must be the path's; (d) the three
               attention kernels at the sequence-parallel shape (B=32, Tq =
               187 at positions 187-373, Tk = 374) in f32 and bf16, dropout
               0.1, outputs poisoned with NaN first, against the plain
               versions, with times beside SDPA's; (e) the model axis
               (tensor parallelism), ranks on this card over gloo: (e1)
               model 2, Conformer-M at full width (2 of 4 heads, FFN 1024,
               V 2501 a rank) and PAR_MODEL_LAYERS layers, f32, every
               kernel flag on but the joint's, 8 x 15 s: the deterministic
               encoder output and the step's gathered gradients, then a
               step with every dropout at 0.1, against one process seeded
               alike; (e3) the full lattice through the joint kernels (W
               gathered) at model 2, one step (float32: the joint's wide
               route, its grids as many as one process launches); (e2) seq 2 x model 2, four
               ranks, PAR_SEQ_MODEL_LAYERS layers, against one process;
               each rank's step ms and the share of its collectives
               (host-staged gloo, several ranks on one card); (e4) the
               three attention kernels at the head-shard shape (B=32, T' =
               374, heads 2-3 of 4, dropout 0.1) in f32 and bf16, outputs
               poisoned, against the plain versions and bit for bit against
               those heads of the whole 4-head attention, times beside
               SDPA's.
Every time and memory size printed stands beside the card's name and
power limit (phase 1's line) or follows it in the same run.
The last two lines are the kernels JSON line and the result line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

BF16_TFLOPS = 989.0      # H100 SXM dense bf16 tensor rate
INT8_TOPS = 1979.0       # H100 SXM dense int8 tensor rate
F32_TFLOPS = 67.0        # H100 SXM float32 outside the tensor cores
TF32_TFLOPS = 495.0      # H100 SXM dense TF32 tensor rate (3xTF32 products: a third of it)
HBM_TBPS = 3.35          # H100 SXM device memory rate
TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # abs and rel; bf16: ~1 ulp at |x| < 4
H100_SMS = 132
H100_CLOCK_HZ = 1.98e9   # boost clock
EXP_PER_CLK_SM = 16      # special-function unit: exp2/log2 per clock per SM


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ------------------------------------------------------------------ timing


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, name: str | tuple = "", iters: int = 20, tries: int = 3,
              per_call: int | None = None):
    """Device time by torch.profiler over ``iters`` calls of ``fn`` after a
    warm-up, of the kernel launches whose name holds ``name`` (or one of
    the names in a tuple). Without ``per_call``: the mean over the
    recorded launches (one a call); a trace that recorded none is taken
    again. With it: the sum of the ``per_call`` launches one call makes; a
    trace that did not record exactly ``iters * per_call`` is taken again.
    After ``tries`` traces the time is None (not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = name if isinstance(name, tuple) else (name,)
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CUDA and any(n in e.name for n in names)]
        if per_call is None and us:
            return sum(us) / len(us) / 1e3
        if per_call is not None and len(us) == iters * per_call:
            return sum(us) / iters / 1e3
    if per_call is not None:
        print(f"device_ms: the last trace recorded {len(us)} launches of {names} in {iters} "
              f"calls, not {iters * per_call}: not measured")
    return None


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes: int, ops_time_s: float) -> tuple[float, str]:
    t_bytes = n_bytes / (HBM_TBPS * 1e12)
    return max(t_bytes, ops_time_s) * 1e3, "bytes" if t_bytes >= ops_time_s else "operations"


def max_err(got, want, tol: float) -> tuple[float, bool]:
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    return float(diff.max()), ok


# ----------------------------------------------------------------- kernels


def attention_inputs(dev, dtype, gen, b=48, h=4, t=374, dk=64, d=256):
    """Inputs of the decode shape: key padding with lengths [T, T-37, 1,
    ...], one dead query row and one zero-length row (all rows masked)."""
    import torch

    lens = torch.randint(t // 4, t + 1, (b,), generator=gen)
    lens[:3] = torch.tensor([t, t - 37, 1])
    mask = (torch.arange(t)[None, None, :] < lens[:, None, None]).expand(b, t, t).clone()
    mask[1, 5, :] = False
    mask[2] = False
    q_u, k, v = (torch.randn(b, h, t, dk, generator=gen) for _ in range(3))
    ab = 0.2 * torch.randn(b, h, t, d, generator=gen)
    feats = torch.randn(t, d, generator=gen)
    cast = [x.to(dev, dtype) for x in (q_u, ab, k, v, feats)]
    return (*cast, mask.to(dev))


def conv_inputs(dev, dtype, gen, b=48, t=374, d=256, k=15):
    import torch

    lens = torch.randint(t // 4, t + 1, (b,), generator=gen)
    lens[:3] = torch.tensor([t, t // 2, 1])

    def u(*shape, bound):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * bound).to(dev)

    p_conv = {
        "pointwise_conv1": {"kernel": u(1, d, 2 * d, bound=d ** -0.5), "bias": u(2 * d, bound=d ** -0.5)},
        "depthwise_conv": {"kernel": u(k, 1, d, bound=k ** -0.5), "bias": u(d, bound=k ** -0.5)},
        "norm": {"scale": 1 + u(d, bound=0.2), "bias": u(d, bound=0.1)},
        "pointwise_conv2": {"kernel": u(1, d, d, bound=d ** -0.5), "bias": u(d, bound=d ** -0.5)},
    }
    p_norm = {"scale": 1 + u(d, bound=0.1), "bias": u(d, bound=0.05)}
    x = torch.randn(b, t, d, generator=gen).to(dev, dtype)
    return x, lens.to(dev, torch.int32), p_norm, p_conv


def check_kernels(dev) -> dict:
    """Each kernel vs its plain version in both dtypes; times and bounds
    at the bf16 decode shape (the main path's). Returns the JSON entries
    without ``launches``."""
    import torch

    from conformer_tpu_torch.ops.conv_block import conv_block, conv_block_plain
    from conformer_tpu_torch.ops.rel_attention import rel_attention, rel_attention_plain

    gen = torch.Generator().manual_seed(0)
    entries = {}
    k_size = 15
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol = TOL[name]
        args = attention_inputs(dev, dtype, gen)
        scale = 1 / 8
        a_out, a_lse = rel_attention(*args, scale=scale)
        torch.cuda.synchronize()
        ref_out, ref_lse = rel_attention_plain(*args, scale=scale)
        err_o, ok_o = max_err(a_out, ref_out, tol)
        err_l, ok_l = max_err(a_lse, ref_lse, tol)
        dead = bool((a_out[2] == 0).all() and (a_out[1, :, 5] == 0).all()
                    and (a_lse[2] == 1e30).all())
        print(f"kernels: rel_flash_attention {name} max_abs_err out {err_o:.3g} lse {err_l:.3g} "
              f"(tol {tol} abs + rel), masked rows zero: {dead}")
        check(ok_o and ok_l and dead, f"rel_flash_attention {name} disagrees with its plain version")

        x, lens, p_norm, p_conv = conv_inputs(dev, dtype, gen, k=k_size)
        out, cache = conv_block(x, lens, p_norm, p_conv, kernel_size=k_size)
        torch.cuda.synchronize()
        ref_out, ref_cache = conv_block_plain(x, lens, p_norm, p_conv, kernel_size=k_size)
        err_c, ok_c = max_err(out, ref_out, tol)
        err_k, ok_k = max_err(cache, ref_cache, tol)
        xs, ls, pn, pc = conv_inputs(dev, dtype, gen, b=3, t=9, k=k_size)   # T < K-1
        out_s, cache_s = conv_block(xs, ls, pn, pc, kernel_size=k_size)
        torch.cuda.synchronize()
        ref_s, ref_cs = conv_block_plain(xs, ls, pn, pc, kernel_size=k_size)
        err_s, ok_s = max_err(out_s, ref_s, tol)
        err_cs, ok_cs = max_err(cache_s, ref_cs, tol)
        print(f"kernels: conv_block {name} max_abs_err out {err_c:.3g} cache {err_k:.3g}; "
              f"T=9<K-1: out {err_s:.3g} cache {err_cs:.3g} (tol {tol} abs + rel)")
        check(ok_c and ok_k and ok_s and ok_cs, f"conv_block {name} disagrees with its plain version")

        if dtype != torch.bfloat16:
            continue
        # --- times at the bf16 decode shape
        q_u, ab, k, v, feats, mask = args
        _, h, _, dk = q_u.shape
        d = ab.shape[-1]
        bias = (torch.matmul(ab.float(), feats.float().T) * scale).masked_fill(
            ~mask[:, None], float("-inf")).to(dtype)
        # the products this run's data needs: unmasked (query, key) pairs only
        attn_ops = 2.0 * h * float(mask.sum()) * (dk + d + dk)
        a_bytes = nbytes(*args, a_out, a_lse)
        a_bound, a_by = bound_ms(a_bytes, attn_ops / (BF16_TFLOPS * 1e12))
        entries["rel_flash_attention"] = {
            "name": "rel_flash_attention", "route": "cuda",
            "source": "conformer_tpu_torch/csrc/rel_flash_attention.cu",
            "replaces": "conformer_tpu/ops/pallas/attention_kernel.py:283",
            "max_abs_err": max(err_o, err_l),
            "ms": time_ms(lambda: rel_attention(*args, scale=scale)),
            "plain_ms": time_ms(lambda: rel_attention_plain(*args, scale=scale)),
            "bound_ms": a_bound, "bound_by": a_by,
            "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q_u, k, v, attn_mask=bias, scale=scale)),
        }
        entries["conv_block"] = {**conv_block_times(x, lens, p_norm, p_conv, k_size),
                                 "max_abs_err": max(err_c, err_k, err_s, err_cs)}
    for e in entries.values():
        print(f"kernels: {e['name']} bf16 B=48 T'=374: kernel {e['ms']:.4f} ms, plain "
              f"{e['plain_ms']:.4f} ms, library {e['library_ms']} ms, bound "
              f"{e['bound_ms'] * 1e3:.2f} us ({e['bound_by']})")
    return entries


# label -> (D, kernel sizes): Conformer-S's and -L's widths (K = 15 as
# shipped; K = 31, WeNet's and ESPnet's, at L's width takes float32's wide
# path), the 1024-wide Conformer's (Conformer XL's width) at K = 15, 31,
# 32 and 64 (the wide path's largest), the wide path's widest D (2048) and
# bf16's wide route by K alone (M's D 256 at K 33), and past the kernel's
# limits (D <= 2048, a multiple of 16; K <= 64): refused
CONV_WIDTHS = {"conformer_s": (144, (15,)), "conformer_l": (512, (15, 31)),
               "conformer_xl": (1024, (15, 31, 32, 64)), "2048": (2048, (15, 64)),
               "conformer_m K 33": (256, (33,)),
               "above the limit": (2064, (15,)), "above the limit K": (1024, (65,))}


def check_conv_widths(dev) -> float:
    """The conv block at each of CONV_WIDTHS (B=4, T'=374, and B=3, T'=9 <
    K-1) in both dtypes, where the wrapper takes them, against its plain
    version, outputs and cache poisoned with NaN beforehand; past the
    kernel's widths the wrapper must raise ValueError before any launch,
    in both dtypes. Returns the largest error."""
    import torch

    from conformer_tpu_torch.ops import conv_block as cb

    gen = torch.Generator().manual_seed(11)
    worst = 0.0
    for label, (d, sizes) in CONV_WIDTHS.items():
        for k_size in sizes:
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).split(".")[-1]
                tol = TOL[name]
                why = cb.width_error(dtype, d, k_size)
                if why is not None:
                    x, lens, pn, pc = conv_inputs(dev, dtype, gen, b=3, t=20, d=d, k=k_size)
                    before = cb.conv_block.launches
                    try:
                        cb.conv_block(x, lens, pn, pc, kernel_size=k_size)
                        refused = False
                    except ValueError:
                        refused = True
                    check(refused and cb.conv_block.launches == before,
                          f"conv_block {label} {name} D={d} K={k_size}: not refused before "
                          f"launch ({why})")
                    print(f"kernels: conv_block {label} {name} D={d} K={k_size}: ValueError "
                          f"before any launch ({why})")
                    continue
                errs = []
                for b, t in ((4, 374), (3, 9)):
                    x, lens, pn, pc = conv_inputs(dev, dtype, gen, b=b, t=t, d=d, k=k_size)
                    poison(((b, t, d), dtype), ((b, k_size - 1, d), dtype))
                    got = cb.conv_block(x, lens, pn, pc, kernel_size=k_size)
                    torch.cuda.synchronize()
                    errs.append(compare(f"conv_block {label} {name} D={d} K={k_size} B={b} "
                                        f"T'={t}", got,
                                        cb.conv_block_plain(x, lens, pn, pc, kernel_size=k_size),
                                        tol))
                worst = max(worst, *errs)
                print(f"kernels: conv_block {label} {name} D={d} K={k_size} "
                      f"({cb.route(dtype, d, k_size)} path): max_abs_err B=4 T'=374 "
                      f"{errs[0]:.3g}, B=3 T'=9 {errs[1]:.3g} (tol {tol} abs + rel; outputs "
                      "poisoned with NaN beforehand)")
    return worst


# ------------------------------------------------- attention, training side

ATTN_RATE = 0.1          # the recipe's attention_dropout
ATTN_SEED = 20240917


def attention_train_inputs(dev, dtype, gen, b, t, dk=64, d=256, h=4, chunk=False,
                           identity=False, tk=None):
    """Inputs of the attention kernels at one training shape, with dO: key
    padding to random lengths (the first rows Tk, Tk-11, 1), a fully masked
    row (zero length) and a dead query row; ``chunk`` adds a dynamic-chunk
    mask (chunk 4, 2 chunks of left context). ``identity`` makes v the
    identity (Tk <= dk), so that each output column is one key's dropped
    probability, and dO the identity, so that dV is the dropped
    probabilities' transpose. ``tk``: keys, when not T (a streaming
    chunk's queries against its cache and itself)."""
    import torch

    tk = t if tk is None else tk
    lens = torch.randint(tk // 2, tk + 1, (b,), generator=gen)
    lens[: min(b, 3)] = torch.tensor([tk, max(tk - 11, 1), 1])[: min(b, 3)]
    pos = torch.arange(t)
    mask = (torch.arange(tk)[None, None, :] < lens[:, None, None]).expand(b, t, tk).clone()
    if chunk:
        ci, cj = pos[:, None] // 4, pos[None, :] // 4
        mask &= (cj <= ci) & (cj >= ci - 2)
    if b > 3:
        mask[3] = False
    mask[0, t // 2, :] = False
    q_u, k, v, g = (torch.randn(b, h, n, dk, generator=gen) for n in (t, tk, tk, t))
    if identity:
        v = torch.eye(tk, dk).expand(b, h, tk, dk).clone()
        g = torch.eye(t, dk).expand(b, h, t, dk).clone()
    ab = 0.2 * torch.randn(b, h, t, d, generator=gen)
    feats = torch.randn(tk, d, generator=gen)
    cast = [x.to(dev, dtype).contiguous() for x in (q_u, ab, k, v, feats)]
    seed = torch.tensor([ATTN_SEED], dtype=torch.int32, device=dev)
    return (*cast, mask.to(dev)), seed, g.to(dev, dtype).contiguous()


def _grads_by_autograd(args, seed, g, scale):
    """dQu, dAB, dK, dV by autograd through the plain forward."""
    import torch

    from conformer_tpu_torch.ops.rel_attention import rel_attention_plain

    leaves = [x.detach().clone().requires_grad_() for x in args[:4]]
    out, _ = rel_attention_plain(*leaves, *args[4:], scale=scale, dropout_rate=ATTN_RATE,
                                 seed=seed)
    return torch.autograd.grad((out.float() * g.float()).sum(), leaves)


def check_attention_train_kernels(dev):
    """The attention kernels of training against their plain versions, in
    float32 and bfloat16, at the training shape (B=32, T'=374) and at a
    ragged edge shape with a dynamic-chunk mask: the forward with dropout
    0.1, and dQu, dAB, dK, dV of the dq and dkv kernels against
    ``rel_attention_bwd_plain`` and against autograd through the plain
    forward. The keep-mask is checked bit for bit with identity v and dO
    (T <= dk): the forward's output and dV are then the dropped
    probabilities, so one flipped element shows. Bitwise repeatability for
    one seed. Times, plain and library times and bounds at the training
    shape in bf16. Returns the JSON entries without ``launches``."""
    import torch

    from conformer_tpu_torch.ops import rel_attention as ra

    big, edge, keep_shape = (32, 374), (3, 37), (32, 64)      # (B, T')
    gen = torch.Generator().manual_seed(2)
    scale = 1 / 8
    errs = {"rel_flash_attention": 0.0, "rel_flash_attention_bwd_dq": 0.0,
            "rel_flash_attention_bwd_dkv": 0.0}
    kept = total = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol = TOL[name]
        for (b, t), chunk in ((big, False), (edge, True)):
            args, seed, g = attention_train_inputs(dev, dtype, gen, b, t, chunk=chunk)
            kw = dict(scale=scale, dropout_rate=ATTN_RATE)
            out, lse = ra.rel_attention(*args, seed=seed, **kw)
            out2, lse2 = ra.rel_attention(*args, seed=seed, **kw)
            ref_out, ref_lse = ra.rel_attention_plain(*args, seed=seed, **kw)
            e_f = compare(f"rel_flash_attention {name} B={b} T={t}", (out, lse),
                          (ref_out, ref_lse), tol)
            delta = (g.float() * ref_out.float()).sum(dim=-1)
            bargs = (*args, seed, g, ref_lse, delta)
            dq = ra.rel_attention_bwd_dq(*bargs, **kw)
            dkv = ra.rel_attention_bwd_dkv(*bargs, **kw)
            same = (torch.equal(out, out2) and torch.equal(lse, lse2)
                    and all(torch.equal(x, y) for x, y in zip(
                        (*dq, *dkv), (*ra.rel_attention_bwd_dq(*bargs, **kw),
                                      *ra.rel_attention_bwd_dkv(*bargs, **kw)))))
            torch.cuda.synchronize()
            check(same, f"attention kernels {name} B={b} T={t}: not bitwise repeatable")
            plain = ra.rel_attention_bwd_plain(*bargs, **kw)
            e_q = compare(f"rel_flash_attention_bwd_dq {name} B={b} T={t}", dq, plain[:2], tol)
            e_kv = compare(f"rel_flash_attention_bwd_dkv {name} B={b} T={t}", dkv, plain[2:],
                           tol)
            # autograd differentiates the float32 output, where the kernels'
            # delta reads the output rounded to the input dtype: give them
            # the float32 delta for this comparison
            out32, _ = ra.rel_attention_plain(*[x.float() for x in args[:5]], args[5],
                                              seed=seed, **kw)
            bargs32 = (*args, seed, g, ref_lse, (g.float() * out32).sum(dim=-1))
            auto = _grads_by_autograd(args, seed, g, scale)
            e_aq = compare(f"rel_flash_attention_bwd_dq {name} B={b} T={t} vs autograd",
                           [x.to(dtype) for x in ra.rel_attention_bwd_dq(*bargs32, **kw)],
                           auto[:2], tol)
            e_akv = compare(f"rel_flash_attention_bwd_dkv {name} B={b} T={t} vs autograd",
                            [x.to(dtype) for x in ra.rel_attention_bwd_dkv(*bargs32, **kw)],
                            auto[2:], tol)
            errs["rel_flash_attention"] = max(errs["rel_flash_attention"], e_f)
            errs["rel_flash_attention_bwd_dq"] = max(errs["rel_flash_attention_bwd_dq"], e_q,
                                                     e_aq)
            errs["rel_flash_attention_bwd_dkv"] = max(errs["rel_flash_attention_bwd_dkv"],
                                                      e_kv, e_akv)
            print(f"kernels: attention training {name} B={b} T'={t}{' chunked' if chunk else ''}"
                  f", dropout {ATTN_RATE}: max_abs_err fwd {e_f:.3g}, dq/dAB {e_q:.3g} "
                  f"(autograd {e_aq:.3g}), dK/dV {e_kv:.3g} (autograd {e_akv:.3g}) "
                  f"(tol {tol} abs + rel), bitwise repeatable {same}")
        # the keep-mask, bit for bit, through the forward's output and dV
        for (b, t) in (keep_shape, edge):
            args, seed, g = attention_train_inputs(dev, dtype, gen, b, t, chunk=(b, t) == edge,
                                                   identity=True)
            out, lse = ra.rel_attention(*args, seed=seed, scale=scale, dropout_rate=ATTN_RATE)
            delta = (g.float() * out.float()).sum(dim=-1)
            _, d_v = ra.rel_attention_bwd_dkv(*args, seed, g, lse, delta, scale=scale,
                                              dropout_rate=ATTN_RATE)
            torch.cuda.synchronize()
            mask = args[5][:, None, :, :].expand(b, 4, t, t)
            want = ra.keep_mask(seed, b, 4, t, t, ATTN_RATE, dev) & mask
            got_f = out[..., :t] != 0
            got_v = d_v[..., :t].transpose(-1, -2) != 0
            check(torch.equal(got_f, want) and torch.equal(got_v, want),
                  f"attention keep-mask {name} B={b} T={t}: {int((got_f != want).sum())} "
                  f"(forward) and {int((got_v != want).sum())} (dV) elements differ")
            if dtype == torch.float32 and (b, t) == keep_shape:
                kept, total = int(want.sum()), int(mask.sum())
        print(f"kernels: attention keep-mask {name}: forward and dV equal the hash bit for bit")
    share = kept / total
    print(f"kernels: attention keep share {share:.5f} over {total} live probabilities "
          f"(want {1 - ATTN_RATE} within 0.005)")
    check(abs(share - (1 - ATTN_RATE)) <= 0.005, f"attention keep share {share}")

    # --- times and bounds at the training shape, bf16 (the recipe's dtype)
    entries = {}
    for name, e in attention_train_times(dev, gen, *big).items():
        entries[name] = {"name": name, "route": "cuda", "max_abs_err": errs[name], **e}
    return entries


def attention_train_times(dev, gen, b: int, t: int, h: int = 4, dk: int = 64,
                          d: int = 256, inputs=None, label: str | None = None,
                          heads: dict | None = None, dropout: float = ATTN_RATE) -> dict:
    """Kernel, plain and SDPA times (CUDA events) of the three attention
    kernels of training in bf16 with ``dropout`` at (B, T', H, dk, D), or
    on ``inputs`` ((args, seed, dO) in bf16 or float32, of any Tq and Tk),
    and each one's bound from this run's inputs (the live (query, key)
    pairs of its mask, at the tensor rate of bf16 or the float32 rate);
    ``heads``: the keep-mask's h_total and h_offset (a model rank's heads).
    Returns each kernel's source, the TPU kernel it replaces, ms,
    plain_ms, library_ms, bound_ms and bound_by."""
    import torch

    from conformer_tpu_torch.ops import rel_attention as ra

    scale = 1 / math.sqrt(dk)
    args, seed, g = inputs or attention_train_inputs(dev, torch.bfloat16, gen, b, t, dk=dk,
                                                     d=d, h=h)
    q_u, ab, k, v, feats, mask = args
    kw = dict(scale=scale, dropout_rate=dropout, **(heads or {}))
    out, lse = ra.rel_attention(*args, seed=seed, **kw)
    delta = (g.float() * out.float()).sum(dim=-1)
    bargs = (*args, seed, g, lse, delta)
    dq = ra.rel_attention_bwd_dq(*bargs, **kw)
    dkv = ra.rel_attention_bwd_dkv(*bargs, **kw)
    live = float(mask.sum())            # the (query, key) pairs this run's data needs
    rate = (BF16_TFLOPS if q_u.dtype == torch.bfloat16 else F32_TFLOPS) * 1e12
    f_bound = bound_ms(nbytes(*args, seed, out, lse), 2.0 * h * live * (2 * dk + d) / rate)
    # dq: scores (dk + D), dP (dk), dQu (dk), dAB (D); dkv: scores, dP, dK, dV
    q_bound = bound_ms(nbytes(*args, seed, g, lse, delta, *dq),
                       2.0 * h * live * (3 * dk + 2 * d) / rate)
    kv_bound = bound_ms(nbytes(*args, seed, g, lse, delta, *dkv),
                        2.0 * h * live * (4 * dk + d) / rate)
    bias = (torch.matmul(ab.float(), feats.float().T) * scale).masked_fill(
        ~mask[:, None], float("-inf")).to(q_u.dtype)
    # a fully masked row makes SDPA's softmax NaN: give it one key
    bias[:, :, :, 0] = torch.where(mask.any(-1)[:, None], bias[:, :, :, 0], 0)
    leaves = [x.detach().clone().requires_grad_() for x in (q_u, k, v, bias)]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            *leaves[:3], attn_mask=leaves[3], dropout_p=dropout, scale=scale)

    with torch.no_grad():
        lib_fwd = time_ms(sdpa)
    sdpa_out = sdpa()
    lib_bwd = time_ms(lambda: torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True))
    plain_bwd = time_ms(lambda: ra.rel_attention_bwd_plain(*bargs, **kw))
    specs = [
        ("rel_flash_attention", "rel_flash_attention.cu", "attention_kernel.py:283",
         lambda: ra.rel_attention(*args, seed=seed, **kw),
         lambda: ra.rel_attention_plain(*args, seed=seed, **kw), lib_fwd, f_bound),
        ("rel_flash_attention_bwd_dq", "rel_flash_attention_bwd.cu", "attention_kernel.py:396",
         lambda: ra.rel_attention_bwd_dq(*bargs, **kw), None, lib_bwd, q_bound),
        ("rel_flash_attention_bwd_dkv", "rel_flash_attention_bwd.cu",
         "attention_kernel.py:436", lambda: ra.rel_attention_bwd_dkv(*bargs, **kw), None,
         lib_bwd, kv_bound),
    ]
    times = {}
    where = label or f"B={b} T'={t}"
    for name, src, rep, kern, plain, lib, (bnd, by) in specs:
        times[name] = {
            "source": f"conformer_tpu_torch/csrc/{src}",
            "replaces": f"conformer_tpu/ops/pallas/{rep}",
            "ms": time_ms(kern), "plain_ms": time_ms(plain) if plain else plain_bwd,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib,
        }
        e = times[name]
        print(f"kernels: {name} {str(q_u.dtype).split('.')[-1]} {where} H={h} D={d} "
              f"dropout {dropout}: kernel "
              f"{e['ms']:.4f} ms, "
              f"plain {e['plain_ms']:.4f} ms, library {e['library_ms']:.4f} ms (SDPA "
              f"{'forward' if plain else 'backward, dq and dkv together'}, bias precomputed), "
              f"bound {bnd * 1e3:.2f} us ({by})")
    return times


# ------------------------------------ attention at the other shipped widths

# Conformer-L (configs/conformer_l.json: d=512, 8 heads) at its training
# shape (B=32) and Conformer-M (d=256, 4 heads) at T'=374 (the wide
# kernels), Conformer-S (configs/conformer_s.json: d=144, 4 heads of 36:
# the narrow mma.sync forward, its backward on the wide kernels with dk
# zero-padded to 40), a wide width whose head is narrower than its TMA box
# and whose D is no multiple of 64 (dk 32, D 136), a narrow one whose
# backward pads both dk and D (dk 20, D 100); the 1024-wide Conformer (Conformer XL's widths: d=1024, 8 heads of 128; the
# wide kernels) at its training shape and at a streaming chunk shape (Tq =
# 16 queries against a 512-frame cache and themselves); the keep-mask
# shape has T' <= dk (identity v and dO)
ATTN_WIDTHS = {"conformer_l": dict(b=32, h=8, dk=64, d=512, keep=(4, 64)),
               "conformer_m": dict(b=8, h=4, dk=64, d=256, keep=(8, 64)),
               "conformer_s": dict(b=8, h=4, dk=36, d=144, keep=(8, 36)),
               "dk 32 D 136": dict(b=4, h=4, dk=32, d=136, keep=(4, 32)),
               "dk 20 D 100": dict(b=4, h=4, dk=20, d=100, keep=(4, 20)),
               "conformer_xl": dict(b=32, h=8, dk=128, d=1024, keep=(4, 128)),
               "conformer_xl chunk": dict(b=16, h=8, dk=128, d=1024, tq=16, tk=528,
                                          keep=None),
               # the wide kernels at head width 64 (their DKM = 64 tiles)
               "dk 64 D 1024": dict(b=8, h=8, dk=64, d=1024, keep=(4, 64)),
               # the wide kernels as a model rank runs them: heads 8-15 of 16
               # (the keep-mask hash at the global head, h_total / h_offset)
               "conformer_xl heads 8-15 of 16": dict(b=32, h=8, dk=128, d=1024, keep=None,
                                                     heads=dict(h_total=16, h_offset=8)),
               "conformer_xl chunk heads 8-15 of 16": dict(
                   b=16, h=8, dk=128, d=1024, tq=16, tk=528, keep=None,
                   heads=dict(h_total=16, h_offset=8)),
               # past every kernel's limit (dk <= 128): all wrappers must refuse
               "above the limit": dict(b=1, h=1, dk=136, d=1024, keep=None)}


def poison(*like) -> None:
    """Allocate and free a NaN-filled tensor of each given (shape, dtype),
    so that the caching allocator hands those blocks to the next outputs
    of the same sizes: an element a kernel never writes then reads NaN and
    fails the comparison with the plain version."""
    import torch

    blocks = [torch.full(shape, float("nan"), dtype=dtype, device="cuda")
              for shape, dtype in like]
    del blocks


def heads_note(w: dict) -> str:
    heads = w.get("heads")
    return f", h_total {heads['h_total']} h_offset {heads['h_offset']}" if heads else ""


def check_attention_widths(dev) -> dict:
    """The attention kernels at each of ATTN_WIDTHS (T'=374, or the entry's
    Tq and Tk): the forward without and with dropout 0.1, dq and dkv, and
    the combined backward (``rel_attention_bwd``, the autograd backward's
    call: in bf16 dS and pd once for dq's and dkv's products), against their plain versions in every dtype whose kernels
    take the width (an entry with ``heads``: bf16 with dropout, at that
    head offset), with outputs poisoned beforehand (no element left
    unwritten); the backward bitwise repeatable, the combined backward's
    four outputs bit for bit the two wrappers', and the keep-mask bit for
    bit. Past the kernels' widths (dk = 136), every wrapper must raise
    ValueError before any launch, in both dtypes. Returns the largest
    error of each kernel."""
    import torch

    from conformer_tpu_torch.ops import rel_attention as ra

    gen = torch.Generator().manual_seed(3)
    errs = dict.fromkeys(ATTENTION_KERNELS, 0.0)
    counters = (ra.rel_attention, ra.rel_attention_bwd_dq, ra.rel_attention_bwd_dkv)
    for label, w in ATTN_WIDTHS.items():
        b, h, dk, d = w["b"], w["h"], w["dk"], w["d"]
        t, tk = w.get("tq", 374), w.get("tk", w.get("tq", 374))
        scale = dk ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            tol = TOL[name]
            args, seed, g = attention_train_inputs(dev, dtype, gen, b, t, dk=dk, d=d, h=h,
                                                   tk=tk)
            why = ra.width_error(dtype, dk, d)
            if why is not None:
                before = [f.launches for f in counters]
                kw = dict(scale=scale, dropout_rate=ATTN_RATE)
                lse = torch.zeros((b, h, t), device=dev)
                refused = 0
                for call in (lambda: ra.rel_attention(*args, seed=seed, **kw),
                             lambda: ra.rel_attention_bwd_dq(*args, seed, g, lse, lse, **kw),
                             lambda: ra.rel_attention_bwd_dkv(*args, seed, g, lse, lse, **kw),
                             lambda: ra.rel_attention_bwd(*args, seed, g, lse, lse, **kw)):
                    try:
                        call()
                    except ValueError:
                        refused += 1
                check(refused == 4 and [f.launches for f in counters] == before,
                      f"attention {label} {name}: {refused} of 4 wrappers refused ({why})")
                print(f"kernels: attention {label} {name} H={h} dk={dk} D={d}: all four "
                      f"wrappers raise ValueError before any launch ({why})")
                continue
            for rate in (0.0, ATTN_RATE):
                if "heads" in w and (rate == 0.0 or dtype != torch.bfloat16):
                    continue    # the head offset moves only the bf16 keep-mask
                kw = dict(scale=scale, dropout_rate=rate, **w.get("heads", {}))
                poison(((b, h, t, dk), dtype), ((b, h, t), torch.float32))
                out, lse = ra.rel_attention(*args, seed=seed, **kw)
                ref_out, ref_lse = ra.rel_attention_plain(*args, seed=seed, **kw)
                e_f = compare(f"rel_flash_attention {name} {label}", (out, lse),
                              (ref_out, ref_lse), tol)
                delta = (g.float() * ref_out.float()).sum(dim=-1)
                bargs = (*args, seed, g, ref_lse, delta)
                # the bf16 backward's outputs at its padded widths (cut back after)
                pk, pd = ((ra.tma_width(dk), ra.tma_width(d)) if dtype == torch.bfloat16
                          else (dk, d))
                poison(((b, h, t, pk), torch.float32), ((b, h, t, pd), torch.float32))
                dq = ra.rel_attention_bwd_dq(*bargs, **kw)
                poison(((b, h, tk, pk), torch.float32), ((b, h, tk, pk), torch.float32))
                dkv = ra.rel_attention_bwd_dkv(*bargs, **kw)
                poison(((b, h, t, pk), torch.float32), ((b, h, t, pd), torch.float32),
                       ((b, h, tk, pk), torch.float32), ((b, h, tk, pk), torch.float32))
                both = ra.rel_attention_bwd(*bargs, **kw)
                same = all(torch.equal(x, y) for x, y in zip(
                    (*dq, *dkv), (*ra.rel_attention_bwd_dq(*bargs, **kw),
                                  *ra.rel_attention_bwd_dkv(*bargs, **kw))))
                joint = all(torch.equal(x, y) for x, y in zip(both, (*dq, *dkv)))
                torch.cuda.synchronize()
                check(same, f"attention {label} {name} rate {rate}: not bitwise repeatable")
                check(joint, f"attention {label} {name} rate {rate}: the combined backward's "
                      "dQu, dAB, dK, dV differ from dq's and dkv's")
                plain = ra.rel_attention_bwd_plain(*bargs, **kw)
                e_q = compare(f"rel_flash_attention_bwd_dq {name} {label}", dq, plain[:2], tol)
                e_kv = compare(f"rel_flash_attention_bwd_dkv {name} {label}", dkv, plain[2:],
                               tol)
                e_kv = max(e_kv, compare(f"rel_flash_attention_bwd (dK, dV) {name} {label}",
                                         both[2:], plain[2:], tol))
                for key, e in zip(ATTENTION_KERNELS, (e_f, e_q, e_kv)):
                    errs[key] = max(errs[key], e)
                route = ra.route(dtype, dk, d)
                if dtype == torch.bfloat16 and route == "narrow":
                    route = (f"narrow forward, backward on the wide at dk {ra.tma_width(dk)} "
                             f"D {ra.tma_width(d)}")
                line = (f"kernels: attention {label} {name} B={b} H={h} Tq={t} Tk={tk} dk={dk} "
                        f"D={d} ({route} kernels{heads_note(w)}), "
                        f"dropout {rate}: max_abs_err fwd {e_f:.3g}, dq/dAB {e_q:.3g}, dK/dV "
                        f"{e_kv:.3g} (alone and in the combined backward; tol {tol} abs + rel; "
                        f"outputs poisoned with NaN beforehand), bitwise repeatable {same}, "
                        f"combined = dq's and dkv's bit for bit {joint}")
                if dtype == torch.bfloat16:
                    line += (f"; kernel ms fwd "
                             f"{time_ms(lambda: ra.rel_attention(*args, seed=seed, **kw)):.4f}"
                             f", dq {time_ms(lambda: ra.rel_attention_bwd_dq(*bargs, **kw)):.4f}"
                             f", dkv "
                             f"{time_ms(lambda: ra.rel_attention_bwd_dkv(*bargs, **kw)):.4f}"
                             f", whole backward "
                             f"{time_ms(lambda: ra.rel_attention_bwd(*bargs, **kw)):.4f}")
                print(line)
            if w["keep"] is None:
                continue
            kb, kt = w["keep"]
            args, seed, g = attention_train_inputs(dev, dtype, gen, kb, kt, dk=dk, d=d, h=h,
                                                   identity=True)
            out, lse = ra.rel_attention(*args, seed=seed, scale=scale, dropout_rate=ATTN_RATE)
            delta = (g.float() * out.float()).sum(dim=-1)
            _, d_v = ra.rel_attention_bwd_dkv(*args, seed, g, lse, delta, scale=scale,
                                              dropout_rate=ATTN_RATE)
            torch.cuda.synchronize()
            want = ra.keep_mask(seed, kb, h, kt, kt, ATTN_RATE, dev) & args[5][:, None]
            got_f, got_v = out[..., :kt] != 0, d_v[..., :kt].transpose(-1, -2) != 0
            check(torch.equal(got_f, want) and torch.equal(got_v, want),
                  f"attention keep-mask {label} {name}: {int((got_f != want).sum())} "
                  f"(forward) and {int((got_v != want).sum())} (dV) elements differ")
            print(f"kernels: attention keep-mask {label} {name} B={kb} T'={kt}: forward and dV "
                  "equal the hash bit for bit")
    return errs


# -------------------------------------------------------- training kernels


def lattice_lengths(gen, b, t, u):
    """(t_len, u_len) int32 [B]: random lengths with t_len >= T/2 (every
    CTC alignment possible), after the edge rows (T, U), (1, 0), (T/2, 0)
    and a bucket-padding row (feature length 0: t_len 1, u_len 0, as
    models/transducer.py makes it)."""
    import torch

    t_len = torch.randint(t // 2, t + 1, (b,), generator=gen)
    u_len = torch.randint(1, u + 1, (b,), generator=gen)
    for i, (tl, ul) in enumerate([(t, u), (1, 0), (max(t // 2, 1), 0), (1, 0)][:b]):
        t_len[i], u_len[i] = tl, ul
    return t_len.to(torch.int32), u_len.to(torch.int32)


def training_kernel_inputs(dev, gen, b, t, u, v):
    """float32 inputs of the six training kernels at one shape, built as
    the pruned loss and the CTC head build them."""
    import torch
    import torch.nn.functional as F

    from conformer_tpu_torch.ops.ctc import NEG_INF, _extended_labels, skip_allowed

    t_len, u_len = lattice_lengths(gen, b, t, u)
    labels = torch.randint(1, v - 1, (b, u), generator=gen)
    labels[0, 1] = labels[0, 0]                       # a repeat: CTC skip not allowed
    labels = torch.where(torch.arange(u)[None, :] < u_len[:, None].long(), labels, 0)
    am = 2.0 * torch.randn(b, t, v, generator=gen)
    lm = 2.0 * torch.randn(b, u + 1, v, generator=gen)
    lab = F.pad(labels, (0, 1), value=0).to(torch.int32)
    g_blank, g_emit = (torch.randn(b, t, u + 1, generator=gen) for _ in range(2))
    lp_blank = F.logsigmoid(torch.randn(b, t, u + 1, generator=gen))
    lp_emit = F.logsigmoid(torch.randn(b, t, u + 1, generator=gen))
    g = 0.5 + 1.5 * torch.rand(b, generator=gen)
    log_probs = torch.log_softmax(torch.randn(b, t, v, generator=gen), dim=-1)
    ext = _extended_labels(labels, 0)
    skip = torch.where(skip_allowed(ext, 0), 0.0, NEG_INF)
    emit = log_probs.gather(2, ext[:, None, :].expand(b, t, ext.shape[1]))
    cuda = {k: x.to(dev).contiguous() for k, x in dict(
        t_len=t_len, u_len=u_len, labels=labels, am=am, lm=lm, lab=lab, g_blank=g_blank,
        g_emit=g_emit, lp_blank=lp_blank, lp_emit=lp_emit, g=g, log_probs=log_probs,
        skip=skip, emit=emit).items()}
    return cuda


def compare(name, got, want, tol=TOL["float32"]) -> float:
    errs = [max_err(x, y, tol) for x, y in zip(got, want)]
    err = max(e for e, _ in errs)
    check(all(ok for _, ok in errs), f"{name} disagrees with its plain version "
          f"(max abs err {err:.3g}, tol {tol} abs + rel)")
    return err


def compare_sums(name, got, want, tol) -> float:
    """``compare`` for sums over many terms: each tensor's max abs
    difference within ``tol`` of its own max-abs."""
    errs = [(float((x.float() - y.float()).abs().max()), float(y.float().abs().max()))
            for x, y in zip(got, want)]
    err = max(e for e, _ in errs)
    check(all(e <= tol * s for e, s in errs), f"{name} disagrees with its plain version "
          f"(max abs err {err:.3g}, tol {tol} of max-abs {[s for _, s in errs]})")
    return err


# the simple lattice past one u tile of its forward and one chunk of its
# backward (72 rows each): U+1 = 301, where the wrappers once refused
# anything above 256 (B, T', U, V)
SIMPLE_LONG = ((2, 412, 300, 5002),)
# the simple lattice's guard: am's maxima at v = 5 on the first half of t,
# lm's at v = 9 on the second half of u, 200 nats high, so that on the cells
# where both meet the factored sum underflows (B, T', U, V)
SIMPLE_APART = (4, 374, 64, 5002)


def check_simple_lattice_guard(dev, gen) -> dict:
    """Both simple-lattice kernels on the "maxima apart" inputs, outputs
    poisoned with NaN first, against the plain versions at TOL["float32"];
    the guard must take cells in both directions. Returns the guarded-cell
    counts."""
    import torch

    from conformer_tpu_torch.ops import simple_lattice as sl

    b, t, u, v = SIMPLE_APART
    x = training_kernel_inputs(dev, gen, b, t, u, v)
    am, lm = x["am"].clone(), x["lm"].clone()
    am[:, :t // 2, 5] += 200.0
    lm[:, (u + 1) // 2:, 9] += 200.0
    poison(*[((b, t, u + 1), torch.float32)] * 3)
    fwd = sl.simple_lattice_fwd(am, lm, x["lab"], 0)
    guarded_f = int(sl.simple_lattice_fwd.guarded.sum())
    fwd_p = sl.simple_lattice_plain_fwd(am, lm, x["lab"], 0)
    e_f = compare("simple_lattice_fwd (maxima apart)", fwd, fwd_p)
    bargs = (am, lm, x["lab"], fwd_p[2], x["g_blank"], x["g_emit"], 0)
    poison(((b, t, v), torch.float32), ((b, u + 1, v), torch.float32))
    bwd = sl.simple_lattice_bwd(*bargs)
    guarded_b = int(sl.simple_lattice_bwd.guarded.sum())
    e_b = compare("simple_lattice_bwd (maxima apart)", bwd, sl.simple_lattice_plain_bwd(*bargs))
    check(guarded_f > 0 and guarded_b > 0,
          f"simple lattice guard took no cell on the maxima-apart inputs ({guarded_f}, {guarded_b})")
    print(f"kernels: simple lattice f32 maxima 200 nats apart B={b} T'={t} U={u} V={v}: "
          f"guarded cells fwd {guarded_f}, bwd {guarded_b} of {b * t * (u + 1)}; max_abs_err fwd "
          f"{e_f:.3g}, bwd {e_b:.3g} (tol {TOL['float32']} abs + rel; outputs poisoned with NaN)")
    return {"forward": guarded_f, "backward": guarded_b}


def check_training_kernels(dev, shapes=((32, 374, 64, 5002), (4, 412, 200, 5002),
                                        (5, 37, 6, 37)), simple_long=SIMPLE_LONG,
                           guard: bool = True) -> dict:
    """The six training kernels against their plain versions in float32 at
    the training shape (B=32, T'=374, U=64, V=5002), at the recipe's
    longest bucket with labels padded to ``max_label_len`` (B=4, T'=412,
    U=200) and at a tiny ragged one, edge rows included; the simple
    lattice's two also at ``simple_long`` (U=300) and on the "maxima apart"
    inputs that reach their guard (``guard``); times, plain and library times (for the
    simple lattice a labelled yardstick: its products alone by float32
    ``torch.matmul``) and bounds at the training shape. Returns the JSON
    entries without ``launches``."""
    import torch
    import torch.nn.functional as F

    from conformer_tpu_torch.ops import ctc_dp as cd
    from conformer_tpu_torch.ops import rnnt_lattice as rl
    from conformer_tpu_torch.ops import simple_lattice as sl

    gen = torch.Generator().manual_seed(1)
    entries = {}
    for b, t, u, v in (*shapes, *simple_long):
        x = training_kernel_inputs(dev, gen, b, t, u, v)
        tl, ul = x["t_len"], x["u_len"]
        errs = {}
        sfwd = sl.simple_lattice_fwd(x["am"], x["lm"], x["lab"], 0)
        sfwd_p = sl.simple_lattice_plain_fwd(x["am"], x["lm"], x["lab"], 0)
        errs["simple_lattice_fwd"] = compare("simple_lattice_fwd", sfwd, sfwd_p)
        logz = sfwd_p[2]
        sbwd = sl.simple_lattice_bwd(x["am"], x["lm"], x["lab"], logz, x["g_blank"], x["g_emit"], 0)
        sbwd_p = sl.simple_lattice_plain_bwd(x["am"], x["lm"], x["lab"], logz, x["g_blank"],
                                             x["g_emit"], 0)
        errs["simple_lattice_bwd"] = compare("simple_lattice_bwd", sbwd, sbwd_p)
        guarded = (int(sl.simple_lattice_fwd.guarded.sum()),
                   int(sl.simple_lattice_bwd.guarded.sum()))
        check(guarded == (0, 0), f"simple lattice guard took cells of random inputs: {guarded}")
        if (b, t, u, v) in simple_long:
            torch.cuda.synchronize()
            print(f"kernels: simple lattice f32 B={b} T'={t} U={u} V={v}: max_abs_err "
                  + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
                  + f" (tol {TOL['float32']} abs + rel; max_u1 {sl.max_u1()}; guarded cells 0)")
            continue
        rfwd = rl.rnnt_lattice_fwd(x["lp_blank"], x["lp_emit"], tl, ul)
        rfwd_p = rl.rnnt_lattice_plain_fwd(x["lp_blank"], x["lp_emit"], tl, ul)
        errs["rnnt_lattice_fwd"] = compare("rnnt_lattice_fwd", rfwd, rfwd_p)
        nll, alpha = rfwd_p
        rargs = (x["lp_blank"], x["lp_emit"], alpha, tl, ul, nll, x["g"])
        errs["rnnt_lattice_bwd"] = compare("rnnt_lattice_bwd", rl.rnnt_lattice_bwd(*rargs),
                                           rl.rnnt_lattice_plain_bwd(*rargs))
        cfwd = cd.ctc_dp_fwd(x["emit"], x["skip"], tl, ul)
        cfwd_p = cd.ctc_dp_plain_fwd(x["emit"], x["skip"], tl, ul)
        errs["ctc_dp_fwd"] = compare("ctc_dp_fwd", cfwd, cfwd_p)
        cargs = (x["emit"], x["skip"], cfwd_p[1], tl, ul, cfwd_p[0], x["g"])
        errs["ctc_dp_bwd"] = compare("ctc_dp_bwd", (cd.ctc_dp_bwd(*cargs),),
                                     (cd.ctc_dp_plain_bwd(*cargs),))
        torch.cuda.synchronize()
        print(f"kernels: training f32 B={b} T'={t} U={u} V={v}: max_abs_err "
              + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
              + f" (tol {TOL['float32']} abs + rel; simple lattice guarded cells 0)")
        if (b, t, u, v) != shapes[0]:
            continue
        # --- times and bounds at the training shape
        lat = b * t * (u + 1)
        exp_rate = EXP_PER_CLK_SM * H100_SMS * H100_CLOCK_HZ
        # The simple lattice's least work is its factored form: logZ[t,u] =
        # max_am + max_lm + log(exp(am - max_am) @ exp(lm - max_lm)^T), one
        # float32 product of 2*lat*V flops; the backward's d am = exp(am) *
        # (W @ exp(lm)) and d lm = exp(lm) * (W^T @ exp(am)), W = (g_b+g_e)/Z,
        # are two such products. Either way, (T+U+1)*V exps per row. The
        # kernels run the products as 3xTF32 on the tensor cores: three TF32
        # products each, at the TF32 rate.
        s_flops = 2.0 * lat * v
        s_exps = float(b) * (t + u + 1) * v + lat
        n_b = nbytes(x["am"], x["lm"], x["lab"], *sfwd)
        fwd_bound = bound_ms(n_b, max(3 * s_flops / (TF32_TFLOPS * 1e12), s_exps / exp_rate))
        n_b = nbytes(x["am"], x["lm"], x["lab"], logz, x["g_blank"], x["g_emit"], *sbwd)
        bwd_bound = bound_ms(n_b, max(6 * s_flops / (TF32_TFLOPS * 1e12), s_exps / exp_rate))
        # yardsticks: the factored products alone by float32 torch.matmul
        ea = torch.exp(x["am"] - x["am"].amax(-1, keepdim=True))
        el = torch.exp(x["lm"] - x["lm"].amax(-1, keepdim=True))
        w_lat = torch.rand(b, t, u + 1, device=x["am"].device)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        s_yard = {"simple_lattice_fwd": time_ms(lambda: torch.matmul(ea, el.transpose(1, 2))),
                  "simple_lattice_bwd": time_ms(lambda: (torch.matmul(w_lat, el),
                                                         torch.matmul(w_lat.transpose(1, 2), ea)))}
        torch.backends.cuda.matmul.allow_tf32 = tf32
        del ea, el, w_lat
        sargs = (x["am"], x["lm"], x["lab"], 0)
        bargs = (x["am"], x["lm"], x["lab"], logz, x["g_blank"], x["g_emit"], 0)
        # transcendentals of the DP kernels: two per cell (exp, log1p) and
        # direction, plus two for each cell's gradients
        r_fwd = bound_ms(nbytes(x["lp_blank"], x["lp_emit"], tl, ul, *rfwd),
                         2.0 * lat / exp_rate)
        r_bwd = bound_ms(nbytes(*rargs, *rl.rnnt_lattice_bwd(*rargs)), 4.0 * lat / exp_rate)
        s_lat = b * t * (2 * u + 1)
        c_fwd = bound_ms(nbytes(x["emit"], x["skip"], tl, ul, *cfwd), 4.0 * s_lat / exp_rate)
        c_bwd = bound_ms(nbytes(*cargs, x["emit"]), 5.0 * s_lat / exp_rate)
        lp_tbv = x["log_probs"].transpose(0, 1).contiguous().requires_grad_()
        tgt = x["labels"]

        def lib_ctc():
            return F.ctc_loss(lp_tbv, tgt, tl, ul, blank=0, reduction="none")

        def lib_ctc_fb():
            return torch.autograd.grad(lib_ctc().sum(), lp_tbv)

        specs = [
            ("simple_lattice_fwd", "simple_lattice.cu", "simple_lattice_kernel.py:163",
             lambda: sl.simple_lattice_fwd(*sargs), lambda: sl.simple_lattice_plain_fwd(*sargs),
             None, fwd_bound, f"factored: {s_flops:.3g} f32 flops as 3xTF32, {s_exps:.3g} exps"),
            ("simple_lattice_bwd", "simple_lattice.cu", "simple_lattice_kernel.py:196",
             lambda: sl.simple_lattice_bwd(*bargs), lambda: sl.simple_lattice_plain_bwd(*bargs),
             None, bwd_bound, f"factored: {2 * s_flops:.3g} f32 flops as 3xTF32, {s_exps:.3g} exps"),
            ("rnnt_lattice_fwd", "rnnt_lattice.cu", "rnnt_kernel.py:240",
             lambda: rl.rnnt_lattice_fwd(x["lp_blank"], x["lp_emit"], tl, ul),
             lambda: rl.rnnt_lattice_plain_fwd(x["lp_blank"], x["lp_emit"], tl, ul),
             None, r_fwd, f"chain of {t + u} dependent steps"),
            ("rnnt_lattice_bwd", "rnnt_lattice.cu", "rnnt_kernel.py:268",
             lambda: rl.rnnt_lattice_bwd(*rargs), lambda: rl.rnnt_lattice_plain_bwd(*rargs),
             None, r_bwd, f"chain of {t + u} dependent steps"),
            ("ctc_dp_fwd", "ctc_dp.cu", "ctc_kernel.py:222",
             lambda: cd.ctc_dp_fwd(x["emit"], x["skip"], tl, ul),
             lambda: cd.ctc_dp_plain_fwd(x["emit"], x["skip"], tl, ul),
             lib_ctc, c_fwd, f"chain of {t} dependent steps"),
            ("ctc_dp_bwd", "ctc_dp.cu", "ctc_kernel.py:253",
             lambda: cd.ctc_dp_bwd(*cargs), lambda: cd.ctc_dp_plain_bwd(*cargs),
             lib_ctc_fb, c_bwd, f"chain of {t} dependent steps"),
        ]
        for name, src, rep, kern, plain, lib, (bnd, by), note in specs:
            entries[name] = {
                "name": name, "route": "cuda",
                "source": f"conformer_tpu_torch/csrc/{src}",
                "replaces": f"conformer_tpu/ops/pallas/{rep}",
                "max_abs_err": errs[name],
                "ms": time_ms(kern), "plain_ms": time_ms(plain),
                "bound_ms": bnd, "bound_by": by,
                "library_ms": time_ms(lib) if lib is not None else None,
            }
            e = entries[name]
            if name in s_yard:    # no one PyTorch call computes the function
                e["yardsticks_ms"] = {"float32 torch.matmul of the factored product(s), "
                                      "allow_tf32 False": s_yard[name]}
            dev_note = ""
            if name.startswith(("rnnt_lattice", "ctc_dp")):   # one launch a call
                e["device_ms"] = device_ms(kern, name)
                dev_note = (" (device not measured)" if e["device_ms"] is None
                            else f" (device {e['device_ms']:.4f} ms, torch.profiler)")
            print(f"kernels: {name} f32 B={b} T'={t} U={u} V={v}: kernel {e['ms']:.4f} ms"
                  f"{dev_note}, plain {e['plain_ms']:.4f} ms, library {e['library_ms']} ms, "
                  f"yardsticks {e.get('yardsticks_ms')} ms, bound {bnd * 1e3:.2f} us ({by}; "
                  f"{note})")
    if guard:
        check_simple_lattice_guard(dev, gen)
    return entries


# DP kernels at label lengths past one thread per state (B, T', U): CTC
# S = 801 and 1201, the lattice U+1 = 601 and 1101
DP_LONG = {"ctc_dp": ((2, 1300, 400), (2, 1300, 600)),
           "rnnt_lattice": ((2, 374, 600), (2, 374, 1100))}


def check_dp_long_labels(dev) -> dict:
    """The CTC and RNN-T DP kernels against their plain versions in
    float32 at the long label lengths of ``DP_LONG`` (V=64: the DPs do not
    see V), and their wrappers' limits, which must pass 1024. Returns the
    largest error of each kernel."""
    import torch

    from conformer_tpu_torch.ops import ctc_dp as cd
    from conformer_tpu_torch.ops import rnnt_lattice as rl

    print(f"kernels: DP wrapper limits (shared memory): ctc_dp S <= {cd.max_states()}; "
          f"rnnt_lattice U+1 <= {rl.max_u1(374)} at T'=374, {rl.max_u1(1300)} at T'=1300")
    check(cd.max_states() > 1024 and rl.max_u1(1300) > 1024, "a DP wrapper caps at 1024")
    gen = torch.Generator().manual_seed(4)
    errs = dict.fromkeys(("ctc_dp_fwd", "ctc_dp_bwd", "rnnt_lattice_fwd", "rnnt_lattice_bwd"),
                         0.0)
    for kind, shapes in DP_LONG.items():
        for b, t, u in shapes:
            x = training_kernel_inputs(dev, gen, b, t, u, 64)
            tl, ul = x["t_len"], x["u_len"]
            if kind == "ctc_dp":
                fargs = (x["emit"], x["skip"], tl, ul)
                fwd, fwd_p = cd.ctc_dp_fwd(*fargs), cd.ctc_dp_plain_fwd(*fargs)
                bargs = (x["emit"], x["skip"], fwd_p[1], tl, ul, fwd_p[0], x["g"])
                bwd, bwd_p = (cd.ctc_dp_bwd(*bargs),), (cd.ctc_dp_plain_bwd(*bargs),)
                f_ms = time_ms(lambda: cd.ctc_dp_fwd(*fargs), iters=5)
                b_ms = time_ms(lambda: cd.ctc_dp_bwd(*bargs), iters=5)
                width = f"S={2 * u + 1}"
            else:
                fargs = (x["lp_blank"], x["lp_emit"], tl, ul)
                fwd, fwd_p = rl.rnnt_lattice_fwd(*fargs), rl.rnnt_lattice_plain_fwd(*fargs)
                bargs = (x["lp_blank"], x["lp_emit"], fwd_p[1], tl, ul, fwd_p[0], x["g"])
                bwd, bwd_p = rl.rnnt_lattice_bwd(*bargs), rl.rnnt_lattice_plain_bwd(*bargs)
                f_ms = time_ms(lambda: rl.rnnt_lattice_fwd(*fargs), iters=5)
                b_ms = time_ms(lambda: rl.rnnt_lattice_bwd(*bargs), iters=5)
                width = f"U+1={u + 1}"
            e_f = compare(f"{kind}_fwd B={b} T'={t} U={u}", fwd, fwd_p)
            e_b = compare(f"{kind}_bwd B={b} T'={t} U={u}", bwd, bwd_p)
            errs[f"{kind}_fwd"] = max(errs[f"{kind}_fwd"], e_f)
            errs[f"{kind}_bwd"] = max(errs[f"{kind}_bwd"], e_b)
            print(f"kernels: {kind} f32 long labels B={b} T'={t} U={u} ({width}): max_abs_err "
                  f"fwd {e_f:.3g}, bwd {e_b:.3g} (tol {TOL['float32']} abs + rel); kernel ms "
                  f"fwd {f_ms:.4f}, bwd {b_ms:.4f}")
    return errs


def ctc_edge_shapes() -> tuple:
    """The CTC DP's dispatch edges (csrc/ctc_dp.cu, ops/ctc_dp.py route),
    (B, T', U): its chain kernels on one warp and two (S = 31, 33), two and
    three (63, 65), the last S they take and the first the block path takes
    (511, 513), there at T' = 1100, many hand-over chunks long."""
    from conformer_tpu_torch.ops import ctc_dp as cd

    u_last = (cd.CHAIN_MAX_STATES - 1) // 2
    return ((6, 300, 15), (6, 300, 16), (6, 300, 31), (6, 300, 32), (6, 1100, u_last),
            (6, 1100, u_last + 1))


def ctc_edge_inputs(dev, gen, t, u, v=64):
    """(emit, skip, t_len, u_len, g) of six rows whose lengths differ
    widely, so that the kernels skip many dead steps: (T', U), (1, 0), (T'/2,
    T'/4), (2, 1), (T'-1, U/2), (T'/7, T'/14), the last four capped at U;
    row 0's first label repeated (no skip there)."""
    import torch

    from conformer_tpu_torch.ops.ctc import NEG_INF, _extended_labels, skip_allowed

    t_len = torch.tensor([t, 1, t // 2, 2, t - 1, max(t // 7, 1)], dtype=torch.int32)
    u_len = torch.tensor([u, 0, min(u, t // 4), min(u, 1), u // 2, min(u, t // 14)],
                         dtype=torch.int32)
    b = len(t_len)
    labels = torch.randint(1, v - 1, (b, u), generator=gen)
    labels[0, 1] = labels[0, 0]
    labels = torch.where(torch.arange(u)[None, :] < u_len[:, None].long(), labels, 0)
    log_probs = torch.log_softmax(torch.randn(b, t, v, generator=gen), dim=-1)
    ext = _extended_labels(labels, 0)
    skip = torch.where(skip_allowed(ext, 0), 0.0, NEG_INF)
    emit = log_probs.gather(2, ext[:, None, :].expand(b, t, ext.shape[1]))
    g = 0.5 + 1.5 * torch.rand(b, generator=gen)
    return [x.to(dev).contiguous() for x in (emit, skip, t_len, u_len, g)]


def check_ctc_dispatch_edges(dev) -> dict:
    """Both CTC DP kernels against their plain versions in float32 at
    ``ctc_edge_shapes``, outputs poisoned with NaN first; which path each
    shape takes must be the one ``route`` names. Returns the largest error
    of each kernel."""
    import torch

    from conformer_tpu_torch.ops import ctc_dp as cd

    gen = torch.Generator().manual_seed(5)
    errs = {"ctc_dp_fwd": 0.0, "ctc_dp_bwd": 0.0}
    routes = []
    for b, t, u in ctc_edge_shapes():
        emit, skip, tl, ul, g = ctc_edge_inputs(dev, gen, t, u)
        s = emit.shape[2]
        routes.append(cd.route(s))
        poison(((b,), torch.float32), ((b, t, s), torch.float32))
        fwd = cd.ctc_dp_fwd(emit, skip, tl, ul)
        fwd_p = cd.ctc_dp_plain_fwd(emit, skip, tl, ul)
        bargs = (emit, skip, fwd_p[1], tl, ul, fwd_p[0], g)
        poison(((b, t, s), torch.float32))
        bwd = (cd.ctc_dp_bwd(*bargs),)
        e_f = compare(f"ctc_dp_fwd S={s}", fwd, fwd_p)
        e_b = compare(f"ctc_dp_bwd S={s}", bwd, (cd.ctc_dp_plain_bwd(*bargs),))
        errs["ctc_dp_fwd"] = max(errs["ctc_dp_fwd"], e_f)
        errs["ctc_dp_bwd"] = max(errs["ctc_dp_bwd"], e_b)
        print(f"kernels: ctc_dp f32 dispatch edge B={b} T'={t} U={u} (S={s}, {cd.route(s)} path; "
              f"t_len {tl.tolist()}): max_abs_err fwd {e_f:.3g}, bwd {e_b:.3g} "
              f"(tol {TOL['float32']} abs + rel; outputs poisoned with NaN)")
    check(routes == ["chain"] * 5 + ["block"], f"ctc_dp routes at the dispatch edges: {routes}")
    return errs


# ------------------------------------------------------------ int8 kernels

INT8_TOL = {"float32": (1e-2, 2e-3), "bfloat16": (2e-2, 2e-2)}   # (rtol, atol), JAX's own
INT8_ROWS = (17952, 374, 37, 1)   # route B's batch (48 x 374), one request of 15 s, ragged, one
# f32 int8 kernel path vs plain path, encoder outputs. The f32 kernels
# differ from their plain versions by ~1e-6 (attention, conv) or take their
# sums in another order (the fused FFN's LayerNorm), which flips an int8
# value wherever an input lies that close to a rounding boundary. One step
# of an FFN input (s_x ~ max|LN(x)| / 127 ~ 0.03) moves the hidden by up to
# s_x * max|W1| ~ 2e-3 and, summed over 2048 hidden units through W2 and
# halved, an FFN output by ~2e-4 at Conformer-M's init; the next layer
# quantizes that difference again, so flips breed flips, and over 12
# layers the two paths part by a share of the quantization's own error
# (on an H100, PERF.md §6, route A: 4.5e-3 max, 4.7e-4 mean, against
# 1.1e-2 and 1.9e-3 between the int8 and the float encoder). Two int8
# encoders whose rounding has fully parted differ by up to sqrt(2) times
# that error. The limits: the max within 5e-2 (some 250 single steps), the
# mean within 1.5 times the quantization's own mean in the same run (int8
# against float weights, plain path). A wrong scale, row or product moves
# outputs by O(1).
INT8_ENC_TOL = 5e-2
INT8_ENC_MEAN_SHARE = 1.5
# the same paths' token agreement on the unbiased weights (every row runs
# to max_hyp_len). bf16 rounding of the float path (~1e-2) left its
# hypotheses identical over 12,288 tokens in earlier runs; a broken kernel
# would agree by chance only. On the served weights (no emission) the
# hypotheses must be identical.
INT8_AGREE_MIN = 0.9


def int8_ffn_weights(dev, gen, d=256, h=2048):
    """Conformer-M FFN weights from ``gen`` as the port initialises them,
    and their int8 form: (LayerNorm params, float w_1, float w_2, int8 w_1,
    int8 w_2), on ``dev``."""
    import torch

    from conformer_tpu_torch.ops.quant import quantize_dense_params

    def u(*shape, bound):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * bound).to(dev)

    f1 = {"kernel": u(d, h, bound=d ** -0.5), "bias": u(h, bound=d ** -0.5)}
    f2 = {"kernel": u(h, d, bound=h ** -0.5), "bias": u(d, bound=h ** -0.5)}
    ln = {"scale": 1 + u(d, bound=0.1), "bias": u(d, bound=0.05)}
    return ln, f1, f2, quantize_dense_params(f1), quantize_dense_params(f2)


def check_int8_kernels(dev) -> dict:
    """The two int8 serving kernels against their plain versions at route
    B's rows (M = 17952), route A's (M = 374), a ragged M and M = 1, with an
    all-zero row, in float32 and bfloat16: ``int8_matmul`` bit for bit (its
    int32 sums are exact and its rescale has no add), ``int8_ffn`` within
    JAX's tolerances, both bitwise repeatable. Times (CUDA events around
    the wrapper and the kernel's device time by torch.profiler), two
    yardsticks each and bounds in bf16 at M = 17952 (the JSON entries) and
    at M = 374 (under "M=374" in each entry). Returns the JSON entries
    without ``launches``."""
    import torch

    from conformer_tpu_torch.models import feedforward, layers
    from conformer_tpu_torch.ops.int8_ffn import int8_ffn_fused, int8_ffn_plain
    from conformer_tpu_torch.ops.int8_matmul import (
        int8_matmul_dynamic,
        int8_matmul_dynamic_plain,
        quant_rows,
    )

    gen = torch.Generator().manual_seed(4)
    ln, f1, f2, w1, w2 = int8_ffn_weights(dev, gen)
    d, h = w1["kernel_q"].shape
    mm_args = (w1["kernel_q"], w1["kernel_scale"])
    ffn_args = (ln, w1["kernel_q"], w1["kernel_scale"], w1["bias"], w2["kernel_q"],
                w2["kernel_scale"], w2["bias"])
    err_mm = err_ffn = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        rtol, atol = INT8_TOL[name]
        for m in INT8_ROWS:
            x = torch.randn(m, d, generator=gen)
            if m > 2:
                x[m // 2] = 0.0                       # a bucket-padding row
            x = x.to(dev, dtype)
            y, y2 = (int8_matmul_dynamic(x, *mm_args) for _ in range(2))
            out, out2 = (int8_ffn_fused(x, *ffn_args) for _ in range(2))
            torch.cuda.synchronize()
            ref = int8_matmul_dynamic_plain(x, *mm_args)
            differ = int((y != ref).sum())
            e_mm = float((y.float() - ref.float()).abs().max())
            zero_ok = m <= 2 or bool((y[m // 2] == 0).all())
            ref_f = int8_ffn_plain(x, *ffn_args)
            diff = (out.float() - ref_f.float()).abs()
            ok_f = bool((diff <= atol + rtol * ref_f.float().abs()).all())
            e_ffn = float(diff.max())
            share = float((diff > 1e-5).float().mean())
            print(f"kernels: int8 {name} M={m}: int8_matmul {differ} of {y.numel()} elements "
                  f"differ from plain (max abs err {e_mm:.3g}; want bit for bit), zero row "
                  f"zero {zero_ok}; int8_ffn max abs err {e_ffn:.3g} (rtol {rtol}, atol {atol}), "
                  f"{share:.4%} of elements differ by more than 1e-5")
            check(differ == 0 and zero_ok,
                  f"int8_matmul {name} M={m} disagrees with its plain version")
            check(ok_f, f"int8_ffn {name} M={m} disagrees with its plain version")
            check(torch.equal(y, y2) and torch.equal(out, out2),
                  f"int8 kernels {name} M={m}: not bitwise repeatable")
            err_mm, err_ffn = max(err_mm, e_mm), max(err_ffn, e_ffn)

    # --- times at route B's rows (M = 17952) and route A's (M = 374), bf16
    # (the serving dtype): CUDA events around the wrapper and the kernel's
    # device time by torch.profiler; the JSON entry is route B's row
    w1_bf = f1["kernel"].to(torch.bfloat16)
    f_ffn = {"w_1": f1, "w_2": f2}
    entries = {}
    for m in (INT8_ROWS[0], INT8_ROWS[1]):
        x = torch.randn(m, d, generator=gen).to(dev, torch.bfloat16)
        y = int8_matmul_dynamic(x, *mm_args)
        out = int8_ffn_fused(x, *ffn_args)
        x_q, _ = quant_rows(x.float())
        h_q, _ = quant_rows(torch.randn(m, h, generator=gen).to(dev))
        mm_bound = bound_ms(nbytes(x, *mm_args, y), 2.0 * m * d * h / (INT8_TOPS * 1e12))
        ffn_bound = bound_ms(nbytes(x, out, *ffn_args[1:], ln["scale"], ln["bias"]),
                             4.0 * m * d * h / (INT8_TOPS * 1e12))
        mm_lib = time_ms(lambda: torch._int_mm(x_q, w1["kernel_q"]))
        w2_lib = time_ms(lambda: torch._int_mm(h_q, w2["kernel_q"]))
        specs = [
            ("int8_matmul", "int8_matmul.cu", "quant_kernel.py:48", err_mm,
             lambda: int8_matmul_dynamic(x, *mm_args),
             lambda: int8_matmul_dynamic_plain(x, *mm_args),
             {"torch._int_mm, the int8 product alone": mm_lib,
              "bf16 torch.matmul, the float product it replaces": time_ms(
                  lambda: torch.matmul(x, w1_bf))}, mm_bound),
            ("int8_ffn", "int8_ffn.cu", "ffn_kernel.py:78", err_ffn,
             lambda: int8_ffn_fused(x, *ffn_args), lambda: int8_ffn_plain(x, *ffn_args),
             {"torch._int_mm x 2, the two int8 products alone": mm_lib + w2_lib,
              "bf16 float FFN half as the port runs it (LN, dense, swish, dense, residual)":
                  time_ms(lambda: x + 0.5 * feedforward.ffn(f_ffn, layers.layer_norm(ln, x)))},
             ffn_bound),
        ]
        for name, src, rep_, err, kern, plain, yard, (bnd, by) in specs:
            e = {"ms": time_ms(kern), "device_ms": device_ms(kern, f"{name}_kernel"),
                 "plain_ms": time_ms(plain), "bound_ms": bnd, "bound_by": by,
                 "yardsticks_ms": yard}
            dev_ms = "not measured" if e["device_ms"] is None else f"{e['device_ms']:.4f} ms"
            print(f"kernels: {name} bf16 M={m} D={d} H={h}: kernel {e['ms']:.4f} ms (events "
                  f"around the wrapper), device {dev_ms} (profiler), plain "
                  f"{e['plain_ms']:.4f} ms, yardsticks {yard} ms, bound {bnd * 1e3:.2f} us ({by})")
            if m != INT8_ROWS[0]:
                entries[name][f"M={m}"] = e
                continue
            entries[name] = {
                "name": name, "route": "cuda", "source": f"conformer_tpu_torch/csrc/{src}",
                "replaces": f"conformer_tpu/ops/pallas/{rep_}", "max_abs_err": err,
                "library_ms": None,          # no one PyTorch call computes the function
                **e}
    return entries


INT8_WIDTHS = {"conformer_s": (144, 576), "conformer_l": (512, 2048)}
# edge shapes (D, H) of each kernel's other paths: the matmul at K = 1000
# (the K > 512 quantization, K padded to 1024) and K = 70 (x read element
# by element), both with N = 130 (rows not whole 16 bytes: the epilogue
# without TMA stores); the FFN at D = 70 (x, out and the vectors element
# by element) and H = 130 (a cluster block with no hidden column)
INT8_EDGES = {"int8_matmul": ((1000, 130), (70, 130)), "int8_ffn": ((70, 130), (144, 130))}
# the fused FFN on its wide route (D > 512 or H > 2048): Conformer XL's
# widths (the 1024-wide model of 6d) and twice them
INT8_FFN_WIDE = {"conformer_xl": (1024, 4096), "2048 / 8192": (2048, 8192)}
INT8_FFN_WIDE_ROWS = (2992, 37)     # 6d (d)'s batch (8 x 374) and a ragged M
# past the kernels' widths: the matmul's K (its A tiles); the FFN has none
INT8_BEYOND = {"int8_matmul K": 1056}


def check_int8_widths(dev) -> tuple[float, float]:
    """The two int8 kernels at Conformer-S's and -L's widths (D / H = 144 /
    576 and 512 / 2048; the matmul as route A runs it, K = D, N = H) in
    float32 and bfloat16, at M = 374 (one request of 15 s) and a ragged M
    = 37 with an all-zero row, outputs poisoned with NaN beforehand:
    ``int8_matmul`` bit for bit against its plain version, ``int8_ffn``
    within INT8_TOL; the FFN alone the same way at INT8_FFN_WIDE (its wide
    route) and INT8_FFN_WIDE_ROWS; past the matmul's K it must
    raise ValueError before any launch; then each kernel at INT8_EDGES in
    both dtypes, the same way. Returns the largest errors (matmul, FFN)."""
    import torch

    from conformer_tpu_torch.ops import int8_ffn as f8
    from conformer_tpu_torch.ops import int8_matmul as m8
    from conformer_tpu_torch.ops.quant import quantize_dense_params

    gen = torch.Generator().manual_seed(12)
    worst_mm = worst_ffn = 0.0
    for label, (d, h) in INT8_WIDTHS.items():
        ln, _, _, w1, w2 = int8_ffn_weights(dev, gen, d=d, h=h)
        mm_args = (w1["kernel_q"], w1["kernel_scale"])
        ffn_args = (ln, w1["kernel_q"], w1["kernel_scale"], w1["bias"], w2["kernel_q"],
                    w2["kernel_scale"], w2["bias"])
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            rtol, atol = INT8_TOL[name]
            for m in (374, 37):
                x = torch.randn(m, d, generator=gen)
                x[m // 2] = 0.0
                x = x.to(dev, dtype)
                poison(((m, h), dtype), ((m, d), dtype))
                y = m8.int8_matmul_dynamic(x, *mm_args)
                out = f8.int8_ffn_fused(x, *ffn_args)
                torch.cuda.synchronize()
                ref = m8.int8_matmul_dynamic_plain(x, *mm_args)
                differ = int((y != ref).sum()) + int(torch.isnan(y).sum())
                ref_f = f8.int8_ffn_plain(x, *ffn_args)
                diff = (out.float() - ref_f.float()).abs()
                ok_f = bool((diff <= atol + rtol * ref_f.float().abs()).all())
                e_mm = float((y.float() - ref.float()).abs().max())
                e_ffn = float(diff.max())
                print(f"kernels: int8 {label} {name} D={d} H={h} M={m}: int8_matmul {differ} "
                      f"of {y.numel()} elements differ from plain (want bit for bit); int8_ffn "
                      f"max abs err {e_ffn:.3g} (rtol {rtol}, atol {atol}); outputs poisoned "
                      "with NaN beforehand")
                check(differ == 0 and bool((y[m // 2] == 0).all()),
                      f"int8_matmul {label} {name} M={m} disagrees with its plain version")
                check(ok_f, f"int8_ffn {label} {name} M={m} disagrees with its plain version")
                worst_mm, worst_ffn = max(worst_mm, e_mm), max(worst_ffn, e_ffn)
    for label, (d, h) in INT8_FFN_WIDE.items():
        ln, _, _, w1, w2 = int8_ffn_weights(dev, gen, d=d, h=h)
        ffn_args = (ln, w1["kernel_q"], w1["kernel_scale"], w1["bias"], w2["kernel_q"],
                    w2["kernel_scale"], w2["bias"])
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            rtol, atol = INT8_TOL[name]
            for m in INT8_FFN_WIDE_ROWS:
                x = torch.randn(m, d, generator=gen)
                x[m // 2] = 0.0
                x = x.to(dev, dtype)
                poison(((m, d), dtype))
                out = f8.int8_ffn_fused(x, *ffn_args)
                torch.cuda.synchronize()
                ref = f8.int8_ffn_plain(x, *ffn_args)
                diff = (out.float() - ref.float()).abs()
                ok = bool((diff <= atol + rtol * ref.float().abs()).all())
                worst_ffn = max(worst_ffn, float(diff.max()))
                print(f"kernels: int8_ffn {label} {name} D={d} H={h} M={m} ({f8.route(d, h)} "
                      f"route): max abs err {float(diff.max()):.3g} (rtol {rtol}, atol {atol}); "
                      "outputs poisoned with NaN beforehand")
                check(ok, f"int8_ffn {label} {name} M={m} disagrees with its plain version")
    for kernel, shapes in INT8_EDGES.items():
        for d, h in shapes:
            ln, _, _, w1, w2 = int8_ffn_weights(dev, gen, d=d, h=h)
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).split(".")[-1]
                rtol, atol = INT8_TOL[name]
                for m in (374, 37):
                    x = torch.randn(m, d, generator=gen)
                    x[m // 2] = 0.0
                    x = x.to(dev, dtype)
                    if kernel == "int8_matmul":
                        poison(((m, h), dtype))
                        y = m8.int8_matmul_dynamic(x, w1["kernel_q"], w1["kernel_scale"])
                        torch.cuda.synchronize()
                        ref = m8.int8_matmul_dynamic_plain(x, w1["kernel_q"], w1["kernel_scale"])
                        err = float((y.float() - ref.float()).abs().max())
                        ok = bool(torch.equal(y, ref))
                        worst_mm = max(worst_mm, err)
                    else:
                        args = (ln, w1["kernel_q"], w1["kernel_scale"], w1["bias"],
                                w2["kernel_q"], w2["kernel_scale"], w2["bias"])
                        poison(((m, d), dtype))
                        out = f8.int8_ffn_fused(x, *args)
                        torch.cuda.synchronize()
                        ref = f8.int8_ffn_plain(x, *args)
                        diff = (out.float() - ref.float()).abs()
                        err = float(diff.max())
                        ok = bool((diff <= atol + rtol * ref.float().abs()).all())
                        worst_ffn = max(worst_ffn, err)
                    print(f"kernels: {kernel} edge {name} D={d} H={h} M={m}: max abs err {err:.3g}"
                          f" ({'bit for bit' if kernel == 'int8_matmul' else 'INT8_TOL'}); "
                          "outputs poisoned with NaN beforehand")
                    check(ok, f"{kernel} edge {name} D={d} H={h} M={m} disagrees with its plain "
                          "version")
    for label, width in INT8_BEYOND.items():
        for dtype in (torch.float32, torch.bfloat16):
            why = m8.width_error(width)
            x = torch.randn(5, width, generator=gen).to(dev, dtype)
            wq = quantize_dense_params({"kernel": torch.randn(width, 64, generator=gen).to(dev)})
            wrapper = m8.int8_matmul_dynamic
            call = lambda: wrapper(x, wq["kernel_q"], wq["kernel_scale"])  # noqa: E731
            before = wrapper.launches
            try:
                call()
                refused = False
            except ValueError:
                refused = True
            check(why is not None and refused and wrapper.launches == before,
                  f"{label} = {width} {dtype}: not refused before launch ({why})")
            print(f"kernels: {label} = {width} {str(dtype).split('.')[-1]}: ValueError before "
                  f"any launch ({why})")
    return worst_mm, worst_ffn


# ------------------------------------------------------ joint and fbank

JOINT_SHAPES = ((32, 374, 64, 5002), (4, 412, 200, 5002), (5, 37, 6, 37))   # (B, T', U, V)
JOINT_J = 512                # Conformer-M's join_dim
JOINT_T_CHUNK = 16           # t rows per product of the plain path and of the yardstick
# dW and dbias sum over every cell of the lattice. In float32, above this
# many cells (the big shapes: 3.3e5 and 7.8e5) kernel and plain version are
# compared against each tensor's max-abs (compare_sums): two float32 orders
# of ~1e5 terms part by ~1e-5 of a column's scale (on an H100: 3.7e-3 at
# 3.3e5 cells, where the elementwise rule allowed 2.2e-3), not of each
# element's value; the tiny shape keeps the elementwise rule. In bf16 the
# kernels round dl to bf16 as the tensor cores' operand (2^-9 relative, per
# term), which the plain version keeps in float32: every sum of the
# backward (d enc, d pred, dW, dbias) parts by that rounding's noise (on an
# H100, dW by 9.0e-2 at the tiny shape, where the elementwise 2e-2 rule
# failed), so bf16 backward outputs are compared against their max-abs at
# every shape.
JOINT_SUM_CELLS = 10000
# (name, enc dtype, pred dtype): float32; the model's bf16 (bf16 enc, float32
# pred: the predictor runs in float32); both bf16
JOINT_DTYPES = (("float32", "float32", "float32"), ("bfloat16", "bfloat16", "float32"),
                ("bfloat16 (pred bf16)", "bfloat16", "bfloat16"))


def joint_inputs(dev, dtype, pred_dtype, gen, b, t, u, v, j=JOINT_J):
    """Inputs of the joint kernels at one shape: enc [B,T,J] in ``dtype`` and
    pred [B,U+1,J] in ``pred_dtype``, float32 W [J,V] (0.1 N(0,1), logits of a few
    units) and bias, the padded labels [B,U+1] (blank past each row's
    u_len and at U) and float32 cotangents, zero outside each row's
    lattice as the DP's backward leaves them (``lattice_lengths``: edge rows
    t_len 1, u_len 0 and a bucket-padding row)."""
    import torch
    import torch.nn.functional as F

    t_len, u_len = lattice_lengths(gen, b, t, u)
    labels = torch.randint(1, v, (b, u), generator=gen)
    labels = torch.where(torch.arange(u)[None, :] < u_len[:, None].long(), labels, 0)
    live = ((torch.arange(t)[None, :, None] < t_len[:, None, None].long())
            & (torch.arange(u + 1)[None, None, :] <= u_len[:, None, None].long()))
    x = {
        "enc": torch.randn(b, t, j, generator=gen).to(dtype),
        "pred": torch.randn(b, u + 1, j, generator=gen).to(pred_dtype),
        "w": 0.1 * torch.randn(j, v, generator=gen),
        "b": 0.1 * torch.randn(v, generator=gen),
        "lab": F.pad(labels, (0, 1), value=0).to(torch.int32),
        "g_blank": torch.where(live, torch.randn(b, t, u + 1, generator=gen), 0.0),
        "g_emit": torch.where(live, torch.randn(b, t, u + 1, generator=gen), 0.0),
    }
    return {k: a.to(dev).contiguous() for k, a in x.items()}


def joint_grads_by_autograd(x):
    """d enc, d pred, dW, dbias of sum(g_b lp_blank + g_e lp_emit) by
    autograd through the port's plain joint (chunked over t, each chunk
    recomputed in the backward)."""
    import torch

    from conformer_tpu_torch.ops.rnnt import rnnt_lattice_log_probs_fused

    leaves = [x[k].detach().clone().requires_grad_() for k in ("enc", "pred", "w", "b")]
    lpb, lpe = rnnt_lattice_log_probs_fused(*leaves, x["lab"][:, :-1], 0, JOINT_T_CHUNK)
    loss = (x["g_blank"] * lpb + x["g_emit"] * lpe).sum()
    return torch.autograd.grad(loss, leaves)


def joint_yardstick(x, dtype):
    """The plain path's product alone: ``torch.matmul`` of [B JOINT_T_CHUNK
    (U+1), J] x [J, V] in ``dtype`` once per chunk of t (all T' at once
    would not fit), into a preallocated output."""
    import torch

    b, t, j = x["enc"].shape
    rows = b * JOINT_T_CHUNK * x["pred"].shape[1]
    xc = torch.randn(rows, j, device=x["enc"].device).to(dtype)
    wc = x["w"].to(dtype)
    out = torch.empty(rows, wc.shape[1], device=xc.device, dtype=dtype)
    n = -(-t // JOINT_T_CHUNK)

    def run():
        for _ in range(n):
            torch.matmul(xc, wc, out=out)
    return run


def joint_fwd_poison(dtype, b, t, u, v, j) -> None:
    """Poison (``poison``) the blocks of the forward's three outputs and, on
    its wide route, of its (max, sum) partials [2, V tiles, cells], so that
    a cell or a tile the kernels leave unwritten reads NaN."""
    import torch

    from conformer_tpu_torch.ops import joint_lattice as jl

    like = [((b, t, u + 1), torch.float32)] * 3
    if jl.route(dtype, j) == "wide":
        vp = -(-v // jl._FWD_V_TILE) * jl._FWD_V_TILE
        like.append(((2, jl.fwd_tiles(vp, dtype == torch.float32), b * t * (u + 1)),
                     torch.float32))
    poison(*like)


def joint_fwd_twice(args, label: str):
    """The forward on ``args`` with its outputs (and partials) poisoned,
    then again; fails unless the two agree bit for bit. Returns the first."""
    import torch

    from conformer_tpu_torch.ops import joint_lattice as jl

    b, t, _ = args[0].shape
    joint_fwd_poison(args[0].dtype, b, t, args[1].shape[1] - 1, args[2].shape[1],
                     args[0].shape[2])
    fwd = jl.joint_lattice_fwd(*args, 0)
    again = jl.joint_lattice_fwd(*args, 0)
    torch.cuda.synchronize()
    check(all(torch.equal(p, q) for p, q in zip(fwd, again)),
          f"joint_lattice_fwd {label}: not bitwise repeatable")
    return fwd


def check_joint_kernels(dev, shapes=JOINT_SHAPES) -> dict:
    """The three joint kernels against their plain versions in float32, in
    the model's bf16 (bf16 enc, float32 pred) and with both bf16
    (``JOINT_DTYPES``) at the training shape (B=32, T'=374, U=64, V=5002), at the
    fit's longest bucket with labels padded to 200 (B=4, T'=412, U+1=201)
    and at a tiny ragged one; in float32 also against autograd through the
    plain forward; the forward's outputs (and on its wide route, float32's,
    its partials) poisoned with NaN beforehand; forward and backward
    bitwise repeatable. Times of kernel, plain
    version and the bf16 product alone (a yardstick: no one PyTorch call
    computes the function) beside the bounds, at the training shape in both
    dtypes (bf16, the recipe's, in the entries' main keys). Returns the
    JSON entries without ``launches``."""
    import torch

    from conformer_tpu_torch.ops import joint_lattice as jl

    gen = torch.Generator().manual_seed(5)
    names = ("joint_lattice_fwd", "joint_lattice_bwd_xp", "joint_lattice_bwd_w")
    errs = dict.fromkeys(names, 0.0)
    times = {}
    for name, dt, pdt in JOINT_DTYPES:
        dtype = getattr(torch, dt)
        tol = TOL[dt]
        for b, t, u, v in shapes:
            x = joint_inputs(dev, dtype, getattr(torch, pdt), gen, b, t, u, v)
            args = (x["enc"], x["pred"], x["w"], x["b"], x["lab"])
            fwd = joint_fwd_twice(args, f"{name} B={b} T'={t} U={u}")
            e_f = compare(f"joint_lattice_fwd {name} B={b} T'={t} U={u}", fwd,
                          jl.joint_lattice_plain_fwd(*args, 0), tol)
            bargs = (*args, fwd[2], x["g_blank"], x["g_emit"], 0)
            xp, xp2 = (jl.joint_lattice_bwd_xp(*bargs) for _ in range(2))
            wg, wg2 = (jl.joint_lattice_bwd_w(*bargs) for _ in range(2))
            torch.cuda.synchronize()
            same = all(torch.equal(p, q) for p, q in zip((*xp, *wg), (*xp2, *wg2)))
            check(same, f"joint backward {name} B={b} T'={t} U={u}: not bitwise repeatable")
            m = b * t * (u + 1)
            bf16 = dtype == torch.bfloat16
            xcmp = compare_sums if bf16 else compare
            wcmp = compare if m <= JOINT_SUM_CELLS and not bf16 else compare_sums
            e_xp = xcmp(f"joint_lattice_bwd_xp {name} B={b} T'={t} U={u}", xp,
                        jl.joint_lattice_plain_bwd_xp(*bargs), tol)
            e_w = wcmp(f"joint_lattice_bwd_w {name} B={b} T'={t} U={u}", wg,
                       jl.joint_lattice_plain_bwd_w(*bargs), tol)
            auto = ""
            if dtype == torch.float32:
                ag = joint_grads_by_autograd(x)
                e_xp = max(e_xp, compare(f"joint_lattice_bwd_xp f32 B={b} vs autograd", xp,
                                         ag[:2], tol))
                e_w = max(e_w, wcmp(f"joint_lattice_bwd_w f32 B={b} vs autograd", wg,
                                    ag[2:], tol))
                auto = " (and against autograd through the plain forward)"
            for k, e in zip(names, (e_f, e_xp, e_w)):
                errs[k] = max(errs[k], e)
            rule = lambda c: "abs + rel" if c is compare else "of max-abs"   # noqa: E731
            print(f"kernels: joint {name} B={b} T'={t} U+1={u + 1} V={v}: max_abs_err fwd "
                  f"{e_f:.3g} (tol {tol} abs + rel; {jl.route(dtype, x['enc'].shape[2])} route, "
                  f"outputs poisoned, bitwise repeatable), bwd_xp {e_xp:.3g} (tol {tol} "
                  f"{rule(xcmp)}), bwd_w {e_w:.3g} (tol {tol} {rule(wcmp)}){auto}; backward "
                  f"bitwise repeatable {same}")
            if (b, t, u, v) != shapes[0] or name not in ("float32", "bfloat16"):
                continue
            # --- times and bounds at the training shape
            j = x["enc"].shape[2]
            product = 2.0 * m * j * v
            # float32 runs each product as 3xTF32 on the tensor cores: three
            # TF32 products at the TF32 rate
            rate = (BF16_TFLOPS if dtype == torch.bfloat16 else TF32_TFLOPS / 3) * 1e12
            exp_rate = EXP_PER_CLK_SM * H100_SMS * H100_CLOCK_HZ
            ops = lambda n: max(n * product / rate, m * v / exp_rate)   # noqa: E731
            lat = (fwd[2], x["g_blank"], x["g_emit"])
            iters = 5 if dtype == torch.bfloat16 else 2
            yard = time_ms(joint_yardstick(x, dtype), iters)
            for k, kern, plain, n_prod, outs, ins in (
                    ("joint_lattice_fwd", lambda: jl.joint_lattice_fwd(*args, 0),
                     lambda: jl.joint_lattice_plain_fwd(*args, 0), 1, fwd, ()),
                    ("joint_lattice_bwd_xp", lambda: jl.joint_lattice_bwd_xp(*bargs),
                     lambda: jl.joint_lattice_plain_bwd_xp(*bargs), 2, xp, lat),
                    ("joint_lattice_bwd_w", lambda: jl.joint_lattice_bwd_w(*bargs),
                     lambda: jl.joint_lattice_plain_bwd_w(*bargs), 2, wg, lat)):
                bnd, by = bound_ms(nbytes(*args, *ins, *outs), ops(n_prod))
                times[(k, name)] = {"ms": time_ms(kern, iters), "plain_ms": time_ms(plain, iters),
                                    "bound_ms": bnd, "bound_by": by, "yardstick_ms": yard}
            pair, _ = bound_ms(nbytes(*args, *lat, *xp, *wg), ops(3))
            print(f"kernels: joint {name} B={b} T'={t} U+1={u + 1} V={v} (M={m} cells, one "
                  f"product {product:.3g} flops): " + "; ".join(
                      f"{k} kernel {times[(k, name)]['ms']:.3f} ms, plain "
                      f"{times[(k, name)]['plain_ms']:.3f} ms, bound "
                      f"{times[(k, name)]['bound_ms']:.3f} ms ({times[(k, name)]['bound_by']})"
                      for k in names)
                  + f"; backward pair bound {pair:.3f} ms (three products); yardstick {name} "
                  f"torch.matmul of the product over {-(-t // JOINT_T_CHUNK)} chunks of "
                  f"{JOINT_T_CHUNK} t: {yard:.3f} ms")
    entries = {}
    for k, rep in zip(names, ("joint_kernel.py:260", "joint_kernel.py:329",
                              "joint_kernel.py:367")):
        bf, f32 = times[(k, "bfloat16")], times[(k, "float32")]
        entries[k] = {
            "name": k, "route": "cuda", "source": "conformer_tpu_torch/csrc/joint_lattice.cu",
            "replaces": f"conformer_tpu/ops/pallas/{rep}", "max_abs_err": errs[k],
            "ms": bf["ms"], "plain_ms": bf["plain_ms"], "bound_ms": bf["bound_ms"],
            "bound_by": bf["bound_by"],
            "library_ms": None,          # no one PyTorch call computes the function
            "yardsticks_ms": {"bf16 torch.matmul of the product, in t chunks": bf["yardstick_ms"]},
            "float32": {"ms": f32["ms"], "plain_ms": f32["plain_ms"],
                        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
                        "yardstick_ms": f32["yardstick_ms"]},
        }
    return entries


# Conformer-S's and -L's join_dim (configs/conformer_s.json, conformer_l.json)
# at a small shape (B, T', U, V): bf16 on the narrow kernels but the backward
# at L's 640, float32 on the wide route at every J (S's 320 padded to 384);
# J 1024, 896 (7 x 128: the dX product's 128-wide tiles in bf16) and a
# ragged J 700 (padded to 768) on the wide route in every dtype. No J is
# refused (JAX's kernel takes any J)
JOINT_WIDTHS = {"conformer_s": 320, "conformer_l": 640, "1024": 1024, "896": 896,
                "ragged 700": 700}
JOINT_WIDTH_SHAPE = (2, 200, 30, 5002)


def check_joint_widths(dev) -> dict:
    """The three joint kernels at each of JOINT_WIDTHS in every row of
    ``JOINT_DTYPES``, on the route ``route`` names, against their plain
    versions under ``check_joint_kernels``'s tolerance rules, every output
    (and the wide forward's partials) poisoned with NaN beforehand, forward
    and backward bitwise repeatable. Returns the largest error of each
    kernel."""
    import torch

    from conformer_tpu_torch.ops import joint_lattice as jl

    gen = torch.Generator().manual_seed(13)
    errs = dict.fromkeys(JOINT_GRIDS, 0.0)
    b, t, u, v = JOINT_WIDTH_SHAPE
    m = b * t * (u + 1)
    for label, j in JOINT_WIDTHS.items():
        jp = -(-j // jl.J_TILE) * jl.J_TILE
        vp = -(-v // 64) * 64     # bwd_w's padded V
        for name, dt, pdt in JOINT_DTYPES:
            dtype = getattr(torch, dt)
            tol = TOL[dt]
            x = joint_inputs(dev, dtype, getattr(torch, pdt), gen, b, t, u, v, j=j)
            args = (x["enc"], x["pred"], x["w"], x["b"], x["lab"])
            check(jl.width_error(dtype, j) is None, f"joint {label} {name}: J={j} refused")
            fwd = joint_fwd_twice(args, f"{name} {label} J={j}")
            e_f = compare(f"joint_lattice_fwd {name} {label} J={j}", fwd,
                          jl.joint_lattice_plain_fwd(*args, 0), tol)
            bargs = (*args, fwd[2], x["g_blank"], x["g_emit"], 0)
            poison(((m, jp), torch.float32), ((b, t, jp), torch.float32),
                   ((b, u + 1, jp), torch.float32))
            xp = jl.joint_lattice_bwd_xp(*bargs)
            poison(((jp, vp), torch.float32), ((vp,), torch.float32))
            wg = jl.joint_lattice_bwd_w(*bargs)
            same = all(torch.equal(p, q) for p, q in zip(
                (*xp, *wg), (*jl.joint_lattice_bwd_xp(*bargs), *jl.joint_lattice_bwd_w(*bargs))))
            torch.cuda.synchronize()
            check(same, f"joint {label} {name} J={j}: backward not bitwise repeatable")
            bf16 = dtype == torch.bfloat16
            xcmp = compare_sums if bf16 else compare
            wcmp = compare if m <= JOINT_SUM_CELLS and not bf16 else compare_sums
            e_xp = xcmp(f"joint_lattice_bwd_xp {name} {label} J={j}", xp,
                        jl.joint_lattice_plain_bwd_xp(*bargs), tol)
            e_w = wcmp(f"joint_lattice_bwd_w {name} {label} J={j}", wg,
                       jl.joint_lattice_plain_bwd_w(*bargs), tol)
            for k, e in zip(JOINT_GRIDS, (e_f, e_xp, e_w)):
                errs[k] = max(errs[k], e)
            rule = lambda c: "abs + rel" if c is compare else "of max-abs"   # noqa: E731
            print(f"kernels: joint {label} {name} B={b} T'={t} U+1={u + 1} V={v} J={j} (padded "
                  f"to {jp}, {jl.route(dtype, j)} forward, {jl.route(dtype, j, 'bwd')} backward "
                  f"kernels): max_abs_err fwd {e_f:.3g} (tol {tol} "
                  f"abs + rel), bwd_xp {e_xp:.3g} (tol {tol} {rule(xcmp)}), bwd_w {e_w:.3g} (tol "
                  f"{tol} {rule(wcmp)}); outputs (and the wide forward's partials) poisoned with "
                  "NaN beforehand; forward and backward bitwise repeatable")
    return errs


FBANK_BATCH, FBANK_SECONDS = 48, 15.0
FBANK_TOL = 1e-2             # abs and rel, kernel vs plain: float32 sums in other orders
FBANK_HOST_TOL = (1e-3, 0.15)   # (rtol, atol) vs the host fbank_numpy, the JAX test's own
FBANK_F64_RATIO = 2.0        # the kernel's max abs distance from float64 over the plain version's
# edge shapes: (label, sample_rate, mel bins, frame_length ms, B, N, waveforms):
# rows that start unaligned (N odd, N % 4 = 2), one frame (N = ws; 64
# waveforms of one launch each, so that the float64 criterion's maximum is
# taken over more than one frame: over single frames either version's
# maximum rests on one bin), padded 256 and 1024, 40 mel bins
FBANK_EDGES = (("N odd", 16000.0, 80, 25.0, 3, 32001, 1),
               ("B=1, N=ws (T=1)", 16000.0, 80, 25.0, 1, 400, 64),
               ("8 kHz (padded 256)", 8000.0, 80, 25.0, 2, 24002, 1),
               ("50 ms frames (padded 1024)", 16000.0, 80, 50.0, 2, 48000, 1),
               ("40 mel bins", 16000.0, 40, 25.0, 2, 48003, 1))


def fbank_float64(wave, dither: float, seed: int, sample_rate: float = 16000.0,
                  num_mel_bins: int = 80, frame_length: float = 25.0):
    """The fbank in float64 by torch.fft.rfft, from the float32 frames that
    the plain version dithers (the same hash) and the same float32
    constants (window, mel^T, 0.97): the truth that the kernel and the
    plain version are both held to."""
    import torch

    from conformer_tpu_torch.ops.fbank import frame_params, num_frames, povey_window
    from conformer_tpu_torch.ops.fbank_kernel import _EPS, dither_normal, mel_t32

    ws, shift, padded = frame_params(sample_rate, frame_length, 10.0)
    bsz, n = wave.shape
    t = num_frames(n, ws, shift)
    idx = (torch.arange(ws, device=wave.device)[None, :]
           + shift * torch.arange(t, device=wave.device)[:, None])
    frames = wave[:, idx]
    if dither != 0.0:
        frames = frames + dither * dither_normal(seed, bsz, t, ws, wave.device)
    x = frames.double()
    x = x - x.mean(dim=-1, keepdim=True)
    prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    win = torch.as_tensor(povey_window(ws).astype(np.float32), device=wave.device).double()
    y = (x - float(np.float32(0.97)) * prev) * win
    spec = torch.fft.rfft(y, n=padded)[..., : padded // 2]
    mel_t = torch.as_tensor(mel_t32(num_mel_bins, padded, sample_rate), device=wave.device)
    mel = (spec.real ** 2 + spec.imag ** 2) @ mel_t.double()
    return torch.log(torch.clamp_min(mel, _EPS))


def fbank_f64_distances(pairs) -> tuple[float, float]:
    """(kernel, plain) max abs distances from ``fbank_float64`` over
    ``pairs`` of (waveform, kwargs) at dither 0 and 1."""
    from conformer_tpu_torch.ops.fbank_kernel import fbank_kernel, fbank_plain

    d_k = d_p = 0.0
    for wave, kw in pairs:
        for dither in (0.0, 1.0):
            truth = fbank_float64(wave, dither, 7, **kw)
            got = fbank_kernel(wave, dither=dither, seed=7, **kw).double()
            plain = fbank_plain(wave, dither=dither, seed=7, **kw).double()
            d_k = max(d_k, float((got - truth).abs().max()))
            d_p = max(d_p, float((plain - truth).abs().max()))
    return d_k, d_p


def check_fbank_edges(dev) -> float:
    """``fbank_kernel`` at ``FBANK_EDGES``: against its plain version at
    dither 0 and 1, the host ``fbank_numpy`` at dither 0, and the float64
    criterion; outputs poisoned with NaN first (the wrapper allocates them:
    the cache is filled with NaN beforehand). Returns the largest error
    against the plain version."""
    import torch

    from conformer_tpu_torch.ops.fbank import fbank_numpy, frame_params, num_frames
    from conformer_tpu_torch.ops.fbank_kernel import fbank_kernel, fbank_plain

    err = 0.0
    rtol, atol = FBANK_HOST_TOL
    for label, sr, bins, fl, b, n, waves in FBANK_EDGES:
        kw = dict(sample_rate=sr, num_mel_bins=bins, frame_length=fl)
        ws, shift, _ = frame_params(sr, fl, 10.0)
        pairs = []
        e_label = 0.0
        for w in range(waves):
            seeds = [600 + 10 * w + i for i in range(b)]
            wavs = np.stack([synthetic_wav(s, n / sr + 0.1, int(sr))[:n] for s in seeds])
            wavs = (wavs * (1 << 15)).astype(np.float32)
            wave = torch.as_tensor(wavs, device=dev)
            pairs.append((wave, kw))
            for dither in (0.0, 1.0):
                poison(((b, num_frames(n, ws, shift), bins), torch.float32))
                got = fbank_kernel(wave, dither=dither, seed=7, **kw)
                torch.cuda.synchronize()
                e = compare(f"fbank {label} dither {dither}", (got,),
                            (fbank_plain(wave, dither=dither, seed=7, **kw),), FBANK_TOL)
                e_label = max(e_label, e)
                if dither == 0.0:
                    host = np.stack([fbank_numpy(x, **kw) for x in wavs])
                    clean = got.cpu().numpy()
                    check(clean.shape == host.shape and np.allclose(clean, host, rtol=rtol,
                                                                    atol=atol),
                          f"fbank {label} disagrees with the host fbank_numpy")
        err = max(err, e_label)
        d_k, d_p = fbank_f64_distances(pairs)
        print(f"kernels: fbank {label}: B={b} N={n} x {waves} waveform(s), {bins} mel bins, "
              f"shape {tuple(got.shape)}: max_abs_err vs plain {e_label:.3g} (tol {FBANK_TOL}); "
              f"host fbank_numpy within (rtol {rtol}, atol {atol}); from float64 kernel "
              f"{d_k:.3g}, plain {d_p:.3g} (limit {FBANK_F64_RATIO}x the plain version's)")
        check(d_k <= FBANK_F64_RATIO * d_p, f"fbank {label}: the kernel is {d_k:.3g} from float64, "
              f"over {FBANK_F64_RATIO}x the plain version's {d_p:.3g}")
    return err


# every window the kernel takes, one of each padded length 1 .. 1024 (an FFT
# template each), at 16 kHz: ws samples, 8 frames of an odd-length row
FBANK_WINDOWS = (1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513, 1024)


def check_fbank_windows(dev) -> float:
    """``fbank_kernel`` at every ``FBANK_WINDOWS`` against its plain version
    at dither 0 and 1, outputs poisoned with NaN first. Returns the largest
    error."""
    import torch

    from conformer_tpu_torch.ops.fbank import frame_params, num_frames
    from conformer_tpu_torch.ops.fbank_kernel import fbank_kernel, fbank_plain

    err = 0.0
    for ws in FBANK_WINDOWS:
        kw = dict(frame_length=ws / 16.0)
        _, shift, padded = frame_params(16000.0, ws / 16.0, 10.0)
        n = ws + 7 * shift + 3 - (ws + 7 * shift) % 2
        wavs = np.stack([synthetic_wav(700 + i, n / 16000 + 0.1)[:n] for i in range(2)])
        wave = torch.as_tensor((wavs * (1 << 15)).astype(np.float32), device=dev)
        for dither in (0.0, 1.0):
            poison(((2, num_frames(n, ws, shift), 80), torch.float32))
            got = fbank_kernel(wave, dither=dither, seed=7, **kw)
            torch.cuda.synchronize()
            err = max(err, compare(f"fbank ws={ws} dither {dither}", (got,),
                                   (fbank_plain(wave, dither=dither, seed=7, **kw),), FBANK_TOL))
    print(f"kernels: fbank windows of {FBANK_WINDOWS} samples (padded 1 .. 1024), B=2, 8 "
          f"frames, dither 0 and 1: max_abs_err vs plain {err:.3g} (tol {FBANK_TOL}); outputs "
          "poisoned with NaN beforehand")
    return err


def fbank_bound(frames: int, ws: int, nf: int, nmel: int, nnz: int, n_bytes: int) -> dict:
    """The fbank kernel's bound: the larger of the bytes (waveform in,
    features out) over the memory rate and the FFT design's float32
    operations over the card's float32 rate; beside it, labelled, the first
    design's DFT-product count. Operations a frame: the complex FFT of nf =
    padded / 2 points, 5 nf log2 nf; the split pass and the power, 12 nf;
    the DC removal, preemphasis and window, 5 ws; the mel sum, 2 nnz (its
    non-zero weights); the log, nmel."""
    fft_flops = frames * (5.0 * nf * math.log2(max(nf, 1)) + 12.0 * nf + 5.0 * ws
                          + 2.0 * nnz + nmel)
    product_flops = frames * (2.0 * ws * nf * 2 + 2.0 * nf * nmel)
    bnd, by = bound_ms(n_bytes, fft_flops / (F32_TFLOPS * 1e12))
    return {"bound_ms": bnd, "bound_by": by, "bound_counts": {
        "bytes": n_bytes, "bytes_ms": n_bytes / (HBM_TBPS * 1e12) * 1e3,
        "fft_flops": fft_flops, "fft_flops_ms": fft_flops / (F32_TFLOPS * 1e12) * 1e3,
        "first_design_dft_product_flops": product_flops,
        "first_design_dft_product_ms": product_flops / (F32_TFLOPS * 1e12) * 1e3}}


def check_fbank_kernel(dev) -> dict:
    """``fbank_kernel`` against its plain version at 48 x 15 s of seeded
    speech-like audio, with dither 0 and 1 (the same hash in both), against
    the host ``fbank_numpy`` (the serving path's features) at dither 0;
    the dither's statistics (two seeds differ, loud bins within 0.5 of the
    clean features, as tests/test_pallas_fbank.py holds the TPU kernel);
    both versions' max abs distance from a float64 fbank of the same
    dithered frames (the kernel's within ``FBANK_F64_RATIO`` of the plain
    version's); the edge shapes (``check_fbank_edges``) and every window
    length (``check_fbank_windows``); times by CUDA events and device times
    by torch.profiler, the bound and a labelled yardstick. Returns the JSON
    entry without ``launches``."""
    import torch

    from conformer_tpu_torch.ops.fbank import fbank_numpy, frame_params
    from conformer_tpu_torch.ops.fbank_kernel import (_kernel_tables, fbank_kernel,
                                                      fbank_plain)

    wavs = np.stack([synthetic_wav(400 + i, FBANK_SECONDS) for i in range(FBANK_BATCH)])
    wavs = (wavs * (1 << 15)).astype(np.float32)
    wave = torch.as_tensor(wavs, device=dev)
    err = 0.0
    outs = {}
    for dither in (0.0, 1.0):
        got = fbank_kernel(wave, dither=dither, seed=7)
        torch.cuda.synchronize()
        e = compare(f"fbank dither {dither}", (got,), (fbank_plain(wave, dither=dither, seed=7),),
                    FBANK_TOL)
        err = max(err, e)
        outs[dither] = got
        print(f"kernels: fbank B={FBANK_BATCH} x {FBANK_SECONDS} s, dither {dither}: max_abs_err "
              f"{e:.3g} vs plain (tol {FBANK_TOL} abs + rel)")
    clean = outs[0.0].cpu().numpy()
    host = np.stack([fbank_numpy(w) for w in wavs])
    rtol, atol = FBANK_HOST_TOL
    host_err = float(np.abs(clean - host).max())
    print(f"kernels: fbank dither 0 vs host fbank_numpy: max_abs_err {host_err:.3g} "
          f"(rtol {rtol}, atol {atol})")
    check(clean.shape == host.shape and np.allclose(clean, host, rtol=rtol, atol=atol),
          "fbank disagrees with the host fbank_numpy")
    other = fbank_kernel(wave, dither=1.0, seed=8).cpu().numpy()
    dith = outs[1.0].cpu().numpy()
    loud = clean > clean.mean()
    loud_err = float(np.abs(dith[loud] - clean[loud]).max())
    print(f"kernels: fbank dither 1: seeds 7 and 8 differ in {np.mean(dith != other):.2%} of "
          f"features; loud bins within {loud_err:.3g} of clean (limit 0.5)")
    check(not np.allclose(dith, other) and loud_err <= 0.5, "fbank dither statistics")
    d_k, d_p = fbank_f64_distances([(wave, {})])
    print(f"kernels: fbank B={FBANK_BATCH} x {FBANK_SECONDS} s, dither 0 and 1: max abs distance "
          f"from float64: kernel {d_k:.3g}, plain {d_p:.3g} (limit {FBANK_F64_RATIO}x the plain "
          "version's)")
    check(d_k <= FBANK_F64_RATIO * d_p, f"fbank: the kernel is {d_k:.3g} from float64, over "
          f"{FBANK_F64_RATIO}x the plain version's {d_p:.3g}")
    err = max(err, check_fbank_edges(dev), check_fbank_windows(dev))

    frames = clean.shape[0] * clean.shape[1]
    ws, shift, padded = frame_params(16000.0, 25.0, 10.0)
    nf, nmel = padded // 2, clean.shape[2]
    nnz = int(_kernel_tables(16000.0, nmel, 25.0, 10.0, str(wave.device))[2][:, 1].sum())
    bound = fbank_bound(frames, ws, nf, nmel, nnz, nbytes(wave, outs[0.0]))
    window = torch.nn.functional.pad(torch.hann_window(ws, periodic=False, device=dev) ** 0.85,
                                     (0, padded - ws))

    def stft_power():
        return torch.stft(wave, n_fft=padded, hop_length=shift, window=window, center=False,
                          return_complex=True).abs() ** 2

    kernel = lambda d: lambda: fbank_kernel(wave, dither=d, seed=7)   # noqa: E731
    entry = {
        "name": "fbank", "route": "cuda", "source": "conformer_tpu_torch/csrc/fbank.cu",
        "replaces": "conformer_tpu/ops/pallas/fbank_kernel.py:74", "max_abs_err": err,
        "ms": time_ms(kernel(0.0)), "device_ms": device_ms(kernel(0.0), "fbank_fft_kernel"),
        "dither_1_ms": time_ms(kernel(1.0)),
        "dither_1_device_ms": device_ms(kernel(1.0), "fbank_fft_kernel"),
        "plain_ms": time_ms(lambda: fbank_plain(wave)), **bound,
        "library_ms": None,              # no one PyTorch call computes the function
        "yardsticks_ms": {"torch.stft power spectrum (512-sample frames; no dither, DC "
                          "removal, preemphasis, mel or log)": time_ms(stft_power)},
        "f64_distance": {"kernel": d_k, "plain": d_p},
        "path": "no caller (as in the JAX package)",
    }
    dev_ms = lambda k: "not measured" if entry[k] is None else f"{entry[k]:.4f} ms"  # noqa: E731
    counts = bound["bound_counts"]
    print(f"kernels: fbank B={FBANK_BATCH} x {FBANK_SECONDS} s ({frames} frames): kernel "
          f"{entry['ms']:.4f} ms (device {dev_ms('device_ms')}), dither 1 "
          f"{entry['dither_1_ms']:.4f} ms (device {dev_ms('dither_1_device_ms')}), plain "
          f"{entry['plain_ms']:.4f} ms, yardsticks {entry['yardsticks_ms']} ms; bound "
          f"{bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']}: {counts['bytes']} bytes "
          f"{counts['bytes_ms'] * 1e3:.2f} us, FFT {counts['fft_flops']:.4g} flops "
          f"{counts['fft_flops_ms'] * 1e3:.2f} us; the first design's DFT products "
          f"{counts['first_design_dft_product_flops']:.4g} flops "
          f"{counts['first_design_dft_product_ms'] * 1e3:.2f} us)")
    return entry


@contextlib.contextmanager
def plain_int8():
    """Inside, the int8 layers take the plain versions of the int8 kernels
    on CUDA tensors too: the plain path of the parity phase."""
    from conformer_tpu_torch.ops import int8_ffn, int8_matmul, quant

    saved = quant.int8_matmul_dynamic, int8_ffn.int8_ffn_fused
    quant.int8_matmul_dynamic = int8_matmul.int8_matmul_dynamic_plain
    int8_ffn.int8_ffn_fused = int8_ffn.int8_ffn_plain
    try:
        yield
    finally:
        quant.int8_matmul_dynamic, int8_ffn.int8_ffn_fused = saved


# ------------------------------------------------------------------- serve


def synthetic_wav(seed: int, seconds: float, sr: int = 16000) -> np.ndarray:
    """Seeded speech-like audio (``conformer_tpu_torch.data.synthetic``)."""
    from conformer_tpu_torch.data.synthetic import synthetic_wav as make

    return make(seed, seconds, sr)


def wav_bytes(wav: np.ndarray, sr: int = 16000) -> bytes:
    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, sr, (wav * 32767).astype(np.int16))
    return buf.getvalue()


def post_wav(url: str, data: bytes) -> dict:
    boundary = "smokeboundary"
    body = (
        f"--{boundary}\r\nContent-Disposition: form-data; name=\"audio\"; "
        f"filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n"
    ).encode() + data + f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"},
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def recipe_config(path: str):
    """The config at ``path`` as it stands, but for the CMVN stats and the
    vocabulary, whose files are not in the repo."""
    from conformer_tpu_torch.config import Config

    cfg = Config.from_json_file(path)
    cfg.data.cmvn_path = ""
    cfg.data.vocab_path = ""
    return cfg


def serving_config(path: str):
    cfg = recipe_config(path)
    cfg.model.use_pallas_attention = True
    cfg.model.use_pallas_conv = True
    return cfg


def blank_biased(params: dict, blank_id: int, delta: float,
                 head: tuple[str, str] = ("joint", "ffn_out")) -> dict:
    """A copy of ``params`` with ``delta`` added to the output bias of
    ``head`` (the joint's, or ("ctc", "ctc_lo") the CTC head's) at
    ``blank_id``; every other tensor is shared."""
    group, name = head
    out = dict(params[group][name])
    out["bias"] = out["bias"].clone()
    out["bias"][blank_id] += delta
    return {**params, group: {**params[group], name: out}}


def make_runner(cfg, device):
    """The port's runner on random weights from cfg.train.seed, with +6 on
    the joint's blank bias as bench.py sets it. Returns the runner and the
    unbiased weights, which emit on most frames."""
    from conformer_tpu_torch.serve.runner import ModelRunner

    runner = ModelRunner(cfg, device=device)
    raw = runner.params
    runner.params = blank_biased(raw, cfg.model.blank_id, 6.0)
    return runner, raw


def serve_requests(runner, seconds=(4.0, 9.5, 15.0)) -> list[dict]:
    """Start the port's REST server on an ephemeral localhost port, POST one
    wav per entry of ``seconds``, and stop the server. Each result holds the
    response and each wrapper's launches during that request (the counts
    set to 0 just before it)."""
    from http.server import ThreadingHTTPServer

    from conformer_tpu_torch.serve.rest_server import make_handler

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(runner))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    results = []
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/recognize/"
        for i, secs in enumerate(seconds):
            reset_launch_counts()
            t0 = time.perf_counter()
            resp = post_wav(url, wav_bytes(synthetic_wav(100 + i, secs)))
            results.append({"seconds": secs, "latency_s": time.perf_counter() - t0,
                            "response": resp, "launches": launch_counts(),
                            "layout_builds": layout_builds()})
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    return results


C2_DIR = os.path.join(REPO, "build", "chip_smoke_c2")     # build/ is git-ignored


def check_c2(runner, raw_params, dev) -> dict:
    """Fault C2 on the card: a runner given an ``.npz`` whose CMVN
    statistics differ from those of ``data.cmvn_path``'s file keeps the
    ``.npz``'s and decodes as the same tree does (JAX restores the
    checkpoint over its init, file stats included)."""
    import torch

    from conformer_tpu_torch.serve.runner import ModelRunner
    from conformer_tpu_torch.train.checkpoint import save_params_npz

    dim = runner.cfg.model.input_dim
    rng = np.random.default_rng(16)
    own = {"mean": (0.1 * rng.standard_normal(dim)).astype(np.float32),
           "istd": rng.uniform(0.8, 1.2, dim).astype(np.float32)}
    tree = {**raw_params, "cmvn": {k: torch.as_tensor(v, device=dev) for k, v in own.items()}}
    shutil.rmtree(C2_DIR, ignore_errors=True)
    os.makedirs(C2_DIR)
    npz, stats = os.path.join(C2_DIR, "weights.npz"), os.path.join(C2_DIR, "global_cmvn")
    t0 = time.perf_counter()
    save_params_npz(npz, tree)
    with open(stats, "w") as f:
        json.dump({"mean_stat": [3.0] * dim, "var_stat": [20.0] * dim, "frame_num": 2}, f)
    cfg = dataclasses.replace(runner.cfg, data=dataclasses.replace(runner.cfg.data,
                                                                   cmvn_path=stats))
    served = ModelRunner(cfg, npz, dev)
    feats, lens = batch_feats(runner, (3.0, 7.5), seed=210)
    got = served.decode_batch(feats, lens)
    want = runner_variant(runner, tree, cfg.model).decode_batch(feats, lens)
    out = {"stats_equal": all(np.array_equal(served.params["cmvn"][k].cpu().numpy(), v)
                              for k, v in own.items()),
           "hyps_identical": hyp_lists(*got) == hyp_lists(*want),
           "tokens": [len(h) for h in hyp_lists(*got)], "s": time.perf_counter() - t0}
    shutil.rmtree(C2_DIR, ignore_errors=True)
    return out


# ------------------------------------------------------------------ parity


def batch_feats(runner, seconds, seed: int):
    feats = [runner.preprocess_waveform(synthetic_wav(seed + i, s), 16000)[0]
             for i, s in enumerate(seconds)]
    lens = np.array([len(f) for f in feats], np.int32)
    out = np.zeros((len(feats), lens.max(), feats[0].shape[1]), np.float32)
    for i, f in enumerate(feats):
        out[i, : len(f)] = f
    return out, lens


def decode(params, model_cfg, decode_cfg, feats, lens, device):
    import torch

    from conformer_tpu_torch.decode.greedy import greedy_search_batch
    from conformer_tpu_torch.models.transducer import encode

    with torch.inference_mode():
        f = torch.as_tensor(feats, device=device)
        fl = torch.as_tensor(lens, device=device)
        enc, enc_lens = encode(params, f, fl, model_cfg)
        hyps, hl, _ = greedy_search_batch(params, enc, enc_lens, model_cfg,
                                          n_steps=decode_cfg.n_steps,
                                          max_hyp_len=decode_cfg.max_hyp_len)
    return enc, hyps, hl


def hyp_lists(hyps, hl) -> list[list[int]]:
    return [h[: int(n)].tolist() for h, n in zip(hyps.cpu(), hl.cpu())]


def edit_distance(a: list[int], b: list[int]) -> int:
    row = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        prev, row[0] = row[0], i
        for j, y in enumerate(b, 1):
            prev, row[j] = row[j], min(row[j] + 1, row[j - 1] + 1, prev + (x != y))
    return row[-1]


def plain_cfg(model_cfg):
    return dataclasses.replace(model_cfg, use_pallas_attention=False, use_pallas_conv=False)


def parity_f32(runner, params, device, seconds=(3.0, 7.5, 15.0, 11.0), float_params=None) -> dict:
    """Kernel path vs plain path in float32 on ``params`` (float or int8:
    the plain path takes the plain int8 versions too). With
    ``float_params`` (the weights ``params`` quantize), also what the
    quantization itself moves: the plain encoder's outputs on the int8
    weights against those on the float ones."""
    import torch

    from conformer_tpu_torch.models.masks import subsampled_lengths
    from conformer_tpu_torch.models.transducer import encode

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg_k = dataclasses.replace(runner.cfg.model, compute_dtype="float32")
    feats, lens = batch_feats(runner, seconds, seed=200)
    enc_k, hyps_k, hl_k = decode(params, cfg_k, runner.cfg.decode, feats, lens, device)
    with plain_int8():
        enc_p, hyps_p, hl_p = decode(params, plain_cfg(cfg_k), runner.cfg.decode, feats, lens,
                                     device)
    enc_lens = subsampled_lengths(torch.as_tensor(lens, device=enc_k.device))
    valid = (torch.arange(enc_k.shape[1], device=enc_k.device)[None, :]
             < enc_lens[:, None])[..., None]
    diff = torch.where(valid, enc_k - enc_p, 0).abs()
    k, p = hyp_lists(hyps_k, hl_k), hyp_lists(hyps_p, hl_p)
    res = {"encoder_max_abs_err": float(diff.max()),
           "encoder_mean_abs_err": float(diff.sum() / (valid.sum() * diff.shape[-1])),
           "hyps_identical": k == p, "token_agreement": token_agreement(k, p),
           "hyp_lens": hl_k.tolist(), "finite": bool(torch.isfinite(enc_k).all())}
    if float_params is not None:
        with torch.inference_mode():
            enc_f, _ = encode(float_params, torch.as_tensor(feats, device=device),
                              torch.as_tensor(lens, device=device), plain_cfg(cfg_k))
        q = torch.where(valid, enc_p - enc_f, 0).abs()
        res["quant_max_abs_err"] = float(q.max())
        res["quant_mean_abs_err"] = float(q.sum() / (valid.sum() * q.shape[-1]))
    return res


def int8_expand_all_parity(runner, raw_params, device, seconds=(3.0, 7.5, 15.0, 11.0)) -> dict:
    """The encoder on ``quantize_tree(expand_only=False)`` of ``raw_params``
    (every dense of the encoder int8: the attention projections and both
    FFN matmuls through the int8 kernels, the subsampling's output dense,
    K = 19 D above the matmul kernel's K <= 1024, through ``int8_dense``'s
    XLA route), float32, kernel path against the plain path, and what the
    quantization itself moves (plain int8 against plain float). Counts
    ``int8_dense.xla_routes`` and the int8 kernels' launches of the kernel
    path's one call."""
    import torch

    from conformer_tpu_torch.models.masks import subsampled_lengths
    from conformer_tpu_torch.models.transducer import encode
    from conformer_tpu_torch.ops import quant
    from conformer_tpu_torch.serve.runner import INT8_SKIP_KEYS

    params = quant.quantize_tree(raw_params, skip_keys=INT8_SKIP_KEYS, expand_only=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg_k = dataclasses.replace(runner.cfg.model, compute_dtype="float32")
    feats, lens = batch_feats(runner, seconds, seed=200)
    f = torch.as_tensor(feats, device=device)
    fl = torch.as_tensor(lens, device=device)
    with torch.inference_mode():
        reset_launch_counts()
        routes = quant.int8_dense.xla_routes
        enc_k, _ = encode(params, f, fl, cfg_k)
        torch.cuda.synchronize()
        routes = quant.int8_dense.xla_routes - routes
        launches = launch_counts()
        with plain_int8():
            enc_p, _ = encode(params, f, fl, plain_cfg(cfg_k))
        enc_f, _ = encode(raw_params, f, fl, plain_cfg(cfg_k))
    enc_lens = subsampled_lengths(fl)
    valid = (torch.arange(enc_k.shape[1], device=enc_k.device)[None, :]
             < enc_lens[:, None])[..., None]
    n = valid.sum() * enc_k.shape[-1]
    diff = torch.where(valid, enc_k - enc_p, 0).abs()
    q = torch.where(valid, enc_p - enc_f, 0).abs()
    return {"encoder_max_abs_err": float(diff.max()), "encoder_mean_abs_err": float(diff.sum() / n),
            "quant_max_abs_err": float(q.max()), "quant_mean_abs_err": float(q.sum() / n),
            "finite": bool(torch.isfinite(enc_k).all()), "xla_routes": routes,
            "launches": {k: launches[k] for k in INT8_KERNELS}}


def token_agreement(a: list[list[int]], b: list[list[int]]) -> tuple[float, int, int]:
    """(1 - edit distance / tokens of ``b``, identical rows, tokens of ``b``)."""
    n_ref = sum(len(x) for x in b)
    errs = sum(edit_distance(x, y) for x, y in zip(a, b))
    return 1.0 - errs / max(n_ref, 1), sum(x == y for x, y in zip(a, b)), n_ref


def timed_decodes(params, cfg_k, dcfg, feats, lens, device, audio_s: float,
                  runs: int = 3) -> dict:
    """A warm-up, then ``runs`` timed decodes of the kernel path (the
    encoder timed apart) of ``audio_s`` seconds of audio; the launch
    counts are set to 0 just before the first timed decode and read just
    after it."""
    import torch

    from conformer_tpu_torch.models.transducer import encode

    decode(params, cfg_k, dcfg, feats, lens, device)       # warm-up
    builds = layout_builds()
    times, enc_times, launches = [], [], None
    for _ in range(runs):
        torch.cuda.synchronize()
        if launches is None:
            reset_launch_counts()
        t0 = time.perf_counter()
        _, hyps, hl = decode(params, cfg_k, dcfg, feats, lens, device)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if launches is None:
            launches = launch_counts()
        with torch.inference_mode():
            t0 = time.perf_counter()
            encode(params, torch.as_tensor(feats, device=device),
                   torch.as_tensor(lens, device=device), cfg_k)
            torch.cuda.synchronize()
            enc_times.append(time.perf_counter() - t0)
    return {"decode_s": times, "encode_s": enc_times, "hyps": hyp_lists(hyps, hl),
            "audio_s_per_s": audio_s / (sum(times) / runs),
            "launches": launches, "layout_builds": (builds, layout_builds())}


def decode_bf16_batch(runner, raw_params, device, feats, lens, audio_s) -> dict:
    """bf16 batched decode of the served weights, kernel path timed (the
    encoder apart from the whole); the plain path's hypotheses on the
    served and on the unbiased weights give the token agreement."""
    cfg_k, dcfg = runner.cfg.model, runner.cfg.decode
    res = timed_decodes(runner.params, cfg_k, dcfg, feats, lens, device, audio_s)
    _, hyps_p, hl_p = decode(runner.params, plain_cfg(cfg_k), dcfg, feats, lens, device)
    res["served"] = token_agreement(res["hyps"], hyp_lists(hyps_p, hl_p))
    _, hyps_rk, hl_rk = decode(raw_params, cfg_k, dcfg, feats, lens, device)
    _, hyps_rp, hl_rp = decode(raw_params, plain_cfg(cfg_k), dcfg, feats, lens, device)
    res["unbiased_hyps"] = hyp_lists(hyps_rk, hl_rk)
    res["unbiased"] = token_agreement(res["unbiased_hyps"], hyp_lists(hyps_rp, hl_rp))
    return res


def decode_int8_batch(runner, fused, fused_raw, float_unbiased_hyps, device, feats, lens,
                      audio_s) -> dict:
    """Route B: bf16 batched decode with both FFN matmuls int8 (the fused
    FFN kernel) on the served weights, timed as ``decode_bf16_batch``
    times the float path; the launches of the first timed batch; the token
    agreement of int8 against the float kernel path on the unbiased
    weights (a quality reading: int8 is lossy)."""
    cfg_k, dcfg = runner.cfg.model, runner.cfg.decode
    res = timed_decodes(fused, cfg_k, dcfg, feats, lens, device, audio_s)
    _, hyps, hl = decode(fused_raw, cfg_k, dcfg, feats, lens, device)
    res["unbiased_vs_float"] = token_agreement(hyp_lists(hyps, hl), float_unbiased_hyps)
    return res


# ------------------------------------------------------------------ stream

STREAM_CHUNK = 16                # decoding_chunk_size of configs/conformer_m.json
STREAM_CACHES = (64, 512)        # the runner's and scheduler's cache; streaming validation's
STREAM_ATTN_LENS = (0, 1, 37)    # a row's valid cache slots, beside a full cache
STREAM_PIECE_MS = 640            # clients.stream_client's chunk_ms
STREAM_SECONDS = 15.0
STREAM_F32_SECONDS = 5.0         # the f32 scheduler check's streams (joins, leaves, padded ends)
STREAM_SLOTS = 16
STREAM_SEED = 500
# the emitting runs' decode settings (sessions, scheduler, handlers): the
# served weights (+6 on the blank bias) emit no token, and the unbiased
# ones run into the config's per-frame cap of 64 emissions, which turns
# every tick into a loop of hundreds of greedy steps; at 2 a frame they
# emit on most frames of a 15 s stream and stay below 1024 tokens
STREAM_N_STEPS = 2
STREAM_MAX_HYP = 1024


def stream_attention_inputs(dev, dtype, gen, b, tq, cache, lens=None, h=4, dk=64, d=256):
    """Attention inputs at a streaming chunk shape: Tq = ``tq`` queries, Tk
    = cache + tq keys (the cache slots, then the chunk); row r's cache
    slots are valid only in its last ``lens[r]`` (default: 0, 1, 37 and a
    full cache in turn; 0 is a fresh session, whose every cache tile is
    masked from every row), by the encoder's own ``cache_valid_mask``."""
    import torch

    from conformer_tpu_torch.models.attention import AttnCache, cache_valid_mask

    tk = cache + tq
    attn_len = (torch.tensor([*STREAM_ATTN_LENS, cache])[torch.arange(b) % 4]
                if lens is None else torch.tensor(lens))
    q_u = torch.randn(b, h, tq, dk, generator=gen)
    k, v = (torch.randn(b, h, tk, dk, generator=gen) for _ in range(2))
    ab = 0.2 * torch.randn(b, h, tq, d, generator=gen)
    feats = torch.randn(tk, d, generator=gen)
    mask = cache_valid_mask(AttnCache(k=k[:, :, :cache], v=v[:, :, :cache], length=attn_len),
                            tq).contiguous()
    cast = [x.to(dev, dtype) for x in (q_u, ab, k, v, feats)]
    return (*cast, mask.to(dev))


def stream_chunk_shapes(runner) -> list[tuple[tuple[int, ...], int, int]]:
    """(batch sizes, Tq, cache) of every attention call the stream paths
    make: the scheduler's and streaming validation's full chunks (Tq =
    STREAM_CHUNK; B = 1 and STREAM_SLOTS; caches 64 and 512), and a live
    session's, where each piece is one chunk of its own fbank: a whole
    STREAM_PIECE_MS piece and the last, shorter piece of a STREAM_SECONDS
    stream, at the runner's session cache."""
    import torch

    from conformer_tpu_torch.models.masks import subsampled_lengths
    from conformer_tpu_torch.ops.fbank import frame_params, num_frames

    d = runner.cfg.data
    size, shift, _ = frame_params(d.resample_rate, d.frame_length, d.frame_shift)
    piece = d.resample_rate * STREAM_PIECE_MS // 1000
    last = int(STREAM_SECONDS * d.resample_rate) % piece or piece
    cache = runner.new_session().enc.attn_k.shape[3]
    tqs = [int(subsampled_lengths(torch.tensor(num_frames(n, size, shift)))) for n in (piece, last)]
    return ([((1, STREAM_SLOTS), STREAM_CHUNK, c) for c in STREAM_CACHES]
            + [((1,), tq, cache) for tq in tqs])


def check_stream_attention(runner, dev) -> dict:
    """(a) The attention forward at the chunk shapes (``stream_chunk_shapes``),
    through the wrapper the encoder calls: float32 and bfloat16, B = 1
    (each attn_len alone) and 16 (mixed), outputs poisoned with NaN first,
    against the plain version at TOL. In bf16 at each (B, Tq, cache):
    kernel ms by events and by the profiler, the plain version's ms, one
    SDPA call on the same scores given as a float mask, and the bound.
    Returns {"max_abs_err", "shapes", "times": [...]}."""
    import torch

    from conformer_tpu_torch.ops import rel_attention as ra

    gen = torch.Generator().manual_seed(7)
    scale = 1 / 8
    shapes = stream_chunk_shapes(runner)
    worst, times = 0.0, []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for bs, tq, cache in shapes:
            for b in bs:
                lens_sets = [[n] for n in (*STREAM_ATTN_LENS, cache)] if b == 1 else [None]
                for lens in lens_sets:
                    args = stream_attention_inputs(dev, dtype, gen, b, tq, cache, lens)
                    poison(((b, 4, tq, 64), dtype), ((b, 4, tq), torch.float32))
                    got = ra.rel_attention(*args, scale=scale)
                    torch.cuda.synchronize()
                    want = ra.rel_attention_plain(*args, scale=scale)
                    label = (f"rel_flash_attention {name} chunk B={b} Tq={tq} cache={cache} "
                             f"attn_len {lens or 'mixed'}")
                    worst = max(worst, compare(label, got, want, TOL[name]))
                if dtype != torch.bfloat16:
                    continue
                q_u, ab, k, v, feats, mask = args
                bias = (torch.matmul(ab.float(), feats.float().T) * scale).masked_fill(
                    ~mask[:, None], float("-inf")).to(dtype)
                ops = 2.0 * 4 * float(mask.sum()) * (64 + ab.shape[-1] + 64)
                bnd, by = bound_ms(nbytes(*args, *got), ops / (BF16_TFLOPS * 1e12))
                times.append({
                    "b": b, "tq": tq, "cache": cache, "tk": cache + tq,
                    "ms": time_ms(lambda: ra.rel_attention(*args, scale=scale)),
                    "device_ms": device_ms(lambda: ra.rel_attention(*args, scale=scale),
                                           "rel_flash_fwd"),
                    "plain_ms": time_ms(lambda: ra.rel_attention_plain(*args, scale=scale)),
                    "sdpa_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                        q_u, k, v, attn_mask=bias, scale=scale)),
                    "bound_ms": bnd, "bound_by": by})
        at = ", ".join(f"Tq={tq} Tk={c + tq} B={'/'.join(map(str, bs))}" for bs, tq, c in shapes)
        print(f"stream: rel_flash_attention {name} at {at} (B=1: attn_len 0, 1, 37, full; "
              f"B=16 mixed): within TOL {TOL[name]} abs + rel of the plain version, outputs "
              "poisoned with NaN beforehand")
    for t in times:
        print(f"stream: rel_flash_attention bf16 B={t['b']} Tq={t['tq']} Tk={t['tk']}: kernel "
              f"{t['ms']:.4f} ms (device {t['device_ms']}), plain {t['plain_ms']:.4f} ms, SDPA "
              f"{t['sdpa_ms']:.4f} ms, bound {t['bound_ms'] * 1e3:.3f} us ({t['bound_by']})")
    return {"max_abs_err": worst, "shapes": shapes, "times": times}


def runner_variant(runner, params, model_cfg, **decode):
    """A copy of ``runner`` serving ``params`` with ``model_cfg`` (and the
    decode settings in ``decode``); the weights are shared."""
    import copy

    r = copy.copy(runner)
    r.params = params
    r.cfg = dataclasses.replace(runner.cfg, model=model_cfg,
                                decode=dataclasses.replace(runner.cfg.decode, **decode))
    return r


def stream_parity_f32(runner, raw_params, dev) -> dict:
    """(b) streaming_greedy_search and the chunk-by-chunk encoder in f32,
    kernel path against plain path, on the unbiased weights (which emit),
    4 utterances of 3, 7.5, 15 and 11 s, left chunks -1 (cache 512) and 4
    (cache 64). Each path's launch counts are set to 0 just before it and
    read just after."""
    import torch

    from conformer_tpu_torch.decode.streaming import streaming_greedy_search
    from conformer_tpu_torch.models.encoder import encoder_forward_chunk_by_chunk
    from conformer_tpu_torch.models.masks import subsampled_lengths

    cfg_k = dataclasses.replace(runner.cfg.model, compute_dtype="float32")
    feats, lens = batch_feats(runner, (3.0, 7.5, 15.0, 11.0), seed=200)
    f, fl = torch.as_tensor(feats, device=dev), torch.as_tensor(lens, device=dev)
    enc_lens = subsampled_lengths(fl)
    out = {}
    for left in (-1, 4):
        paths = {}
        for name, mcfg in (("kernel", cfg_k), ("plain", plain_cfg(cfg_k))):
            with torch.inference_mode():
                reset_launch_counts()
                enc, _ = encoder_forward_chunk_by_chunk(
                    raw_params["encoder"], f, mcfg, decoding_chunk_size=STREAM_CHUNK,
                    num_decoding_left_chunks=left, cmvn=raw_params.get("cmvn"))
                hyps, hl = streaming_greedy_search(
                    raw_params, f, fl, mcfg, decoding_chunk_size=STREAM_CHUNK,
                    num_decoding_left_chunks=left, n_steps=runner.cfg.decode.n_steps,
                    max_hyp_len=runner.cfg.decode.max_hyp_len)
                torch.cuda.synchronize()
                paths[name] = (enc, hyp_lists(hyps, hl), launch_counts())
        (enc_k, hyp_k, n_k), (enc_p, hyp_p, n_p) = paths["kernel"], paths["plain"]
        valid = (torch.arange(enc_k.shape[1], device=dev)[None, :] < enc_lens[:, None])[..., None]
        diff = torch.where(valid, enc_k - enc_p, 0).abs()
        out[left] = {"cache": 512 if left < 0 else STREAM_CHUNK * left,
                     "encoder_max_abs_err": float(diff.max()),
                     "finite": bool(torch.isfinite(enc_k).all()),
                     "hyps_identical": hyp_k == hyp_p, "hyp_lens": [len(h) for h in hyp_k],
                     "launches_kernel": n_k, "launches_plain": n_p,
                     "chunks": (int(lens.max()) - 7) // (4 * STREAM_CHUNK) + 1}
    return out


def stream_pieces(seed: int, seconds: float = STREAM_SECONDS):
    """A synthetic wav as int16 PCM pieces of STREAM_PIECE_MS (what a
    client sends) and the same pieces as float32 in [-1, 1) (what the
    server decodes)."""
    wav = synthetic_wav(seed, seconds)
    pcm = (np.clip(wav, -1, 1) * 32767).astype(np.int16)
    n = 16000 * STREAM_PIECE_MS // 1000
    ints = [pcm[i:i + n] for i in range(0, len(pcm), n)]
    return ints, [p.astype(np.float32) / 32768.0 for p in ints]


def session_feed(runner, pieces) -> dict:
    """(c) One live session fed piece by piece through the runner:
    per-piece host latency (the transcript is on the host when
    accept_chunk returns) and the final tokens."""
    s = runner.new_session()
    lat = []
    for p in pieces:
        t0 = time.perf_counter()
        s, rec = runner.accept_chunk(s, p, 16000)
        lat.append(time.perf_counter() - t0)
    return {"tokens": rec.tokens, "latency_s": lat}


def drive_scheduler(sched, streams) -> dict:
    """(d) One thread a stream, each feeding its float pieces with ``feed``
    then ``flush_wait`` (as the pooled WebSocket handler does) and then
    closing. The streams start a piece apart: stream i opens once stream
    i - m has fed m pieces, m = min(i, pieces in a stream - 1), so with
    16 streams of 24 pieces stream i opens once stream 0 has fed i, and
    shorter streams still open while earlier ones run. Returns the final
    tokens, the wall seconds and the scheduler's counters."""
    progress = threading.Condition()
    fed = [0] * len(streams)
    lag = len(streams[0]) - 1
    finals, errors = [None] * len(streams), []

    def client(i):
        try:
            m = min(i, lag)
            with progress:
                check(progress.wait_for(lambda: fed[i - m] >= m, timeout=600),
                      f"stream {i} never started")
            slot = sched.open()
            for k, p in enumerate(streams[i]):
                sched.feed(slot, p, 16000)
                sched.flush_wait(slot, timeout=600)
                with progress:
                    fed[i] = k + 1
                    progress.notify_all()
            finals[i] = sched.close(slot, timeout=600)
        except Exception as e:  # noqa: BLE001 (collected, then fails the smoke)
            errors.append(f"stream {i}: {type(e).__name__}: {e}")
            with progress:
                fed[:] = [len(s) for s in streams]   # release the waiting streams
                progress.notify_all()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(streams))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads) and not errors,
          f"scheduler streams failed: {errors or 'a client thread did not finish'}")
    return {"finals": finals, "wall_s": wall, "stats": sched.stats(),
            "latencies": list(sched.chunk_latencies), "steps": list(sched.step_records)}


def b1_stream(runner, pieces, cache_size: int) -> list[int]:
    """A stream's B=1 decode: the featurizer's frames of the same pieces
    through streaming_greedy_search at B=1, whose chunks are the
    scheduler's (the padded final chunk included), at the scheduler's
    cache."""
    import torch

    from conformer_tpu_torch.decode.streaming import streaming_greedy_search
    from conformer_tpu_torch.serve.scheduler import StreamFeaturizer

    fz = StreamFeaturizer(runner.cfg.data)
    feats = np.concatenate([fz.feed(p) for p in pieces])
    d = runner.cfg.decode
    with torch.inference_mode():
        hyps, hl = streaming_greedy_search(
            runner.params, torch.as_tensor(feats[None], device=runner.device),
            torch.tensor([len(feats)], device=runner.device), runner.cfg.model,
            decoding_chunk_size=d.decoding_chunk_size,
            num_decoding_left_chunks=cache_size // d.decoding_chunk_size,
            n_steps=d.n_steps, max_hyp_len=d.max_hyp_len)
    return hyp_lists(hyps, hl)[0]


class StandInSocket:
    """A WebSocket stand-in for the handlers: an async iterator over the
    client's frames and a ``send`` that records the replies."""

    def __init__(self, frames):
        self.frames, self.sent = frames, []

    def __aiter__(self):
        return self._frames()

    async def _frames(self):
        for f in self.frames:
            yield f

    async def send(self, message):
        self.sent.append(message)


def run_handler(handler, runner, *extra, pcm_pieces) -> list:
    """(e) Drive a WebSocket handler in process, ``handler(runner, socket,
    *extra)``: the start signal, the int16 pieces, the end signal. Returns
    the replies."""
    import asyncio

    ws = StandInSocket([json.dumps({"signal": 1}), *(p.tobytes() for p in pcm_pieces),
                        json.dumps({"signal": 0})])
    asyncio.run(handler(runner, ws, *extra))
    return ws.sent


def check_handler_replies(label: str, replies: list, n_pieces: int, want: str) -> None:
    fails = [r for r in replies if isinstance(r, str) and r.startswith("{")]
    check(not fails, f"{label}: fail replies {fails[:3]}")
    check(replies[0] == "$start$" and len(replies) == n_pieces + 2
          and replies[-1] == "$final$" + want,
          f"{label}: replies {replies[:2]} ... {replies[-1][:80]!r} ({len(replies)}), want "
          f"$final${want[:80]!r}")


def pct(xs, q) -> float:
    """The q-th percentile of seconds ``xs``, in ms."""
    return float(np.percentile(np.asarray(xs) * 1e3, q))


def stream_phase(runner, raw_params, dev, layers: int) -> dict:
    """(a)-(e) of the stream phase. The f32 checks run on the unbiased
    weights ((c)-(e) at STREAM_N_STEPS emissions a frame: "emitting"),
    since the served ones (+6) emit no token; the bf16 readings run on the
    served weights as the serve phase serves them, and these main paths
    have their counts set to 0 just before and read just after. Each step
    prints its seconds."""
    import torch

    from conformer_tpu_torch.serve import websocket_server as ws_srv

    clock = [time.perf_counter()]

    def lap() -> float:
        now = time.perf_counter()
        dt, clock[0] = now - clock[0], now
        return dt

    res = {"attention": check_stream_attention(runner, dev)}
    print(f"stream: (a) in {lap():.1f} s")
    zero = dict.fromkeys(kernel_wrappers(), 0)

    par = stream_parity_f32(runner, raw_params, dev)
    for left, p in par.items():
        print(f"stream: f32 streaming_greedy_search, kernel path vs plain path, left chunks "
              f"{left} (cache {p['cache']}, Tk {p['cache'] + STREAM_CHUNK}), unbiased weights, "
              f"3 / 7.5 / 15 / 11 s: chunk-by-chunk encoder max_abs_err "
              f"{p['encoder_max_abs_err']:.3g} (tol 1e-3), hyps identical {p['hyps_identical']}, "
              f"hyp lens {p['hyp_lens']}; attention launches kernel path "
              f"{p['launches_kernel']['rel_flash_attention']} ({p['chunks']} chunks x {layers} "
              f"layers x 2 calls), plain path {p['launches_plain']['rel_flash_attention']}")
        check(p["finite"] and p["encoder_max_abs_err"] <= 1e-3 and p["hyps_identical"],
              f"f32 streaming kernel path disagrees with the plain path (left chunks {left})")
        check(max(p["hyp_lens"]) > 0, f"the f32 streaming decode emitted no token (left {left})")
        want = {**zero, "rel_flash_attention": 2 * p["chunks"] * layers}
        check(p["launches_kernel"] == want and p["launches_plain"] == zero,
              f"streaming launches {p['launches_kernel']} / {p['launches_plain']}, expected "
              f"{want} / none")
    res["parity"] = par
    print(f"stream: (b) in {lap():.1f} s")

    # (c) live sessions: 640 ms pieces of one 15 s wav
    ints, floats = stream_pieces(STREAM_SEED)
    emit = dict(n_steps=STREAM_N_STEPS, max_hyp_len=STREAM_MAX_HYP)
    m32 = dataclasses.replace(runner.cfg.model, compute_dtype="float32")
    r32k = runner_variant(runner, raw_params, m32, **emit)
    r32p = runner_variant(runner, raw_params, plain_cfg(m32), **emit)
    s_k, s_p = session_feed(r32k, floats), session_feed(r32p, floats)
    print(f"stream: f32 session, {len(floats)} pieces of {STREAM_PIECE_MS} ms, emitting "
          f"weights: kernel path {len(s_k['tokens'])} tokens, plain path {len(s_p['tokens'])}, "
          f"identical {s_k['tokens'] == s_p['tokens']}")
    check(s_k["tokens"] == s_p["tokens"] and len(s_k["tokens"]) > 0,
          "f32 session: the kernel and plain paths' transcripts differ (or are empty)")
    torch.cuda.synchronize()
    reset_launch_counts()
    sess = session_feed(runner, floats)
    torch.cuda.synchronize()
    sess["launches"] = launch_counts()
    print(f"stream: bf16 session, served weights: per-piece latency p50 "
          f"{pct(sess['latency_s'], 50):.2f} ms, p95 {pct(sess['latency_s'], 95):.2f} ms, max "
          f"{pct(sess['latency_s'], 100):.2f} ms (host clock, transcript on the host), "
          f"{len(sess['tokens'])} tokens; launches {sess['launches']} ({len(floats)} pieces)")
    want = {**zero, "rel_flash_attention": layers * len(floats)}
    check(sess["launches"] == want, f"session launches {sess['launches']}, expected {want}")
    res["session"] = sess
    print(f"stream: (c) in {lap():.1f} s")

    # (d) the scheduler: 16 streams, each starting a piece after the last,
    # of STREAM_F32_SECONDS in f32 (so that they join and leave the pool
    # while others run) and of STREAM_SECONDS in bf16; (e) the pooled
    # handler on the f32 scheduler, its stream 0's audio
    streams32 = [stream_pieces(STREAM_SEED + i, STREAM_F32_SECONDS) for i in range(STREAM_SLOTS)]
    s32 = r32k.make_scheduler(n_slots=STREAM_SLOTS)
    try:
        d32 = drive_scheduler(s32, [f for _, f in streams32])
        pooled = run_handler(ws_srv.handle_connection_pooled, r32k, s32,
                             pcm_pieces=streams32[0][0])
    finally:
        s32.shutdown()
    print(f"stream: (d) f32 scheduler in {lap():.1f} s")
    refs = [b1_stream(r32k, f, s32.cache_size) for _, f in streams32]
    same = [g == w for g, w in zip(d32["finals"], refs)]
    print(f"stream: f32 scheduler, {STREAM_SLOTS} slots, {STREAM_SLOTS} streams x "
          f"{STREAM_F32_SECONDS} s a piece apart, emitting weights: {sum(same)}/{len(same)} "
          f"final transcripts equal their B=1 streams', tokens "
          f"{[len(g) for g in d32['finals']]}; the B=1 streams in {lap():.1f} s")
    check(all(same) and min(len(g) for g in refs) > 0,
          f"f32 scheduler transcripts differ from their B=1 streams (streams "
          f"{[i for i, s in enumerate(same) if not s]})")
    streams = [stream_pieces(STREAM_SEED + i) for i in range(STREAM_SLOTS)]
    sched = runner.make_scheduler(n_slots=STREAM_SLOTS)
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        d = drive_scheduler(sched, [f for _, f in streams])
        torch.cuda.synchronize()
        d["launches"] = launch_counts()
    finally:
        sched.shutdown()
    active = sum(n for _, n in d["steps"]) / len(d["steps"])
    print(f"stream: bf16 scheduler, served weights: chunk latency p50 "
          f"{pct(d['latencies'], 50):.2f} ms, p99 {pct(d['latencies'], 99):.2f} ms over "
          f"{len(d['latencies'])} chunks; {len(d['steps'])} ticks, step host ms p50 "
          f"{pct([t for t, _ in d['steps']], 50):.2f}, mean {d['stats']['step_ms_mean']}; mean "
          f"active slots {active:.2f}; {STREAM_SLOTS * STREAM_SECONDS / d['wall_s']:.1f} audio-s "
          f"per wall s ({d['wall_s']:.2f} s wall); launches {d['launches']}")
    want = {**zero, "rel_flash_attention": layers * len(d["steps"])}
    check(d["launches"] == want, f"scheduler launches {d['launches']}, expected {want}")
    res["scheduler"] = d
    print(f"stream: (d) bf16 scheduler in {lap():.1f} s")

    # (e) the B=1 handler against the f32 session's transcript, the pooled
    # one against the f32 scheduler's (same audio, same weights)
    replies = run_handler(ws_srv.handle_connection, r32k, pcm_pieces=ints)
    check_handler_replies("handle_connection", replies, len(ints),
                          r32k._ids_to_text(s_k["tokens"]))
    check_handler_replies("handle_connection_pooled", pooled, len(streams32[0][0]),
                          r32k._ids_to_text(d32["finals"][0]))
    print(f"stream: WebSocket handlers in process (stand-in socket), f32, emitting weights: "
          f"$start$, {len(ints)} partials and $final$ from each, no fail reply; $final$ equals "
          f"the session's ({len(s_k['tokens'])} tokens) and the scheduler's "
          f"({len(d32['finals'][0])} tokens); (e) in {lap():.1f} s")
    return res


def streaming_validation(fit_cfg) -> dict:
    """(f) Trainer.validate(max_batches=1) with decode.streaming on the fit
    phase's dev set and its last checkpoint; the counts are set to 0 just
    before and read just after."""
    import torch

    from conformer_tpu_torch.data.dataset import AsrDataset, eval_config
    from conformer_tpu_torch.train.loop import Trainer

    cfg = dataclasses.replace(fit_cfg, decode=dataclasses.replace(fit_cfg.decode, streaming=True))
    trainer = Trainer(cfg, device="cuda")
    trainer.restore("last")
    dev_set = AsrDataset(eval_config(cfg.data), mode="dev", tokenizer=trainer.tokenizer)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    wer = trainer.validate(dev_set, max_batches=1)
    torch.cuda.synchronize()
    out = {"wer": wer, "s": time.perf_counter() - t0, "launches": launch_counts()}
    trainer.logger.close()
    return out


# ------------------------------------------------------------ decode modes

# the JAX bench's settings of each mode (bench.py:175-265): the beams at 8
# with 2 expansion rounds, hypotheses of up to 256 tokens, 16 labels a
# frame in the CTC prefix beam; rescoring with 3 decoder layers
# (attention_weight 0.1), ctc_weight 0.5 and hypotheses of up to 64
MODES = (("beam_rnnt", 0), ("beam_rnnt", 8), ("greedy_ctc", 0), ("prefix_beam_ctc", 0),
         ("attention_rescoring", 0))
MODE_BEAM, MODE_EXPANSIONS, MODE_MAX_HYP, MODE_TOP_C = 8, 2, 256, 16
RESCORE_LAYERS, RESCORE_ATTENTION_WEIGHT, RESCORE_CTC_WEIGHT, RESCORE_MAX_HYP = 3, 0.1, 0.5, 64
DECODER_SEED = 15
# the unbiased weights emit on most frames in the greedy search, but not in
# the beam: every hypothesis pays a blank a frame, an emission adds its own
# cost, and the flat random joint (best token ~ -7.6, blank ~ -8.6 nats)
# never repays it, so the beam's best row stays empty. The f32 beam check
# sharpens the joint's output kernel by this factor (best token ~ -0.4,
# blank ~ -35): the beam then emits ~13 tokens in 200 frames, as a CPU run
# of the full-width joint and predictor on random encoder rows shows
BEAM_SHARPEN = 32.0
EVAL_MODES = ("beam_rnnt", "greedy_ctc", "prefix_beam_ctc")


def mode_label(mode: str, skip: int) -> str:
    return f"{mode} (blank skip {skip})" if mode == "beam_rnnt" else mode


def with_decoder(params: dict, model_cfg, device) -> dict:
    """``params`` plus a random attention decoder of the bench's rescoring
    settings (L2R only, RESCORE_LAYERS layers), drawn from DECODER_SEED."""
    import torch

    from conformer_tpu_torch.models import decoder
    from conformer_tpu_torch.params import tree_map

    cfg = dataclasses.replace(model_cfg, decoder_num_layers=RESCORE_LAYERS,
                              attention_weight=RESCORE_ATTENTION_WEIGHT)
    dec = decoder.init_bi_decoder(torch.Generator().manual_seed(DECODER_SEED), cfg)
    return {**params, "decoder": tree_map(lambda t: t.to(device), dec)}


def sharpened(params: dict, factor: float) -> dict:
    """A copy of ``params`` with the joint's output kernel times ``factor``."""
    out = dict(params["joint"]["ffn_out"])
    out["kernel"] = out["kernel"] * factor
    return {**params, "joint": {**params["joint"], "ffn_out": out}}


def mode_search(params, model_cfg, decode_cfg, mode: str, skip: int, enc, enc_lens):
    """The mode's search on an encoder output as ``Trainer.validate`` runs
    it (``train.loop.decode_search``), at the bench's settings ->
    (tokens [B, K, L] or [B, L], lengths [B, K] or [B])."""
    from conformer_tpu_torch.train.loop import decode_search

    dcfg = dataclasses.replace(
        decode_cfg, mode=mode, beam_blank_skip_window=skip, beam_size=MODE_BEAM,
        beam_expansions=MODE_EXPANSIONS, prefix_beam_top_c=MODE_TOP_C,
        rescore_ctc_weight=RESCORE_CTC_WEIGHT,
        max_hyp_len=RESCORE_MAX_HYP if mode == "attention_rescoring" else MODE_MAX_HYP)
    return decode_search(params, enc, enc_lens, model_cfg, dcfg)


def beam_rows(toks, lens) -> list[list[list[int]]]:
    """Each utterance's rows (K of a beam, one otherwise) as token lists."""
    toks, lens = toks.cpu(), lens.cpu()
    if toks.ndim == 2:
        toks, lens = toks[:, None], lens[:, None]
    return [[t[k, : int(n[k])].tolist() for k in range(t.shape[0])] for t, n in zip(toks, lens)]


def decode_modes_parity(runner, raw_params, dev) -> list[dict]:
    """(a) Each mode in float32, kernel path against plain path, on the
    unbiased weights (the beam's with its joint sharpened by BEAM_SHARPEN;
    a random decoder for rescoring), 4 utterances of 3, 7.5, 15 and 11 s:
    the encoders within 1e-3 (parity_f32's limit), then each path's search
    on its own encoder output."""
    import torch

    from conformer_tpu_torch.models.masks import subsampled_lengths
    from conformer_tpu_torch.models.transducer import encode

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg_k = dataclasses.replace(runner.cfg.model, compute_dtype="float32")
    params = with_decoder(raw_params, cfg_k, dev)
    feats, lens = batch_feats(runner, (3.0, 7.5, 15.0, 11.0), seed=200)
    f, fl = torch.as_tensor(feats, device=dev), torch.as_tensor(lens, device=dev)
    out = []
    with torch.inference_mode():
        enc_k, el_k = encode(params, f, fl, cfg_k)
        enc_p, el_p = encode(params, f, fl, plain_cfg(cfg_k))
        valid = (torch.arange(enc_k.shape[1], device=dev)[None, :]
                 < subsampled_lengths(fl)[:, None])[..., None]
        enc_err = float(torch.where(valid, enc_k - enc_p, 0).abs().max())
        beam_params = sharpened(params, BEAM_SHARPEN)
        for mode, skip in MODES:
            t0 = time.perf_counter()
            pm = beam_params if mode == "beam_rnnt" else params
            dcfg = runner.cfg.decode
            rk = beam_rows(*mode_search(pm, cfg_k, dcfg, mode, skip, enc_k, el_k))
            rp = beam_rows(*mode_search(pm, plain_cfg(cfg_k), dcfg, mode, skip, enc_p, el_p))
            pairs = [(a, b) for xs, ys in zip(rk, rp) for a, b in zip(xs, ys)]
            out.append({"mode": mode, "skip": skip, "encoder_max_abs_err": enc_err,
                        "finite": bool(torch.isfinite(enc_k).all()),
                        "top_identical": [r[0] for r in rk] == [r[0] for r in rp],
                        "rows_agree": sum(a == b for a, b in pairs) / len(pairs),
                        "rows": len(pairs), "top_lens": [len(r[0]) for r in rk],
                        "s": time.perf_counter() - t0})
    return out


def decode_modes_bf16(runner, dev, feats, lens, audio_s: float, runs: int = 3) -> list[dict]:
    """(b) Each mode in bfloat16 on the bench's weights (+6 on the joint's
    blank bias; for the CTC modes and rescoring also on the CTC head's),
    B x 15 s: a warm-up, then ``runs`` timed decodes (encoder and search,
    the host clock after synchronize); the launch counts and the beam's
    host syncs are set to 0 just before the first timed decode and read
    just after it."""
    import torch

    from conformer_tpu_torch.decode.beam_batched import beam_search_batch
    from conformer_tpu_torch.models.transducer import encode

    cfg_k = runner.cfg.model
    ctc_params = with_decoder(blank_biased(runner.params, cfg_k.blank_id, 6.0, ("ctc", "ctc_lo")),
                              cfg_k, dev)
    f, fl = torch.as_tensor(feats, device=dev), torch.as_tensor(lens, device=dev)
    out = []
    for mode, skip in MODES:
        params = runner.params if mode == "beam_rnnt" else ctc_params

        def run():
            with torch.inference_mode():
                enc, el = encode(params, f, fl, cfg_k)
                return mode_search(params, cfg_k, runner.cfg.decode, mode, skip, enc, el)

        run()                                                # warm-up
        times, launches, syncs = [], None, None
        for r in range(runs):
            torch.cuda.synchronize()
            if r == 0:
                reset_launch_counts()
                beam_search_batch.host_syncs = 0
            t0 = time.perf_counter()
            toks, tl = run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if r == 0:
                launches, syncs = launch_counts(), beam_search_batch.host_syncs
        ms = sorted(times)[len(times) // 2] * 1e3
        top = tl[:, 0] if tl.ndim == 2 else tl
        out.append({"mode": mode, "skip": skip, "ms": ms, "times_s": times,
                    "audio_s_per_s": audio_s / (ms / 1e3), "tokens": int(top.sum()),
                    "launches": launches, "host_syncs": syncs})
    return out


def eval_modes(fit: dict) -> dict:
    """(c) ``conformer_tpu_torch.main --eval --resume`` on the fit corpus and
    its last checkpoint with each of EVAL_MODES (the counts set to 0 just
    before each and read just after), then attention_rescoring, which
    must raise ValueError: the fit checkpoint has no decoder."""
    import torch

    from conformer_tpu_torch.main import main as port_main

    args = ["--eval", "--resume", "--resume_from", "last", *fit["eval_args"]]
    res = {}
    for mode in EVAL_MODES:
        out = io.StringIO()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            port_main([*args, f"decode.mode={mode}"])
        torch.cuda.synchronize()
        res[mode] = {"s": time.perf_counter() - t0, "launches": launch_counts(),
                     "wer": [float(line.split()[-1]) for line in out.getvalue().splitlines()
                             if line.startswith("WER:")]}
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            port_main([*args, "decode.mode=attention_rescoring"])
        res["attention_rescoring"] = "no error"
    except ValueError as e:
        res["attention_rescoring"] = f"ValueError: {e}"
    except Exception as e:                                 # any other outcome fails
        res["attention_rescoring"] = f"{type(e).__name__}: {e}"
    return res


def check_decode_modes(par: list[dict], bf: list[dict], layers: int, card: str,
                       batch: int, seconds: float) -> None:
    per_batch = {**dict.fromkeys(kernel_wrappers(), 0), "rel_flash_attention": layers,
                 "conv_block": layers}
    for r in par:
        label = mode_label(r["mode"], r["skip"])
        weights = (f"unbiased weights, joint x{BEAM_SHARPEN:g}" if r["mode"] == "beam_rnnt"
                   else "unbiased weights")
        print(f"decode modes: (a) {label}, f32 kernel path vs plain path, {weights}, 4 "
              f"utterances: encoder max_abs_err {r['encoder_max_abs_err']:.3g} (tol 1e-3); top "
              f"hypotheses identical {r['top_identical']}, {r['rows_agree']:.2%} of {r['rows']} "
              f"rows identical, top lengths {r['top_lens']} ({r['s']:.1f} s)")
        check(r["finite"] and r["encoder_max_abs_err"] <= 1e-3,
              f"decode modes: {label}: the f32 encoders disagree")
        check(r["top_identical"], f"decode modes: {label}: f32 top hypotheses differ")
        check(max(r["top_lens"]) > 0, f"decode modes: {label}: no token emitted")
    for r in bf:
        label = mode_label(r["mode"], r["skip"])
        syncs = (f", host syncs {r['host_syncs']} a batch" if r["mode"] == "beam_rnnt" else "")
        print(f"decode modes: (b) {label}, bf16, B={batch} x {seconds} s, bench weights: "
              f"{r['ms']:.1f} ms a batch (median of {len(r['times_s'])}: "
              f"{[round(t * 1e3, 1) for t in r['times_s']]}), {r['audio_s_per_s']:.1f} audio-s/s, "
              f"{r['tokens']} tokens, launches {r['launches']}{syncs} [{card}]")
        check(r["launches"] == per_batch, f"decode modes: {label}: launches {r['launches']} in a "
              f"batch, expected {per_batch}")
        check(r["mode"] != "beam_rnnt" or (r["skip"] > 0) == (r["host_syncs"] > 0),
              f"decode modes: {label}: {r['host_syncs']} host syncs")


def check_eval_modes(ev: dict, fit: dict) -> None:
    from conformer_tpu_torch.data.dataset import eval_config

    cfg = fit["cfg"]
    layers = cfg.model.encoder_num_layers
    n_batches = -(-FIT_DEV // eval_config(cfg.data).batch_size)
    want = {**dict.fromkeys(kernel_wrappers(), 0), "rel_flash_attention": layers * n_batches,
            "conv_block": layers * n_batches}
    for mode in EVAL_MODES:
        r = ev[mode]
        print(f"decode modes: (c) --eval --set decode.mode={mode} on the fit checkpoint: WER "
              f"{r['wer']} in {r['s']:.1f} s, {n_batches} batches, launches {r['launches']}")
        check(len(r["wer"]) == 1 and np.isfinite(r["wer"][0]),
              f"--eval decode.mode={mode} printed {r['wer']}")
        check(r["launches"] == want,
              f"--eval decode.mode={mode}: launches {r['launches']}, expected {want}")
    msg = ev["attention_rescoring"]
    print(f"decode modes: (c) --eval --set decode.mode=attention_rescoring on the fit checkpoint "
          f"(no decoder): {msg}")
    check(msg == "ValueError: attention_rescoring needs an attention decoder head",
          f"--eval decode.mode=attention_rescoring without a decoder: {msg}")


# ------------------------------------------------- reference-parity modes

# the encoder modes of reference-checkpoint parity (5d): label -> model
# overrides. The BatchNorm conv never takes the conv kernel; no mode takes
# the attention kernel (the ref modes' plain products; absolute positions
# have no position term)
REF_MODES = {"ref_batch+batch_norm": dict(rel_mode="ref_batch", conv_norm="batch_norm"),
             "ref_abs+batch_norm": dict(rel_mode="ref_abs", conv_norm="batch_norm"),
             "ref_abs+layer_norm": dict(rel_mode="ref_abs"),
             "absolute+layer_norm": dict(use_relative=False)}
REF_SEED = 16


def ref_mode_params(model_cfg, seed: int, dev) -> dict:
    """Random weights of ``model_cfg`` from ``seed``, with BatchNorm running
    statistics off the identity (mean ~ N(0, 0.1), var in [0.5, 2])."""
    import torch

    from conformer_tpu_torch.models.transducer import init_transducer

    params = init_transducer(model_cfg, seed, dev)
    norm = params["encoder"]["layers"]["conv_module"]["norm"]
    if "mean" in norm:
        g = torch.Generator().manual_seed(seed)
        norm["mean"] = (0.1 * torch.randn(norm["mean"].shape, generator=g)).to(dev)
        norm["var"] = (0.5 + 1.5 * torch.rand(norm["var"].shape, generator=g)).to(dev)
    return params


def ref_modes_phase(runner, dev, layers: int) -> dict:
    """5d: Conformer-M at full width, both encoder kernel flags on, in each
    of REF_MODES: the f32 kernel path against the plain path on 4
    utterances (parity_f32; the counts set to 0 just before, read just
    after: attention 0, conv ``layers`` with the LayerNorm conv, 0 with
    BatchNorm); then one live f32 session of STREAM_F32_SECONDS under
    ref_abs, kernel path against plain path (no launch)."""
    import torch

    zero = dict.fromkeys(kernel_wrappers(), 0)
    out = {}
    for label, over in REF_MODES.items():
        t0 = time.perf_counter()
        mcfg = dataclasses.replace(runner.cfg.model, **over)
        params = ref_mode_params(mcfg, REF_SEED, dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        par = parity_f32(runner_variant(runner, params, mcfg), params, dev)
        torch.cuda.synchronize()
        par["launches"] = launch_counts()
        bn = mcfg.conv_norm == "batch_norm"
        par["want_launches"] = {**zero, "conv_block": 0 if bn else layers}
        par["s"] = time.perf_counter() - t0
        out[label] = par
        del params
    t0 = time.perf_counter()
    mcfg = dataclasses.replace(runner.cfg.model, compute_dtype="float32", **REF_MODES[
        "ref_abs+layer_norm"])
    params = ref_mode_params(mcfg, REF_SEED, dev)
    _, floats = stream_pieces(STREAM_SEED, STREAM_F32_SECONDS)
    emit = dict(n_steps=STREAM_N_STEPS, max_hyp_len=STREAM_MAX_HYP)
    torch.cuda.synchronize()
    reset_launch_counts()
    s_k = session_feed(runner_variant(runner, params, mcfg, **emit), floats)
    torch.cuda.synchronize()
    launches = launch_counts()
    s_p = session_feed(runner_variant(runner, params, plain_cfg(mcfg), **emit), floats)
    out["session"] = {"kernel": s_k["tokens"], "plain": s_p["tokens"], "pieces": len(floats),
                      "launches": launches, "want_launches": zero,
                      "s": time.perf_counter() - t0}
    return out


def nonzero(launches: dict) -> dict | str:
    return {k: n for k, n in launches.items() if n} or "none"


def check_ref_modes(res: dict, card: str) -> None:
    for label in REF_MODES:
        par = res[label]
        agree, _, n_ref = par["token_agreement"]
        print(f"ref modes: {label}, f32 kernel path vs plain path, 3 / 7.5 / 15 / 11 s: encoder "
              f"max_abs_err {par['encoder_max_abs_err']:.3g} (tol 1e-3), hyps identical "
              f"{par['hyps_identical']} over {n_ref} tokens, hyp lens {par['hyp_lens']}; "
              f"launches {nonzero(par['launches'])}; {par['s']:.1f} s ({card})")
        check(par["finite"] and par["encoder_max_abs_err"] <= 1e-3 and par["hyps_identical"],
              f"{label}: the f32 kernel path disagrees with the plain path")
        check(max(par["hyp_lens"]) > 0, f"{label}: no token emitted")
        check(par["launches"] == par["want_launches"],
              f"{label}: launches {par['launches']}, expected {par['want_launches']}")
    ses = res["session"]
    print(f"ref modes: ref_abs f32 session, {ses['pieces']} pieces of {STREAM_PIECE_MS} ms: "
          f"kernel path {len(ses['kernel'])} tokens, plain path {len(ses['plain'])}, identical "
          f"{ses['kernel'] == ses['plain']}; kernel path launches {nonzero(ses['launches'])}; "
          f"{ses['s']:.1f} s ({card})")
    check(ses["kernel"] == ses["plain"] and len(ses["kernel"]) > 0,
          "ref_abs session: the kernel and plain paths' transcripts differ (or are empty)")
    check(ses["launches"] == ses["want_launches"],
          f"ref_abs session launches {ses['launches']}, expected none")


# ------------------------------------------------------------------- train

# limits of the f32 training parity's band check. The two paths' occupancies
# differ by float32 rounding (|logZ| in the thousands), so argmax near-ties
# may flip and move a few band starts; a wrong occupancy moves them by far
# more. Readings behind each limit: PERF.md, section 6.
BAND_LIMITS = {"s_begin_diff_share": 0.02, "occupancy_max_abs_err": 2e-3, "flip_max_gap": 5e-4}

# kernel launches per microbatch of the recipe's step (pruned loss): the
# simple lattice once (its forward two kernels, the V-split products and
# their merge; its backward four: row maxima, W, products, guard); the lattice DP
# twice (the occupancies and the simple NLL), each with its backward; the
# CTC DP once; with the attention flag on, the attention kernels once per
# encoder layer (forward, dq, dkv). The conv kernel runs only in
# deterministic forwards (validation), one launch per layer and batch.
PER_MICROBATCH = {"simple_lattice_fwd": 2, "simple_lattice_bwd": 4, "rnnt_lattice_fwd": 2,
                  "rnnt_lattice_bwd": 2, "ctc_dp_fwd": 1, "ctc_dp_bwd": 1}
# the full-lattice loss (use_pruned_loss false): the lattice DP once, the
# CTC DP once and, with use_pallas_joint, the joint kernels once (their
# backwards in 2 and 3 grids: csrc/joint_lattice.cu); no simple lattice
PER_MICROBATCH_FULL = {"simple_lattice_fwd": 0, "simple_lattice_bwd": 0, "rnnt_lattice_fwd": 1,
                       "rnnt_lattice_bwd": 1, "ctc_dp_fwd": 1, "ctc_dp_bwd": 1}
JOINT_GRIDS = {"joint_lattice_fwd": 1, "joint_lattice_bwd_xp": 2, "joint_lattice_bwd_w": 3}
ATTENTION_KERNELS = ("rel_flash_attention", "rel_flash_attention_bwd_dq",
                     "rel_flash_attention_bwd_dkv")
INT8_KERNELS = ("int8_matmul", "int8_ffn")     # serving only: never launched in training
FBANK_KERNELS = ("fbank",)                     # no caller, as in the JAX package


def per_microbatch(layers: int, attention: bool, pruned: bool = True,
                   joint: bool = False, remat: bool = False) -> dict:
    """Launches per microbatch with the pruned loss or the full lattice (its
    joint through the kernels with ``joint``); none depends on the labels.
    With ``remat`` the backward reruns each layer's attention forward."""
    loss = PER_MICROBATCH if pruned else PER_MICROBATCH_FULL
    n = layers if attention else 0
    return {"rel_flash_attention": 2 * n if remat else n, "rel_flash_attention_bwd_dq": n,
            "rel_flash_attention_bwd_dkv": n, "conv_block": 0,
            **loss, **dict.fromkeys(INT8_KERNELS, 0),
            **{k: n if joint and not pruned else 0 for k, n in JOINT_GRIDS.items()},
            **dict.fromkeys(FBANK_KERNELS, 0)}


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by the name in the kernels line."""
    from conformer_tpu_torch.ops import ctc_dp, joint_lattice, rnnt_lattice, simple_lattice
    from conformer_tpu_torch.ops import rel_attention as ra
    from conformer_tpu_torch.ops.conv_block import conv_block
    from conformer_tpu_torch.ops.fbank_kernel import fbank_kernel
    from conformer_tpu_torch.ops.int8_ffn import int8_ffn_fused
    from conformer_tpu_torch.ops.int8_matmul import int8_matmul_dynamic

    return {"rel_flash_attention": ra.rel_attention,
            "rel_flash_attention_bwd_dq": ra.rel_attention_bwd_dq,
            "rel_flash_attention_bwd_dkv": ra.rel_attention_bwd_dkv,
            "conv_block": conv_block,
            "simple_lattice_fwd": simple_lattice.simple_lattice_fwd,
            "simple_lattice_bwd": simple_lattice.simple_lattice_bwd,
            "rnnt_lattice_fwd": rnnt_lattice.rnnt_lattice_fwd,
            "rnnt_lattice_bwd": rnnt_lattice.rnnt_lattice_bwd,
            "ctc_dp_fwd": ctc_dp.ctc_dp_fwd, "ctc_dp_bwd": ctc_dp.ctc_dp_bwd,
            "int8_matmul": int8_matmul_dynamic, "int8_ffn": int8_ffn_fused,
            "joint_lattice_fwd": joint_lattice.joint_lattice_fwd,
            "joint_lattice_bwd_xp": joint_lattice.joint_lattice_bwd_xp,
            "joint_lattice_bwd_w": joint_lattice.joint_lattice_bwd_w,
            "fbank": fbank_kernel}


def launch_counts() -> dict:
    return {k: w.launches for k, w in kernel_wrappers().items()}


def layout_builds() -> int:
    """The int8 weights' kernel layouts made so far (ops/int8_matmul.py)."""
    from conformer_tpu_torch.ops.int8_matmul import kernel_layout

    return kernel_layout.builds


def reset_launch_counts() -> None:
    for w in kernel_wrappers().values():
        w.launches = 0


def random_batch(cfg, seed: int, batch: int, seconds: float, labels: int = 64,
                 feat_frames=None) -> dict:
    """Seeded random-normal features [B, 100*seconds, F] (lengths
    ``feat_frames`` or full) and labels in [1, V-2] of length ``labels``."""
    rng = np.random.default_rng(seed)
    frames = int(seconds * 100)          # 10 ms frame shift
    lens = np.full(batch, frames, np.int32) if feat_frames is None else np.asarray(
        feat_frames, np.int32)
    return {
        "feats": rng.standard_normal((batch, frames, cfg.model.input_dim), np.float32),
        "feat_lengths": lens,
        "labels": rng.integers(1, cfg.model.vocab_size - 1, (batch, labels)).astype(np.int32),
        "label_lengths": np.full(batch, labels, np.int32),
    }


def train_steps(trainer, steps: int = 3, batch: int = 32, seconds: float = 15.0) -> dict:
    """One warm-up and ``steps`` timed optimizer steps of ``accum_grad``
    microbatches each; the launch counts cover the timed steps only."""
    import torch

    from conformer_tpu_torch.train.flops import transducer_step_flops
    from conformer_tpu_torch.train.optimizer import leaf_paths

    cfg = trainer.cfg
    accum = cfg.train.accum_grad
    data = [[random_batch(cfg, 1000 * s + i, batch, seconds) for i in range(accum)]
            for s in range(steps + 1)]

    def one(mbs):
        before = {k: v.detach().clone() for k, v in leaf_paths(trainer.params)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = trainer.train_step(mbs)
        torch.cuda.synchronize()
        res["step_s"] = time.perf_counter() - t0
        after = dict(leaf_paths(trainer.params))
        changed = {k: not torch.equal(before[k], after[k]) for k in before}
        check(np.isfinite(res["loss"]) and np.isfinite(res["grad_norm"]),
              f"non-finite loss or gradients: {res}")
        check(not changed["encoder.pos_table"], "pos_table changed")
        check(all(c for k, c in changed.items() if after[k].dim() >= 2 and k != "encoder.pos_table"),
              "a weight matrix did not change")
        res["leaves_changed"] = sum(changed.values())
        res["leaves"] = len(changed)
        return res

    warm = one(data[0])
    reset_launch_counts()
    timed = [one(mbs) for mbs in data[1:]]
    launches = launch_counts()
    m = cfg.model
    for k, n in per_microbatch(m.encoder_num_layers, m.use_pallas_attention,
                               pruned=m.use_pruned_loss, joint=m.use_pallas_joint,
                               remat=m.remat).items():
        want = n * accum * steps
        check(launches[k] == want, f"{k} launched {launches[k]} times in {steps} steps, "
              f"expected {want}")
    step_s = sum(r["step_s"] for r in timed) / steps
    # the model's matrix flops of a step (train/flops.py: forward and
    # backward, no recomputation credited) over the step time
    flops = accum * transducer_step_flops(m, batch, int(seconds * 100), 64)["total"]
    return {"warmup": warm, "steps": timed, "launches": launches, "step_s": step_s,
            "audio_s_per_s": accum * batch * seconds / step_s,
            "model_tflops": flops / step_s / 1e12,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}


@contextlib.contextmanager
def band_hook(hook):
    """Inside, the pruned loss's ``prune_bounds_from_occupancy(occ, ...)``
    becomes ``hook(original, occ, ...)``."""
    from conformer_tpu_torch.ops import rnnt_pruned

    orig = rnnt_pruned.prune_bounds_from_occupancy
    rnnt_pruned.prune_bounds_from_occupancy = lambda occ, *a: hook(orig, occ, *a)
    try:
        yield
    finally:
        rnnt_pruned.prune_bounds_from_occupancy = orig


def train_parity(trainer, batch: int = 8, seconds: float = 15.0) -> dict:
    """Float32 kernel path (the trainer's kernel flags and the attention
    kernel) vs plain path on one deterministic microbatch of
    ragged lengths. The band starts of the two paths are compared, and the
    occupancies' argmax over u where they differ; then the plain path is
    run again on the kernel path's band, so that loss terms and gradients
    compare the same pruned loss."""
    import torch

    from conformer_tpu_torch.models.transducer import transducer_forward
    from conformer_tpu_torch.train.loop import plain_model_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg_k = dataclasses.replace(trainer.cfg.model, compute_dtype="float32",
                                use_pallas_attention=True)
    cfg_p = plain_model_config(cfg_k)
    mb = parity_batch(trainer.cfg, batch, seconds)
    occ = {}

    def record(key):
        def hook(orig, o, t_len, *a):
            occ[key] = (o.detach(), t_len)
            return orig(o, t_len, *a)
        return hook

    with band_hook(record("kernel")):
        g_k, out_k = trainer.compute_grads(mb, deterministic=True, model_cfg=cfg_k)
    with band_hook(record("plain")), torch.no_grad():
        b = trainer._batch(mb)
        s_plain = transducer_forward(trainer.params, b["feats"], b["feat_lengths"], b["labels"],
                                     b["label_lengths"], cfg_p, deterministic=True)["s_begin"]
    s_k = out_k["s_begin"]
    with band_hook(lambda orig, o, *a: s_k):
        g_p, out_p = trainer.compute_grads(mb, deterministic=True, model_cfg=cfg_p)
    (o_k, t_len), (o_p, _) = occ["kernel"], occ["plain"]
    live = torch.arange(o_k.shape[1], device=o_k.device)[None, :] < t_len.long()[:, None]
    u_k, u_p = o_k.argmax(dim=2), o_p.argmax(dim=2)
    flips = live & (u_k != u_p)
    # at a flip: how far apart the two cells are in the plain occupancy
    gap = (o_p.gather(2, u_p[..., None]) - o_p.gather(2, u_k[..., None]))[..., 0]
    return {**loss_grad_errors(out_k, out_p, g_k, g_p, ("loss", "loss_ctc", "loss_rnnt",
                                                         "loss_simple")),
            "s_begin_diff": int((s_k != s_plain).sum()),
            "s_begin_entries": int(s_k.numel()),
            "occupancy_max_abs_err": float(torch.where(live[..., None], o_k - o_p, 0).abs().max()),
            "argmax_flips": int(flips.sum()),
            "flip_max_gap": float(gap[flips].max()) if bool(flips.any()) else 0.0}


def parity_batch(cfg, batch: int, seconds: float) -> dict:
    """One microbatch of ragged lengths: features from the full length down
    to 55 % of it, labels from 64 down to 5."""
    frames = [int(seconds * 100 * f) for f in np.linspace(1.0, 0.55, batch)]
    mb = random_batch(cfg, 77, batch, seconds, feat_frames=frames)
    mb["label_lengths"] = np.linspace(64, 5, batch).astype(np.int32)
    mb["labels"] = np.where(np.arange(64)[None, :] < mb["label_lengths"][:, None],
                            mb["labels"], 0).astype(np.int32)
    return mb


def loss_grad_errors(out_k, out_p, g_k, g_p, keys, floor_share: float = 1e-6) -> dict:
    """Loss terms ``keys`` of the kernel and plain paths and their largest
    relative difference; each gradient leaf's max difference against its
    own max-abs, floored at ``floor_share`` of the largest leaf's (a
    gradient that is zero in exact arithmetic, such as the key bias's,
    whose shift softmax ignores, holds only rounding noise), the three
    worst leaves."""
    import torch

    losses = {k: (float(out_k[k].detach()), float(out_p[k].detach())) for k in keys}
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in losses.values())
    scales = {k: float(g.abs().max()) for k, g in g_p.items()}
    floor = floor_share * max(scales.values())
    grad_rel = {k: float((g_k[k] - g_p[k]).float().abs().max()) / max(scales[k], floor)
                for k in g_p}
    top = sorted(grad_rel.items(), key=lambda kv: -kv[1])[:3]
    return {"losses": losses, "loss_max_rel_err": loss_rel, "grad_worst_leaves": top,
            "grad_max_rel_err": top[0][1],
            "grad_floored_leaves": [k for k in g_p if scales[k] < floor],
            "finite": all(bool(torch.isfinite(g).all()) for g in g_k.values())}


# ---------------------------------------------------- train Conformer-L remat

REMAT_STEPS = 2
# the remat gradient check (6c (b)): loss terms within this relative
# difference, every gradient leaf within this share of its own max-abs;
# both runs draw the same masks and kernel seeds, so only the order of
# float32 sums may differ (the recompute runs the same kernels on the same
# inputs: in practice none)
REMAT_LIMITS = (1e-6, 1e-5)


def remat_config(remat: bool):
    """configs/conformer_l.json as shipped (pruned loss, RNN-T and CTC
    kernel flags, attention flag off, bf16, model.remat and train.remat
    on), CMVN and vocabulary cleared as in phase 6; ``remat`` False turns
    both remat flags off."""
    cfg = recipe_config(os.path.join(REPO, "configs", "conformer_l.json"))
    check(cfg.model.remat and cfg.train.remat, "configs/conformer_l.json no longer sets remat")
    cfg.model.remat = cfg.train.remat = remat
    return cfg


def remat_train(dev) -> dict:
    """6c (a): one warm-up and REMAT_STEPS timed steps of B=32 x 15 s with
    remat, then without (train_steps: counts set to 0 just before the
    timed steps, read just after); each run's peak memory from a reset
    just before its trainer is built."""
    import torch

    from conformer_tpu_torch.train.loop import Trainer

    out = {}
    for remat in (True, False):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(remat_config(remat), device=dev)
        check(trainer.cfg.model.remat is remat, "the trainer's model.remat")
        out[remat] = train_steps(trainer, steps=REMAT_STEPS)
        del trainer
    torch.cuda.empty_cache()
    return out


def remat_grad_parity(dev, batch: int = 8, seconds: float = 15.0) -> dict:
    """6c (b): the attention kernel on, dropout 0.1 (attention and
    elsewhere), float32: one microbatch's gradients with remat and without,
    from the same generator states (the trainer's device and host
    generators set back before each run); each run's counts set to 0 just
    before it and read just after. PyTorch's deterministic algorithms are
    on for these runs: the backward of a gather sums by atomics otherwise,
    in an order that changes from run to run. A second run without remat
    must equal the first (the control); a last one without remat and with
    PyTorch's default algorithms reads that noise (printed, not checked)."""
    import torch

    from conformer_tpu_torch.train.loop import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trainer = Trainer(remat_config(True), device=dev)
    mb = parity_batch(trainer.cfg, batch, seconds)
    start = (trainer.gen.get_state(), trainer.host_gen.get_state())
    deterministic = torch.are_deterministic_algorithms_enabled()
    runs = []
    try:
        for remat, det in ((True, True), (False, True), (False, True), (False, False)):
            torch.use_deterministic_algorithms(det, warn_only=True)
            trainer.gen.set_state(start[0])
            trainer.host_gen.set_state(start[1])
            mcfg = dataclasses.replace(trainer.cfg.model, compute_dtype="float32",
                                       use_pallas_attention=True, remat=remat)
            torch.cuda.synchronize()
            reset_launch_counts()
            g, o = trainer.compute_grads(mb, model_cfg=mcfg)
            torch.cuda.synchronize()
            runs.append((g, o, launch_counts(), trainer.gen.get_state()))
    finally:
        torch.use_deterministic_algorithms(deterministic)
    (g1, o1, n1, s1), (g0, o0, n0, s0), (gc, oc, _, sc), (gn, on, _, _) = runs
    keys = ("loss", "loss_ctc", "loss_rnnt", "loss_simple")
    res = loss_grad_errors(o1, o0, g1, g0, keys)
    res.update(launches_remat=n1, launches_plain=n0,
               gen_equal=torch.equal(s1, s0) and torch.equal(sc, s0),
               control=loss_grad_errors(oc, o0, gc, g0, keys),
               noise=loss_grad_errors(on, o0, gn, g0, keys),
               layers=trainer.cfg.model.encoder_num_layers, live=float(trainer.cfg.model.dropout))
    del trainer
    torch.cuda.empty_cache()
    return res


def check_remat_train(tr: dict, card: str) -> None:
    for remat, r in tr.items():
        label = "remat" if remat else "no remat"
        for st in (r["warmup"], *r["steps"]):
            print(f"train Conformer-L, {label}: step {st['step_s'] * 1e3:.1f} ms, loss "
                  f"{st['loss']:.4f}, grad norm {st['grad_norm']:.4g}, {st['leaves_changed']}/"
                  f"{st['leaves']} leaves changed ({card})")
        print(f"train Conformer-L, {label}: B=32 x 15 s, accum_grad 2: {r['step_s'] * 1e3:.1f} "
              f"ms per step, {r['audio_s_per_s']:.1f} training audio-s/s, peak memory "
              f"{r['peak_mem_gb']:.2f} GiB, launches in {REMAT_STEPS} steps "
              f"{nonzero(r['launches'])} ({card})")
    check(tr[True]["peak_mem_gb"] < tr[False]["peak_mem_gb"],
          f"remat's peak memory {tr[True]['peak_mem_gb']:.2f} GiB is not below "
          f"{tr[False]['peak_mem_gb']:.2f} GiB")


def check_remat_parity(par: dict) -> None:
    worst = ", ".join(f"{k} {e:.3g}" for k, e in par["grad_worst_leaves"])
    print(f"train Conformer-L remat parity: f32, attention kernel on, dropout {par['live']}, "
          f"B=8 x 15 s, remat vs no remat from the same generator states: losses "
          f"{par['losses']}, max rel err {par['loss_max_rel_err']:.3g} (limit "
          f"{REMAT_LIMITS[0]}); gradients max err / max-abs, worst leaves: {worst} (limit "
          f"{REMAT_LIMITS[1]}; scale floored at 1e-6 of the largest for "
          f"{par['grad_floored_leaves']}); generator states equal {par['gen_equal']}; launches "
          f"with remat {nonzero(par['launches_remat'])}, without "
          f"{nonzero(par['launches_plain'])}")
    for label, key in (("control, no remat twice", "control"),
                       ("no remat, default against deterministic algorithms", "noise")):
        ctl = par[key]
        worst = ", ".join(f"{k} {e:.3g}" for k, e in ctl["grad_worst_leaves"])
        print(f"train Conformer-L remat parity: {label}: loss max rel err "
              f"{ctl['loss_max_rel_err']:.3g}; gradients, worst leaves: {worst}")
    check(par["finite"] and par["loss_max_rel_err"] <= REMAT_LIMITS[0]
          and par["grad_max_rel_err"] <= REMAT_LIMITS[1] and par["gen_equal"],
          "remat and no-remat gradients differ: the recompute drew other masks")
    ctl = par["control"]
    check(ctl["loss_max_rel_err"] == 0 and ctl["grad_max_rel_err"] == 0,
          "two deterministic runs without remat differ")
    n = par["layers"]
    for name, runs, want in (("remat", par["launches_remat"], 2 * n),
                             ("no remat", par["launches_plain"], n)):
        got = (runs["rel_flash_attention"], runs["rel_flash_attention_bwd_dq"],
               runs["rel_flash_attention_bwd_dkv"])
        check(got == (want, n, n), f"{name}: attention fwd / dq / dkv launches {got}, "
              f"expected {(want, n, n)}")


# ------------------------------------------------ the 1024-wide Conformer

# configs/conformer_l.json at the widths of Conformer XL (Zhang et al. 2020,
# arXiv:2010.10504: d=1024, 8 heads, so dk=128; FFN 4096), which the
# attention and conv kernels take on their wide path; its 17 layers cut to
# WIDE_LAYERS to fit the smoke's time
WIDE_MODEL = dict(encoder_dim=1024, num_heads=8, hidden_dim=4096)
WIDE_LAYERS = 4
WIDE_BATCH = 8               # (a), (b): B=8 x 15 s
WIDE_SECONDS = 15.0
WIDE_STEPS = 2               # (b): timed training steps after a warm-up
WIDE_DECODES = 3             # (a), (d): timed bf16 decodes after a warm-up
WIDE_DQ_FIRST_MS = 4.1960    # (c): the first wide dq design at B=32 (PERF.md, run CN)
# (c): the earlier designs' times at B=32 (PERF.md, run CS): the forward
# and dkv on mma.sync, dq's dS once then dS [K | F]
WIDE_EARLIER_MS = {"rel_flash_attention": 0.5744, "rel_flash_attention_bwd_dq": 0.7159,
                   "rel_flash_attention_bwd_dkv": 0.8725}


def wide_config(**model):
    """configs/conformer_l.json as shipped (pruned loss + CTC, dropout 0.1,
    remat, bf16), CMVN and vocabulary cleared as in phase 6, at WIDE_MODEL's
    widths and WIDE_LAYERS layers; ``model`` sets more fields."""
    cfg = recipe_config(os.path.join(REPO, "configs", "conformer_l.json"))
    cfg.model = dataclasses.replace(cfg.model, **WIDE_MODEL, encoder_num_layers=WIDE_LAYERS,
                                    **model)
    return cfg


def conv_block_times(x, lens, p_norm, p_conv, k: int) -> dict:
    """Kernel and plain times (CUDA events) of the conv block on these
    inputs, and its bound from them: the bytes of inputs, weights and
    outputs against the pointwise products of the valid frames (frames
    past a row's length need none: their pw1 input is zero, their output
    masked; on the tensor cores in bf16) and the depthwise taps
    (float32). Returns the JSON entry without ``max_abs_err`` and
    ``launches``."""
    import torch

    from conformer_tpu_torch.ops.conv_block import conv_block, conv_block_plain, kernel_weights

    out = conv_block(x, lens, p_norm, p_conv, kernel_size=k)
    frames, d = float(lens.sum()), x.shape[-1]
    mm_rate = (BF16_TFLOPS if x.dtype == torch.bfloat16 else F32_TFLOPS) * 1e12
    ops_s = (2.0 * frames * d * 3 * d) / mm_rate + 2.0 * frames * d * k / (F32_TFLOPS * 1e12)
    bnd, by = bound_ms(nbytes(x, *out, lens, *kernel_weights(p_norm, p_conv, x.dtype).values()),
                       ops_s)
    return {"name": "conv_block", "route": "cuda",
            "source": "conformer_tpu_torch/csrc/conv_block.cu",
            "replaces": "conformer_tpu/ops/pallas/conv_kernel.py:107",
            "ms": time_ms(lambda: conv_block(x, lens, p_norm, p_conv, kernel_size=k)),
            "plain_ms": time_ms(lambda: conv_block_plain(x, lens, p_norm, p_conv, kernel_size=k)),
            "bound_ms": bnd, "bound_by": by, "library_ms": None}


def wide_backward_times(inputs) -> dict:
    """6d (c): the wide bf16 backward as training runs it (``rel_attention_bwd``:
    dS and pd once, then dq's and dkv's products) by CUDA events, and its
    kernels' device times by torch.profiler: dq's kernel 1 (S, dP, dS)
    and kernel 2 (dS [K | F]), dkv's kernel 1 (with pd) and its product
    kernel (dS^T (q+u), pd^T dO), with the product kernel's bound from
    this run's inputs (the scratches dS and pd, q+u and dO read, dK and dV
    written in float32; the products of the live pairs)."""
    import torch

    from conformer_tpu_torch.ops import rel_attention as ra

    args, seed, g = inputs
    q_u, mask, (b, h, tq, dk) = args[0], args[5], args[0].shape
    kw = dict(scale=dk ** -0.5, dropout_rate=ATTN_RATE)
    out, lse = ra.rel_attention(*args, seed=seed, **kw)
    bargs = (*args, seed, g, lse, (g.float() * out.float()).sum(dim=-1))
    dq = lambda: ra.rel_attention_bwd_dq(*bargs, **kw)    # noqa: E731
    dkv = lambda: ra.rel_attention_bwd_dkv(*bargs, **kw)  # noqa: E731
    tk, d = args[2].shape[2], args[1].shape[-1]
    scratch = 2 * math.prod(ra.scratch_shape(b, h, tq, tk, pd=True))     # bf16 bytes
    pairs, rate = h * float(mask.sum()), BF16_TFLOPS * 1e12               # live (query, key)
    n_bytes = scratch + nbytes(q_u, g) + 2 * b * h * tk * dk * 4
    bnd, by = bound_ms(n_bytes, 2.0 * 2 * pairs * dk / rate)
    # kernel 1: the inputs and dO, lse, delta read once, dS (and pd) written;
    # S over the depth dk + D and dP over dk. Kernel 2: dS, K and F read,
    # [dQu | dAB] written in float32; dS [K | F] over the depth of the keys
    in1 = nbytes(*args, g, *bargs[8:])
    k1 = bound_ms(in1 + scratch // 2, 2.0 * pairs * (2 * dk + d) / rate)
    k1_pd = bound_ms(in1 + scratch, 2.0 * pairs * (2 * dk + d) / rate)
    k2 = bound_ms(scratch // 2 + nbytes(args[2], args[4]) + b * h * tq * (dk + d) * 4,
                  2.0 * pairs * (dk + d) / rate)
    return {"ms": time_ms(lambda: ra.rel_attention_bwd(*bargs, **kw)),
            "ds_ms": device_ms(dq, "rel_flash_bwd_ds_wide_kernel"),
            "dsk_ms": device_ms(dq, "rel_flash_bwd_dsk_wide_kernel"),
            "ds_pd_ms": device_ms(dkv, "rel_flash_bwd_ds_wide_kernel"),
            "dkv_product_ms": device_ms(dkv, "rel_flash_bwd_dkv_wide_kernel"),
            "dkv_product_bound_ms": bnd, "dkv_product_bound_by": by,
            "ds_bound": k1, "ds_pd_bound": k1_pd, "dsk_bound": k2}


def wide_phase(dev, card: str) -> dict:
    """6d: the 1024-wide Conformer on the wide kernels. (a) serve: a
    ModelRunner (both encoder kernel flags, bf16, random weights from the
    config's seed, which emit on most frames) decodes B=8 x 15 s through
    ``decode_batch``: a warm-up, then WIDE_DECODES timed batches, the
    counts set to 0 just before the first and read just after it; then the
    f32 kernel path against the plain path on 8 utterances of 15 s
    (encoders within 1e-3, identical hypotheses, tokens emitted). (b)
    train: the recipe's Trainer with the attention kernel on (dropout 0.1,
    remat): a warm-up and WIDE_STEPS timed steps of B=8 x 15 s (counts set
    to 0 just before the timed steps and read just after), step ms and
    peak memory; then f32 at dropout 0, kernel path vs plain path, under
    BAND_LIMITS and the float32 FULL_PARITY_LIMITS. (c) the kernels' times
    at the shapes these paths give them: the attention kernels at the
    training shape (B=32, T'=374) and the conv block at the decode shape.
    (d) serve on int8 route B (``quantize_tree(fuse_ffn=True)`` of the
    runner's weights: the fused int8 FFN at D 1024 / H 4096): timed bf16
    decodes of the same batch and the launches of the first; f32 kernel
    path vs plain path (INT8_ENC_TOL, INT8_ENC_MEAN_SHARE, INT8_AGREE_MIN).
    Returns the launches of the counted runs and the kernels' times."""
    import torch

    from conformer_tpu_torch.ops.quant import quantize_tree
    from conformer_tpu_torch.serve.runner import INT8_SKIP_KEYS, ModelRunner
    from conformer_tpu_torch.train.loop import Trainer

    layers, res = WIDE_LAYERS, {}
    # (a) serve
    cfg = wide_config(use_pallas_attention=True, use_pallas_conv=True)
    runner = ModelRunner(cfg, device=dev)
    feats, lens = batch_feats(runner, [WIDE_SECONDS] * WIDE_BATCH, seed=600)
    runner.decode_batch(feats, lens)                 # warm-up
    times, launches = [], None
    for _ in range(WIDE_DECODES):
        torch.cuda.synchronize()
        if launches is None:
            reset_launch_counts()
        t0 = time.perf_counter()
        hyps, hl = runner.decode_batch(feats, lens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if launches is None:
            launches = launch_counts()
    want = {**dict.fromkeys(kernel_wrappers(), 0), "rel_flash_attention": layers,
            "conv_block": layers}
    check(launches == want, f"wide decode: launches {launches} in a batch, expected {want}")
    audio_s = WIDE_BATCH * WIDE_SECONDS
    res["decode"] = {"ms": sorted(times)[len(times) // 2] * 1e3, "launches": launches,
                     "audio_s_per_s": audio_s / (sum(times) / len(times)),
                     "tokens": int(hl.sum())}
    res["decode_parity"] = parity_f32(runner, runner.params, dev,
                                      seconds=(WIDE_SECONDS,) * WIDE_BATCH)
    # (d) int8 route B (both FFN matmuls through the fused int8 FFN at D
    # 1024 / H 4096: its wide route): a warm-up, then timed bf16 decodes of
    # the same batch, counts set to 0 just before the first and read just
    # after it; then f32 kernel path vs plain path as phase 5 holds
    # Conformer-M's route B
    fused = quantize_tree(runner.params, skip_keys=INT8_SKIP_KEYS, fuse_ffn=True)
    res["int8"] = timed_decodes(fused, cfg.model, cfg.decode, feats, lens, dev,
                                WIDE_BATCH * WIDE_SECONDS, runs=WIDE_DECODES)
    res["int8_parity"] = parity_f32(runner, fused, dev, seconds=(WIDE_SECONDS,) * WIDE_BATCH,
                                    float_params=runner.params)
    del runner, fused
    torch.cuda.empty_cache()

    # (b) train
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(wide_config(use_pallas_attention=True), device=dev)
    check(trainer.cfg.model.remat and trainer.cfg.model.attention_dropout > 0,
          "the wide recipe lost remat or attention dropout")
    tr = train_steps(trainer, steps=WIDE_STEPS, batch=WIDE_BATCH, seconds=WIDE_SECONDS)
    res["train"] = tr
    res["train_parity"] = train_parity(trainer, batch=WIDE_BATCH, seconds=WIDE_SECONDS)
    del trainer
    torch.cuda.empty_cache()
    res["launches"] = {k: launches[k] + tr["launches"][k] + res["int8"]["launches"][k]
                       for k in launches}

    # (c) the kernels' times at the paths' shapes
    gen = torch.Generator().manual_seed(13)
    inputs = attention_train_inputs(dev, torch.bfloat16, gen, 32, 374, dk=128, d=1024, h=8)
    res["times"] = attention_train_times(dev, gen, 32, 374, h=8, dk=128, d=1024, inputs=inputs,
                                         label="1024-wide B=32 T'=374")
    res["backward"] = wide_backward_times(inputs)
    k = cfg.model.kernel_size
    x, lens, p_norm, p_conv = conv_inputs(dev, torch.bfloat16, gen, b=WIDE_BATCH, t=374,
                                          d=WIDE_MODEL["encoder_dim"], k=k)
    res["times"]["conv_block"] = conv_block_times(x, lens, p_norm, p_conv, k)
    res["conv_shape"] = f"B={WIDE_BATCH} T'=374 D={x.shape[-1]} K={k}"
    res["conv_wide"] = wide_conv_check(x, lens, p_norm, p_conv, k)
    res["ffn_wide"] = wide_ffn_check(dev, gen, WIDE_BATCH * 374, WIDE_MODEL["encoder_dim"],
                                     WIDE_MODEL["hidden_dim"])
    return res


# the wide bf16 conv route's launches: LN_pre, pw1 + GLU, depthwise + LN +
# swish, pw2 + residual (a call also casts float32 weights to bf16)
WIDE_CONV_KERNELS = ("ln_pre_bf16_kernel", "conv_gemm_kernel", "dw_ln_bf16_kernel")


def wide_conv_check(x, lens, p_norm, p_conv, k: int) -> dict:
    """6d (c): the conv block's wide bf16 route at the decode shape against
    its plain version, out and cache poisoned with NaN beforehand (TOL),
    and its device time by torch.profiler."""
    import torch

    from conformer_tpu_torch.ops import conv_block as cb

    b, t, d = x.shape
    poison(((b, t, d), x.dtype), ((b, k - 1, d), x.dtype))
    got = cb.conv_block(x, lens, p_norm, p_conv, kernel_size=k)
    torch.cuda.synchronize()
    err = compare(f"conv_block wide bf16 B={b} T'={t} D={d} K={k}", got,
                  cb.conv_block_plain(x, lens, p_norm, p_conv, kernel_size=k), TOL["bfloat16"])
    return {"route": cb.route(x.dtype, d, k), "max_abs_err": err,
            "device_ms": device_ms(lambda: cb.conv_block(x, lens, p_norm, p_conv, kernel_size=k),
                                   WIDE_CONV_KERNELS, per_call=4)}


def wide_ffn_check(dev, gen, m: int, d: int, h: int) -> dict:
    """6d (d): the fused int8 FFN's wide route at route B's batch (M = 8 x
    374 rows, bf16 x with an all-zero row) against its plain version,
    output poisoned with NaN beforehand (INT8_TOL); its times by CUDA
    events (the wrapper's host work included where it outlasts the
    device), by torch.profiler on the device, and on the host (a call that
    returns before the device ends, 200 back to back), the plain version's
    and the two products alone by ``torch._int_mm`` (yardstick); its bound
    from these inputs: x read and out written, the weights and vectors
    read once, against the products' integer operations."""
    import torch

    from conformer_tpu_torch.ops import int8_ffn as f8

    ln, _, _, w1, w2 = int8_ffn_weights(dev, gen, d=d, h=h)
    args = (ln, w1["kernel_q"], w1["kernel_scale"], w1["bias"], w2["kernel_q"],
            w2["kernel_scale"], w2["bias"])
    x = torch.randn(m, d, generator=gen)
    x[m // 2] = 0.0
    x = x.to(dev, torch.bfloat16)
    poison(((m, d), x.dtype))
    out = f8.int8_ffn_fused(x, *args)
    torch.cuda.synchronize()
    ref = f8.int8_ffn_plain(x, *args)
    rtol, atol = INT8_TOL["bfloat16"]
    diff = (out.float() - ref.float()).abs()
    check(bool((diff <= atol + rtol * ref.float().abs()).all()),
          f"int8_ffn wide bf16 M={m} D={d} H={h} disagrees with its plain version")
    call = lambda: f8.int8_ffn_fused(x, *args)  # noqa: E731
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    host = (time.perf_counter() - t0) * 1e3 / 200
    torch.cuda.synchronize()
    xq = torch.randint(-127, 128, (m, d), generator=gen, dtype=torch.int8).to(dev)
    hq = torch.randint(-127, 128, (m, h), generator=gen, dtype=torch.int8).to(dev)

    def yard():
        torch._int_mm(xq, w1["kernel_q"])
        torch._int_mm(hq, w2["kernel_q"])

    bnd, by = bound_ms(nbytes(x, out, w1["kernel_q"], w2["kernel_q"], *ln.values(),
                              w1["kernel_scale"], w1["bias"], w2["kernel_scale"], w2["bias"]),
                       4.0 * m * d * h / (INT8_TOPS * 1e12))
    return {"route": f8.route(d, h), "max_abs_err": float(diff.max()), "ms": time_ms(call),
            "device_ms": device_ms(call, "ffn_", per_call=4), "host_ms": host,
            "plain_ms": time_ms(lambda: f8.int8_ffn_plain(x, *args)), "bound_ms": bnd,
            "bound_by": by, "library_ms": time_ms(yard), "shape": f"M={m} D={d} H={h}"}


def check_wide(res: dict, card: str) -> None:
    dec, par = res["decode"], res["decode_parity"]
    m = WIDE_MODEL
    print(f"wide: {WIDE_LAYERS} layers, d={m['encoder_dim']}, {m['num_heads']} heads of "
          f"{m['encoder_dim'] // m['num_heads']}, FFN {m['hidden_dim']}, "
          f"bf16 decode B={WIDE_BATCH} x {WIDE_SECONDS:g} s through ModelRunner.decode_batch: "
          f"{dec['ms']:.1f} ms a batch (median of {WIDE_DECODES}), {dec['audio_s_per_s']:.1f} "
          f"audio-s/s, {dec['tokens']} tokens, launches in one batch {nonzero(dec['launches'])} "
          f"({card})")
    print(f"wide: f32 kernel path vs plain path, {WIDE_BATCH} x {WIDE_SECONDS:g} s: encoder "
          f"max_abs_err {par['encoder_max_abs_err']:.3g} (tol 1e-3), mean "
          f"{par['encoder_mean_abs_err']:.3g}; hyps identical {par['hyps_identical']}, hyp lens "
          f"{par['hyp_lens']}")
    check(par["finite"] and par["encoder_max_abs_err"] <= 1e-3 and par["hyps_identical"]
          and max(par["hyp_lens"]) > 0,
          "wide: the f32 kernel path's decode differs from the plain path's")
    tr = res["train"]
    for st in (tr["warmup"], *tr["steps"]):
        print(f"wide train: step {st['step_s'] * 1e3:.1f} ms, loss {st['loss']:.4f} (ctc "
              f"{st['loss_ctc']:.4f}, rnnt {st['loss_rnnt']:.4f}), grad norm "
              f"{st['grad_norm']:.4g}, {st['leaves_changed']}/{st['leaves']} leaves changed")
    print(f"wide train: recipe (pruned + CTC, dropout 0.1, remat, attention kernel), B="
          f"{WIDE_BATCH} x {WIDE_SECONDS:g} s, accum_grad 2: {tr['step_s'] * 1e3:.1f} ms per step, "
          f"{tr['audio_s_per_s']:.1f} training audio-s/s, peak memory {tr['peak_mem_gb']:.2f} "
          f"GiB, launches in {WIDE_STEPS} steps {nonzero(tr['launches'])} ({card})")
    par = res["train_parity"]
    loss_lim, grad_lim, _ = FULL_PARITY_LIMITS["float32"]
    worst = ", ".join(f"{k} {e:.3g}" for k, e in par["grad_worst_leaves"])
    print(f"wide train parity: f32, dropout 0, kernel path vs plain path, B={WIDE_BATCH} x "
          f"{WIDE_SECONDS:g} s: losses {par['losses']}, max rel err "
          f"{par['loss_max_rel_err']:.3g} (limit {loss_lim}); gradients max err / max-abs, worst "
          f"leaves: {worst} (limit {grad_lim}); s_begin differs in {par['s_begin_diff']} of "
          f"{par['s_begin_entries']}, occupancy max abs err {par['occupancy_max_abs_err']:.3g}, "
          f"argmax flips {par['argmax_flips']} (max gap {par['flip_max_gap']:.3g})")
    check(par["s_begin_diff"] <= BAND_LIMITS["s_begin_diff_share"] * par["s_begin_entries"]
          and par["occupancy_max_abs_err"] <= BAND_LIMITS["occupancy_max_abs_err"]
          and par["flip_max_gap"] <= BAND_LIMITS["flip_max_gap"],
          "wide: the kernel path's pruning band differs from the plain path's beyond its limits")
    check(par["finite"] and par["loss_max_rel_err"] <= loss_lim
          and par["grad_max_rel_err"] <= grad_lim,
          "wide: the f32 training kernel path disagrees with the plain path")
    e, cw = res["times"]["conv_block"], res["conv_wide"]
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"   # noqa: E731
    print(f"kernels: conv_block bf16 {res['conv_shape']} ({cw['route']} route: wgmma + TMA, "
          f"192-row tiles): kernel {e['ms']:.4f} ms (device {fmt(cw['device_ms'])}), plain "
          f"{e['plain_ms']:.4f} ms, bound {e['bound_ms'] * 1e3:.2f} us ({e['bound_by']}); "
          f"max_abs_err {cw['max_abs_err']:.3g} (tol {TOL['bfloat16']} abs + rel; out and cache "
          f"poisoned with NaN beforehand) ({card})")
    check(cw["route"] == "wide", f"wide: the conv block took the {cw['route']} route")
    fw = res["ffn_wide"]
    print(f"kernels: int8_ffn bf16 {fw['shape']} ({fw['route']} route: int8 wgmma + TMA, "
          f"192 x 128 tiles, persistent): kernel {fw['ms']:.4f} ms (device "
          f"{fmt(fw['device_ms'])}, host {fw['host_ms']:.4f} ms a call), plain "
          f"{fw['plain_ms']:.4f} ms, 2 x torch._int_mm {fw['library_ms']:.4f} ms, bound "
          f"{fw['bound_ms']:.4f} ms ({fw['bound_by']}); max_abs_err {fw['max_abs_err']:.3g} "
          f"(INT8_TOL {INT8_TOL['bfloat16']}; out poisoned with NaN beforehand) ({card})")
    check(fw["route"] == "wide", f"wide: the int8 FFN took the {fw['route']} route")
    t, bw = res["times"], res["backward"]
    for name, what in (("rel_flash_attention", "forward (wgmma + TMA)"),
                       ("rel_flash_attention_bwd_dq", "dq (dS once, then dS [K | F])"),
                       ("rel_flash_attention_bwd_dkv", "dkv (dS and pd once, then dS^T (q+u), "
                                                       "pd^T dO)")):
        e = t[name]
        lib = "forward" if name == "rel_flash_attention" else "whole backward"
        print(f"wide: {what} {e['ms']:.4f} ms (earlier design {WIDE_EARLIER_MS[name]} ms, "
              f"PERF.md run CS), SDPA's {lib} {e['library_ms']:.4f} ms, bound "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']}) at B=32 T'=374 H=8 dk=128 D=1024 "
              f"({card})")
    dq = t["rel_flash_attention_bwd_dq"]
    before = (WIDE_EARLIER_MS["rel_flash_attention_bwd_dq"]
              + WIDE_EARLIER_MS["rel_flash_attention_bwd_dkv"])
    print(f"wide: the whole backward as training runs it (dS and pd once, then both products) "
          f"{bw['ms']:.4f} ms, against dq + dkv {before:.4f} ms before (PERF.md run CS) and "
          f"SDPA's whole backward {dq['library_ms']:.4f} ms; "
          f"device times: dq's kernel 1 (S, dP, dS) {fmt(bw['ds_ms'])} (bound "
          f"{bw['ds_bound'][0]:.4f} ms, {bw['ds_bound'][1]}), kernel 2 (dS [K | F]) "
          f"{fmt(bw['dsk_ms'])} (bound {bw['dsk_bound'][0]:.4f} ms, {bw['dsk_bound'][1]}); dkv's "
          f"kernel 1 (with pd) {fmt(bw['ds_pd_ms'])} (bound {bw['ds_pd_bound'][0]:.4f} ms, "
          f"{bw['ds_pd_bound'][1]}), product kernel "
          f"{fmt(bw['dkv_product_ms'])} (bound {bw['dkv_product_bound_ms']:.4f} ms, "
          f"{bw['dkv_product_bound_by']}); dq's first design {WIDE_DQ_FIRST_MS} ms (run CN) "
          f"({card})")
    i8, par = res["int8"], res["int8_parity"]
    want = {**dict.fromkeys(kernel_wrappers(), 0), "rel_flash_attention": WIDE_LAYERS,
            "conv_block": WIDE_LAYERS, "int8_ffn": 2 * WIDE_LAYERS}
    ms = sorted(i8["decode_s"])[len(i8["decode_s"]) // 2] * 1e3
    print(f"wide int8 route B: bf16 decode B={WIDE_BATCH} x {WIDE_SECONDS:g} s: {ms:.1f} ms a "
          f"batch (median of {WIDE_DECODES}; encoder {min(i8['encode_s']) * 1e3:.1f} ms), "
          f"{i8['audio_s_per_s']:.1f} audio-s/s, launches in one batch {nonzero(i8['launches'])}, "
          f"weight layouts made by the end of the first batch and of the last "
          f"{i8['layout_builds']} ({card})")
    check(i8["launches"] == want, f"wide int8 route B: launches {i8['launches']}, expected {want}")
    check(i8["layout_builds"][1] == i8["layout_builds"][0],
          f"wide int8 route B: weight layouts made after the first batch {i8['layout_builds']}")
    agree, same, n_ref = par["token_agreement"]
    print(f"wide int8 route B: f32 kernel path vs plain path: encoder max_abs_err "
          f"{par['encoder_max_abs_err']:.3g} (tol {INT8_ENC_TOL}), mean "
          f"{par['encoder_mean_abs_err']:.3g} (limit {INT8_ENC_MEAN_SHARE} x the quantization's "
          f"own mean {par['quant_mean_abs_err']:.3g}; its max {par['quant_max_abs_err']:.3g}); "
          f"hyps identical {par['hyps_identical']}, token agreement {agree:.4f} over {n_ref} "
          f"tokens, hyp lens {par['hyp_lens']}")
    check(par["finite"] and par["encoder_max_abs_err"] <= INT8_ENC_TOL
          and par["encoder_mean_abs_err"] <= INT8_ENC_MEAN_SHARE * par["quant_mean_abs_err"]
          and (par["hyps_identical"] or agree >= INT8_AGREE_MIN) and max(par["hyp_lens"]) > 0,
          "wide int8 route B: the f32 kernel path disagrees with the plain path")


# -------------------------------------------------------- train full lattice

FULL_BATCH = 24              # bench.py --full-lattice's default train batch (bench.py:423)
# limits of the full-lattice parity, kernel path vs plain path, per dtype:
# (loss terms, relative; every gradient leaf, against its own max-abs;
# the floor of that max-abs, a share of the largest leaf's). In float32
# those of the pruned parity. In bf16 both paths round x and W to bf16 and
# sum in float32; the kernels' backward also rounds dl to bf16 (the tensor
# cores' operand), 2^-9 relative, and the encoder's bf16 activations carry
# that on through the backward: a few bf16 ulps. A gradient that is zero in
# exact arithmetic (the key bias) keeps bf16 rounding noise of ~1e-3 of the
# sums it comes from, hence the bf16 floor.
FULL_PARITY_LIMITS = {"float32": (1e-4, 1e-3, 1e-6), "bfloat16": (1e-3, 5e-2, 1e-3)}


def full_lattice_config(path: str):
    """The recipe as shipped but for the loss: the full lattice
    (``use_pruned_loss`` false, the JAX ModelConfig default) with its joint
    through the kernels (``use_pallas_joint``), as ``bench.py --full-lattice
    --pallas-joint`` trains it; the RNN-T and CTC kernel flags on and the
    attention flag off, as shipped."""
    cfg = recipe_config(path)
    cfg.model.use_pruned_loss = False
    cfg.model.use_pallas_joint = True
    return cfg


FULL_L_LAYERS = 4            # 6e: Conformer-L's 17 layers cut to fit the smoke's time
FULL_L_BATCH = 4             # 6e: B=4 x 15 s, 64 labels


def full_lattice_l_parity(dev) -> dict:
    """6e: configs/conformer_l.json (join_dim 640: the joint kernels' wide
    route in float32) with the full-lattice loss through the joint kernels,
    FULL_L_LAYERS layers, float32 kernel path vs plain path on one ragged
    microbatch (``full_lattice_parity``); the counts set to 0 just before
    and read just after."""
    import torch

    from conformer_tpu_torch.ops import joint_lattice as jl
    from conformer_tpu_torch.train.loop import Trainer

    cfg = full_lattice_config(os.path.join(REPO, "configs", "conformer_l.json"))
    cfg.model = dataclasses.replace(cfg.model, encoder_num_layers=FULL_L_LAYERS)
    check(jl.route(torch.float32, cfg.model.join_dim, "bwd") == "wide",
          f"6e: join_dim {cfg.model.join_dim} is not on the joint kernels' wide route")
    trainer = Trainer(cfg, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    par = full_lattice_parity(trainer, "float32", FULL_PARITY_LIMITS["float32"][2],
                              batch=FULL_L_BATCH)
    torch.cuda.synchronize()
    par["launches"] = launch_counts()
    par["join_dim"] = cfg.model.join_dim
    del trainer
    torch.cuda.empty_cache()
    return par


def full_lattice_parity(trainer, dtype: str, floor_share: float, batch: int = 8,
                        seconds: float = 15.0) -> dict:
    """The full-lattice loss's kernel path (the trainer's kernel flags) vs
    its plain path in ``dtype`` on one deterministic microbatch of ragged
    lengths: loss terms and gradients (``loss_grad_errors``)."""
    import torch

    from conformer_tpu_torch.train.loop import plain_model_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg_k = dataclasses.replace(trainer.cfg.model, compute_dtype=dtype)
    mb = parity_batch(trainer.cfg, batch, seconds)
    g_k, out_k = trainer.compute_grads(mb, deterministic=True, model_cfg=cfg_k)
    g_p, out_p = trainer.compute_grads(mb, deterministic=True,
                                       model_cfg=plain_model_config(cfg_k))
    return loss_grad_errors(out_k, out_p, g_k, g_p, ("loss", "loss_ctc", "loss_rnnt"),
                            floor_share)


# -------------------------------------------------------------------- host

FIT_DIR = os.path.join(REPO, "build", "chip_smoke_fit")   # build/ is git-ignored
FIT_TRAIN, FIT_DEV = 40, 8          # synthetic utterances of 2-15 s
HOST_UTTS, HOST_SECONDS = 48, 15.0  # the fbank batch of the host phase
HOST_THREADS = (1, 2, 8)            # fbank_batch's threads, each equal to the single calls
HOST_RUNS = 5                       # host times: median of this many runs
HOST_DECODE_TOL = 1e-4              # decode_wav vs the stdlib parser (the JAX test's)
HOST_RESAMPLE_P99 = 5e-3            # resample vs scipy, 99th percentile off the edges (JAX's)


def fit_corpus() -> tuple[dict, float]:
    """The fit phase's synthetic corpus, written anew from seed 0 under
    ``FIT_DIR``; returns its paths and the seconds it took."""
    from conformer_tpu_torch.data.synthetic import write_corpus

    shutil.rmtree(FIT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    corpus = write_corpus(os.path.join(FIT_DIR, "corpus"), seed=0, n_train=FIT_TRAIN,
                          n_dev=FIT_DEV)
    return corpus, time.perf_counter() - t0


def median_ms(fn, runs: int = HOST_RUNS) -> float:
    """Host wall time of ``fn()``, median of ``runs``."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


@contextlib.contextmanager
def numpy_features():
    """The data pipeline on its numpy path, as without g++."""
    from conformer_tpu_torch.data import native

    saved = native.native_available
    native.native_available = lambda: False
    try:
        yield
    finally:
        native.native_available = saved


def pipeline_rate(corpus: dict) -> float:
    """Audio-seconds per second of the training pipeline: ``AsrDataset``
    in train mode at configs/conformer_m.json's data settings (dither 0.1,
    speed perturbation, SpecAugment, shuffle, sort, bucket batching) over
    the corpus's train list, one epoch a run, median of ``HOST_RUNS``;
    audio-seconds are the batches' frames x frame shift, as the trainer
    counts them."""
    from conformer_tpu_torch.data.dataset import AsrDataset

    cfg = recipe_config(os.path.join(REPO, "configs", "conformer_m.json")).data
    cfg = dataclasses.replace(cfg, train_data_list_path=corpus["train"],
                              vocab_path=corpus["vocab"], bpe_model=None)
    ds = AsrDataset(cfg, "train")
    rates = []
    for epoch in range(HOST_RUNS):
        ds.set_epoch(epoch)
        t0 = time.perf_counter()
        frames = sum(int(b["feat_lengths"].sum()) for b in ds)
        rates.append(frames * cfg.frame_shift / 1000 / (time.perf_counter() - t0))
    return float(np.median(rates))


def host_phase(corpus: dict) -> dict:
    """The host audio runtime on the card machine's CPU: build it with g++
    (timed, from a clean library path), then native against numpy (fbank
    of HOST_UTTS x HOST_SECONDS synthetic wavs within FBANK_HOST_TOL of
    fbank_numpy, fbank_batch at HOST_THREADS bit for bit equal to the
    single calls, decode_wav against the stdlib parser, resample 16 k ->
    8 k against scipy, dither 0.1 repeatable in its seed), then host times
    and the training pipeline's audio-s/s with native on and off."""
    from conformer_tpu_torch.data import audio, native
    from conformer_tpu_torch.ops.fbank import fbank_numpy

    native.reset()
    cxx = native.compiler()
    check(cxx is not None, "host: g++ is not on PATH, the audio runtime cannot be built")
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                             check=True).stdout.splitlines()[0]
    native.library_path(cxx).unlink(missing_ok=True)
    t0 = time.perf_counter()
    available = native.native_available()      # raises with g++'s output if the build fails
    res = {"compiler": version, "build_s": time.perf_counter() - t0,
           "library": os.path.relpath(native.library_path(cxx), REPO)}
    check(available, "host: native_available() is False")

    waves = [synthetic_wav(700 + i, HOST_SECONDS) * (1 << 15) for i in range(HOST_UTTS)]
    nat = [native.fbank(w) for w in waves]
    ref = [fbank_numpy(w) for w in waves]
    rtol, atol = FBANK_HOST_TOL
    check(all(a.shape == b.shape == (1498, 80) for a, b in zip(nat, ref)),
          f"host: fbank shapes {nat[0].shape}, {ref[0].shape}")
    res["fbank_max_abs_err"] = max(float(np.abs(a - b).max()) for a, b in zip(nat, ref))
    res["fbank_excess"] = max(float((np.abs(a - b) - atol - rtol * np.abs(b)).max())
                              for a, b in zip(nat, ref))
    res["batch_equal"] = {t: all(np.array_equal(a, b) for a, b in
                                 zip(native.fbank_batch(waves, num_threads=t), nat))
                          for t in HOST_THREADS}
    wav = synthetic_wav(800, 4.0)
    os.makedirs(FIT_DIR, exist_ok=True)
    path = os.path.join(FIT_DIR, "host.wav")
    with open(path, "wb") as f:
        f.write(wav_bytes(wav))
    with open(path, "rb") as f:
        got, sr = native.decode_wav(f.read())
    want, want_sr = audio._load_wav_stdlib(path)
    res["decode"] = {"sr": (sr, want_sr), "n": (len(got), len(want)),
                     "max_abs_err": float(np.abs(got - want).max())}
    tone = (0.4 * np.sin(2 * np.pi * 440.0 * np.arange(8000) / 16000)).astype(np.float32)
    ours, theirs = native.resample(tone, 16000, 8000), audio.resample(tone, 16000, 8000)
    n = min(len(ours), len(theirs))
    res["resample_p99"] = float(np.percentile(np.abs(ours[200:n - 200] - theirs[200:n - 200]),
                                              99))
    a, b, c = (native.fbank(waves[0], dither=0.1, seed=s) for s in (42, 42, 43))
    res["dither"] = {"same_seed_equal": bool(np.array_equal(a, b)),
                     "other_seed_differs": not np.array_equal(a, c)}

    res["ms"] = {
        "fbank_numpy": median_ms(lambda: [fbank_numpy(w) for w in waves]),
        "native fbank": median_ms(lambda: [native.fbank(w) for w in waves]),
        f"fbank_batch {HOST_THREADS[-1]} threads": median_ms(
            lambda: native.fbank_batch(waves, num_threads=HOST_THREADS[-1])),
    }
    res["pipeline_native"] = pipeline_rate(corpus)
    with numpy_features():
        res["pipeline_numpy"] = pipeline_rate(corpus)
    return res


def check_host(res: dict, card: str) -> None:
    d = res["decode"]
    print(f"host: {res['compiler']}; audio runtime built in {res['build_s']:.2f} s "
          f"({res['library']})")
    print(f"host: native fbank vs fbank_numpy, {HOST_UTTS} x {HOST_SECONDS:g} s: max abs err "
          f"{res['fbank_max_abs_err']:.3g} (rtol {FBANK_HOST_TOL[0]}, atol "
          f"{FBANK_HOST_TOL[1]}: largest excess {res['fbank_excess']:.3g}); fbank_batch equal to "
          f"the single calls at threads {res['batch_equal']}; decode_wav vs the stdlib parser "
          f"max abs err {d['max_abs_err']:.3g} (tol {HOST_DECODE_TOL}); resample 16 k -> 8 k vs "
          f"scipy p99 {res['resample_p99']:.3g} (limit {HOST_RESAMPLE_P99}); dither 0.1 "
          f"{res['dither']}")
    check(res["fbank_excess"] <= 0, "host: native fbank outside the tolerance of fbank_numpy")
    check(all(res["batch_equal"].values()), f"host: fbank_batch {res['batch_equal']}")
    check(d["sr"] == (16000, 16000) and d["n"][0] == d["n"][1]
          and d["max_abs_err"] <= HOST_DECODE_TOL, f"host: decode_wav {d}")
    check(res["resample_p99"] < HOST_RESAMPLE_P99, f"host: resample p99 {res['resample_p99']}")
    check(all(res["dither"].values()), f"host: dither {res['dither']}")
    times = ", ".join(f"{k} {v:.1f} ms" for k, v in res["ms"].items())
    print(f"host: on the card machine's CPU ({os.cpu_count()} cores; {card}), "
          f"{HOST_UTTS} x {HOST_SECONDS:g} s, median of {HOST_RUNS}: {times}")
    print(f"host: training pipeline (AsrDataset train, the recipe's data settings, the fit "
          f"corpus), median of {HOST_RUNS} epochs: native {res['pipeline_native']:.1f} "
          f"audio-s/s, numpy {res['pipeline_numpy']:.1f} audio-s/s ({card})")


# --------------------------------------------------------------------- fit

FIT_STEPS, FIT_RESUME_TO = 4, 6
FIT_FULL_STEPS = 2                  # the full-lattice run: steps, no validation
FIT_MFCC_STEPS = 2                  # the MFCC run: steps, no validation
MFCC_CEPS = 40                      # DataConfig.num_ceps's default: the model's input_dim


def compute_cmvn(corpus: dict) -> dict:
    """``python -m conformer_tpu_torch.tools.compute_cmvn_stats`` over the
    corpus's train list, as a user runs it: in a process of its own, so
    its worker pool forks no process that holds CUDA."""
    path = os.path.join(FIT_DIR, "global_cmvn")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "conformer_tpu_torch.tools.compute_cmvn_stats",
                           "--data_list", corpus["train"], "--output", path],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"compute_cmvn_stats failed:\n{proc.stderr[-3000:]}")
    return {"path": path, "s": time.perf_counter() - t0, "stdout": proc.stdout.strip()}


def fit_phase(corpus: dict, corpus_s: float) -> dict:
    """The user's training command on the synthetic corpus (``fit_corpus``):
    first ``compute_cmvn`` makes the corpus's CMVN statistics; then
    ``conformer_tpu_torch.main.main`` with ``--train`` on
    configs/conformer_m.json at full width (attention and conv kernel flags
    on; the recipe's global CMVN from those statistics, dither, speed
    perturbation, SpecAugment, bucket batching, dropout 0.1 and accum_grad
    2 as they stand, features from the host audio runtime), validating
    every ``FIT_STEPS // 2`` steps; the launch counts are set to 0 just
    before it and read just after. Then ``--resume_from last`` to
    ``FIT_RESUME_TO`` steps and ``--eval``; then a new trainer restores the
    last checkpoint, to be compared with the file (its CMVN with the
    statistics'), and validates the dev set lazy and eager. Then the
    full-lattice run and the MFCC run, counts set to 0 just before each."""
    import torch

    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.data.dataset import AsrDataset, eval_config
    from conformer_tpu_torch.main import main as port_main
    from conformer_tpu_torch.models.cmvn import init_cmvn_from_file
    from conformer_tpu_torch.train import checkpoint as ckpt_mod
    from conformer_tpu_torch.train.loop import Trainer
    from conformer_tpu_torch.train.optimizer import leaf_paths

    cmvn = compute_cmvn(corpus)
    ckpt = os.path.join(FIT_DIR, "ckpt")
    config = os.path.join(REPO, "configs", "conformer_m.json")
    sets = ["model.use_pallas_attention=true", "model.use_pallas_conv=true",
            f"train.val_check_interval={FIT_STEPS // 2}", "train.log_every=1",
            f"train.checkpoint_dir={ckpt}", f"data.train_data_list_path={corpus['train']}",
            f"data.dev_data_list_path={corpus['dev']}",
            f"data.test_data_list_path={corpus['dev']}", f"data.vocab_path={corpus['vocab']}",
            "data.bpe_model=null", f"data.cmvn_path={cmvn['path']}"]
    base = ["--config", config, "--set", *sets]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    port_main(["--train", *base, f"train.max_steps={FIT_STEPS}"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = launch_counts()
    first = {"names": sorted(os.listdir(ckpt)), "last": open(os.path.join(ckpt, "last")).read()}
    port_main(["--train", *base, f"train.max_steps={FIT_RESUME_TO}", "--resume_from", "last"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port_main(["--eval", "--resume", "--resume_from", "last", *base])
    print(out.getvalue().strip())
    cfg = Config.from_json_file(config).apply_overrides(sets)
    trainer = Trainer(cfg, device="cuda")
    trainer.restore("last")
    saved = ckpt_mod.restore_checkpoint(ckpt_mod.latest_checkpoint(ckpt), trainer.device)
    want = dict(leaf_paths(saved["params"]))
    restored = {"step": trainer.step, "saved_step": saved["step"],
                "params_equal": all(torch.equal(v, want[k]) for k, v in leaf_paths(trainer.params))}
    stats = init_cmvn_from_file(cmvn["path"], trainer.device)
    cmvn["checkpoint_equal"] = {k: torch.equal(saved["params"]["cmvn"][k], stats[k])
                                for k in ("mean", "istd")}
    # the dev set lazy and eager through Trainer.validate, counts set to 0
    # just before each and read just after
    eager = {}
    for label, kw in (("lazy", {}), ("eager", {"eager": True})):
        dev_set = AsrDataset(eval_config(cfg.data), "dev", tokenizer=trainer.tokenizer, **kw)
        torch.cuda.synchronize()
        reset_launch_counts()
        wer = trainer.validate(dev_set)
        torch.cuda.synchronize()
        eager[label] = {"wer": wer, "launches": launch_counts()}
    eager["batches"] = len(dev_set)
    trainer.logger.close()
    del trainer
    # the full lattice through the same command on the same corpus: its own
    # checkpoints, FIT_FULL_STEPS steps, no validation; counts set to 0
    # just before it and read just after
    ckpt_full = os.path.join(FIT_DIR, "ckpt_full")
    full_sets = [*sets, f"train.checkpoint_dir={ckpt_full}", "train.num_sanity_val_steps=0",
                 f"train.val_check_interval={FIT_FULL_STEPS + 1}", "model.use_pruned_loss=false",
                 "model.use_pallas_joint=true", f"train.max_steps={FIT_FULL_STEPS}"]
    reset_launch_counts()
    t0 = time.perf_counter()
    port_main(["--train", "--config", config, "--set", *full_sets])
    torch.cuda.synchronize()
    full = {"fit_s": time.perf_counter() - t0, "launches": launch_counts(),
            "records": [json.loads(line) for line in open(os.path.join(ckpt_full, "metrics.jsonl"))],
            "names": sorted(os.listdir(ckpt_full))}
    # MFCC features (the config's num_ceps as the model's input width), the
    # same command, its own checkpoints, no validation; CMVN cleared, the
    # statistics being the fbank's; counts set to 0 just before and read
    # just after
    ckpt_mfcc = os.path.join(FIT_DIR, "ckpt_mfcc")
    mfcc_sets = [*sets, f"train.checkpoint_dir={ckpt_mfcc}", "train.num_sanity_val_steps=0",
                 f"train.val_check_interval={FIT_MFCC_STEPS + 1}", "data.feat_type=mfcc",
                 f"data.num_ceps={MFCC_CEPS}", f"model.input_dim={MFCC_CEPS}", "data.cmvn_path=",
                 f"train.max_steps={FIT_MFCC_STEPS}"]
    reset_launch_counts()
    t0 = time.perf_counter()
    port_main(["--train", "--config", config, "--set", *mfcc_sets])
    torch.cuda.synchronize()
    mfcc = {"fit_s": time.perf_counter() - t0, "launches": launch_counts(),
            "records": [json.loads(line) for line in open(os.path.join(ckpt_mfcc,
                                                                        "metrics.jsonl"))]}
    records = [json.loads(line) for line in open(os.path.join(ckpt, "metrics.jsonl"))]
    eval_wer = [float(line.split()[-1]) for line in out.getvalue().splitlines()
                if line.startswith("WER:")]
    return {"cfg": cfg, "eval_args": base, "corpus_s": corpus_s, "fit_s": fit_s,
            "launches": launches, "cmvn": cmvn, "eager": eager, "mfcc": mfcc,
            "first": first, "records": records, "eval_wer": eval_wer, "restored": restored,
            "names": sorted(os.listdir(ckpt)), "last": open(os.path.join(ckpt, "last")).read(),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30, "full_lattice": full}


def validation_batches(cfg) -> int:
    """Batches decoded in the fit phase's first run: the sanity check's,
    then a whole dev set at every ``val_check_interval`` steps."""
    from conformer_tpu_torch.data.dataset import eval_config

    per_set = -(-FIT_DEV // eval_config(cfg.data).batch_size)
    return (min(cfg.train.num_sanity_val_steps, per_set)
            + FIT_STEPS // cfg.train.val_check_interval * per_set)


def check_fit(fit: dict) -> None:
    cfg = fit["cfg"]
    layers, accum = cfg.model.encoder_num_layers, cfg.train.accum_grad
    train = [r for r in fit["records"] if "train_loss" in r]
    valid = [r for r in fit["records"] if "valid_wer" in r]
    steps = [r["step"] for r in train]
    check(steps == list(range(1, FIT_RESUME_TO + 1)),
          f"metrics.jsonl holds steps {steps} (the resume must go on at {FIT_STEPS + 1})")
    for r in train:
        check(np.isfinite(r["train_loss"]) and np.isfinite(r["train_grad_norm"]),
              f"fit step {r['step']}: loss {r['train_loss']}, grad norm {r['train_grad_norm']}")
    vals = [r["step"] for r in valid]
    interval = cfg.train.val_check_interval
    check(vals == list(range(interval, FIT_RESUME_TO + 1, interval))
          and all(np.isfinite(r["valid_wer"]) for r in valid),
          f"validations {[(r['step'], r['valid_wer']) for r in valid]}")
    # the first run: FIT_STEPS steps of accum microbatches, and the
    # validations' deterministic encoders (attention forward and conv)
    n_val = validation_batches(cfg)
    want = {k: n * accum * FIT_STEPS for k, n in
            per_microbatch(layers, True).items()}
    want["rel_flash_attention"] += layers * n_val
    want["conv_block"] += layers * n_val
    check(fit["launches"] == want, f"fit launches {fit['launches']}, expected {want}")
    names = fit["first"]["names"]
    for prefix in (f"step_{FIT_STEPS // 2}-wer_", f"step_{FIT_STEPS}-wer_"):
        check(any(n.startswith(prefix) for n in names), f"no checkpoint {prefix}* in {names}")
    check(f"step_{FIT_STEPS}" in names and fit["first"]["last"] == f"step_{FIT_STEPS}",
          f"checkpoints {names}, last -> {fit['first']['last']}")
    check(fit["last"] == f"step_{FIT_RESUME_TO}", f"after the resume last -> {fit['last']}")
    r = fit["restored"]
    check(r["params_equal"] and r["step"] == r["saved_step"] == FIT_RESUME_TO,
          f"restore of the last checkpoint: {r}")
    check(len(fit["eval_wer"]) == 1 and np.isfinite(fit["eval_wer"][0]),
          f"--eval printed {fit['eval_wer']}")
    # the full-lattice run: its steps, finite, no validation, its launches
    # (labels padded to max_label_len: U+1 = 201 in the joint)
    full = fit["full_lattice"]
    recs = [r for r in full["records"] if "train_loss" in r]
    check([r["step"] for r in recs] == list(range(1, FIT_FULL_STEPS + 1))
          and all(np.isfinite(r["train_loss"]) and np.isfinite(r["train_grad_norm"]) for r in recs)
          and not any("valid_wer" in r for r in full["records"]),
          f"full-lattice fit records {full['records']}")
    want = {k: n * accum * FIT_FULL_STEPS for k, n in per_microbatch(
        layers, True, pruned=False, joint=True).items()}
    check(full["launches"] == want, f"full-lattice fit launches {full['launches']}, expected {want}")
    # CMVN as shipped: the checkpoint's statistics are the tool's file's
    check(all(fit["cmvn"]["checkpoint_equal"].values()),
          f"the checkpoint's CMVN differs from {fit['cmvn']['path']}: "
          f"{fit['cmvn']['checkpoint_equal']}")
    # the eager dev set validates as the lazy one, with the same launches
    ev = fit["eager"]
    want = {**dict.fromkeys(kernel_wrappers(), 0), "rel_flash_attention": layers * ev["batches"],
            "conv_block": layers * ev["batches"]}
    check(np.isfinite(ev["lazy"]["wer"]) and ev["eager"]["wer"] == ev["lazy"]["wer"]
          and ev["lazy"]["launches"] == ev["eager"]["launches"] == want,
          f"eager validation {ev['eager']} against lazy {ev['lazy']}, launches expected {want}")
    # the MFCC run: its steps, finite, no validation, its launches
    mfcc = fit["mfcc"]
    recs = [r for r in mfcc["records"] if "train_loss" in r]
    check([r["step"] for r in recs] == list(range(1, FIT_MFCC_STEPS + 1))
          and all(np.isfinite(r["train_loss"]) and np.isfinite(r["train_grad_norm"]) for r in recs)
          and not any("valid_wer" in r for r in mfcc["records"]),
          f"MFCC fit records {mfcc['records']}")
    want = {k: n * accum * FIT_MFCC_STEPS for k, n in per_microbatch(layers, True).items()}
    check(mfcc["launches"] == want, f"MFCC fit launches {mfcc['launches']}, expected {want}")


# ------------------------------------------------------------ WeNet import


def reference_state_dict(params: dict, model_cfg) -> dict:
    """The params tree (the JAX layout) as a reference / WeNet
    ``state_dict``: the inverse of ``train/checkpoint.import_torch_checkpoint``
    (linear weights [out, in], Conv2d [O, I, kh, kw], Conv1d [O, I, K], one
    tensor per encoder layer, LSTM weights per layer, BatchNorm running
    statistics where the tree has them). CMVN, ``pos_table`` and the
    pruned loss's projections have no key there."""
    import torch

    sd = {}

    def put(key, t):
        sd[key] = t.detach().float().cpu().contiguous()

    def linear(prefix, p):
        put(prefix + ".weight", p["kernel"].T)
        if "bias" in p:
            put(prefix + ".bias", p["bias"])

    def norm(prefix, p):
        put(prefix + ".weight", p["scale"])
        put(prefix + ".bias", p["bias"])
        if "mean" in p:
            put(prefix + ".running_mean", p["mean"])
            put(prefix + ".running_var", p["var"])
            sd[prefix + ".num_batches_tracked"] = torch.tensor(0)

    enc = params["encoder"]
    for i, name in ((0, "conv1"), (2, "conv2")):
        put(f"encoder.embed.conv.{i}.weight", enc["embed"][name]["kernel"].permute(3, 2, 0, 1))
        put(f"encoder.embed.conv.{i}.bias", enc["embed"][name]["bias"])
    linear("encoder.embed.out.0", enc["embed"]["out"])
    norm("encoder.after_norm", enc["after_norm"])
    lay = enc["layers"]

    def at(p, i):
        return {n: t[i] for n, t in p.items()}

    for i in range(model_cfg.encoder_num_layers):
        pre = f"encoder.encoders.{i}."
        for ffn in ("feed_forward", "feed_forward_macaron"):
            for w in ("w_1", "w_2"):
                linear(f"{pre}{ffn}.{w}", at(lay[ffn][w], i))
        attn = lay["self_attn"]
        for lin in ("linear_q", "linear_k", "linear_v", "linear_out", "linear_pos"):
            if lin in attn:
                linear(f"{pre}self_attn.{lin}", at(attn[lin], i))
        for bias in ("pos_bias_u", "pos_bias_v"):
            if bias in attn:
                put(f"{pre}self_attn.{bias}", attn[bias][i])
        conv = lay["conv_module"]
        for name in ("pointwise_conv1", "pointwise_conv2", "depthwise_conv"):
            put(f"{pre}conv_module.{name}.weight", conv[name]["kernel"][i].permute(2, 1, 0))
            put(f"{pre}conv_module.{name}.bias", conv[name]["bias"][i])
        norm(f"{pre}conv_module.norm", at(conv["norm"], i))
        for ln in ("norm_ff", "norm_ff_macaron", "norm_mha", "norm_conv", "norm_final"):
            norm(pre + ln, at(lay[ln], i))
    pred = params["predictor"]
    put("predictor.embed.weight", pred["embed"]["embedding"])
    for k, lp in enumerate(pred["rnn"]):
        put(f"predictor.rnn.weight_ih_l{k}", lp["w_ih"].T)
        put(f"predictor.rnn.weight_hh_l{k}", lp["w_hh"].T)
        put(f"predictor.rnn.bias_ih_l{k}", lp["b_ih"])
        put(f"predictor.rnn.bias_hh_l{k}", lp["b_hh"])
    linear("predictor.projection", pred["projection"])
    for name in ("enc_ffn", "pred_ffn", "ffn_out"):
        linear(f"joint.{name}", params["joint"][name])
    linear("ctc.ctc_lo", params["ctc"]["ctc_lo"])
    return sd


def wenet_phase(fit: dict) -> dict:
    """7b: the fit's last checkpoint written out as a reference-layout
    state dict (``reference_state_dict``, ``torch.save`` to ``.pt``);
    ``main --eval --wenet_ckpt_path`` on the fit corpus (its WER against
    the fit's ``--eval --resume``); a runner given the ``.pt`` against one
    given the checkpoint's tree on the serve phase's three requests (the
    counts set to 0 just before each request, read just after)."""
    import torch

    from conformer_tpu_torch.main import main as port_main
    from conformer_tpu_torch.serve.runner import ModelRunner
    from conformer_tpu_torch.train import checkpoint as ckpt_mod

    t0 = time.perf_counter()
    cfg = fit["cfg"]
    ckpt = ckpt_mod.latest_checkpoint(cfg.train.checkpoint_dir)
    params = ckpt_mod.restore_checkpoint(ckpt)["params"]
    pt = os.path.join(FIT_DIR, "reference.pt")
    sd = reference_state_dict(params, cfg.model)
    torch.save(sd, pt)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port_main(["--eval", "--wenet_ckpt_path", pt, *fit["eval_args"]])
    wer = [float(line.split()[-1]) for line in out.getvalue().splitlines()
           if line.startswith("WER:")]
    texts = {}
    for name, weights in (("pt", pt), ("tree", params)):
        runner = ModelRunner(cfg, weights, device="cuda")
        texts[name] = serve_requests(runner)
        del runner
    torch.cuda.empty_cache()
    return {"checkpoint": os.path.basename(ckpt), "eval_wer": wer, "requests": texts,
            "keys": len(sd),
            "s": time.perf_counter() - t0}


def check_wenet(wn: dict, fit: dict, card: str) -> None:
    layers = fit["cfg"].model.encoder_num_layers
    want = {**dict.fromkeys(kernel_wrappers(), 0), "rel_flash_attention": layers,
            "conv_block": layers}
    print(f"wenet: {wn['keys']} reference keys from {wn['checkpoint']}; --eval "
          f"--wenet_ckpt_path WER {wn['eval_wer']}, --eval --resume WER {fit['eval_wer']}; "
          f"{wn['s']:.1f} s ({card})")
    check(len(wn["eval_wer"]) == 1 and wn["eval_wer"] == fit["eval_wer"],
          f"--wenet_ckpt_path WER {wn['eval_wer']} != --resume WER {fit['eval_wer']}")
    for a, b in zip(wn["requests"]["pt"], wn["requests"]["tree"]):
        ra, rb = a["response"], b["response"]
        print(f"wenet: {a['seconds']} s wav -> .pt runner {ra['status']} "
              f"{len(ra.get('message', '').split())} words, tree runner "
              f"{len(rb.get('message', '').split())} words, same {ra == rb}; launches "
              f"{nonzero(a['launches'])}")
        check(ra["status"] == "success" and ra == rb,
              f"the .pt runner answered {ra}, the checkpoint tree's {rb}")
        check(a["launches"] == want, f".pt runner launches {a['launches']}, expected {want}")


# ----------------------------------------------------------------- 7c. micro

MICRO_DIR = os.path.join(REPO, "build", "chip_smoke_micro")     # build/ is git-ignored
MICRO_FIXTURE = os.path.join(REPO, "tests", "fixtures", "micro_trained.npz")
MICRO_SAMPLES = 4            # recordings (the reference shipped four, about 33 s in all)
MICRO_SAMPLE_S = 8.0         # 64 segments of 0.5 s: the fixture's 24-entry vocab
MICRO_SEED = 900
MICRO_STEPS = 2              # (c): training steps of each path


def micro_script():
    """``scripts/torch_train_micro_wer.py`` as a module."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_train_micro_wer

    return torch_train_micro_wer


def stub_gradio():
    """A stand-in ``gradio`` module (the card machine has none) whose
    Blocks record the microphone's stream callback and the button's click
    callback in the returned dict."""
    import types

    got = {}

    class Component:
        def __init__(self, *a, **k):
            pass

    class Audio(Component):
        def stream(self, fn, inputs=None, outputs=None):
            got["stream"] = fn

    class Button(Component):
        def click(self, fn, inputs=None, outputs=None):
            got["click"] = fn

    class Blocks(Component):
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    mod = types.ModuleType("gradio")
    mod.Blocks, mod.Textbox, mod.Audio, mod.Button = Blocks, Component, Audio, Button
    return mod, got


def micro_sweeps(drv, meta: dict, dev) -> dict:
    """(b): the fixture through ``eval_decode_modes`` in float32, every
    mode: with the encoder kernel flags on; off with the decomposed
    relative bias (the kernel path's function: sinusoids of the relative
    positions); off as the script's config has it (the skew path reads the
    stored ``pos_table``, which in the fixture is not the sinusoid table
    the other two compute). The counts set to 0 just before each sweep and
    read just after."""
    from conformer_tpu_torch.train.checkpoint import load_params_npz

    params = load_params_npz(MICRO_FIXTURE, dev)
    base = drv.build_config(meta, os.path.join(MICRO_DIR, "exp"), pruned=True, steps=0)
    out = {}
    for path, flags in (("kernel", dict(use_pallas_attention=True, use_pallas_conv=True)),
                        ("plain", dict(rel_mode="decomposed")), ("skew", {})):
        cfg = dataclasses.replace(base)
        cfg.model = dataclasses.replace(base.model, **flags)
        details = {}
        reset_launch_counts()
        t0 = time.perf_counter()
        drv.eval_decode_modes(cfg, params, meta, details=details)
        out[path] = {"details": details, "launches": launch_counts(),
                     "s": time.perf_counter() - t0}
    return out


def micro_batches(cfg, n: int) -> list[dict]:
    """The first ``n`` batches of the micro corpus's train pipeline."""
    from conformer_tpu_torch.data.dataset import AsrDataset

    ds = AsrDataset(cfg.data, mode="train")
    ds.set_epoch(0)
    it = iter(ds)
    return [next(it) for _ in range(n)]


def micro_train(drv, meta: dict, dev) -> dict:
    """(c): ``MICRO_STEPS`` float32 training steps of the micro config with
    the pruned loss, dropout 0, from one init: a trainer with the recipe's
    kernel flags (RNN-T, CTC, attention) on and one with them off, on the
    same batches of the corpus. Each step: the kernel path's gradients
    (counts set to 0 just before, read just after), the plain path's on the
    kernel path's band (its own band's differing starts counted), their
    losses and gradients compared, then each trainer's Adam update with its
    own gradients."""
    import torch

    from conformer_tpu_torch.train.loop import Trainer

    base = drv.build_config(meta, os.path.join(MICRO_DIR, "exp"), pruned=True,
                            steps=MICRO_STEPS)
    base.model = dataclasses.replace(base.model, **dropout_model(0.0))
    trainers = {}
    for path, on in (("kernel", True), ("plain", False)):
        cfg = dataclasses.replace(base)
        cfg.model = dataclasses.replace(base.model, use_pallas_rnnt=on, use_pallas_ctc=on,
                                        use_pallas_attention=on)
        trainers[path] = Trainer(cfg, device=dev)
    launches = dict.fromkeys(kernel_wrappers(), 0)
    steps = []
    for mb in micro_batches(base, MICRO_STEPS):
        s_k = {}

        def record(orig, o, *a):
            s_k["band"] = orig(o, *a)
            return s_k["band"]

        def force(orig, o, *a):
            s_k["plain"] = orig(o, *a)
            return s_k["band"]

        reset_launch_counts()
        with band_hook(record):
            g_k, out_k = trainers["kernel"].compute_grads(mb, deterministic=True)
        torch.cuda.synchronize()
        for k, n in launch_counts().items():
            launches[k] += n
        with band_hook(force):
            g_p, out_p = trainers["plain"].compute_grads(mb, deterministic=True)
        res = loss_grad_errors(out_k, out_p, g_k, g_p, ("loss", "loss_ctc", "loss_rnnt",
                                                         "loss_simple"))
        res.update(s_begin_diff=int((s_k["plain"] != s_k["band"]).sum()),
                   s_begin_entries=int(s_k["band"].numel()), shape=tuple(s_k["band"].shape),
                   labels=int(np.shape(mb["labels"])[1]))
        for t, g in ((trainers["kernel"], g_k), (trainers["plain"], g_p)):
            t.optimizer.update(t.params, g, t.opt_state)
            t.step += 1
        steps.append(res)
    del trainers
    torch.cuda.empty_cache()
    return {"steps": steps, "launches": launches}


def micro_demo(drv, meta: dict, dev) -> dict:
    """(d): the Gradio demo's wiring (``serve/gradio_server.build_app`` with
    the stand-in module) on the fixture, both encoder kernel flags on: the
    longest eval wav streamed through the microphone callback in 640 ms
    int16 pieces (the counts set to 0 just before, read just after), then
    "Reset Model" and the first piece again; beside it a session driven
    with ``runner.accept_chunk`` directly."""
    from conformer_tpu_torch.data.audio import load_audio
    from conformer_tpu_torch.serve import gradio_server
    from conformer_tpu_torch.serve.runner import ModelRunner

    cfg = drv.build_config(meta, os.path.join(MICRO_DIR, "exp"), pruned=True, steps=0)
    cfg.model = dataclasses.replace(cfg.model, use_pallas_attention=True, use_pallas_conv=True)
    runner = ModelRunner(cfg, MICRO_FIXTURE, dev)
    mod, got = stub_gradio()
    saved = sys.modules.get("gradio")
    sys.modules["gradio"] = mod
    try:
        gradio_server.build_app(runner)
    finally:
        if saved is None:
            del sys.modules["gradio"]
        else:
            sys.modules["gradio"] = saved
    with open(meta["eval_list"]) as f:
        path = max((json.loads(line)["wav_path"] for line in f), key=os.path.getsize)
    wav, sr = load_audio(path)
    n = sr * STREAM_PIECE_MS // 1000
    pcm = np.round(wav * 32767.0).astype(np.int16)
    pieces = [pcm[i:i + n] for i in range(0, len(pcm), n)]
    reset_launch_counts()
    demo = [got["stream"]((sr, p)) for p in pieces]
    launches = launch_counts()
    session, direct = runner.new_session(), []
    for p in pieces:
        session, rec = runner.accept_chunk(session, p.astype(np.float32) / 32768.0, sr)
        direct.append(rec.text)
    reset = got["click"]()
    return {"demo": demo, "direct": direct, "reset": reset,
            "after_reset": got["stream"]((sr, pieces[0])), "launches": launches,
            "seconds": len(wav) / sr, "none": got["stream"](None)}


def check_micro_kernels(dev, eval_shape: tuple, train_shape: tuple, v: int,
                        heads: int, dk: int, d: int, kernel_size: int) -> dict:
    """The kernels of the micro paths at the shapes those paths gave them,
    float32, against their plain versions (outputs poisoned with NaN
    first): the attention forward and the conv block at the sweep's
    encoder shape (B, T') = ``eval_shape``; the attention kernels of
    training (dropout 0) and the six loss kernels at the training shape
    (B, T', U) = ``train_shape``, V = ``v``. Times of kernel, plain version
    and library call (SDPA) beside the bound. Returns a list of entries,
    each with the kernel's ``name`` and its ``shape``."""
    import torch

    from conformer_tpu_torch.ops import rel_attention as ra
    from conformer_tpu_torch.ops.conv_block import conv_block, conv_block_plain

    gen = torch.Generator().manual_seed(21)
    scale = 1 / math.sqrt(dk)
    out = []
    for label, (b, t), kinds in (("sweep", eval_shape, ATTENTION_KERNELS[:1]),
                                 ("training", train_shape[:2], ATTENTION_KERNELS)):
        args, seed, g = attention_train_inputs(dev, torch.float32, gen, b, t, dk=dk, d=d,
                                               h=heads)
        kw = dict(scale=scale, dropout_rate=0.0)
        poison(((b, heads, t, dk), torch.float32), ((b, heads, t), torch.float32))
        fwd = ra.rel_attention(*args, seed=seed, **kw)
        want = ra.rel_attention_plain(*args, seed=seed, **kw)
        errs = {"rel_flash_attention": compare(f"micro rel_flash_attention at {label}", fwd,
                                               want)}
        bargs = (*args, seed, g, want[1], (g.float() * want[0].float()).sum(dim=-1))
        plain = ra.rel_attention_bwd_plain(*bargs, **kw)
        poison(((b, heads, t, dk), torch.float32), ((b, heads, t, d), torch.float32))
        errs["rel_flash_attention_bwd_dq"] = compare(
            f"micro rel_flash_attention_bwd_dq at {label}", ra.rel_attention_bwd_dq(*bargs, **kw),
            plain[:2])
        poison(((b, heads, t, dk), torch.float32), ((b, heads, t, dk), torch.float32))
        errs["rel_flash_attention_bwd_dkv"] = compare(
            f"micro rel_flash_attention_bwd_dkv at {label}",
            ra.rel_attention_bwd_dkv(*bargs, **kw), plain[2:])
        times = attention_train_times(dev, gen, b, t, h=heads, dk=dk, d=d, dropout=0.0,
                                      inputs=(args, seed, g), label=f"micro {label} B={b} T'={t}")
        out += [{**times[name], "name": name, "max_abs_err": errs[name],
                 "shape": f"{label}, B={b} T'={t}"} for name in kinds]
    b, t = eval_shape
    x, lens, p_norm, p_conv = conv_inputs(dev, torch.float32, gen, b=b, t=t, d=d, k=kernel_size)
    poison(((b, t, d), torch.float32))
    got = conv_block(x, lens, p_norm, p_conv, kernel_size=kernel_size)
    want = conv_block_plain(x, lens, p_norm, p_conv, kernel_size=kernel_size)
    out.append({**conv_block_times(x, lens, p_norm, p_conv, kernel_size),
                "max_abs_err": compare("micro conv_block", got, want),
                "shape": f"sweep, B={b} T'={t}"})
    b, t, u = train_shape
    out += [{**e, "shape": f"training, B={b} T'={t} U={u} V={v}"} for e in check_training_kernels(
        dev, shapes=((b, t, u, v),), simple_long=(), guard=False).values()]
    for e in out:
        print(f"micro: kernel {e['name']} f32 {e['shape']}: max_abs_err {e['max_abs_err']:.3g} (tol "
              f"{TOL['float32']} abs + rel), kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} "
              f"ms, library {e['library_ms']} ms, bound {e['bound_ms'] * 1e3:.2f} us "
              f"({e['bound_by']})")
    return out


def micro_phase(dev, card: str) -> dict:
    """7c: (a) the micro corpus from seeded recordings, (b) the decode
    sweep on the trained fixture, kernel path vs plain path, (c) two
    training steps, kernel path vs plain path, (d) the Gradio demo's
    wiring, and the kernels at the shapes (b)-(c) gave them. Returns the
    launches of the kernel paths of (b)-(d), and the kernels' entries."""
    import torch

    from conformer_tpu_torch.data.synthetic import write_recordings
    from conformer_tpu_torch.tools.make_micro_corpus import build_micro_corpus

    t_phase = time.perf_counter()
    drv = micro_script()
    shutil.rmtree(MICRO_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    samples = write_recordings(os.path.join(MICRO_DIR, "samples"), MICRO_SAMPLES,
                               MICRO_SAMPLE_S, MICRO_SEED)
    meta = build_micro_corpus(os.path.join(MICRO_DIR, "corpus"), samples)
    print(f"micro: (a) corpus from {MICRO_SAMPLES} recordings of {MICRO_SAMPLE_S} s: "
          f"{meta['n_segments']} segments, {meta['n_train']} train and {meta['n_eval']} eval "
          f"utterances, vocab {meta['vocab_size']}; {time.perf_counter() - t0:.1f} s")
    with np.load(MICRO_FIXTURE) as fx:
        v_fixture = fx["joint/ffn_out/kernel"].shape[-1]
    check(meta["vocab_size"] == v_fixture, f"micro corpus vocab {meta['vocab_size']}, the "
          f"fixture's {v_fixture}")

    sw = micro_sweeps(drv, meta, dev)
    k_det, p_det, s_det = (sw[k]["details"] for k in ("kernel", "plain", "skew"))
    m = drv.build_config(meta, "", pruned=True, steps=0).model
    layers = m.encoder_num_layers
    batches = -(-meta["n_eval"] // 16)
    for mode, k in k_det.items():
        p, sk = p_det[mode], s_det[mode]
        same = sum(a == b for a, b in zip(k["hyps"], sk["hyps"]))
        print(f"micro: (b) {mode}: {k['tokens']} tokens, WER {k['wer']:.4f} (a corpus the "
              f"fixture never learned); plain path {p['tokens']} tokens, hypotheses identical "
              f"{k['hyps'] == p['hyps']}; skew path (the stored pos_table) {sk['tokens']} "
              f"tokens, WER {sk['wer']:.4f}, {same}/{len(k['hyps'])} hypotheses as the "
              "kernel path's")
        check(k["hyps"] == p["hyps"], f"micro (b) {mode}: kernel path hypotheses differ from "
              "the plain path's")
        check(k["tokens"] > 0 and sk["tokens"] > 0, f"micro (b) {mode}: no token emitted")
    want = {**dict.fromkeys(kernel_wrappers(), 0),
            **dict.fromkeys(("rel_flash_attention", "conv_block"), layers * batches * len(k_det))}
    print(f"micro: (b) 10 modes over {meta['n_eval']} utterances in {sw['kernel']['s']:.1f} s "
          f"(plain path {sw['plain']['s']:.1f} s, skew path {sw['skew']['s']:.1f} s); launches "
          f"{nonzero(sw['kernel']['launches'])} ({card})")
    check(len(k_det) == 10 and sw["kernel"]["launches"] == want,
          f"micro (b): launches {sw['kernel']['launches']}, expected {want}")
    check(not any(sw["plain"]["launches"].values()) and not any(sw["skew"]["launches"].values()),
          f"micro (b): the plain paths launched {nonzero(sw['plain']['launches'])}, "
          f"{nonzero(sw['skew']['launches'])}")

    tr = micro_train(drv, meta, dev)
    for i, r in enumerate(tr["steps"]):
        worst = ", ".join(f"{k} {e:.3g}" for k, e in r["grad_worst_leaves"])
        print(f"micro: (c) step {i + 1}, B x T' {r['shape']}, U {r['labels']}: losses "
              f"{r['losses']}, max rel err {r['loss_max_rel_err']:.3g} (tol 1e-4); gradients "
              f"worst leaves {worst} (tol 1e-3 of max-abs); s_begin differs in "
              f"{r['s_begin_diff']} of {r['s_begin_entries']}")
        check(r["finite"] and r["loss_max_rel_err"] <= 1e-4 and r["grad_max_rel_err"] <= 1e-3,
              f"micro (c) step {i + 1}: the kernel path disagrees with the plain path")
        check(r["s_begin_diff"] <= BAND_LIMITS["s_begin_diff_share"] * r["s_begin_entries"],
              f"micro (c) step {i + 1}: the pruning bands differ in {r['s_begin_diff']} starts")
    want = {k: n * MICRO_STEPS for k, n in per_microbatch(layers, attention=True).items()}
    print(f"micro: (c) launches in {MICRO_STEPS} steps {nonzero(tr['launches'])}")
    check(tr["launches"] == want, f"micro (c): launches {tr['launches']}, expected {want}")

    demo = micro_demo(drv, meta, dev)
    print(f"micro: (d) Gradio demo (stand-in gradio), {demo['seconds']:.2f} s wav in "
          f"{len(demo['demo'])} pieces of {STREAM_PIECE_MS} ms: transcripts {demo['demo']}, "
          f"accept_chunk {demo['direct']} (lengths {[len(t) for t in demo['direct']]}); reset "
          f"{demo['reset']!r}, then {demo['after_reset']!r}; launches "
          f"{nonzero(demo['launches'])}")
    check(demo["demo"] == demo["direct"], "micro (d): the demo's transcripts differ from "
          "accept_chunk's")
    # a transcript that grows past its first piece's, so that a Reset which
    # kept the old session would show in the transcript after it
    check(demo["direct"][-1] != "" and demo["direct"][-1] != demo["direct"][0],
          f"micro (d): accept_chunk's transcripts {demo['direct']} do not grow from the first "
          "piece's, so the demo's and the Reset's checks cannot see a fault")
    check(demo["reset"] == "" and demo["none"] == "" and demo["after_reset"] == demo["direct"][0],
          "micro (d): Reset Model did not start a fresh session")
    attn = demo["launches"]["rel_flash_attention"]
    check(attn > 0 and attn % layers == 0 and demo["launches"] == {
        **dict.fromkeys(kernel_wrappers(), 0), "rel_flash_attention": attn},
        f"micro (d): launches {demo['launches']}")

    step = tr["steps"][0]
    eval_t = k_det["greedy_rnnt"]["enc_shape"]
    kernels = check_micro_kernels(dev, (eval_t[0], eval_t[1]),
                                  (*step["shape"], step["labels"]), m.vocab_size, m.num_heads,
                                  m.encoder_dim // m.num_heads, m.encoder_dim, m.kernel_size)
    launches = {k: sw["kernel"]["launches"][k] + tr["launches"][k] + demo["launches"][k]
                for k in kernel_wrappers()}
    shutil.rmtree(MICRO_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"micro: in {time.perf_counter() - t_phase:.1f} s ({card})")
    return {"launches": launches, "kernels": kernels}


# -------------------------------------------------------------- 8. parallel

PAR_SECONDS = 15.0
PAR_LOCAL_B = 8              # (b): each rank's rows; (c): the rows of the seq / pipe group
PAR_TIMEOUT = 420            # s, for one set of ranks, start to end
PAR_FIT_STEPS = 2            # (a): steps of the world-size-1 NCCL run through main
PAR_LABELS = 4               # (b)-(c): tokens a row; configs/conformer_m.json's prune_range is 5
PAR_ENC_TOL = 1e-3           # (c): encoder output, kernel path of the mesh vs of one process
PAR_LOSS_TOL, PAR_GRAD_TOL = 1e-4, 1e-3     # relative; gradients: of each leaf's max-abs
PAR_RANK_FLAG = "--parallel-rank"           # chip_smoke.py's own worker mode: one rank
GLOO_OPS = ("all_reduce", "all_gather", "broadcast")    # what the port's paths call
NEEDS = {"data": ("all_reduce",), "seq": ("all_reduce", "all_gather"),
         "pipe": ("all_reduce", "all_gather", "broadcast")}
# (d): the attention kernels at the sequence-parallel shape, seq 2 at T' =
# 374: rank 1's 187 queries at positions 187-373 against all 374 keys
SEQ_SHAPE = dict(b=32, h=4, dk=64, d=256, tq=187, q0=187, tk=374)
# (e4): at the head-shard shape, model 2: rank 1's heads 2-3 of 4
HEAD_SHAPE = dict(b=32, h=2, dk=64, d=256, tq=374, q0=0, tk=374, h_total=4, h_offset=2)
NEEDS["model"] = ("all_reduce", "all_gather")
PAR_LAYERS = 6               # (b)-(c): Conformer-M's widths, its depth cut to fit the limit
PAR_MODEL_LAYERS = 6         # (e1), (e3): Conformer-M's widths, its depth cut to fit the limit
PAR_SEQ_MODEL_LAYERS = 4     # (e2)
PAR_DROPOUT = 0.1            # (e1): every dropout of the model in the dropout step


def parallel_config(model: dict | None = None, **train):
    """configs/conformer_m.json at full width in float32 with both kernel
    flags on and dropout and the dynamic chunk off (parity is checked
    deterministic); ``model`` sets ModelConfig fields over that, ``train``
    TrainConfig fields."""
    cfg = recipe_config(os.path.join(REPO, "configs", "conformer_m.json"))
    m = cfg.model
    m.compute_dtype, m.use_pallas_attention, m.use_pallas_conv = "float32", True, True
    m.dropout = m.attention_dropout = m.pos_enc_dropout = 0.0
    m.predictor_embed_dropout = m.predictor_dropout = 0.0
    m.use_dynamic_chunk = m.use_dynamic_left_chunk = False
    for k, v in (model or {}).items():
        setattr(m, k, v)
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def dropout_model(rate: float) -> dict:
    """ModelConfig fields setting every dropout of the model to ``rate``."""
    return dict.fromkeys(("dropout", "attention_dropout", "pos_enc_dropout",
                          "predictor_embed_dropout", "predictor_dropout"), rate)


def parallel_batch(cfg, seed: int, rows: int) -> dict:
    """``rows`` x 15 s of ragged lengths (full down to 60 %) with labels of
    PAR_LABELS tokens: U + 1 <= prune_range, so that the pruned loss's band
    covers every label and no band start can flip on an argmax near-tie
    between the mesh and one process (phase 6 holds the band itself)."""
    frames = [int(PAR_SECONDS * 100 * f) for f in np.linspace(1.0, 0.6, rows)]
    return random_batch(cfg, seed, rows, PAR_SECONDS, labels=PAR_LABELS, feat_frames=frames)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(kind: str, world: int, out: str, **spec) -> subprocess.Popen:
    """Start ``world`` ranks of this script in its worker mode on the one
    card (gloo), on a free port; their output goes to ``out.rank<r>.log``."""
    port = free_port()
    procs = []
    for rank in range(world):
        s = {"kind": kind, "world": world, "rank": rank, "port": port, "out": out, **spec}
        log = open(f"{out}.rank{rank}.log", "w")
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                        PAR_RANK_FLAG, json.dumps(s)], cwd=REPO, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return procs


def wait_ranks(procs, timeout: float = PAR_TIMEOUT) -> list[dict | None]:
    """Each rank's result (None for a rank that failed or ran out of time;
    every process is ended here)."""
    deadline = time.monotonic() + timeout
    results = []
    for rank, (proc, log) in enumerate(procs):
        try:
            proc.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        res_path = log.name.replace(".log", ".json")
        if proc.returncode == 0 and os.path.exists(res_path):
            with open(res_path) as f:
                results.append(json.load(f))
        else:
            with open(log.name) as f:
                tail = f.read()[-2000:]
            print(f"parallel: rank {rank} of {log.name} exited {proc.returncode}:\n{tail}")
            results.append(None)
    return results


def parallel_rank(spec: dict) -> int:
    """One rank of phase 8: joins a gloo group on cuda:0 and runs
    ``spec["kind"]``; writes its result to ``<out>.rank<r>.json``."""
    import torch

    sys.path.insert(0, REPO)
    from conformer_tpu_torch.parallel import distributed as pdist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pdist.maybe_initialize_distributed(f"127.0.0.1:{spec['port']}", spec["world"],
                                       spec["rank"], device="cuda:0", backend="gloo")
    try:
        res = (probe_rank if spec["kind"] == "probe" else train_rank)(spec)
    finally:
        pdist.destroy()
    with open(f"{spec['out']}.rank{spec['rank']}.json", "w") as f:
        json.dump(res, f)
    return 0


def probe_rank(spec: dict) -> dict:
    """Which of ``spec["ops"]`` gloo takes on CUDA tensors, each checked
    for the right values: {op: "ok" | "wrong values" | "refused: ..."}."""
    import torch
    import torch.distributed as dist

    r, n = spec["rank"], spec["world"]
    res = {}
    for op in spec["ops"]:
        x = torch.full((1024,), float(r + 1), device="cuda")
        try:
            if op == "all_reduce":
                dist.all_reduce(x)
                good = bool((x == n * (n + 1) / 2).all())
            elif op == "all_gather":
                parts = [torch.empty_like(x) for _ in range(n)]
                dist.all_gather(parts, x)
                good = all(bool((p == i + 1).all()) for i, p in enumerate(parts))
            elif op == "broadcast":
                dist.broadcast(x, src=0)
                good = bool((x == 1).all())
            else:           # send_recv: rank 0 to rank 1
                if r == 0:
                    dist.send(x, dst=1)
                    good = True
                else:
                    dist.recv(x, src=0)
                    good = bool((x == 1).all())
            torch.cuda.synchronize()
            res[op] = "ok" if good else "wrong values"
        except RuntimeError as e:       # gloo refuses the device or the op
            res[op] = f"refused: {str(e).splitlines()[0][:160]}"
    return res


def train_rank(spec: dict) -> dict:
    """``train_run`` of the spec or, with ``runs``, of each run in turn in
    this process (a run's keys over the spec's, its files ``<out>_<name>``),
    the results by run name."""
    import torch

    if "runs" not in spec:
        return train_run(spec)
    res = {}
    for run in spec["runs"]:
        res[run["name"]] = train_run({**spec, **run, "out": f"{spec['out']}_{run['name']}"})
        torch.cuda.empty_cache()
    return res


def train_run(spec: dict) -> dict:
    """(b)-(c), (e) on this rank: a ``Trainer`` over the mesh of
    ``spec["train"]`` (``spec["model"]``'s model fields set) on its rows of
    the seeded global batch; with ``forward``, the deterministic encoder
    forward (both kernel flags) and the step's reduced gradients with the
    ms of its ``all_reduce`` phase, both after a warm-up step; counts set to
    0 before each, read after. Under a model axis one more step with the
    model axis's collectives clocked (``ModelShard.clock``). Rank 0 writes the output
    and the whole gradients (a pipeline's stages and the model axis's
    shards gathered) to ``<out>.npz``."""
    import torch

    from conformer_tpu_torch.parallel import distributed as pdist
    from conformer_tpu_torch.train.loop import Trainer

    cfg = parallel_config(spec.get("model"), **spec["train"])
    tr = Trainer(cfg, device="cuda:0")
    rows = spec["rows"][spec["rank"]]
    mb = {k: v[rows[0]:rows[1]] for k, v in parallel_batch(cfg, spec["seed"],
                                                            spec["global_rows"]).items()}
    res, save = {}, {}
    tr.step_grads([mb])             # a warm-up: the rank's first launches and allocations
    if spec.get("forward"):
        b = tr._batch(mb)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out, _ = tr.encoder_fn(tr.params["encoder"], b["feats"], b["feat_lengths"],
                                   cfg.model, cmvn=tr.params.get("cmvn"), deterministic=True)
        torch.cuda.synchronize()
        res["fwd_ms"] = (time.perf_counter() - t0) * 1e3
        res["fwd_launches"] = launch_counts()
        save["out"] = out.float().cpu().numpy()
    marks = []      # (phase, its end): the trainer's phases, each closed by a sync
    tr.phase_end = lambda name: (torch.cuda.synchronize(),
                                 marks.append((name, time.perf_counter())))
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads, metrics, norm = tr.step_grads([mb])
    torch.cuda.synchronize()
    res["step_ms"] = (time.perf_counter() - t0) * 1e3
    res["launches"] = launch_counts()
    check(marks[-1][0] == "all_reduce", f"the step's last phase is {marks[-1][0]}")
    res["all_reduce_ms"] = (marks[-1][1] - marks[-2][1]) * 1e3
    res["metrics"] = metrics.tolist()
    res["norm"] = float(norm)
    host = pdist.gather_tree_to_host(grads, tr.mesh)
    if spec["rank"] == 0:
        np.savez(spec["out"] + ".npz", **save, **{f"g:{k}": v for k, v in host.items()})
    if tr.model_shard is not None:
        del grads, host
        clock = tr.model_shard.clock = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.step_grads([mb])
        torch.cuda.synchronize()
        res["clocked_ms"] = (time.perf_counter() - t0) * 1e3
        res["collective_ms"], res["collectives"] = sum(clock), len(clock)
    del tr
    return res


def mesh_parity(kind: str, results: list, out: str, ref: dict, layers: int, card: str,
                pruned: bool = True, joint: bool = False) -> dict:
    """(b)-(c), (e): every rank ran and launched the path's kernels; the
    step's losses and gradients (and, with a forward, the encoder output)
    against the one-process ``ref`` on the same rows."""
    import torch

    check(all(r is not None for r in results), f"parallel {kind}: a rank failed")
    want = per_microbatch(layers, True, pruned=pruned, joint=joint)
    if joint:
        # the joint's grids as one process launched them on the same rows:
        # float32 takes its wide route, whose grids grow with the chunks of cells
        want.update({k: ref["launches"][k] for k in JOINT_GRIDS})
        check(all(want[k] >= n for k, n in JOINT_GRIDS.items()),
              f"parallel {kind}: one process launched the joint's grids {want}")
    for r, res in enumerate(results):
        check(res["launches"] == want, f"parallel {kind}: rank {r} launched {res['launches']} "
              f"in its step, expected {want}")
        if "fwd_launches" in res:
            fwd = {**dict.fromkeys(want, 0), "rel_flash_attention": layers, "conv_block": layers}
            check(res["fwd_launches"] == fwd, f"parallel {kind}: rank {r} launched "
                  f"{res['fwd_launches']} in its forward, expected {fwd}")
    z = np.load(out + ".npz")
    g_k = {k[2:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("g:")}
    check(set(g_k) == set(ref["grads"]), f"parallel {kind}: gradient leaves differ")
    err = loss_grad_errors({"loss": torch.tensor(results[0]["metrics"][0])},
                           {"loss": torch.tensor(ref["loss"])}, g_k, ref["grads"], ("loss",))
    res = {"loss_rel": err["loss_max_rel_err"], "grad_rel": err["grad_max_rel_err"],
           "worst": err["grad_worst_leaves"], "finite": err["finite"],
           "step_ms": [r["step_ms"] for r in results], "launches": results[0]["launches"],
           "all_reduce_ms": [r["all_reduce_ms"] for r in results], "one_ms": ref["step_ms"]}
    worst = ", ".join(f"{k} {e:.3g}" for k, e in err["grad_worst_leaves"])
    line = (f"parallel {kind}: {len(results)} ranks on one card over gloo vs one process, "
            f"f32: loss "
            f"{results[0]['metrics'][0]:.6f} vs {ref['loss']:.6f} (rel {res['loss_rel']:.3g}, "
            f"tol {PAR_LOSS_TOL}), gradients max err / max-abs, worst leaves: {worst} (tol "
            f"{PAR_GRAD_TOL}); the second step's ms by rank (the ranks sharing the card) "
            f"{[round(x, 1) for x in res['step_ms']]} against one process's {ref['step_ms']:.1f} "
            f"on the mesh's global rows, of "
            f"which the step's all-reduce {[round(x, 1) for x in res['all_reduce_ms']]} "
            f"({max(a / t for a, t in zip(res['all_reduce_ms'], res['step_ms'])):.1%} at most)")
    if "out" in z.files:
        res["enc_err"] = float(np.abs(z["out"] - ref["out"]).max())
        res["fwd_ms"] = [r["fwd_ms"] for r in results]
        line += (f"; deterministic encoder output max_abs_err {res['enc_err']:.3g} (tol "
                 f"{PAR_ENC_TOL}), forward ms by rank {[round(x, 1) for x in res['fwd_ms']]}")
        check(res["enc_err"] <= PAR_ENC_TOL, f"parallel {kind}: encoder output disagrees")
    if "collective_ms" in results[0]:
        res["collective_ms"] = [r["collective_ms"] for r in results]
        res["clocked_ms"] = [r["clocked_ms"] for r in results]
        res["collectives"] = results[0]["collectives"]
        line += (f"; a third step with each of the model axis's {res['collectives']} "
                 "collectives between two syncs: its ms by rank "
                 f"{[round(x, 1) for x in res['clocked_ms']]}, of which those collectives "
                 f"(gloo, host-staged, ranks sharing the card) "
                 f"{[round(x, 1) for x in res['collective_ms']]} ("
                 f"{max(c / t for c, t in zip(res['collective_ms'], res['clocked_ms'])):.1%} "
                 "at most)")
    print(f"{line} ({card})")
    check(res["finite"] and res["loss_rel"] <= PAR_LOSS_TOL and res["grad_rel"] <= PAR_GRAD_TOL,
          f"parallel {kind}: the mesh's step disagrees with one process")
    return res


def one_process_reference(cfg, mb: dict, forward: bool) -> dict:
    """The step's loss, gradients and launches (and the deterministic
    encoder output) of one process on ``mb``."""
    import torch

    from conformer_tpu_torch.train.loop import Trainer

    tr = Trainer(cfg, device="cuda")
    ref = {}
    if forward:
        b = tr._batch(mb)
        with torch.no_grad():
            out, _ = tr.encoder_fn(tr.params["encoder"], b["feats"], b["feat_lengths"],
                                   cfg.model, cmvn=tr.params.get("cmvn"), deterministic=True)
        ref["out"] = out.float().cpu().numpy()
    tr.step_grads([mb])             # a warm-up, as each rank has
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    grads, metrics, _ = tr.step_grads([mb])
    torch.cuda.synchronize()
    ref["step_ms"] = (time.perf_counter() - t0) * 1e3
    ref["launches"] = launch_counts()
    ref["grads"] = {k: g.detach().cpu() for k, g in grads.items()}
    ref["loss"] = float(metrics[0])
    del tr
    torch.cuda.empty_cache()
    return ref


def nccl_fit(fit: dict) -> dict:
    """(a): ``main --train`` with ``--coordinator 127.0.0.1:<port>
    --num_processes 1 --process_id 0`` (NCCL's init on this card, then the
    one-process step: no collective runs at world size 1) on the fit
    corpus and config, PAR_FIT_STEPS steps, no validation; counts set to 0
    just before and read just after."""
    import torch

    from conformer_tpu_torch.main import main as port_main

    ckpt = os.path.join(FIT_DIR, "ckpt_nccl")
    cfg = fit["cfg"]
    path = os.path.join(FIT_DIR, "nccl.json")
    with open(path, "w") as f:
        f.write(cfg.to_json())
    reset_launch_counts()
    t0 = time.perf_counter()
    port_main(["--train", "--config", path, "--coordinator", f"127.0.0.1:{free_port()}",
               "--num_processes", "1", "--process_id", "0", "--set",
               f"train.checkpoint_dir={ckpt}", f"train.max_steps={PAR_FIT_STEPS}",
               "train.num_sanity_val_steps=0", "train.val_check_interval=1000000",
               "train.log_every=1"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    import torch.distributed as dist

    check(not dist.is_initialized(), "main left its process group behind")
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if "train_loss" in line]
    return {"records": recs, "launches": launches, "s": run_s, "names": sorted(os.listdir(ckpt))}


def check_attention_at(dev, s: dict, part: str, where: str, seed: int) -> dict:
    """The three attention kernels at shape ``s`` (the bias factors from
    ``rel_features`` at its query positions, the rows of a padded
    full-context mask, one dead row; with ``h_total``, a model rank's
    heads [h_offset, h_offset + h) of h_total, then also held bit for bit
    to those heads of the whole attention's kernels) in float32 and
    bfloat16 with dropout 0.1, outputs poisoned with NaN first, against
    the plain versions: elementwise within TOL, but at a model rank's heads
    the bf16 gradients, sums over 374 rounded terms, within TOL of their
    max-abs (``compare_sums``; the elements past the elementwise rule are
    counted and printed); times in bf16 beside SDPA's. Returns {"errs",
    "times"}."""
    import torch

    from conformer_tpu_torch.models.attention import rel_features
    from conformer_tpu_torch.ops import rel_attention as ra

    b, h, dk, d, tq, q0, tk = (s[k] for k in ("b", "h", "dk", "d", "tq", "q0", "tk"))
    heads = {k: s[k] for k in ("h_total", "h_offset") if k in s}
    hw = heads.get("h_total", h)            # the heads the inputs are drawn for
    gen = torch.Generator().manual_seed(seed)
    scale = 1 / math.sqrt(dk)
    lens = torch.randint(tk // 2, tk + 1, (b,), generator=gen)
    lens[:3] = torch.tensor([tk, q0 + 5, 1])
    mask = (torch.arange(tk)[None, None, :] < lens[:, None, None]).expand(b, tq, tk).clone()
    mask[1, 7, :] = False
    errs = dict.fromkeys(ATTENTION_KERNELS, 0.0)
    kw = dict(scale=scale, dropout_rate=ATTN_RATE, **heads)
    made = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        q_u, q_v, k, v, g = (torch.randn(b, hw, n, dk, generator=gen)
                             for n in (tq, tq, tk, tk, tq))
        w = 0.05 * torch.randn(d, hw * dk, generator=gen)
        ab, feats = rel_features({"linear_pos": {"kernel": w}}, q_v, q0 + torch.arange(tq),
                                 torch.arange(tk), hw)
        whole = (*[x.to(dev, dtype).contiguous() for x in (q_u, ab, k, v, feats)], mask.to(dev))
        if heads:           # this rank's heads of the whole attention's inputs
            lo = heads["h_offset"]
            q_u, ab, k, v, g = (x[:, lo:lo + h] for x in (q_u, ab, k, v, g))
        args = (*[x.to(dev, dtype).contiguous() for x in (q_u, ab, k, v, feats)], mask.to(dev))
        seed = torch.tensor([ATTN_SEED], dtype=torch.int32, device=dev)
        g = g.to(dev, dtype).contiguous()
        made[name] = (args, seed, g)
        poison(((b, h, tq, dk), dtype), ((b, h, tq), torch.float32))
        got = ra.rel_attention(*args, seed=seed, **kw)
        same = ""
        if heads:       # the same heads of the whole attention, through the same kernels
            lo = heads["h_offset"]
            p_b = (*args, seed, g, got[1], (g.float() * got[0].float()).sum(dim=-1))
            mine = (*got, *ra.rel_attention_bwd_dq(*p_b, **kw),
                    *ra.rel_attention_bwd_dkv(*p_b, **kw))
            w_out = ra.rel_attention(*whole, seed=seed, scale=scale, dropout_rate=ATTN_RATE)
            g_w = torch.zeros_like(whole[0])
            g_w[:, lo:lo + h] = g
            w_delta = (g_w.float() * w_out[0].float()).sum(dim=-1)
            wb = (*whole, seed, g_w, w_out[1], w_delta)
            wkw = dict(scale=scale, dropout_rate=ATTN_RATE)
            w_all = (*w_out, *ra.rel_attention_bwd_dq(*wb, **wkw),
                     *ra.rel_attention_bwd_dkv(*wb, **wkw))
            equal = all(torch.equal(x, y[:, lo:lo + h]) for x, y in zip(mine, w_all))
            check(equal, f"attention {name} at heads {lo}-{lo + h - 1} of {hw}: the kernels "
                  "differ from those heads of the whole attention's")
            same = (f"; bit for bit heads {lo}-{lo + h - 1} of the whole {hw}-head attention's "
                    "kernels (fwd, lse, dQu, dAB, dK, dV)")
        want = ra.rel_attention_plain(*args, seed=seed, **kw)
        tol = TOL[name]
        e_f = compare(f"rel_flash_attention {name} at {where}", got, want, tol)
        delta = (g.float() * want[0].float()).sum(dim=-1)
        bargs = (*args, seed, g, want[1], delta)
        poison(((b, h, tq, dk), torch.float32), ((b, h, tq, d), torch.float32))
        dq = ra.rel_attention_bwd_dq(*bargs, **kw)
        poison(((b, h, tk, dk), torch.float32), ((b, h, tk, dk), torch.float32))
        dkv = ra.rel_attention_bwd_dkv(*bargs, **kw)
        plain = ra.rel_attention_bwd_plain(*bargs, **kw)
        rule = compare_sums if heads and dtype == torch.bfloat16 else compare
        e_q = rule(f"rel_flash_attention_bwd_dq {name} at {where}", dq, plain[:2], tol)
        e_kv = rule(f"rel_flash_attention_bwd_dkv {name} at {where}", dkv, plain[2:], tol)
        past = sum(int((x.float() - y.float()).abs().gt(tol + tol * y.float().abs()).sum())
                   for x, y in zip((*dq, *dkv), plain))
        if rule is compare_sums:
            same += (f"; gradients within {tol} of each one's max-abs, {past} element(s) past "
                     f"{tol} abs + rel")
        for kname, e in zip(ATTENTION_KERNELS, (e_f, e_q, e_kv)):
            errs[kname] = max(errs[kname], e)
        print(f"parallel ({part}): attention {name} at {where} B={b} H={h} "
              f"{'of ' + str(hw) + ' from head ' + str(heads['h_offset']) + ' ' if heads else ''}"
              f"Tq={tq} (positions {q0}-{q0 + tq - 1}) Tk={tk} D={d}, dropout {ATTN_RATE}: "
              f"max_abs_err fwd {e_f:.3g}, dq/dAB {e_q:.3g}, dK/dV {e_kv:.3g} (tol {tol} abs + "
              f"rel), outputs poisoned with NaN first{same}")
    times = attention_train_times(dev, gen, b, tk, h=h, dk=dk, d=d, inputs=made["bfloat16"],
                                  label=f"at {where} B={b} Tq={tq} Tk={tk}", heads=heads)
    return {"errs": errs, "times": times}


def parallel_phase(fit: dict, dev, layers: int, card: str) -> dict:
    """Phase 8: (a) ``nccl_fit``; gloo's collectives on CUDA tensors; (b)
    data parallelism and (c) sequence and pipeline parallelism, 2 ranks on
    this card over gloo, against one process; (d) ``check_attention_at``
    the sequence-parallel shape; (e) ``model_axis_phase`` and the
    attention at the head-shard shape."""
    import torch

    res = {}
    # (a) NCCL's init and the one-process step through the user's entry
    # point, beside the fit's steps
    a = nccl_fit(fit)
    fit_steps = [r for r in fit["records"] if "train_loss" in r][:PAR_FIT_STEPS]
    for r, f in zip(a["records"], fit_steps):
        print(f"parallel (a): NCCL init and the one-process step through main (world size "
              f"1, no collective), step {r['step']}: "
              f"{r['train_step_s'] * 1e3:.1f} ms, loss {r['train_loss']:.6f}; the one-process "
              f"fit's step {f['step']}: {f['train_step_s'] * 1e3:.1f} ms, loss "
              f"{f['train_loss']:.6f} ({card})")
    accum = fit["cfg"].train.accum_grad
    want = {k: n * accum * PAR_FIT_STEPS for k, n in per_microbatch(
        layers, True, pruned=fit["cfg"].model.use_pruned_loss).items()}
    print(f"parallel (a): {a['s']:.1f} s, checkpoints {a['names']}, launches {a['launches']}")
    check(len(a["records"]) == PAR_FIT_STEPS and a["launches"] == want
          and all(abs(r["train_loss"] - f["train_loss"]) <= 1e-3 * abs(f["train_loss"])
                  for r, f in zip(a["records"], fit_steps)),
          f"parallel (a): the NCCL run's steps or launches ({a['launches']}, expected {want}) "
          "differ from the one-process fit's")
    res["nccl"] = a

    # which collectives gloo takes on CUDA tensors: the port's three, and
    # send/recv in a set of its own (a refusal there may end the process)
    base = os.path.join(FIT_DIR, "par")
    probe = wait_ranks(run_ranks("probe", 2, base + "_probe", ops=list(GLOO_OPS)), 120)
    sr = wait_ranks(run_ranks("probe", 2, base + "_sendrecv", ops=["send_recv"]), 120)
    taken = {op: (probe[0] or {}).get(op, "rank failed") for op in GLOO_OPS}
    taken["send_recv"] = (sr[1] or {}).get("send_recv", "rank failed")
    print(f"parallel: gloo on CUDA tensors, 2 ranks on this card: {taken}")
    res["gloo"] = taken

    def runnable(kind):
        refused = [op for op in NEEDS[kind] if taken[op] != "ok"]
        if refused:
            print(f"parallel: {kind} parallelism NOT run on the card: gloo does not take "
                  f"{refused} on CUDA tensors here; it is held on the CPU tests only and waits "
                  "for a machine with two cards (NCCL)")
        return not refused

    # (b) data, (c) seq and pipe: 2 ranks each on this card over gloo
    depth = {"encoder_num_layers": PAR_LAYERS}
    runs = {"data": dict(train={}, model=depth, global_rows=2 * PAR_LOCAL_B, seed=801,
                         rows=[[0, PAR_LOCAL_B], [PAR_LOCAL_B, 2 * PAR_LOCAL_B]]),
            "seq": dict(train={"mesh_seq": 2}, model=depth, global_rows=PAR_LOCAL_B, seed=802,
                        rows=[[0, PAR_LOCAL_B]] * 2, forward=True),
            "pipe": dict(train={"mesh_pipe": 2, "pipeline_microbatches": 2}, model=depth,
                         global_rows=PAR_LOCAL_B, seed=803, rows=[[0, PAR_LOCAL_B]] * 2,
                         forward=True)}
    live = [k for k in runs if runnable(k)]
    done = {}
    # the data set alone (its ranks hold the most), then seq and pipe together
    for group in (["data"], ["seq", "pipe"]):
        sets = {k: run_ranks("train", 2, f"{base}_{k}", **runs[k]) for k in group if k in live}
        done.update({k: wait_ranks(p) for k, p in sets.items()})
    for kind in live:
        spec = runs[kind]
        cfg = parallel_config(depth)
        mb = parallel_batch(cfg, spec["seed"], spec["global_rows"])
        ref = one_process_reference(cfg, mb, spec.get("forward", False))
        res[kind] = mesh_parity(kind, done[kind], f"{base}_{kind}", ref, PAR_LAYERS, card)
    # (d) the attention kernels at the sequence-parallel query shape
    res["seq_attention"] = check_attention_at(dev, SEQ_SHAPE, "d", "the sequence-parallel shape",
                                              18)
    if runnable("model"):
        res.update(model_axis_phase(base, card))
    # (e4) the attention kernels at the head-shard shape
    res["head_attention"] = check_attention_at(dev, HEAD_SHAPE, "e4", "the head-shard shape", 19)
    return res


def model_axis_phase(base: str, card: str) -> dict:
    """(e1)-(e3): the model axis, ranks on this card over gloo, each run
    against one process on the same rows: (e1) model 2 deterministic (the
    encoder output too) and with every dropout at PAR_DROPOUT, and (e3)
    the full lattice through the joint kernels, in one set of 2 ranks;
    (e2) seq 2 x model 2, 4 ranks."""
    depth = {"encoder_num_layers": PAR_MODEL_LAYERS}
    runs = [{"name": "model", "model": depth, "forward": True},
            {"name": "model_dropout", "model": {**depth, **dropout_model(PAR_DROPOUT)}},
            {"name": "model_full", "model": {**depth, "use_pruned_loss": False,
                                             "use_pallas_joint": True}}]
    spec = dict(train={"mesh_model": 2}, global_rows=PAR_LOCAL_B, seed=804,
                rows=[[0, PAR_LOCAL_B]] * 2, runs=runs)
    done = wait_ranks(run_ranks("train", 2, f"{base}_m", **spec))
    sm_model = {"encoder_num_layers": PAR_SEQ_MODEL_LAYERS}
    sm = dict(train={"mesh_seq": 2, "mesh_model": 2}, model=sm_model, global_rows=PAR_LOCAL_B,
              seed=805, rows=[[0, PAR_LOCAL_B]] * 4, forward=True)
    sm_done = wait_ranks(run_ranks("train", 4, f"{base}_sm", **sm))
    res = {}
    for run in runs:
        cfg = parallel_config(run["model"])
        mb = parallel_batch(cfg, spec["seed"], spec["global_rows"])
        ref = one_process_reference(cfg, mb, run.get("forward", False))
        full = run["name"] == "model_full"
        res[run["name"]] = mesh_parity(
            run["name"], [r and r[run["name"]] for r in done], f"{base}_m_{run['name']}", ref,
            PAR_MODEL_LAYERS, card, pruned=not full, joint=full)
    cfg = parallel_config(sm_model)
    ref = one_process_reference(cfg, parallel_batch(cfg, sm["seed"], sm["global_rows"]), True)
    res["seq_model"] = mesh_parity("seq_model", sm_done, f"{base}_sm", ref,
                                   PAR_SEQ_MODEL_LAYERS, card)
    return res


def main() -> int:
    import torch

    if sys.argv[1:2] == [PAR_RANK_FLAG]:       # one rank of phase 8, started by the smoke
        return parallel_rank(json.loads(sys.argv[2]))
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "conformer_tpu_torch")):
        print(f"chip_smoke: no conformer_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from conformer_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi gave no card line")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    logs = cuda_build.build()
    print(f"build: {len(logs)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or line.startswith("nvcc:"):
                print(f"build: {name}: {line.strip()}")

    # 3. kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entries = check_kernels(dev)
    decode_attention = entries.pop("rel_flash_attention")
    entries.update(check_attention_train_kernels(dev))
    entries["rel_flash_attention"]["max_abs_err"] = max(
        entries["rel_flash_attention"]["max_abs_err"], decode_attention["max_abs_err"])
    for name, e in check_attention_widths(dev).items():
        entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], e)
    entries.update(check_training_kernels(dev))
    for name, e in check_dp_long_labels(dev).items():
        entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], e)
    for name, e in check_ctc_dispatch_edges(dev).items():
        entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], e)
    entries.update(check_int8_kernels(dev))
    for name, e in zip(INT8_KERNELS, check_int8_widths(dev)):
        entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], e)
    entries.update(check_joint_kernels(dev))
    for name, e in check_joint_widths(dev).items():
        entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], e)
    entries["conv_block"]["max_abs_err"] = max(entries["conv_block"]["max_abs_err"],
                                               check_conv_widths(dev))
    entries["fbank"] = check_fbank_kernel(dev)

    # 4. serve: the main path, counts set to 0 just before each request;
    # then route A, int8 serving (decode.quantize_int8), behind the same server
    from conformer_tpu_torch.ops.quant import quantize_tree
    from conformer_tpu_torch.serve.runner import INT8_SKIP_KEYS

    cfg = serving_config(os.path.join(REPO, "configs", "conformer_m.json"))
    runner, raw_params = make_runner(cfg, dev)
    layers = cfg.model.encoder_num_layers
    cfg8 = serving_config(os.path.join(REPO, "configs", "conformer_m.json"))
    cfg8.decode.quantize_int8 = True
    runner8, raw8 = make_runner(cfg8, dev)
    per_request = {**dict.fromkeys(kernel_wrappers(), 0), "rel_flash_attention": layers,
                   "conv_block": layers}
    route_a_launches = 0
    for label, srv, seconds, extra in (
            ("serve", runner, (4.0, 9.5, 15.0), {}),
            ("serve int8 route A", runner8, (4.0, 15.0), {"int8_matmul": 2 * layers})):
        results = serve_requests(srv, seconds)
        builds = [r["layout_builds"] for r in results]
        print(f"{label}: int8 weight layouts made by the end of each request {builds}")
        check(builds[-1] == builds[0], f"{label}: weight layouts made after the first request "
              f"({builds})")
        for r in results:
            resp = r["response"]
            n_tok = len(resp.get("message", "").split())
            print(f"{label}: {r['seconds']} s wav -> {resp['status']} in {r['latency_s']:.3f} s, "
                  f"{n_tok} tokens, launches {r['launches']}")
            check(resp["status"] == "success", f"{label}: request failed: {resp.get('message')}")
            want = {**per_request, **extra}
            check(r["launches"] == want, f"{label}: launches {r['launches']} in a request, "
                  f"expected {want}")
            route_a_launches += r["launches"]["int8_matmul"]
    # fault C2: a given .npz keeps its CMVN against data.cmvn_path's file
    c2 = check_c2(runner, raw_params, dev)
    print(f"serve: C2, a runner given an .npz and a cmvn_path with other stats: serves the "
          f".npz's stats {c2['stats_equal']}, hyps identical to the tree's {c2['hyps_identical']} "
          f"(tokens {c2['tokens']}); {c2['s']:.1f} s ({card})")
    check(c2["stats_equal"] and c2["hyps_identical"], "C2: the runner did not serve the .npz's "
          "CMVN statistics")

    # 5. parity: the served weights, and the unbiased ones, whose
    # hypotheses are long enough to make "identical" a real check; float
    # weights, route A's int8 weights, route B's (both FFN matmuls int8)
    fused_raw = quantize_tree(raw_params, skip_keys=INT8_SKIP_KEYS, fuse_ffn=True)
    fused = blank_biased(fused_raw, cfg.model.blank_id, 6.0)
    for label, served, unbiased, tol in (
            ("float", runner.params, raw_params, 1e-3),
            ("int8 route A", runner8.params, raw8, INT8_ENC_TOL),
            ("int8 route B", fused, fused_raw, INT8_ENC_TOL)):
        int8 = label != "float"
        for name, params in (("served", served), ("unbiased", unbiased)):
            par = parity_f32(runner, params, dev,
                             float_params=raw_params if int8 else None)
            agree, same, n_ref = par["token_agreement"]
            quant = (f", quantization itself: max {par['quant_max_abs_err']:.3g} mean "
                     f"{par['quant_mean_abs_err']:.3g}" if int8 else "")
            print(f"parity: {label} f32 kernel path vs plain path, {name} weights: encoder "
                  f"max_abs_err {par['encoder_max_abs_err']:.3g} (tol {tol}), mean "
                  f"{par['encoder_mean_abs_err']:.3g}{quant}; hyps identical "
                  f"{par['hyps_identical']}, token agreement {agree:.4f} over {n_ref} tokens, "
                  f"hyp lens {par['hyp_lens']}")
            check(par["finite"] and par["encoder_max_abs_err"] <= tol and (
                not int8 or par["encoder_mean_abs_err"]
                <= INT8_ENC_MEAN_SHARE * par["quant_mean_abs_err"]),
                f"{label} f32 kernel path disagrees with the plain path on the {name} weights")
            # float: identical everywhere; int8: identical on the served
            # weights, held to INT8_AGREE_MIN on the unbiased ones
            check(par["hyps_identical"] or (int8 and name == "unbiased"
                                            and agree >= INT8_AGREE_MIN),
                  f"{label} f32 hypotheses differ on the {name} weights (agreement {agree:.4f})")
        check(max(par["hyp_lens"]) > 0, f"the unbiased {label} weights emitted no token")
    # every encoder dense int8 (expand_only=False): the subsampling's output
    # dense, K = 19 D = 4864, goes round the matmul kernel's K <= 1024
    par = int8_expand_all_parity(runner, raw_params, dev)
    print(f"parity: int8 expand_only=False f32 kernel path vs plain path, encoder: max_abs_err "
          f"{par['encoder_max_abs_err']:.3g} (tol {INT8_ENC_TOL}), mean "
          f"{par['encoder_mean_abs_err']:.3g}, quantization itself: max "
          f"{par['quant_max_abs_err']:.3g} mean {par['quant_mean_abs_err']:.3g}; "
          f"int8_dense.xla_routes {par['xla_routes']}; int8 launches {par['launches']}")
    check(par["finite"] and par["encoder_max_abs_err"] <= INT8_ENC_TOL
          and par["encoder_mean_abs_err"] <= INT8_ENC_MEAN_SHARE * par["quant_mean_abs_err"],
          "int8 expand_only=False f32 kernel path disagrees with the plain path")
    check(par["xla_routes"] >= 1 and par["launches"]["int8_matmul"] > 0
          and par["launches"]["int8_ffn"] == 2 * layers,
          f"int8 expand_only=False: XLA routes {par['xla_routes']}, launches {par['launches']}")
    batch, seconds = 48, 15.0
    feats, lens = batch_feats(runner, [seconds] * batch, seed=300)
    bat = decode_bf16_batch(runner, raw_params, dev, feats, lens, batch * seconds)
    b8 = decode_int8_batch(runner, fused, fused_raw, bat["unbiased_hyps"], dev, feats, lens,
                           batch * seconds)
    for label, res in (("float", bat), ("int8 route B", b8)):
        print(f"parity: {label} bf16 decode B={batch} x {seconds} s, served weights: "
              f"{res['audio_s_per_s']:.1f} audio-s/s (decode s {res['decode_s']}, of which "
              f"encoder s {res['encode_s']}), launches in one batch {res['launches']}")
    for name in ("served", "unbiased"):
        agree, same, n_ref = bat[name]
        print(f"parity: float bf16 kernel path vs plain path, {name} weights: {same}/{batch} "
              f"rows identical, token agreement {agree:.4f} over {n_ref} tokens")
    agree, same, n_ref = b8["unbiased_vs_float"]
    print(f"parity: int8 route B vs float, bf16 kernel paths, unbiased weights (a quality "
          f"reading): {same}/{batch} rows identical, token agreement {agree:.4f} over {n_ref} "
          f"tokens")
    want = {**per_request, "int8_ffn": 2 * layers}
    check(b8["launches"] == want, f"route B: launches {b8['launches']} in one batch, "
          f"expected {want}")
    print(f"parity: int8 route B: weight layouts made by the end of the first batch and of the "
          f"last {b8['layout_builds']}")
    check(b8["layout_builds"][1] == b8["layout_builds"][0],
          f"route B: weight layouts made after the first batch {b8['layout_builds']}")
    route_b_launches = b8["launches"]["int8_ffn"]
    del runner8, raw8, fused, fused_raw

    # 5b. stream: (a) the attention kernel at the chunk shapes, (b) f32
    # streaming parity, (c) live sessions, (d) the scheduler, (e) the
    # WebSocket handlers; (f) comes after the fit phase, on its corpus
    t0 = time.perf_counter()
    stream = stream_phase(runner, raw_params, dev, layers)
    entries["rel_flash_attention"]["max_abs_err"] = max(
        entries["rel_flash_attention"]["max_abs_err"], stream["attention"]["max_abs_err"])
    print(f"stream: (a)-(e) in {time.perf_counter() - t0:.1f} s")

    # 5c. decode modes: (a) f32 parity of each mode, (b) bf16 times at
    # B=48 x 15 s, counts set to 0 just before the first timed batch of
    # each mode and read just after; (c) comes after the fit phase
    t0 = time.perf_counter()
    dm_par = decode_modes_parity(runner, raw_params, dev)
    dm_bf = decode_modes_bf16(runner, dev, feats, lens, batch * seconds)
    check_decode_modes(dm_par, dm_bf, layers, card, batch, seconds)
    print(f"decode modes: (a)-(b) in {time.perf_counter() - t0:.1f} s")

    # 5d. reference-parity modes: f32 kernel path = plain path in each, the
    # counts set to 0 just before each mode's decodes and read just after
    t0 = time.perf_counter()
    check_ref_modes(ref_modes_phase(runner, dev, layers), card)
    print(f"ref modes: in {time.perf_counter() - t0:.1f} s ({card})")

    # 6. train: the shipped recipe (loss kernel flags on, attention flag
    # off), counts set to 0 just before the timed steps (inside train_steps)
    # and read just after; then the f32 parity with the attention kernel on
    from conformer_tpu_torch.train.loop import Trainer

    del runner, raw_params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tcfg = recipe_config(os.path.join(REPO, "configs", "conformer_m.json"))
    trainer = Trainer(tcfg, device=dev)
    tr = train_steps(trainer)
    for r in (tr["warmup"], *tr["steps"]):
        print(f"train: step {r['step_s'] * 1e3:.1f} ms, loss {r['loss']:.4f} (ctc "
              f"{r['loss_ctc']:.4f}, rnnt {r['loss_rnnt']:.4f}), grad norm "
              f"{r['grad_norm']:.4g}, lr {r['lr']:.4g}, {r['leaves_changed']}/{r['leaves']} "
              "leaves changed")
    print(f"train: B=32 x 15 s, accum_grad {tcfg.train.accum_grad}: {tr['step_s'] * 1e3:.1f} ms "
          f"per step, {tr['audio_s_per_s']:.1f} training audio-s/s, peak memory "
          f"{tr['peak_mem_gb']:.2f} GiB, launches in 3 steps {tr['launches']}")
    par = train_parity(trainer)
    worst = ", ".join(f"{k} {e:.3g}" for k, e in par["grad_worst_leaves"])
    print(f"train parity: f32 kernel path vs plain path, B=8 x 15 s: losses {par['losses']}, "
          f"max rel err {par['loss_max_rel_err']:.3g} (tol 1e-4); gradients max err / max-abs, "
          f"worst leaves: {worst} (tol 1e-3; scale floored at 1e-6 of the largest for "
          f"{par['grad_floored_leaves']}), plain path on the kernel path's band; s_begin differs "
          f"in {par['s_begin_diff']} of {par['s_begin_entries']} entries (limit "
          f"{BAND_LIMITS['s_begin_diff_share']:.0%}), occupancy max abs err "
          f"{par['occupancy_max_abs_err']:.3g} (limit {BAND_LIMITS['occupancy_max_abs_err']}), "
          f"argmax over u differs at {par['argmax_flips']} frames, by at most "
          f"{par['flip_max_gap']:.3g} in the plain occupancy (limit {BAND_LIMITS['flip_max_gap']})")
    check(par["s_begin_diff"] <= BAND_LIMITS["s_begin_diff_share"] * par["s_begin_entries"]
          and par["occupancy_max_abs_err"] <= BAND_LIMITS["occupancy_max_abs_err"]
          and par["flip_max_gap"] <= BAND_LIMITS["flip_max_gap"],
          "the kernel path's pruning band differs from the plain path's beyond its limits")
    check(par["finite"] and par["loss_max_rel_err"] <= 1e-4 and par["grad_max_rel_err"] <= 1e-3,
          "f32 training kernel path disagrees with the plain path")
    del trainer
    torch.cuda.empty_cache()

    # 6b. train full lattice: the loss of the JAX ModelConfig default, its
    # joint through the joint kernels; counts set to 0 just before the timed
    # steps and read just after; then the kernel path's parity, f32 and bf16
    torch.cuda.reset_peak_memory_stats()
    fcfg = full_lattice_config(os.path.join(REPO, "configs", "conformer_m.json"))
    trainer = Trainer(fcfg, device=dev)
    fl = train_steps(trainer, batch=FULL_BATCH)
    for r in (fl["warmup"], *fl["steps"]):
        print(f"train full lattice: step {r['step_s'] * 1e3:.1f} ms, loss {r['loss']:.4f} (ctc "
              f"{r['loss_ctc']:.4f}, rnnt {r['loss_rnnt']:.4f}), grad norm {r['grad_norm']:.4g}, "
              f"{r['leaves_changed']}/{r['leaves']} leaves changed")
    print(f"train full lattice: B={FULL_BATCH} x 15 s, U=64, accum_grad {fcfg.train.accum_grad}: "
          f"{fl['step_s'] * 1e3:.1f} ms per step, {fl['audio_s_per_s']:.1f} training audio-s/s, "
          f"model {fl['model_tflops']:.1f} TFLOP/s ({fl['model_tflops'] / BF16_TFLOPS:.2%} of the "
          f"{BF16_TFLOPS:.0f} bf16 peak; train/flops.py), peak memory {fl['peak_mem_gb']:.2f} GiB, "
          f"launches in 3 steps {fl['launches']}")
    for dtype, (loss_lim, grad_lim, floor_share) in FULL_PARITY_LIMITS.items():
        par = full_lattice_parity(trainer, dtype, floor_share)
        worst = ", ".join(f"{k} {e:.3g}" for k, e in par["grad_worst_leaves"])
        print(f"train full lattice parity: {dtype} kernel path vs plain path, B=8 x 15 s: losses "
              f"{par['losses']}, max rel err {par['loss_max_rel_err']:.3g} (limit {loss_lim}); "
              f"gradients max err / max-abs, worst leaves: {worst} (limit {grad_lim}; scale "
              f"floored at {floor_share:g} of the largest for {par['grad_floored_leaves']})")
        check(par["finite"] and par["loss_max_rel_err"] <= loss_lim
              and par["grad_max_rel_err"] <= grad_lim,
              f"{dtype} full-lattice kernel path disagrees with the plain path")
    del trainer
    torch.cuda.empty_cache()

    # 6c. train Conformer-L with remat: (a) the recipe as shipped with and
    # without remat, counts set to 0 just before the timed steps (inside
    # train_steps) and read just after; (b) remat's gradients against no
    # remat's, the attention kernel on, counts set to 0 before each run
    t0 = time.perf_counter()
    check_remat_train(remat_train(dev), card)
    check_remat_parity(remat_grad_parity(dev))
    # the attention kernels at Conformer-L's training shape (6c (b) runs
    # them there: 2 x 17 forwards, 17 dq and 17 dkv a microbatch)
    attention_train_times(dev, torch.Generator().manual_seed(12), 32, 374, h=8, dk=64, d=512)
    print(f"train Conformer-L remat: in {time.perf_counter() - t0:.1f} s ({card})")

    # 6d. the 1024-wide Conformer on the wide kernels: (a) serve, (b)
    # train, counts set to 0 just before each counted run and read just
    # after; (c) the kernels' times at those paths' shapes
    t0 = time.perf_counter()
    wide = wide_phase(dev, card)
    check_wide(wide, card)
    print(f"wide: in {time.perf_counter() - t0:.1f} s ({card})")

    # 6e. Conformer-L's float32 full lattice (join 640, the joint kernels'
    # wide route): kernel path vs plain path, counts set to 0 just before
    # and read just after
    t0 = time.perf_counter()
    full_l = full_lattice_l_parity(dev)
    loss_lim, grad_lim, _ = FULL_PARITY_LIMITS["float32"]
    worst = ", ".join(f"{k} {e:.3g}" for k, e in full_l["grad_worst_leaves"])
    joint = {k: full_l["launches"][k] for k in JOINT_GRIDS}
    print(f"train full lattice Conformer-L: float32, join {full_l['join_dim']}, {FULL_L_LAYERS} "
          f"layers, kernel path vs plain path, B={FULL_L_BATCH} x 15 s: losses "
          f"{full_l['losses']}, max rel err {full_l['loss_max_rel_err']:.3g} (limit {loss_lim}); "
          f"gradients max err / max-abs, worst leaves: {worst} (limit {grad_lim}); joint launches "
          f"{joint}; in {time.perf_counter() - t0:.1f} s ({card})")
    check(full_l["finite"] and full_l["loss_max_rel_err"] <= loss_lim
          and full_l["grad_max_rel_err"] <= grad_lim,
          "Conformer-L float32 full-lattice kernel path disagrees with the plain path")
    check(all(full_l["launches"][k] > 0 for k in JOINT_GRIDS),
          f"6e: the joint kernels did not run ({full_l['launches']})")

    # 7. host: the audio runtime built with g++ and held against the numpy
    # path on the card machine's CPU; host times on the fit corpus
    t0 = time.perf_counter()
    corpus, corpus_s = fit_corpus()
    check_host(host_phase(corpus), card)
    print(f"host: in {time.perf_counter() - t0:.1f} s ({card})")

    # 7a. fit: the main path of this slice, through the user's entry point;
    # counts set to 0 just before the first training run and read just after
    fit = fit_phase(corpus, corpus_s)
    check_fit(fit)
    # stream (f): streaming validation on the fit phase's corpus, counts
    # set to 0 just before it and read just after
    sv = streaming_validation(fit["cfg"])
    # decode modes (c): --eval in each mode on the fit checkpoint
    t0 = time.perf_counter()
    check_eval_modes(eval_modes(fit), fit)
    print(f"decode modes: (c) in {time.perf_counter() - t0:.1f} s")
    # 7b. wenet: the WeNet import of the fit's last checkpoint: --eval
    # --wenet_ckpt_path and the runner's .pt route, counts set to 0 just
    # before each request and read just after
    check_wenet(wenet_phase(fit), fit, card)
    # 7c. micro: the micro corpus tool, the micro-WER script's decode sweep
    # on the trained fixture and two training steps, kernel path vs plain
    # path, and the Gradio demo's wiring; the counts set to 0 just before
    # each kernel path's run and read just after; the kernels at the
    # shapes those paths gave them
    micro = micro_phase(dev, card)
    for e in micro["kernels"]:
        entries[e["name"]]["max_abs_err"] = max(entries[e["name"]]["max_abs_err"],
                                                e["max_abs_err"])
    # 8. parallel: (a) NCCL's init and the one-process step through main on
    # the fit corpus, counts set to 0 just before and read just after; which collectives gloo
    # takes on CUDA tensors; (b) data, (c) sequence and pipeline
    # parallelism, 2 ranks on this card over gloo against one process, each
    # rank's counts set to 0 just before its step and read just after; (d)
    # the attention kernels at the sequence-parallel shape; (e) the model
    # axis: model 2 (deterministic, dropout, full lattice) and seq 2 x
    # model 2 against one process, counts as (b)-(c), and the attention
    # kernels at the head-shard shape
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    par = parallel_phase(fit, dev, layers, card)
    for part in ("seq_attention", "head_attention"):
        for name, e in par[part]["errs"].items():
            entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], e)
    print(f"parallel: in {time.perf_counter() - t0:.1f} s ({card})")
    shutil.rmtree(FIT_DIR, ignore_errors=True)
    attn = sv["launches"]["rel_flash_attention"]
    print(f"stream: streaming validation (decode.streaming, chunk "
          f"{fit['cfg'].decode.decoding_chunk_size}, cache 512), one dev batch of the fit corpus "
          f"from the last checkpoint: WER {sv['wer']:.4f} in {sv['s']:.2f} s, launches "
          f"{sv['launches']}")
    check(np.isfinite(sv["wer"]) and attn > 0 and attn % layers == 0
          and sv["launches"] == {**dict.fromkeys(kernel_wrappers(), 0),
                                 "rel_flash_attention": attn},
          f"streaming validation: WER {sv['wer']}, launches {sv['launches']}")
    train_recs = [r for r in fit["records"] if "train_loss" in r]
    for r in fit["records"]:
        if "valid_wer" in r:
            print(f"fit: validation at step {r['step']}: WER {r['valid_wer']:.4f}")
        else:
            print(f"fit: step {r['step']}: {r['train_step_s'] * 1e3:.1f} ms, "
                  f"{r['train_audio_s']:.1f} audio s, loss {r['train_loss']:.4f} (ctc "
                  f"{r['train_loss_ctc']:.4f}, rnnt {r['train_loss_rnnt']:.4f}), grad norm "
                  f"{r['train_grad_norm']:.4g}, lr {r['train_lr']:.4g}")
    step_s = sum(r["train_step_s"] for r in train_recs)
    wait_s = sum(r["train_data_wait_s"] for r in train_recs)
    audio_s = sum(r["train_audio_s"] for r in train_recs)
    # functional readings of a 40-utterance corpus, not a throughput
    # measure: each epoch's first batch waits for all its features
    full = fit["full_lattice"]
    for r in full["records"]:
        print(f"fit full lattice: step {r['step']}: {r['train_step_s'] * 1e3:.1f} ms, "
              f"{r['train_audio_s']:.1f} audio s, loss {r['train_loss']:.4f}, grad norm "
              f"{r['train_grad_norm']:.4g}")
    print(f"fit full lattice: {full['fit_s']:.1f} s, checkpoints {full['names']}, launches "
          f"{full['launches']}")
    cm = fit["cmvn"]
    print(f"fit: CMVN from `python -m conformer_tpu_torch.tools.compute_cmvn_stats` over the "
          f"train list ({cm['stdout']}) in {cm['s']:.1f} s; the checkpoint's mean and istd equal "
          f"the file's {cm['checkpoint_equal']}")
    ev = fit["eager"]
    print(f"fit: Trainer.validate on the dev set, lazy WER {ev['lazy']['wer']:.4f}, eager "
          f"({ev['batches']} batches) WER {ev['eager']['wer']:.4f}; launches "
          f"{nonzero(ev['eager']['launches'])}")
    mfcc = fit["mfcc"]
    for r in mfcc["records"]:
        print(f"fit MFCC: step {r['step']}: {r['train_step_s'] * 1e3:.1f} ms, "
              f"{r['train_audio_s']:.1f} audio s, loss {r['train_loss']:.4f}, grad norm "
              f"{r['train_grad_norm']:.4g}")
    print(f"fit MFCC ({MFCC_CEPS} cepstra, input_dim {MFCC_CEPS}, CMVN cleared): "
          f"{mfcc['fit_s']:.1f} s, launches {nonzero(mfcc['launches'])}")
    print(f"fit: corpus {fit['corpus_s']:.1f} s; first run {fit['fit_s']:.1f} s; over "
          f"{len(train_recs)} steps: {step_s / len(train_recs) * 1e3:.1f} ms per step, "
          f"{audio_s / step_s:.1f} training audio-s/s, waiting on the prefetcher "
          f"{wait_s / (wait_s + step_s):.1%} of the loop's step + wait time (native features, "
          f"CMVN from the corpus); peak memory "
          f"{fit['peak_mem_gb']:.2f} GiB; checkpoints {fit['names']}; eval WER "
          f"{fit['eval_wer'][0]:.4f}; restore {fit['restored']}; "
          f"{validation_batches(fit['cfg'])} validation batches and launches in the first "
          f"run {fit['launches']}")
    for name, n in fit["launches"].items():
        entries[name]["launches"] = n
    # the int8 kernels' main paths: route A's requests, route B's batch;
    # the joint kernels': the full-lattice run of the user's command; the
    # fbank kernel has none (no caller, as in the JAX package)
    entries["int8_matmul"]["launches"] = route_a_launches
    entries["int8_ffn"]["launches"] = route_b_launches
    for name in JOINT_GRIDS:
        entries[name]["launches"] = full["launches"][name]
    # and the micro phase's kernel paths: the decode sweep, the training
    # steps and the demo's stream
    for name, n in micro["launches"].items():
        entries[name]["launches"] += n
    # and the 1024-wide paths': one decode batch, the timed training steps
    # and one route-B batch; and 6e's Conformer-L full lattice
    for name, n in wide["launches"].items():
        entries[name]["launches"] += n
    for name in JOINT_GRIDS:
        entries[name]["launches"] += full_l["launches"][name]

    print(f"total: {time.perf_counter() - t_start:.1f} s")
    order = [*ATTENTION_KERNELS, "conv_block", *PER_MICROBATCH, *INT8_KERNELS, *JOINT_GRIDS,
             *FBANK_KERNELS]
    print(json.dumps({"kernels": [entries[k] for k in order]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
