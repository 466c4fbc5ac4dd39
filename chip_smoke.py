#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its CUDA kernels to account.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU or to a
kernel's plain version):

1. build   — nvcc compiles every kernel in videonavqa_tpu_torch/csrc/ for
             sm_90a, one process per source, all at once;
2. card    — prints the card's name and power limit (nvidia-smi);
3. kernels — each kernel against its plain PyTorch version on the card, at
             the full-width shapes of the serving path, with the tolerances
             stated below; times the kernel, the plain version and, where one
             PyTorch call computes part of the same work, that call
             (``library_ms``, a yardstick the port never calls): the
             re-encode also against 35 chained cuDNN LSTM calls, the LSTM
             kernel at time_multi_hop's chained launch (35 passes) and at
             single passes from non-zero (h0, c0), the wide one (hidden 512
             and 1536) up to 64 batch rows; attn_tail also at attention
             sizes it pads (64, 200), 100 frames and 64 batch rows; the two
             hidden-128 kernels on the shared chain (film_reencode, lstm)
             against recorded digests of their outputs' bits; the int8
             kernel also with its stored requantization source
             (``requant_stored``) at 4,550 and 145,600 rows, its yq
             bit-equal to quantize_act of the y it stored, both sources
             timed; then the int8 row gate: both routes of a trunk block's
             1x1 conv (the fused kernel, requantizing from the source the
             trunk picks at that count; conv2d_int8_prequant, ReLU and the
             3x3 conv's quantize) timed at the served folded row counts and
             above them, held against INT8_FUSED_MAX_ROWS;
4. serve   — InferenceEngine at the film_attn_pt eval.sh preset (5 FiLM
             blocks x 1024 channels, hidden/attention/embed 128, 512 input
             channels, bf16, 35 frames, 56 tokens, 134 words, 70 classes)
             with the static int8 trunk and the kernels on, twice: from
             seeded bf16 features, and from seeded uint8 video
             [35, 160, 208, 3] through the engine's video mode (the frozen
             stem from seed 1234, VGG block 1 through its kernel; the model
             from seed 0), and from the same video through the int8 stem
             (stem/quant.py, calibrated on one other video; vgg_block1 0
             times). Each calibrates on its first micro-batch, then
             serves other items: batch 32 (from features at frame buckets 20
             and 35, from video at 35) and batch 1 at 35 frames, every one
             at or under the fused-1x1 row gate, with every launch counter set to 0
             just before and read just after; then holds the kernel path
             against the plain path on the same calibrated state and times
             ms/video, and from video the stem's share of a batch.
             The same from seeded bf16 features for time_multi_hop at its
             eval.sh preset (3 FiLM blocks x 1024 channels, 64 tail
             channels, hidden/embed 128, int8 trunk)
             at batch 16 in two frame buckets and batch 1, where the LSTM
             kernel launches once a forward, its passes over the frames
             chained; and for lstm, v_only_cnn2d_lstm,
             concat2d and mac at the ModelConfig defaults (hidden 128,
             mac_dim 512, 12 MAC steps) at batch 32 and batch 1, the video
             models from seeded uint8 frames [35, 160, 208, 3]; and mac at
             batch 64 (its wide LSTMs in two launches of 32 rows a pass);
             film_gp_pt at its eval.sh preset (4 FiLM blocks x 1024
             channels, 32 tail channels, the int8 trunk) and film_attn_pt's
             preset with the BoW question encoder (int8 trunk; its batch 1
             held to the port on the CPU, as the two routes requantize from
             other sources there) over the same features (batch 32 at
             buckets 20 and 35, batch 1: the re-encode once a forward, or,
             under BoW, never and the attention tail once; the fused int8
             1x1 once a block); concat3d at the defaults (lstm
             once a forward); v_only_cnn3d through the engine from uint8
             video at buckets 8, 16, 24 and 35 (batch 32; batch 1 at 8 and
             35), its zero-run computed at load, no kernel; bow at batch
             1,024; then v_only_cnn3d's trimmed routes in f32 at batch 32
             (the splice at T 12 and 24, the pad path at 24, the
             precomputed zero-run at 8 and 16) held to the full zero-padded
             volume (logits atol 2e-4 rtol 1e-5), and the sweep of the three
             routes' eval time over bucket widths at batch 32 (and 1), which
             fails where the route SPLICE_MAX_T / SPLICE_MAX_T_CACHED pick is
             over 1.1x the fastest;
5. train   — the train steps (train/step.py make_train_step, a generator on
             the step's device for each step, seeded by its index): (a) 3
             steps on the card and the same 3 on the CPU from the same
             seeded weights and numpy-seeded batches, f32, TF32 off, held to
             TRAIN_* below with no kernel launched: film_attn_pt at the
             small config of tests/test_torch_film_attn.py, time_multi_hop
             and MAC (without dropout: the two generators draw different
             masks) at that of tests/test_torch_lstm_models.py, kernels
             asked for; (b) film_attn_pt at the eval.sh preset (bf16, batch
             32, T35, 56 tokens, sum loss, clip 1.0, Adam 1e-4) from seeded
             bf16 features: 8 steps on one batch, the second to fourth
             timed, the fifth profiled, every loss and grad_norm finite and
             the last loss under the first, and the plain re-encode's
             forward and backward timed alone; (c) the same from seeded
             uint8 video [32, 35, 160, 208, 3] through the frozen stem (seed
             1234, all 1,120 frames in one chunk, as the engine serves them:
             VGG block 1 through its kernel once a step), 5 steps, counted,
             and the stem's share of a step from the stem timed alone; (d)
             time_multi_hop at its eval.sh preset (batch 16, lr 5e-5) from
             bf16 features, 5 steps, and its plain hop encoder's forward and
             backward alone; (e) MAC at the ModelConfig defaults (batch 32,
             dropout 0.15, mean loss, the +-1 clamp, lr 1e-4) from bf16
             features (6 steps) and from uint8 video through the stem (5
             steps); (f) v_only_cnn2d_lstm and concat2d at the ModelConfig
             defaults (batch 32, T35, mean loss, clip 1.0, Adam 1e-4) from
             seeded uint8 video [32, 35, 160, 208, 3], concat2d with dropout
             0.5, 5 steps each, and the question-only lstm at its harness
             default (batch 1,024, mean loss with seeded class weights, no
             clip, Adam 1e-5), 30 steps. The train forward runs no kernel
             but the stem's: no kernel has a backward pass, and the LSTM
             kernel launches 0 times in (a), (d), (e) and (f). (a) also
             holds v_only_cnn2d_lstm and concat2d (on seeded uint8 frames
             [3, 6, 160, 208, 3]; concat2d's dropout on) and lstm (seeded
             class weights) card vs CPU, the draws of concat2d's mask and
             lstm's (h0, c0) made on the CPU for both, and film_gp_pt (LSTM
             and BoW encoders) and bow; v_only_cnn3d and concat3d (dropout on,
             its mask drawn on the CPU) one step at batch 2 on seeded uint8
             frames [2, 35, 160, 208, 3] (fc6's geometry), held to C3D_*
             below; (h) film_gp_pt at its preset from bf16 features,
             v_only_cnn3d and concat3d at batch 32 from uint8 video at T35 and
             at bucket 12 through the splice, 5 steps each, and bow at batch
             1,024, 30 steps;
6. eval    — (g) the eval step (train/step.py make_eval_step: loss over the
             rows of a ``valid`` mask, hits, predictions, logits) of
             v_only_cnn2d_lstm, concat2d, lstm and concat3d at the serve
             phase's configs and film_gp_pt at its preset, batch 32 at bucket
             35, the last 3 rows invalid, once on the kernel route (the LSTM
             kernel 1, 2, 1 and 1 launches a forward, the re-encode 1,
             counted) and once on the plain route: the losses
             within EVAL_LOSS_RTOL, the hits equal but on rows whose top-2
             logit margin is under ARGMAX_MARGIN;
7. harness — the training entry points as a user runs them (cli/), on a
             synthetic npy dataset written to a temporary directory (64
             train, 32 val and 32 test videos of up to 140 frames, v_len up
             to 35; ~1 GB, removed afterwards), each run's launches counted
             from 0: q_and_v_eval for film_attn_pt at its eval.sh preset
             through the native VNR loader with frame buckets, kernels on,
             one epoch (2 train steps from raw video, the stem's vgg_block1
             in each, and 1 val batch through vgg_block1, film_reencode and
             attn_tail) with an epoch checkpoint and a JSONL stream; the same
             resumed from its e0_ checkpoint with --val_only, whose val loss
             must match within RESUME_LOSS_RTOL and its hits and predictions
             exactly; q_and_v_eval for concat2d through the Python loader
             (lstm twice a val batch); v_only_eval cnn2d_lstm; q_only_eval
             lstm at batch 32 for 2 epochs; q_and_v_eval film_gp_pt at its
             preset from raw video (vgg_block1 a step, the re-encode a val
             batch), film_attn_pt's preset with --int8_stem true (improved:
             calibrated on the first train batch; vgg_block1 never) and
             q_and_v_test of its e0_ checkpoint so (absmax), v_only_eval
             cnn3d with frame buckets and q_only_eval
             bow, each then tested from its checkpoint by q_and_v_test,
             v_only_test and q_only_test (the test split in order), and
             results_analysis run over the dumps each wrote. Every loss
             finite, every JSONL stream with its epoch events; each run's
             wall time and examples/s printed;
7b. interchange — the reference checkpoint interchange on the harness
             phase's dataset, at film_attn_pt's eval.sh preset: seeded
             weights written as a reference .pt (utils/zoo_export.py), an
             engine started from it (every imported leaf bit-equal, the five
             conv1x1 leaves named as drawn), batch 32 at buckets 20 and 35
             and batch 1 served from seeded features with film_reencode,
             attn_tail and int8_matmul_fused counted and held to the plain
             path; one q_and_v_eval epoch resumed from the .pt (epoch 1,
             Adam's count that epoch's steps); cli/export_checkpoint from
             that epoch's npz, read back bit-equal but for conv1x1;
8. daemon  — the serving half on the harness phase's dataset:
             cli/extract_features.py over the test split (32 videos) in bf16
             and in fp8 (vgg_block1 counted; two videos' stored planes equal
             the stem's features, bit for bit); cli/serve.py's daemon
             (build_server on port 0, warmed up) at the eval.sh preset from
             the harness phase's e0_ checkpoint over each cache, with the
             int8 trunk, the kernels, auto frame buckets, max_batch 32 and
             pipeline depth 2: closed-loop HTTP clients in another process
             (serve/loadgen.py), 64 of them and at least 256 requests, a
             /reload sent mid-load (the weights version must rise and later
             requests be answered on the new weights), over the bf16 cache;
             16 clients and 64 requests over the fp8 cache. Every answer
             must be its micro-batch's row; each micro-batch is run again
             through engine.run_batch, and each request that was the longest
             of its micro-batch alone (the reference's attention mask makes
             an answer depend on its batch's longest video), within
             PROB_ATOL, the argmax equal where the margin exceeds
             ARGMAX_MARGIN; film_reencode and attn_tail must launch once a
             forward and matmul_int8_fused five times a non-calibrating one.
             Each daemon is then shut down under a burst of 64 requests:
             every accepted request answered, the others refused at the
             closed socket. Then cli/predict.py on one stored video through
             the stem, and again with --int8_stem true (no calibration batch:
             the bf16 stem's answer, as in JAX); the daemon from the stored
             videos through the int8 stem (--int8_stem true, calibrated at
             start-up on the first video; 16 clients, vgg_block1 never).
             Prints requests/s, p50 / p95 / p99 latency, the average batch,
             avg_forward_ms and one micro-batch's idle share;
9. stem    — the rest of the stem: the int8 stem at full width over seeded
             uint8 video [32, 35, 160, 208, 3], calibrated both ways (no
             kernel launched): the VGG stage bit-equal between the card and
             the CPU on one qstem, the features within the JAX package's
             test bounds of the f32 stem (relative L2 0.06 absmax, 0.03
             improved), its time, peak memory and top device ops at 1,120
             frames against the bf16 stem; cli/train_obj_detector.py --data
             at full width (512 filters, tail 1,024, batch 32, dropout 0.5,
             2 epochs of 3 steps: vgg_block1 once a step, the loss finite
             and falling); MAC with both write variants at a small config,
             served with the kernels (lstm 3 a forward) against the CPU and
             3 train steps card vs CPU (TRAIN_* bounds);
10. datagen — the dataset generator: cli/generate_dataset.py (10 houses of 8
             trajectories, seed 0, 4 spawned workers, npy videos) run in a
             process of its own, as a user runs it; labels in [0, 70), the
             8 / 1 / 1 house split's parts non-empty, every video uint8
             [T, 160, 208, 3]; cli/dataset_stats.py over it, its totals
             against labels.json and split.json; examples/s printed; one
             house generated again in this process, its wall time split
             into question generation (the attempts that timed out apart),
             the observation passes and the videos' rendering. Then
             q_and_v_eval for film_attn_pt at FILM_PRESET's widths, batch 8
             (the harness's default: the val house holds at most 8
             examples), one epoch from the generated raw video (vgg_block1
             once a train step and once a val batch, film_reencode and
             attn_tail once a val batch), q_and_v_test from its e0_
             checkpoint (all three once a test batch) and results_analysis
             over the dumps; cli/train_obj_detector.py --synthetic 96 at
             full width (as phase 9's --data run: vgg_block1 once a step,
             the loss finite and falling), its render time, frames/s and
             positive rate printed;
11. mesh   — parallel/ on the one card, on phase 7's dataset and phase 8's
             test-split cache and checkpoint, film_attn_pt at the eval.sh
             preset's widths, batch 32: (a) q_and_v_eval one epoch from the
             bf16 cache without a mesh, with --mesh_devices 1 (NCCL, a world
             of one) and as one --distributed process, epoch losses rtol
             1e-5, val hits and predictions equal, examples/s and the
             gradient sum's ms and bytes a step; (b) two gloo ranks spawned
             on the one card (its times say nothing about scaling): a train
             step at data 2 (16 rows a rank) and at model 2, f32 TF32 off,
             against one process (loss rtol 1e-5, params 2.5e-3, BN state
             1e-5; the gradients the step summed over 'data' and the
             clipped ones it applied, relative L2 within 4x the one-process
             step's own move when the rows are reordered, or 1e-4; the norm
             after the clip rtol 1e-4), the eval step at data 2 with the
             kernels and the calibrated int8 trunk (probabilities 2e-2, the
             argmax rule), and the engine on model 2 (two threads) against
             one device; (c) the
             daemon with --mesh_devices 1 over the bf16 cache, each answer
             against run_batch of the engine without a mesh;
12. widths — (the grid after phase 3's checks, while torch.profiler still
             records every launch: late in a run, after the train phase's
             traces, a window saw 0-4 of 5; the served part after phase 6)
             every width a ModelConfig can carry: the four width-bound
             kernels against their plain versions over a grid of widths the
             served presets do not use (lstm hidden 6, 100, 1,600, 2,048;
             the re-encode 12, 64, 256, 512; the tail 20, 300, 512, 1,024;
             the int8 1x1 N = K 48, 200, 1,536, 2,048 on both requant
             sources), with the bounds of phase 3, each timed with its plain
             version, its bound and, where one PyTorch call computes it, that
             call; then InferenceEngine with the kernels on at batch 32 and
             1, T35, counted and held to the plain path: (a) film_attn_pt at
             the eval.sh preset's depth with channels 2,048, hidden 256 and
             attention 512, int8 trunk; (b) film_gp_pt at channels 200 and
             hidden 100; (c) mac at mac_dim 2,048; (d) the question-only
             lstm at hidden 100 and 2,048.

Run one kernel's check alone (it builds only that source), e.g.
``python3 -c "import torch, chip_smoke as cs; cs.check_vgg_block1(torch.device('cuda'))"``.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it holds the per-kernel JSON record.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.multiprocessing as torch_mp
import torch.nn.functional as F

from videonavqa_tpu_torch.cli import common as harness_mod
from videonavqa_tpu_torch.cli import dataset_stats as stats_cli
from videonavqa_tpu_torch.cli import generate_dataset as generate_cli
from videonavqa_tpu_torch.cli import export_checkpoint as export_cli
from videonavqa_tpu_torch.cli import extract_features as extract_mod
from videonavqa_tpu_torch.cli import predict as predict_mod
from videonavqa_tpu_torch.cli import q_and_v_eval, q_and_v_test, q_only_eval, q_only_test
from videonavqa_tpu_torch.cli import results_analysis, v_only_eval, v_only_test
from videonavqa_tpu_torch.cli import serve as serve_mod
from videonavqa_tpu_torch.cli import train_obj_detector as detector_mod
from videonavqa_tpu_torch.cli.common import PRESET_L_RATE, TRAIN_STEP_OPTIONS
from videonavqa_tpu_torch.data.pipeline import DataPaths, load_json
from videonavqa_tpu_torch.data.synthetic import generate_synthetic_dataset
from videonavqa_tpu_torch.data.vnr import VNRBatchLoader
from videonavqa_tpu_torch.datagen import generator as generator_mod
from videonavqa_tpu_torch.datagen.ontology import ANSWER_VOCAB
from videonavqa_tpu_torch.datagen import trajectory as trajectory_mod
from videonavqa_tpu_torch.kernels import _build
from videonavqa_tpu_torch.kernels import attn_tail as attn_mod
from videonavqa_tpu_torch.kernels import film_reencode as reenc_mod
from videonavqa_tpu_torch.kernels import int8_matmul as int8_mod
from videonavqa_tpu_torch.kernels import lstm as lstm_mod
from videonavqa_tpu_torch.kernels import vgg_block1 as block1_mod
from videonavqa_tpu_torch.models import ModelConfig, get_model
from videonavqa_tpu_torch.models import concat2d as concat_mod
from videonavqa_tpu_torch.models import mac as mac_model
from videonavqa_tpu_torch.models import q_only_lstm
from videonavqa_tpu_torch.models import v_only_cnn3d as c3d_mod
from videonavqa_tpu_torch.models.film import (
    INT8_FUSED_MAX_ROWS, INT8_REQUANT_F32_MAX_ROWS, film_values_over_frames)
from videonavqa_tpu_torch.models.time_multi_hop import film_values_all_frames
from videonavqa_tpu_torch.ops import initializers as init
from videonavqa_tpu_torch.ops.masking import attn_frame_mask, length_mask
from videonavqa_tpu_torch.ops.quant import (
    act_scale, conv2d_int8_prequant, quantize_act, quantize_weight_channelwise)
from videonavqa_tpu_torch.ops.video import normalize_video
from videonavqa_tpu_torch.parallel import collectives, launch, multihost
from videonavqa_tpu_torch.parallel.mesh import make_mesh, param_shardings, put_global
from videonavqa_tpu_torch.serve.engine import STEM_SEED, InferenceEngine
from videonavqa_tpu_torch.serve.loadgen import request as http
from videonavqa_tpu_torch.stem import init_obj_detector, init_vgg_partial, stem_features
from videonavqa_tpu_torch.stem import quant
from videonavqa_tpu_torch.train.step import (
    forward, make_eval_step, make_optimizer, make_train_step, tree_items, tree_leaves)
from videonavqa_tpu_torch.utils.checkpoint import (
    OPT_INNER_COUNT, epoch_path, params_from_jax, read_npz, save_checkpoint)
from videonavqa_tpu_torch.utils.device import tree_to
from videonavqa_tpu_torch.utils.zoo_export import save_reference_checkpoint
from videonavqa_tpu_torch.utils.zoo_import import import_model_checkpoint

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12        # outside the tensor cores
BF16_FLOPS = 989e12      # tensor cores
INT8_OPS = 1979e12       # tensor cores

# Tolerances.
RECURRENCE_ATOL = 1e-5   # f32 recurrences; sums taken in another order
YQ_MAX_STEP = 1          # int8 requant: at most one step apart ...
YQ_MAX_FRACTION = 1e-4   # ... on at most this share of elements
PROB_ATOL = 2e-2         # serving, kernel path vs plain path, probabilities
ARGMAX_MARGIN = 1e-2     # argmax must agree where the top-2 logit margin is wider
BLOCK1_F32_TOL = (2e-5, 2e-6)   # (rtol, atol) f32 block 1: the JAX kernel test's own
TRAIN_LOSS_RTOL = 1e-5   # train step, card vs CPU, f32: each step's loss
TRAIN_GRAD_TOL = 1e-5    # ... step 1's gradients, as a share of the largest gradient
TRAIN_PARAM_ATOL = 5e-4  # ... params and BN state after 3 steps (the JAX golden's bound)
# The two per-frame video models (v_only_cnn2d_lstm, concat2d): on ulp-sized
# differences their frame trunk's ReLUs and pools flip on a few of its
# millions of elements a step, the gradient jumps there, and Adam turns small
# gradient elements' signs into steps of ~lr. The JAX step does the same
# against itself on reordered sums; tests/test_torch_train_frame_models.py
# measures both and holds the port to these bounds there too.
FRAME_LATER_LOSS_RTOL = 2e-3  # their losses at steps 2-3
FRAME_TRUNK_GRAD_RTOL = 0.2   # step 1's trunk gradients, relative L2 per leaf
FRAME_NOISE_GRAD_TOL = 5e-5   # the conv biases' step-1 gradients (zero in exact
#                               arithmetic), as a share of the largest gradient
FRAME_PARAM_SHARE = 0.98      # params within TRAIN_PARAM_ATOL after 3 steps
EVAL_LOSS_RTOL = 1e-4         # eval step, kernel route vs plain route

REPO_SOURCE = {
    "film_reencode": ("videonavqa_tpu_torch/csrc/film_reencode.cu",
                      "videonavqa_tpu/kernels/film_reencode_pallas.py:65"),
    "attn_tail": ("videonavqa_tpu_torch/csrc/attn_tail.cu",
                  "videonavqa_tpu/kernels/attn_tail_pallas.py:60"),
    "int8_matmul_fused": ("videonavqa_tpu_torch/csrc/int8_matmul.cu",
                          "videonavqa_tpu/kernels/int8_matmul_pallas.py:58"),
    "lstm": ("videonavqa_tpu_torch/csrc/lstm.cu",
             "videonavqa_tpu/kernels/lstm_pallas.py:54"),
    "vgg_block1": ("videonavqa_tpu_torch/csrc/vgg_block1.cu",
                   "videonavqa_tpu/kernels/vgg_block1_pallas.py:109"),
}
COUNTERS = {"film_reencode": reenc_mod, "attn_tail": attn_mod, "int8_matmul_fused": int8_mod,
            "lstm": lstm_mod, "vgg_block1": block1_mod}


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters, warmup=2):
    """Mean device time of ``fn()`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, kernel, iters=10, windows=3):
    """Device time of one launch of the CUDA kernel named ``kernel`` inside
    ``fn()``, read from torch.profiler (CUPTI); raises where the profiler sees
    no such kernel in ``windows`` profiled windows (one window on the card
    once recorded no kernel at all of a path that launches one every call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for window in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
        count = sum(e.count for e in hits)
        if count:
            return sum(e.self_device_time_total for e in hits) / count / 1e3
        log(f"  profiler window {window + 1} of {windows} saw no {kernel} launch")
    raise AssertionError(f"the profiler saw no {kernel} launch")


# Substrings of the CUDA kernel names of each kernel of the port.
KERNEL_NAMES = {"film_reencode": ("film_reencode_kernel", "film_reencode_wide_kernel"),
                "attn_tail": ("attn_tail_kernel", "attn_tail_context_kernel",
                              "attn_tail_gates_kernel", "attn_tail_wide_kernel"),
                "int8_matmul_fused": ("int8_matmul_kernel", "int8_quantize_kernel"),
                "lstm": ("lstm_h128_cluster_kernel", "lstm_wide_kernel"),
                "vgg_block1": ("vgg_block1_bf16_kernel", "vgg_block1_f32_kernel")}


def device_breakdown(fn, top=8, tally=None):
    """(device busy ms, wall ms, [(kernel, ms)] by device time) of one ``fn()``;
    with ``tally`` ({name of KERNEL_NAMES: ms}), adds each port kernel's
    device ms to it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    if tally is not None:
        for name, subs in KERNEL_NAMES.items():
            tally[name] += sum(ms for key, ms in rows if any(sub in key for sub in subs))
    return sum(ms for _, ms in rows), wall, rows[:top]


def timings(kernel_fn, plain_fn, kernel, iters, plain_iters):
    """ms: the kernel's own device time per launch (profiler); wrapper_ms: one
    wrapper call, glue included, by CUDA events; plain_ms: the plain version."""
    return dict(wrapper_ms=time_ms(kernel_fn, iters), ms=kernel_device_ms(kernel_fn, kernel),
                plain_ms=time_ms(plain_fn, plain_iters, warmup=1))


def bound_ms(nbytes, ops, peak):
    """(least time in ms, which bound) for ``nbytes`` moved and ``ops`` done."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# Batch rows of the re-encode check: the served batch 1 and 32, and an odd
# count past one wave of 8-block clusters (16 clusters fill the 132 SMs).
REENC_BATCHES = (1, 32, 45)


def reencode_library(cell, emb, lens, num_frames):
    """The re-encode as PyTorch computes it, the yardstick of film_reencode
    that the port never calls: ``num_frames`` chained torch.nn.LSTM calls
    (cuDNN on the card) over the question packed by its lengths, each started
    from the previous call's (h_n, c_n). A packed sequence stops each row at
    its length, so h_n is the frozen carry. emb [B, Tq, E] -> fn() -> [F, B, H]."""
    from torch.nn.utils.rnn import pack_padded_sequence

    E, H = emb.shape[-1], cell["w_hh"].shape[1]
    lib = torch.nn.LSTM(E, H, batch_first=True).to(emb.device)
    with torch.no_grad():
        for name, key in (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh"),
                          ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh")):
            getattr(lib, name).copy_(cell[key])
    packed = pack_padded_sequence(emb, lens.cpu(), batch_first=True, enforce_sorted=False)

    def run():
        state, finals = None, []
        with torch.no_grad():
            for _ in range(num_frames):
                _, state = lib(packed, state)
                finals.append(state[0][0])
        return torch.stack(finals)
    return run


def check_film_reencode(dev):
    """B in REENC_BATCHES, Tq 56, H 128, F 35, ragged q_len including 1 and
    56, and ``library_ms``: reencode_library on cuDNN in f32 (TF32 off), held
    to the plain version with the same tolerance."""
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    H, E, Tq, F = 128, 128, 56, 35
    cell = init.reference_lstm(gen, E, H)
    cell_dev = {k: v.to(dev) for k, v in cell.items()}
    rows = {}
    for B in REENC_BATCHES:
        lens = torch.randint(1, Tq + 1, (B,), generator=gen, dtype=torch.int32)
        lens[0] = Tq if B == 1 else 1
        if B > 1:
            lens[1] = Tq
        emb = torch.randn((B, Tq, E), generator=gen)
        xw = (emb @ cell["w_ih"].t() + cell["b_ih"]).transpose(0, 1).contiguous()
        args = [t.to(dev) for t in (xw, cell["w_hh"], cell["b_hh"], lens)] + [F]
        want = reenc_mod.film_reencode_plain(*args)
        library = reencode_library(cell_dev, emb.to(dev), lens, F)
        lib_err = (library() - want).abs().max().item()
        log(f"  film_reencode B={B}: cuDNN yardstick vs plain max_abs_err {lib_err:.3e}"
            f" (atol {RECURRENCE_ATOL})")
        if not lib_err <= RECURRENCE_ATOL:
            raise AssertionError(f"film_reencode B={B}: the cuDNN yardstick disagrees: {lib_err}")
        got = reenc_mod.film_reencode(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        log(f"  film_reencode B={B}: max_abs_err {err:.3e} (atol {RECURRENCE_ATOL})")
        if not err <= RECURRENCE_ATOL:
            raise AssertionError(f"film_reencode B={B} disagrees: {err}")
        steps = F * int(lens.sum())
        nbytes = xw.numel() * 4 + cell["w_hh"].numel() * 4 + 4 * H * 4 + B * 4 + F * B * H * 4
        ops = steps * (2 * 4 * H * H + 12 * H)
        b_ms, b_by = bound_ms(nbytes, ops, F32_FLOPS)
        rows[B] = row = dict(
            max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(library, 10),
            **timings(lambda: reenc_mod.film_reencode(*args),
                      lambda: reenc_mod.film_reencode_plain(*args), "film_reencode_kernel",
                      10, 2))
        log(f"  film_reencode B={B}: {row['ms']:.4f} ms (wrapper {row['wrapper_ms']:.4f});"
            f" plain {row['plain_ms']:.3f} ms, cuDNN yardstick {row['library_ms']:.4f} ms,"
            f" bound {b_ms:.5f} ms by {b_by}; the serial chain is {F} x max q_len ="
            f" {F * int(lens.max())} dependent steps")
    return rows


# (B, T, A) of the attn_tail check beyond the timed served rows: attention
# sizes the kernel pads (64 to 128, 200 to 256), more frames than two warp
# passes (T 100), and more batch rows than one wave of clusters (B 64);
# check_attn_tail adds the most frames the kernel holds at 128 (B 1).
ATTN_EXTRA = ((4, 35, 64), (4, 35, 200), (4, 100, 128), (64, 35, 128))


def check_attn_tail(dev):
    """B in {1, 32}, T in {35, 20} (n_phantom 0 and 15), A 128, timed; then
    ATTN_EXTRA and the most frames the kernel holds at A 128 (n_phantom
    max(0, 35 - T)), each within RECURRENCE_ATOL; one frame more is refused."""
    gen = torch.Generator().manual_seed(2)
    S = 35
    most = _build.function("attn_tail", "attn_tail_max_frames", [ctypes.c_int])(128)
    rows, params_of = {}, {}
    for B, T, A in ([(B, T, 128) for B in (1, 32) for T in (35, 20)] + list(ATTN_EXTRA)
                    + [(1, most, 128)]):
        if A not in params_of:
            params = {"fc_hidden_attn": init.reference_linear(gen, 1, A),
                      "lstm_attn": init.reference_lstm(gen, A, A)}
            params_of[A] = {k: {n: t.to(dev) for n, t in v.items()} for k, v in params.items()}
        params = params_of[A]
        v_lens = torch.randint(1, T + 1, (B,), generator=gen, dtype=torch.int32)
        v_lens[0] = T
        v_lens = v_lens.to(dev)
        fmask = length_mask(v_lens, T)
        feats = (torch.randn((B, T, A), generator=gen).to(dev)) * fmask[..., None]
        scores = torch.where(fmask, torch.randn((B, T), generator=gen).to(dev), 0.0)
        mask = attn_frame_mask(v_lens, T)
        args = (params, feats, scores, mask, S, float(max(0, S - T)))
        got = attn_mod.attn_tail(*args)
        want = attn_mod.attn_tail_plain(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        log(f"  attn_tail B={B} T={T} A={A}: max_abs_err {err:.3e} (atol {RECURRENCE_ATOL})")
        if not err <= RECURRENCE_ATOL:
            raise AssertionError(f"attn_tail B={B} T={T} A={A} disagrees: {err}")
        if A != 128 or (B, T) not in ((1, 35), (1, 20), (32, 35), (32, 20)):
            rows[(B, T, A)] = dict(max_abs_err=err)
            continue
        # what the function needs: v cancels in the softmax, so the weights,
        # the context and its W_ih product once per row, the W_hh product
        # and the cell once per step; w_hid and b_hid are never read
        nbytes = 4 * (B * T * A + 2 * B * T + 2 * 4 * A * A + 4 * A + B * S * A)
        ops = B * (6 * T + 2 * T * A + 2 * 4 * A * A + 4 * A + S * (2 * 4 * A * A + 12 * A))
        b_ms, b_by = bound_ms(nbytes, ops, F32_FLOPS)
        rows[(B, T)] = dict(
            max_abs_err=err, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            **timings(lambda: attn_mod.attn_tail(*args),
                      lambda: attn_mod.attn_tail_plain(*args), "attn_tail_kernel", 20, 3))
        r = rows[(B, T)]
        log(f"  attn_tail B={B} T={T}: {r['ms']:.4f} ms (wrapper {r['wrapper_ms']:.4f}),"
            f" plain {r['plain_ms']:.3f} ms,"
            f" bound {b_ms:.5f} ms by {b_by}; the serial chain is {S} dependent steps")
    # every score far under v and no phantom frame (T 35): the max runs over
    # the frames, so no exp underflows to 0 / 0 (the BoW encoder's scale)
    B, T = 4, 35
    feats = torch.randn((B, T, 128), generator=gen).to(dev)
    scores = (-1e4 * (1 + torch.rand((B, T), generator=gen))).to(dev)
    args = (params_of[128], feats, scores, torch.zeros((B, T), device=dev), S, 0.0)
    got, want = attn_mod.attn_tail(*args), attn_mod.attn_tail_plain(*args)
    err = (got - want).abs().max().item()
    log(f"  attn_tail B={B} T={T}, scores ~ -1e4, no phantom frame: finite"
        f" {bool(torch.isfinite(got).all())}, max_abs_err {err:.3e}")
    if not (torch.isfinite(got).all() and err <= RECURRENCE_ATOL):
        raise AssertionError("attn_tail underflowed with no phantom frame")
    T = most + 1
    try:
        attn_mod.attn_tail(params_of[128], torch.zeros((1, T, 128), device=dev),
                           torch.zeros((1, T), device=dev), torch.zeros((1, T), device=dev), S, 0.0)
    except ValueError as err:
        log(f"  attn_tail at {T} frames, A=128: refused before any launch ({err})")
    else:
        raise AssertionError(f"attn_tail took {T} frames, past the {most} it holds")
    return rows


# (F, B, T, H) at which the served models launch the LSTM kernel: F passes
# chained in one launch (time_multi_hop's question re-encoded once per frame)
# and single passes (F = 1), with batch 1 at each hidden size; at hidden 512
# a chain the wrapper runs as one wide-kernel launch a pass.
LSTM_SHAPES = (
    (35, 16, 56, 128),   # time_multi_hop batch 16 at frame bucket 35, one launch
    (20, 16, 56, 128),   # time_multi_hop batch 16 at frame bucket 20
    (35, 1, 56, 128),    # time_multi_hop batch 1
    (1, 32, 56, 128),    # lstm (q-only) and concat2d's q_lstm
    (1, 16, 56, 128),    # one pass of time_multi_hop's chain (its launch before chaining)
    (1, 32, 35, 128),    # v_only_cnn2d_lstm and concat2d's v_lstm
    (1, 1, 56, 128),
    (1, 32, 56, 512),    # mac's biLSTM, forward and backward
    (1, 1, 56, 512),
    (1, 64, 56, 512),    # mac served at batch 64: two launches of 32 rows
    (3, 4, 20, 512),     # a chain at a hidden size other than 128: a launch a pass
    (1, 32, 35, 1536),   # mac's tail LSTM
    (1, 1, 35, 1536),
    (1, 33, 35, 1536),   # one batch row past a launch's 32
)
LSTM_MAIN = (35, 16, 56, 128)   # the shape on the JSON line: time_multi_hop's
LSTM_TIMED = (LSTM_MAIN, (1, 32, 56, 128), (1, 16, 56, 128), (1, 32, 56, 512),
              (1, 32, 35, 1536))
# Wide shapes of LSTM_SHAPES whose times check_lstm logs besides (not on the
# JSON line): mac's batch 1, and batches past 32 rows, which the wrapper runs
# as launches of 32 rows (its time covers every launch of the pass).
LSTM_WIDE_LOGGED = ((1, 1, 56, 512), (1, 64, 56, 512), (1, 1, 35, 1536), (1, 33, 35, 1536))


def check_lstm(dev):
    """Each (F, B, T, H) of LSTM_SHAPES: ragged lens including 1 and T, non-zero
    h0 and c0; outs of every pass, h_f and c_f within RECURRENCE_ATOL of the
    plain version (F chained lstm_plain calls) and outs exactly zero at
    t >= len in every pass. ``library_ms`` of a single pass is one
    torch.nn.LSTM forward (cuDNN) of the same shape from the same weights and
    state: it takes the un-projected input and has no length masking (every
    row runs all T steps), so it is a yardstick for the unmasked recurrence
    only; of a chain, F chained torch.nn.LSTM calls over the input packed by
    its lengths (``reencode_library``, from zero state)."""
    gen = torch.Generator().manual_seed(6)
    rows = {}
    for F, B, T, H in LSTM_SHAPES:
        cell = init.torch_default_lstm(gen, H, H) if H > 128 else init.reference_lstm(gen, H, H)
        lens = torch.randint(1, T + 1, (B,), generator=gen, dtype=torch.int32)
        lens[0] = T if B == 1 else 1
        if B > 1:
            lens[1] = T
        x = torch.randn((B, T, H), generator=gen)
        xw = (x @ cell["w_ih"].t() + cell["b_ih"]).transpose(0, 1).contiguous()
        h0, c0 = torch.randn((B, H), generator=gen), torch.randn((B, H), generator=gen)
        args = [t.to(dev) for t in (xw, cell["w_hh"], cell["b_hh"], lens, h0, c0)] + [F]
        got = lstm_mod.lstm_frames(*args)
        want = lstm_mod.lstm_frames_plain(*args)
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        past = torch.arange(T, device=dev)[:, None] >= args[3][None, :]          # [T, B]
        stray = float((got[0].abs() * past[..., None]).max())
        tag = f"F={F} B={B} T={T} H={H}"
        log(f"  lstm {tag}: max_abs_err {err:.3e} over outs, h_f, c_f (atol {RECURRENCE_ATOL});"
            f" largest |out| at t >= len: {stray}")
        if not err <= RECURRENCE_ATOL or stray != 0.0:
            raise AssertionError(f"lstm {tag} disagrees: {err}, {stray}")
        rows[(F, B, T, H)] = row = dict(max_abs_err=err)
        if (F, B, T, H) in LSTM_WIDE_LOGGED:
            run = lambda: lstm_mod.lstm_frames(*args)
            log(f"  lstm {tag}: {kernel_device_ms(run, 'lstm_wide_kernel'):.4f} ms a launch,"
                f" {-(-B // lstm_mod.wide_rows(H, dev))} launches a pass, wrapper"
                f" {time_ms(run, 10):.4f} ms")
        if (F, B, T, H) not in LSTM_TIMED:
            continue
        steps = F * int(lens.sum())
        nbytes = 4 * (xw.numel() + 4 * H * H + 4 * H + B + 2 * B * H + F * T * B * H + 2 * B * H)
        ops = steps * (2 * 4 * H * H + 12 * H)
        b_ms, b_by = bound_ms(nbytes, ops, F32_FLOPS)
        cell_dev = {k: v.to(dev) for k, v in cell.items()}
        if F > 1:
            library = reencode_library(cell_dev, x.to(dev), lens, F)
        else:
            lib = torch.nn.LSTM(H, H, batch_first=True).to(dev)
            with torch.no_grad():
                for name, key in (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh"),
                                  ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh")):
                    getattr(lib, name).copy_(cell_dev[key])
            x_dev, state = x.to(dev), (args[4][None], args[5][None])

            def library():
                with torch.no_grad():
                    return lib(x_dev, state)
        row.update(bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library, 10),
                   **timings(lambda: lstm_mod.lstm_frames(*args),
                             lambda: lstm_mod.lstm_frames_plain(*args),
                             "lstm_h128_cluster_kernel" if H == 128 else "lstm_wide_kernel",
                             10, 1 if F > 1 else 2))
        yard = f"{F} chained torch.nn.LSTM" if F > 1 else "torch.nn.LSTM (no masking)"
        log(f"  lstm {tag}: {row['ms']:.4f} ms (wrapper {row['wrapper_ms']:.4f}),"
            f" plain {row['plain_ms']:.3f} ms, {yard} {row['library_ms']:.4f} ms,"
            f" bound {b_ms:.5f} ms by {b_by}; the serial chain is F x max len ="
            f" {F * int(lens.max())} dependent steps, {steps} row-steps in all")
    return rows


# Seeded runs of the two kernels on the shared hidden-128 chain
# (lstm_cluster.cuh), whose bits this version of the kernels keeps: sha256 of
# their outputs' bytes, from numpy-seeded inputs (stable across library
# versions). film_reencode (B, Tq, F) and lstm (F, B, T) at hidden 128.
BITS_REENCODE = ((32, 56, 35), (1, 56, 35))
BITS_LSTM = ((35, 16, 56), (1, 32, 35))
# Recorded on an NVIDIA H100 80GB HBM3 (700 W) from the kernels as they were
# before attn_tail was redesigned, and equal to them after.
BITS_DIGESTS = {
    "film_reencode B=32 Tq=56 F=35":
        "ef58fa7ac668cedeee74d77319278899769f51e7ce5e6f00e08d1f9e25dc574e",
    "film_reencode B=1 Tq=56 F=35":
        "965946e6e4d7a42b897b2add586cf63e17ba47ca0cda863035240237282844e2",
    "lstm F=35 B=16 T=56 H=128":
        "6143189f10e0dd2896a41610703cc06f7f4b6b9f37e53fafe7e73a8ca9324fa6",
    "lstm F=1 B=32 T=35 H=128":
        "72d385843cff15faaea3b0070e98f57f39daf592273e251bbc43e95d3f5dba7a",
}


def bit_digests(dev):
    """{name: sha256 hex} of film_reencode's finals and lstm's (outs, h_f,
    c_f) at BITS_REENCODE and BITS_LSTM, hidden 128, ragged lengths."""
    import hashlib

    H = 128
    rng = np.random.default_rng(70)
    k = 1.0 / np.sqrt(H)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    def weights():
        w = rng.uniform(-k, k, (4 * H, H)).astype(np.float32)
        b = rng.uniform(-k, k, (4 * H,)).astype(np.float32)
        return torch.from_numpy(w).to(dev), torch.from_numpy(b).to(dev)

    def lens(B, T):
        n = rng.integers(1, T + 1, B).astype(np.int32)
        n[0] = T
        return torch.from_numpy(n).to(dev)

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    out = {}
    for B, Tq, F in BITS_REENCODE:
        w_hh, b_hh = weights()
        xw, q_len = arr(Tq, B, 4 * H), lens(B, Tq)
        out[f"film_reencode B={B} Tq={Tq} F={F}"] = digest(
            reenc_mod.film_reencode(xw, w_hh, b_hh, q_len, F))
    for F, B, T in BITS_LSTM:
        w_hh, b_hh = weights()
        xw, n = arr(T, B, 4 * H), lens(B, T)
        h0, c0 = arr(B, H, scale=0.5), arr(B, H, scale=0.5)
        out[f"lstm F={F} B={B} T={T} H={H}"] = digest(
            *lstm_mod.lstm_frames(xw, w_hh, b_hh, n, h0, c0, F))
    torch.cuda.synchronize()
    return out


def check_bits_unchanged(dev):
    """The hidden-128 kernels give the bits recorded in BITS_DIGESTS."""
    got = bit_digests(dev)
    for name, d in got.items():
        want = BITS_DIGESTS.get(name)
        log(f"  {name}: sha256 {d} ({'as recorded' if d == want else f'recorded {want}'})")
        if d != want:
            raise AssertionError(f"{name}: the outputs' bits moved")


def _bf16_ulp(v):
    """One bf16 unit in the last place at |v| (8 significant bits)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def check_int8_matmul(dev):
    """rows 4,550 (batch 1 x 35 frames x 10 x 13) and an odd count, 1024 -> 1024,
    x bf16 and f32, with and without ReLU and requant.

    The integer parts (quantize, int8 product) are exact; y must lie within
    one bf16 ulp of the plain version's; yq within one int8 step, on at most
    a tiny share of elements (f32 round-off at a rounding boundary)."""
    gen = torch.Generator().manual_seed(3)
    C = 1024
    w = init.reference_conv2d(gen, 1, 1, C, C)["weight"]
    wq, w_scale = quantize_weight_channelwise(w)
    wq2 = wq[:, :, 0, 0].contiguous().to(dev)
    w_scale = w_scale.to(dev)
    bias = (0.1 * torch.randn(C, generator=gen)).to(dev)
    rows = {}
    for M in (4550, 1337):
        for x_dtype, relu, requant in ((torch.bfloat16, True, True), (torch.float32, True, True),
                                       (torch.bfloat16, False, False)):
            x = torch.relu(torch.randn((M, C), generator=gen)).to(dev).to(x_dtype)
            sx = act_scale(1.25 * x.float().abs().amax())
            comb = (sx * w_scale).contiguous()
            y_ref, _ = int8_mod.int8_matmul_plain(x, wq2, comb, bias, sx, None, relu=relu,
                                                  out_dtype=torch.float32)
            nx = act_scale(1.25 * y_ref.abs().amax()) if requant else None
            args = (x, wq2, comb, bias, sx, nx)
            y, yq = int8_mod.int8_matmul_2d(*args, relu=relu, out_dtype=torch.bfloat16)
            y_p, yq_p = int8_mod.int8_matmul_plain(*args, relu=relu, out_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            y32, yp32 = y.float(), y_p.float()
            err = (y32 - yp32).abs().max().item()
            off_ulp = int(((y32 - yp32).abs() > _bf16_ulp(yp32)).sum())
            tag = f"M={M} x={str(x_dtype)[6:]} relu={relu} requant={requant}"
            log(f"  int8_matmul_fused {tag}: y max_abs_err {err:.3e},"
                f" elements beyond 1 bf16 ulp: {off_ulp}")
            if off_ulp:
                raise AssertionError(f"int8_matmul_fused {tag}: y beyond 1 bf16 ulp")
            if requant:
                step = (yq.int() - yq_p.int()).abs()
                frac = float((step > 0).float().mean())
                log(f"  int8_matmul_fused {tag}: yq max step {int(step.max())},"
                    f" share differing {frac:.2e}")
                if int(step.max()) > YQ_MAX_STEP or frac > YQ_MAX_FRACTION:
                    raise AssertionError(f"int8_matmul_fused {tag}: yq disagrees")
            if M == 4550 and relu and requant and x_dtype == torch.bfloat16:
                nbytes = M * C * 2 + C * C + 2 * C * 4 + 8 + M * C * 2 + M * C
                b_ms, b_by = bound_ms(nbytes, 2 * M * C * C, INT8_OPS)
                xq = quantize_act(x, sx)
                wt = wq2.t()
                rows["main"] = dict(
                    bound_ms=b_ms, bound_by=b_by,
                    library_ms=time_ms(lambda: torch._int_mm(xq, wt), 200),
                    **timings(lambda: int8_mod.int8_matmul_2d(*args, relu=True),
                              lambda: int8_mod.int8_matmul_plain(
                                  *args, relu=True, out_dtype=torch.bfloat16),
                              "int8_matmul_kernel", 200, 50))
                r = rows["main"]
                log(f"  int8_matmul_fused {tag}: {r['ms']:.4f} ms (wrapper {r['wrapper_ms']:.4f}),"
                    f" plain {r['plain_ms']:.4f} ms,"
                    f" torch._int_mm alone {r['library_ms']:.4f} ms, bound {b_ms:.5f} ms by {b_by}")
            rows.setdefault("errs", []).append(err)
    rows["stored"] = check_int8_requant_stored(dev, wq2, w_scale, bias, gen)
    return rows


# Folded rows of the stored-source check: batch 1 and batch 32 at 35 frames.
STORED_ROWS = (4550, 145600)


def check_int8_requant_stored(dev, wq2, w_scale, bias, gen):
    """The kernel's second requantization source (``requant_stored``, the
    JAX package's plain route, which the trunk takes above
    INT8_REQUANT_F32_MAX_ROWS) at STORED_ROWS, bf16 x and y with ReLU: y
    within one bf16 ulp of the plain version's, as with the f32 source, and
    yq bit-equal to ``quantize_act`` of the y the kernel stored and to the
    plain version's stored-source yq. Times the kernel with each source, in
    turns (f32, stored, stored, f32). -> {rows: (f32-source ms, stored ms)}."""
    C = wq2.shape[0]
    out = {}
    for M in STORED_ROWS:
        x = torch.relu(torch.randn((M, C), generator=gen)).to(dev).to(torch.bfloat16)
        sx = act_scale(1.25 * x.float().abs().amax())
        comb = (sx * w_scale).contiguous()
        y_ref, _ = int8_mod.int8_matmul_plain(x, wq2, comb, bias, sx, None, relu=True,
                                              out_dtype=torch.float32)
        nx = act_scale(1.25 * y_ref.abs().amax())
        args = (x, wq2, comb, bias, sx, nx)
        y, yq = int8_mod.int8_matmul_2d(*args, relu=True, requant_stored=True)
        y_p, yq_p = int8_mod.int8_matmul_plain(*args, relu=True, out_dtype=torch.bfloat16,
                                               requant_stored=True)
        _, yq_f32 = int8_mod.int8_matmul_2d(*args, relu=True)
        torch.cuda.synchronize()
        off_ulp = int(((y.float() - y_p.float()).abs() > _bf16_ulp(y_p.float())).sum())
        own = int((yq != quantize_act(y.float(), nx)).sum())
        plain = int((yq != yq_p).sum())
        moved = float((yq != yq_f32).float().mean())
        log(f"  int8_matmul_fused M={M} requant_stored: y elements beyond 1 bf16 ulp {off_ulp};"
            f" yq differing from quantize_act(stored y) {own}, from the plain version {plain}"
            f" (share of codes the f32 source gives otherwise: {moved:.2e})")
        if off_ulp or own or plain:
            raise AssertionError(f"int8_matmul_fused M={M} requant_stored: disagrees")
        del y, yq, y_p, yq_p, yq_f32, y_ref
        iters = max(10, 200 * 4550 // M)
        t = [kernel_device_ms(lambda st=st: int8_mod.int8_matmul_2d(
                 *args, relu=True, requant_stored=st), "int8_matmul_kernel", iters=iters)
             for st in (False, True, True, False)]
        out[M] = ((t[0] + t[3]) / 2, (t[1] + t[2]) / 2)
        log(f"  int8_matmul_fused M={M} device ms, f32 source {t[0]:.4f} / {t[3]:.4f},"
            f" stored source {t[1]:.4f} / {t[2]:.4f}"
            f" ({out[M][1] / out[M][0] - 1:+.1%})")
        del x, args
        torch.cuda.empty_cache()
    return out


# Folded rows (B x T x 10 x 13) of the gate sweep: those at which the trunk's
# 1x1 conv runs on the served paths (batch 1 T35, time_multi_hop batch 16 at
# T20 and T35, batch 32 at T20 and T35), then batch 128 and 256 at T35.
GATE_ROWS = (4550, 41600, 72800, 83200, 145600, 582400, 1164800)


def sweep_int8_gate(dev):
    """The two routes of one trunk block's 1x1 conv (1024 -> 1024, bf16) at
    each of GATE_ROWS, timed in turns (plain, fused, fused, plain) by CUDA
    events over whole calls, glue included, as the trunk calls them:

    - fused: ``matmul_int8_fused`` with ReLU and ``next_absmax`` (y and the
      int8 input of the 3x3 conv in one kernel);
    - plain: ``conv2d_int8_prequant`` (quantize, ``torch._int_mm``,
      dequant), ReLU, and the quantize the 3x3 conv then does itself.

    The fused route requantizes from the source the trunk picks at that
    count (the f32 y at or under INT8_REQUANT_F32_MAX_ROWS, else the stored
    one). Holds the two routes against each other (y within one bf16 ulp; yq
    bit-equal where both quantize the stored y, else within one int8 step),
    and INT8_FUSED_MAX_ROWS against the times: raises unless the fused route
    is the faster at every count at or under the gate and the plain route at
    every count above it.
    -> {rows: (fused ms, plain ms, kernel device ms)}."""
    cpu_gen = torch.Generator().manual_seed(12)
    gen = torch.Generator(device=dev).manual_seed(12)
    C = 1024
    wq, w_scale = (t.to(dev) for t in quantize_weight_channelwise(
        init.reference_conv2d(cpu_gen, 1, 1, C, C)["weight"]))
    wq2 = wq[:, :, 0, 0].contiguous()
    bias = (0.1 * torch.randn(C, generator=cpu_gen)).to(dev)
    out = {}
    for rows in GATE_ROWS:
        x = torch.relu(torch.randn((rows // 130, 10, 13, C), generator=gen, device=dev)
                       ).to(torch.bfloat16)
        a1 = 1.25 * x.float().abs().amax()

        def plain_res():
            return torch.relu(conv2d_int8_prequant(wq, w_scale, bias, x, a1,
                                                   out_dtype=torch.bfloat16))
        a3 = 1.25 * plain_res().float().abs().amax()

        def plain():
            res = plain_res()
            return res, quantize_act(res, act_scale(a3))

        stored = rows > INT8_REQUANT_F32_MAX_ROWS

        def fused():
            return int8_mod.matmul_int8_fused(x, wq2, w_scale, bias, a1, relu=True,
                                              next_absmax=a3, out_dtype=torch.bfloat16,
                                              requant_stored=stored)

        (y, yq), (yp, yqp) = fused(), plain()
        torch.cuda.synchronize()
        off_ulp = int(((y.float() - yp.float()).abs() > _bf16_ulp(yp.float())).sum())
        step = (yq.int() - yqp.int()).abs()
        log(f"  int8 gate sweep rows={rows} ({'stored' if stored else 'f32'} source): fused vs"
            f" plain route: y elements beyond 1 bf16 ulp {off_ulp}, yq max step"
            f" {int(step.max())}, share differing {float((step > 0).float().mean()):.2e}")
        if off_ulp or int(step.max()) > (0 if stored else YQ_MAX_STEP):
            raise AssertionError(f"int8 gate sweep rows={rows}: the routes disagree")
        del y, yq, yp, yqp, step
        iters = max(5, 200 * 4550 // rows)
        p1, f1, f2, p2 = (time_ms(fn, iters) for fn in (plain, fused, fused, plain))
        dev_ms = kernel_device_ms(fused, "int8_matmul_kernel", iters=5)
        out[rows] = ((f1 + f2) / 2, (p1 + p2) / 2, dev_ms)
        b_ms, _ = bound_ms(rows * C * 5 + C * C + 2 * C * 4 + 8, 2 * rows * C * C, INT8_OPS)
        log(f"  int8 gate sweep rows={rows}: fused route {f1:.4f} / {f2:.4f} ms (the kernel"
            f" alone {dev_ms:.4f}, bound {b_ms:.5f}), plain route {p1:.4f} / {p2:.4f} ms")
        del x
        torch.cuda.empty_cache()
    gate = INT8_FUSED_MAX_ROWS
    faster = [r for r, (f, p, _) in out.items() if f <= p]
    log(f"  int8 gate: INT8_FUSED_MAX_ROWS = {gate}; the fused route is faster at"
        f" {faster} rows in this run")
    if faster != [r for r in GATE_ROWS if r <= gate]:
        raise AssertionError(f"INT8_FUSED_MAX_ROWS = {gate} disagrees with this run's sweep")
    return out


# (M frames, dtype) of the block-1 check: batch 32 x 35 frames (the served
# batch, timed), batch 1 x 35, an odd count, and f32 for the tight check.
BLOCK1_RUNS = ((1120, torch.bfloat16), (35, torch.bfloat16), (7, torch.bfloat16),
               (35, torch.float32))


def check_vgg_block1(dev):
    """vgg_block1 against vgg_block1_plain at BLOCK1_RUNS, biases drawn
    non-zero so h1 outside the frame (zero) differs from relu(b1).

    f32: BLOCK1_F32_TOL. bf16: both compute h1 bit for bit alike (h1_plain),
    so they differ only in the order of conv1_2's 576 f32 sums. Each output
    must lie within one bf16 ulp of the plain one, plus the f32 bound on that
    order, 2 * 576 * 2^-24 * sum|terms| (sum|terms| = conv(|h1|, |w2|) + |b2|,
    the largest over the pooled window): ReLU cuts at zero, where the two
    sums can land on either side. ``library_ms`` is PyTorch's block 1 on
    cuDNN (``cudnn_block1``), a yardstick the port never calls."""
    torch.backends.cudnn.allow_tf32 = False   # the plain f32 conv in full f32, run alone too
    gen = torch.Generator().manual_seed(10)
    params = {name: init.reference_conv2d(gen, 3, 3, cin, 64)
              for name, cin in (("conv1_1", 3), ("conv1_2", 64))}
    for p in params.values():
        p["bias"] = 0.1 * torch.randn(64, generator=gen)
    params = {k: {n: t.to(dev) for n, t in v.items()} for k, v in params.items()}
    gdev = torch.Generator(device=dev).manual_seed(10)
    rows = {}
    for M, dtype in BLOCK1_RUNS:
        x = torch.randint(0, 256, (M, 160, 208, 3), generator=gdev, device=dev,
                          dtype=torch.uint8).float() / 255.0
        got = block1_mod.vgg_block1(params, x, dtype=dtype).float()
        torch.cuda.synchronize()
        err, worst, beyond_ulp = 0.0, 0.0, 0
        for lo in range(0, M, 160):   # the plain version in chunks: its f32 temporaries
            xs = x[lo:lo + 160]
            want = block1_mod.vgg_block1_plain(params, xs, dtype=dtype).float()
            diff = (got[lo:lo + 160] - want).abs()
            if dtype == torch.float32:
                tol = BLOCK1_F32_TOL[1] + BLOCK1_F32_TOL[0] * want.abs()
            else:
                h1 = block1_mod.h1_plain(params, xs, dtype=dtype).float().abs()
                w2 = params["conv1_2"]["weight"].to(dtype).float().abs()
                terms = F.conv2d(h1.permute(0, 3, 1, 2), w2, padding=1)
                terms = F.max_pool2d(terms + params["conv1_2"]["bias"].abs()[:, None, None], 2)
                ulp = _bf16_ulp(want)
                tol = ulp + 2 * 576 * 2.0 ** -24 * terms.permute(0, 2, 3, 1)
                beyond_ulp += int((diff > ulp).sum())
                del h1, terms
            err = max(err, diff.max().item())
            worst = max(worst, (diff / tol).max().item())
        tag = f"M={M} {str(dtype)[6:]}"
        log(f"  vgg_block1 {tag}: max_abs_err {err:.3e}, worst |err| / tolerance {worst:.3f}"
            + ("" if dtype == torch.float32 else f", elements beyond 1 bf16 ulp: {beyond_ulp}"))
        if not worst <= 1.0:
            raise AssertionError(f"vgg_block1 {tag} disagrees: {err}")
        rows[(M, dtype)] = row = dict(max_abs_err=err)
        if (M, dtype) != BLOCK1_RUNS[0]:
            continue
        ops = M * 2 * 160 * 208 * 64 * (27 + 576)
        nbytes = M * 160 * 208 * 3 * 2 + 64 * (27 + 576) * 2 + 2 * 64 * 4 + M * 80 * 104 * 64 * 2
        b_ms, b_by = bound_ms(nbytes, ops, BF16_FLOPS)
        lib_ms = cudnn_block1(params, x, got)
        row.update(bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   **timings(lambda: block1_mod.vgg_block1(params, x, dtype=dtype),
                             lambda: block1_mod.vgg_block1_plain(params, x, dtype=dtype),
                             "vgg_block1_bf16_kernel", 10, 2))
        log(f"  vgg_block1 {tag}: {row['ms']:.4f} ms (wrapper {row['wrapper_ms']:.4f}),"
            f" plain {row['plain_ms']:.3f} ms, PyTorch block 1 {lib_ms:.4f} ms,"
            f" bound {b_ms:.5f} ms by {b_by} ({ops / 1e12:.3f} TFLOP)")
    return rows


def cudnn_block1(params, x, kernel_out):
    """PyTorch's block 1 on the same frames in bf16, the yardstick of
    vgg_block1, which the port never calls: F.conv2d x2 with bias, ReLU and
    F.max_pool2d, channels-last (the frames' own memory order) and NCHW, each
    with cudnn.benchmark off and on (on: cuDNN tries its algorithms for the
    shape and keeps the fastest); and cuDNN's fused conv + bias + ReLU
    (``torch.cudnn_convolution_relu``) x2 with the 2x2 max as one reduction,
    channels-last, benchmark on. Logs each one's ms and its largest
    difference from the kernel's output, and with benchmark on its device
    time by kernel; returns the fastest ms."""
    ws = [params[n][k].to(torch.bfloat16) for n in ("conv1_1", "conv1_2")
          for k in ("weight", "bias")]
    xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)   # NCHW view of channels-last memory

    def weights(fmt):
        return [w.contiguous(memory_format=fmt) if w.dim() == 4 else w for w in ws]

    def composed(inp, fmt):
        w1, b1, w2, b2 = weights(fmt)

        def run():
            h = F.relu(F.conv2d(inp, w1, b1, padding=1))
            return F.max_pool2d(F.relu(F.conv2d(h, w2, b2, padding=1)), 2).permute(0, 2, 3, 1)
        return run

    def fused():
        w1, b1, w2, b2 = weights(torch.channels_last)

        def conv_relu(h, w, b):
            return torch.cudnn_convolution_relu(h, w, b, (1, 1), (1, 1), (1, 1), 1)
        y = conv_relu(conv_relu(xb, w1, b1), w2, b2).permute(0, 2, 3, 1)   # NHWC memory
        return y.reshape(-1, 80, 2, 104, 2, 64).amax(dim=(2, 4))

    nchw = xb.contiguous()
    variants = [("F.conv2d+relu+max_pool2d channels-last", False,
                 composed(xb, torch.channels_last)),
                ("F.conv2d+relu+max_pool2d channels-last", True, composed(xb, torch.channels_last)),
                ("F.conv2d+relu+max_pool2d NCHW", False, composed(nchw, torch.contiguous_format)),
                ("F.conv2d+relu+max_pool2d NCHW", True, composed(nchw, torch.contiguous_format)),
                ("cudnn_convolution_relu x2 + amax pool channels-last", True, fused)]
    saved = torch.backends.cudnn.benchmark
    times = []
    try:
        for name, bench, fn in variants:
            torch.backends.cudnn.benchmark = bench
            ms = time_ms(fn, 10)
            diff = (fn().float() - kernel_out).abs().max().item()
            log(f"  PyTorch block 1, {name}, cudnn.benchmark {'on' if bench else 'off'}:"
                f" {ms:.4f} ms, max |out - kernel out| {diff:.3e}")
            times.append(ms)
            if bench:
                busy, _, rows = device_breakdown(fn, top=8)
                log(f"    device time {busy:.3f} ms, by kernel:")
                for kname, t in rows:
                    log(f"    {t:9.4f} ms  {kname[:110]}")
    finally:
        torch.backends.cudnn.benchmark = saved
    return min(times)


def reset_counters():
    for mod in COUNTERS.values():
        mod.launches = 0


def read_counters():
    return {name: mod.launches for name, mod in COUNTERS.items()}


def check_probs(probs, n, num_classes=70):
    if probs.shape != (n, num_classes):
        raise AssertionError(f"probabilities of shape {probs.shape}")
    p = torch.from_numpy(probs)
    if not (torch.isfinite(p).all() and float((p.sum(dim=1) - 1.0).abs().max()) < 1e-3):
        raise AssertionError("probabilities are not finite or do not sum to 1")


def plain_path(eng, batch):
    """The plain path's logits on the card (the engine's generator seed)."""
    cfg = dataclasses.replace(eng.cfg, use_pallas_kernels=False)
    return eng.forward(batch, cfg, torch.Generator(device=eng.device).manual_seed(11))[0]


def port_on_cpu(eng, batch):
    """The port's logits on the CPU on the engine's weights and state (the
    calibrated int8 trunk's included), where the kernels' wrappers run their
    plain versions along the kernel path's route."""
    cpu = torch.device("cpu")
    return forward(eng.spec, eng.cfg, tree_to(eng.params, cpu), tree_to(eng.state, cpu),
                   tree_to(batch, cpu), torch.Generator().manual_seed(11))[0]


def compare_paths(eng, its, reference=plain_path):
    """Max |dprob| between the kernel path on the card and ``reference``
    (``plain_path`` or ``port_on_cpu``) of one padded batch on the engine's
    state, the same generator seed for both; raises beyond PROB_ATOL or on a
    differing argmax where the margin is wide."""
    cfg = eng.cfg
    batch = eng.make_batch(its)
    with torch.inference_mode():
        lk, _ = eng.forward(batch, cfg, torch.Generator(device=eng.device).manual_seed(11))
        lr = reference(eng, batch)
    n = len(its)
    lk, lr = lk[:n].float().cpu(), lr[:n].float().cpu()
    pdiff = (torch.softmax(lk, -1) - torch.softmax(lr, -1)).abs().max().item()
    top2 = lr.topk(2, dim=-1).values
    wide = (top2[:, 0] - top2[:, 1]) > ARGMAX_MARGIN
    agree = (lk.argmax(-1) == lr.argmax(-1))
    what = reference.__name__.replace("_", " ")
    frames = f" T{batch[eng.visual_key].shape[1]}" if eng.visual_key else ""
    log(f"  {cfg.model} kernel path vs {what}, batch {eng.B}{frames}:"
        f" max |dprob| {pdiff:.3e} (bound {PROB_ATOL}), argmax agree"
        f" {int(agree.sum())}/{n} ({int(wide.sum())} rows with margin > {ARGMAX_MARGIN})")
    if pdiff > PROB_ATOL or not bool(agree[wide].all()):
        raise AssertionError(f"{cfg.model}: the kernel path disagrees with the {what}")
    return pdiff


def per_video_ms(eng, its, iters, use_kernels):
    saved = eng.cfg
    eng.cfg = dataclasses.replace(saved, use_pallas_kernels=use_kernels)
    try:
        eng.run_batch(its)
        t0 = time.perf_counter()
        for _ in range(iters):
            eng.run_batch(its)
        return (time.perf_counter() - t0) / iters / len(its) * 1e3
    finally:
        eng.cfg = saved


def time_paths(label, eng, its, iters, tally, top=8):
    """(kernel path, plain path) ms/video of ``its``, and the device breakdown
    of one kernel-path batch, whose port-kernel device ms go into ``tally``."""
    ms = (per_video_ms(eng, its, iters, True), per_video_ms(eng, its, iters, False))
    busy, wall, rows = device_breakdown(lambda: eng.run_batch(its), top, tally)
    log(f"  {label}: kernel path {ms[0]:.4f} ms/video, plain path"
        f" {ms[1]:.4f} ms/video; one batch: device busy {busy:.3f} ms of"
        f" {wall:.3f} ms wall (idle share {max(0.0, 1 - busy / wall):.3f})")
    for name, t in rows:
        log(f"    {t:9.4f} ms  {name[:110]}")
    return ms


def feature_items(feats, cpu_gen, lo, hi, v_max):
    out = []
    for i in range(lo, hi):
        v = int(torch.randint(1, v_max + 1, (1,), generator=cpu_gen))
        q = int(torch.randint(1, 57, (1,), generator=cpu_gen))
        out.append((feats[i], v, torch.randint(1, 134, (q,), generator=cpu_gen).tolist()))
    return out


def serve_stem_model(dev, cfg, feats, big, seed, tally, label=None, batch1_reference=plain_path,
                     checkpoint_path=None):
    """One int8-trunk model over cached features: calibrate, then batch ``big``
    at frame buckets 20 and 35 and batch 1 at 35 frames, counted; the kernel
    path against the plain path (batch 1 against ``batch1_reference``);
    ms/video (under ``label``, by default the
    model's name). The engines' weights come from ``checkpoint_path``, else
    from seed 0. -> (launches, ms, worst |dprob|)."""
    label = label or cfg.model
    t0 = time.perf_counter()
    eng_big = InferenceEngine(cfg, checkpoint_path=checkpoint_path, seed=0, max_batch=big,
                              device=dev)
    eng1 = InferenceEngine(cfg, checkpoint_path=checkpoint_path, seed=0, max_batch=1,
                           device=dev)
    log(f"  {label} weights: 2 engines from {checkpoint_path or 'seed 0'} in"
        f" {time.perf_counter() - t0:.1f} s")
    cpu_gen = torch.Generator().manual_seed(seed)
    cal = feature_items(feats, cpu_gen, 0, big, 35)
    b20 = feature_items(feats, cpu_gen, 32, 32 + big, 20)
    b35 = feature_items(feats, cpu_gen, 64, 64 + big, 35)
    b35[0] = (b35[0][0], 35, b35[0][2])
    one = [(feats[96], 35, feature_items(feats, cpu_gen, 96, 97, 35)[0][2])]

    t0 = time.perf_counter()
    eng_big.run_batch(cal)   # first micro-batch: the f32 calibration pass
    eng1.run_batch(one)
    torch.cuda.synchronize()
    log(f"  each engine's first micro-batch"
        f"{' (the f32 int8 calibration pass)' if cfg.use_int8_trunk else ''}:"
        f" {time.perf_counter() - t0:.2f} s")
    if eng_big.needs_int8_calibration or eng1.needs_int8_calibration:
        raise AssertionError("the engines did not calibrate")
    runs = ((eng_big, b20), (eng_big, b35), (eng1, one))
    for eng, its in runs:   # warm-up
        eng.run_batch(its)

    reset_counters()
    outs = [eng.run_batch(its) for eng, its in runs]
    torch.cuda.synchronize()
    launches = read_counters()
    log(f"  {label} launches on its path (batch {big} at buckets 20 and 35, batch 1 at 35):"
        f" {launches}")
    for probs, (_, its) in zip(outs, runs):
        check_probs(probs, len(its))
    worst = max(compare_paths(eng, its) for eng, its in runs[:2])
    worst = max(worst, compare_paths(eng1, one, batch1_reference))
    ms = {f"{label} batch {big} T35": time_paths(f"{label} batch {big} T35", eng_big, b35, 3,
                                                 tally),
          f"{label} batch 1 T35": time_paths(f"{label} batch 1 T35", eng1, one, 10, tally)}
    return launches, ms, worst


def expect_launches(model, launches, want):
    """``want``: {kernel: exact count, or None for 'at least one'}; every
    other kernel must not have been launched."""
    for name, n in launches.items():
        w = want.get(name, 0)
        if (n < 1) if w is None else (n != w):
            raise AssertionError(f"{model}: {name} launched {n} times on its path, expected"
                                 f" {'at least 1' if w is None else w}")


def stem_share(label, eng, its, iters=3, top=8):
    """Logs the stem's ms and the whole forward's ms of one padded video batch
    (CUDA events), and the stem's device time by kernel (profiler)."""
    batch = eng.make_batch(its)

    def stem():
        return eng.features(batch)

    with torch.inference_mode():
        stem_ms = time_ms(stem, iters, 1)
        whole_ms = time_ms(lambda: eng.forward(batch), iters, 1)
        busy, _, rows = device_breakdown(stem, top)
    log(f"  {label}: stem {stem_ms:.3f} ms of {whole_ms:.3f} ms a forward (kernel path);"
        f" the stem's device time {busy:.3f} ms, by kernel:")
    for name, t in rows:
        log(f"    {t:9.4f} ms  {name[:110]}")


FILM_ATTN_CFG = ModelConfig(model="film_attn_pt", num_res_blocks=5, num_res_block_channels=1024,
                            hidden_size=128, at_hidden_size=128, embed_size=128,
                            num_input_channels=512, compute_dtype="bfloat16", max_num_frames=35,
                            max_q_len=56, vocab_size=134, num_classes=70,
                            use_pallas_kernels=True, use_int8_trunk=True)
FILM_ATTN_KERNELS = {"film_reencode": None, "attn_tail": None, "int8_matmul_fused": None}


def fused_1x1_launches(blocks, *rows):
    """Launches of the fused int8 1x1 kernel over forwards of these folded row
    counts: one per trunk block where the count is at or under the gate."""
    return blocks * sum(r <= INT8_FUSED_MAX_ROWS for r in rows)


def serve_film_attn_features(dev, feats, tally):
    """The eval.sh preset over cached features (serve_stem_model)."""
    launches, ms, worst = serve_stem_model(dev, FILM_ATTN_CFG, feats, 32, 5, tally)
    expect_launches(FILM_ATTN_CFG.model, launches, dict(
        FILM_ATTN_KERNELS, int8_matmul_fused=fused_1x1_launches(5, 32 * 20 * 130,
                                                                 32 * 35 * 130, 35 * 130)))
    return launches, ms, worst


def serve_film_attn_video(dev, video, tally, stem=None, label="from video"):
    """The eval.sh preset from raw uint8 video through the engine's video mode
    (``stem``: a stem callable, e.g. the int8 stem; by default the engine's
    seeded stem, block 1 through vgg_block1): calibrate on one set of videos,
    then serve batch 32 and batch 1 at 35 frames from others, counted; the
    kernel path against the plain path; ms/video and the stem's share."""
    cfg = FILM_ATTN_CFG
    t0 = time.perf_counter()
    eng_big = InferenceEngine(cfg, seed=0, max_batch=32, device=dev, from_video=True, stem=stem)
    eng1 = InferenceEngine(cfg, seed=0, max_batch=1, device=dev, from_video=True,
                           stem=eng_big.stem)
    log(f"  {cfg.model} {label} weights: stem {'given' if stem else 'from seed 1234'}, 2 engines"
        f" from seed 0 in {time.perf_counter() - t0:.1f} s")
    cpu_gen = torch.Generator().manual_seed(5)
    cal = feature_items(video, cpu_gen, 0, 32, 35)
    cal1 = feature_items(video, cpu_gen, 64, 65, 35)
    b35 = feature_items(video, cpu_gen, 32, 64, 35)
    b35[0] = (b35[0][0], 35, b35[0][2])
    one = [(video[65], 35, feature_items(video, cpu_gen, 65, 66, 35)[0][2])]

    t0 = time.perf_counter()
    eng_big.run_batch(cal)   # first micro-batch: the f32 calibration pass, on the stem's output
    eng1.run_batch(cal1)
    torch.cuda.synchronize()
    log(f"  int8 calibration on each engine's first micro-batch: {time.perf_counter() - t0:.2f} s")
    if eng_big.needs_int8_calibration or eng1.needs_int8_calibration:
        raise AssertionError("the engines did not calibrate")
    runs = ((eng_big, b35), (eng1, one))
    for eng, its in runs:   # warm-up
        eng.run_batch(its)

    reset_counters()
    outs = [eng.run_batch(its) for eng, its in runs]
    torch.cuda.synchronize()
    launches = read_counters()
    log(f"  {cfg.model} {label}, launches on its path (batch 32 and batch 1 at 35 frames):"
        f" {launches}")
    # the int8 stem quantizes block 1 with the rest: vgg_block1 launches 0 times there
    expect_launches(cfg.model, launches, dict(
        FILM_ATTN_KERNELS, vgg_block1=0 if stem else 2,
        int8_matmul_fused=fused_1x1_launches(5, 32 * 35 * 130, 35 * 130)))
    for probs, (_, its) in zip(outs, runs):
        check_probs(probs, len(its))
    worst = max(compare_paths(eng, its) for eng, its in runs)
    ms = {}
    for name, eng, its, iters in ((f"{cfg.model} {label} batch 32 T35", eng_big, b35, 3),
                                  (f"{cfg.model} {label} batch 1 T35", eng1, one, 10)):
        ms[name] = time_paths(name, eng, its, iters, tally)
        stem_share(name, eng, its)
    return launches, ms, worst


TIME_MULTI_HOP_CFG = ModelConfig(
    model="time_multi_hop", num_res_blocks=3, num_res_block_channels=1024, num_tail_channels=64,
    hidden_size=128, embed_size=128, num_input_channels=512, compute_dtype="bfloat16",
    max_num_frames=35, max_q_len=56, vocab_size=134, num_classes=70, use_pallas_kernels=True,
    use_int8_trunk=True)
# MAC at the ModelConfig defaults (mac_dim 512, 12 steps, dropout 0.15, bf16
# knowledge convs).
MAC_CFG = ModelConfig(model="mac", use_pallas_kernels=True)


def serve_time_multi_hop(dev, feats, tally):
    """eval.sh preset: 3 FiLM blocks x 1024 channels, 64 tail channels, batch 16.
    The LSTM kernel launches once a forward, all frames chained (3); the fused
    int8 1x1 kernel once per block in each forward at or under the row gate
    (batch 16: 41,600 and 72,800 folded rows; batch 1: 4,550)."""
    cfg = TIME_MULTI_HOP_CFG
    launches, ms, worst = serve_stem_model(dev, cfg, feats, 16, 7, tally)
    expect_launches(cfg.model, launches, {
        "lstm": 3,
        "int8_matmul_fused": fused_1x1_launches(3, 16 * 20 * 130, 16 * 35 * 130, 35 * 130)})
    return launches, ms, worst


def serve_zoo_model(dev, model, feats, lstm_per_forward, tally):
    """One of lstm, v_only_cnn2d_lstm, concat2d, mac at the ModelConfig
    defaults: one bucket-35 batch of 32 and one batch-1 call, counted; the
    kernel path against the plain path; ms/video."""
    cfg = ModelConfig(model=model, use_pallas_kernels=True)
    eng32 = InferenceEngine(cfg, seed=0, max_batch=32, device=dev)
    eng1 = InferenceEngine(cfg, seed=0, max_batch=1, device=dev)
    cpu_gen = torch.Generator().manual_seed(8)
    its = feature_items(feats, cpu_gen, 0, 33, 35)
    its[0] = (its[0][0], 35, its[0][2])
    its[32] = (its[32][0], 35, its[32][2])
    if eng32.visual_key == "video":
        gen = torch.Generator(device=dev).manual_seed(9)
        video = torch.randint(0, 256, (33, 35, 160, 208, 3), generator=gen, device=dev,
                              dtype=torch.uint8)
        its = [(video[i], v, q) for i, (_, v, q) in enumerate(its)]
    elif eng32.visual_key is None:
        its = [(None, 0, q) for _, _, q in its]
    runs = ((eng32, its[:32]), (eng1, its[32:]))
    for eng, b in runs:   # warm-up
        eng.run_batch(b)
    reset_counters()
    outs = [eng.run_batch(b) for eng, b in runs]
    torch.cuda.synchronize()
    launches = read_counters()
    log(f"  {model} launches on its path (batch 32 and batch 1): {launches}")
    expect_launches(model, launches, {"lstm": 2 * lstm_per_forward})
    for probs, (_, b) in zip(outs, runs):
        check_probs(probs, len(b))
    worst = max(compare_paths(eng, b) for eng, b in runs)
    ms = {f"{model} batch 32": time_paths(f"{model} batch 32", eng32, its[:32], 2, tally, top=5),
          f"{model} batch 1": time_paths(f"{model} batch 1", eng1, its[32:], 5, tally, top=5)}
    return launches, ms, worst


def serve_mac_batch64(dev, feats, tally):
    """mac at the ModelConfig defaults served at batch 64 through the engine:
    its biLSTM (hidden 512) and tail LSTM (1536) each run as two launches of
    32 batch rows. Counted, held against the plain path, timed."""
    cfg = MAC_CFG
    eng = InferenceEngine(cfg, seed=0, max_batch=64, device=dev)
    its = feature_items(feats, torch.Generator().manual_seed(13), 0, 64, 35)
    its[0] = (its[0][0], 35, its[0][2])
    eng.run_batch(its)   # warm-up
    reset_counters()
    probs = eng.run_batch(its)
    torch.cuda.synchronize()
    launches = read_counters()
    log(f"  mac launches at batch 64: {launches}")
    expect_launches("mac", launches, {"lstm": 6})
    check_probs(probs, 64)
    worst = compare_paths(eng, its)
    ms = {"mac batch 64": time_paths("mac batch 64", eng, its, 2, tally, top=5)}
    return launches, ms, worst

# film_gp_pt at its eval.sh preset (4 FiLM blocks x 1024 channels, 32 tail
# channels, hidden/embed 128, the static int8 trunk); film_attn_pt's preset
# with the BoW question encoder.
FILM_GP_CFG = ModelConfig(model="film_gp_pt", num_res_blocks=4, num_res_block_channels=1024,
                          num_tail_channels=32, hidden_size=128, embed_size=128,
                          num_input_channels=512, compute_dtype="bfloat16", max_num_frames=35,
                          max_q_len=56, vocab_size=134, num_classes=70,
                          use_pallas_kernels=True, use_int8_trunk=True)
FILM_ATTN_BOW_CFG = dataclasses.replace(FILM_ATTN_CFG, q_encoder="bow")


def serve_film_gp(dev, feats, tally):
    """film_gp_pt over cached features (serve_stem_model): the re-encode once
    a forward and the fused int8 1x1 kernel once a block of each
    non-calibrating forward (batch 32 at buckets 20 and 35, batch 1)."""
    cfg = FILM_GP_CFG
    launches, ms, worst = serve_stem_model(dev, cfg, feats, 32, 31, tally)
    expect_launches(cfg.model, launches, {
        "film_reencode": 3,
        "int8_matmul_fused": fused_1x1_launches(4, 32 * 20 * 130, 32 * 35 * 130, 35 * 130)})
    return launches, ms, worst


def serve_film_attn_bow(dev, feats, tally):
    """film_attn_pt with --q_encoder bow over cached features, int8 trunk: the
    attention tail once a forward, the fused int8 1x1 kernel once a block,
    the re-encode never. Its FiLM values are unbounded sums over 56 tokens,
    which at random weights make the attention near one-hot, so the int8
    codes decide frames on rows of no margin: above INT8_REQUANT_F32_MAX_ROWS
    the kernel path requantizes from the plain path's source and is held to
    it; at batch 1 (4,550 rows) the two routes requantize from other sources,
    as in the JAX package, and the card's kernel path is held to the port on
    the CPU, which takes its route."""
    launches, ms, worst = serve_stem_model(dev, FILM_ATTN_BOW_CFG, feats, 32, 32, tally,
                                           label="film_attn_pt (bow)",
                                           batch1_reference=port_on_cpu)
    expect_launches("film_attn_pt (bow)", launches, {
        "attn_tail": 3,
        "int8_matmul_fused": fused_1x1_launches(5, 32 * 20 * 130, 32 * 35 * 130, 35 * 130)})
    return launches, ms, worst


def serve_bow(dev, tally):
    """bow at its harness batch, 1,024 questions of up to 56 tokens: no
    kernel; its probabilities checked; ms/question."""
    cfg = ModelConfig(model="bow", use_pallas_kernels=True)
    eng = InferenceEngine(cfg, seed=0, max_batch=1024, device=dev)
    gen = torch.Generator().manual_seed(33)
    its = [(None, 0, torch.randint(1, 134, (int(torch.randint(1, 57, (1,), generator=gen)),),
                                   generator=gen).tolist()) for _ in range(1024)]
    eng.run_batch(its)   # warm-up
    reset_counters()
    probs = eng.run_batch(its)
    torch.cuda.synchronize()
    launches = read_counters()
    expect_launches("bow", launches, {})
    check_probs(probs, 1024)
    worst = compare_paths(eng, its)
    ms = {"bow batch 1024": time_paths("bow batch 1024", eng, its, 5, tally, top=5)}
    return launches, ms, worst


# v_only_cnn3d at the ModelConfig defaults (bf16 convs) served from uint8 video
# [32, T, 160, 208, 3]; the trimmed routes held in f32 (TF32 off) to the full
# zero-padded volume with the JAX trimming test's bound; the route sweep
# behind SPLICE_MAX_T and SPLICE_MAX_T_CACHED at batch 32, and each served
# bucket timed at batch 32 and 1.
C3D_CFG = ModelConfig(model="v_only_cnn3d", use_pallas_kernels=True)
C3D_LOGIT_TOL = dict(atol=2e-4, rtol=1e-5)
C3D_CHECKS = (("splice", 12), ("splice", 24), ("pad", 24), ("cached", 8), ("cached", 16))
SPLICE_SWEEP = (4, 8, 12, 16, 20, 24, 28, 32)
SPLICE_GATE_SLACK = 1.1   # the route the gates pick: within this factor of the fastest


@contextlib.contextmanager
def c3d_gates(splice, cached):
    """SPLICE_MAX_T and SPLICE_MAX_T_CACHED set for the block: (0, 0) pads
    every trimmed batch, (35, 0) splices it, (35, 35) takes a cached zero-run
    from the state."""
    saved = c3d_mod.SPLICE_MAX_T, c3d_mod.SPLICE_MAX_T_CACHED
    c3d_mod.SPLICE_MAX_T, c3d_mod.SPLICE_MAX_T_CACHED = splice, cached
    try:
        yield
    finally:
        c3d_mod.SPLICE_MAX_T, c3d_mod.SPLICE_MAX_T_CACHED = saved


ROUTE_GATES = {"pad": (0, 0), "splice": (35, 0), "cached": (35, 35)}


def c3d_state(state, gen):
    """Non-trivial BN running statistics (the init's are 0 and 1)."""
    return {k: {n: t + 0.05 * torch.rand(t.shape, generator=gen, device=t.device)
                for n, t in v.items()} for k, v in state.items()}


def c3d_route(spec, params, state, video, v_len, cfg, route, zc=None):
    """A function running one route's eval forward over ``video`` -> logits."""
    st = dict(state, c3d_zero=zc) if route == "cached" else state

    def run():
        with c3d_gates(*ROUTE_GATES[route]):
            return spec.apply(params, st, {"video": video, "v_len": v_len}, cfg)[0]

    return run


def check_c3d_routes(dev):
    """Each trimmed route in f32 against the full zero-padded volume at batch
    32 (videos of 1-8 frames) -> worst |dlogit|."""
    cfg = dataclasses.replace(C3D_CFG, compute_dtype="float32")
    spec = get_model(cfg.model)
    gen = torch.Generator(device=dev).manual_seed(41)
    params, state = spec.init(torch.Generator().manual_seed(0), cfg, dev)
    state = c3d_state(state, gen)
    v_len = torch.randint(1, 9, (32,), generator=gen, device=dev)
    video = seeded_video(32, 35, gen, dev)
    video[~length_mask(v_len, 35)] = 0
    worst = 0.0
    with torch.inference_mode():
        full = spec.apply(params, state, {"video": video, "v_len": v_len}, cfg)[0]
        zc = c3d_mod.precompute_c3d_zero_slices(params, state, cfg, [8, 16])
        for route, T in C3D_CHECKS:
            got = c3d_route(spec, params, state, video[:, :T], v_len, cfg, route, zc)()
            err = float((got - full).abs().max())
            ok = bool(torch.allclose(got, full, **C3D_LOGIT_TOL))
            log(f"  v_only_cnn3d f32 batch 32, {route} route at T{T} against the full volume:"
                f" max |dlogit| {err:.3e} (atol {C3D_LOGIT_TOL['atol']}, rtol"
                f" {C3D_LOGIT_TOL['rtol']})")
            if not ok:
                raise AssertionError(f"v_only_cnn3d: the {route} route at T{T} is not the full"
                                     " volume's answer")
            worst = max(worst, err)
    del video, full, params
    torch.cuda.empty_cache()
    return worst


def sweep_splice_gate(dev, B=32, sweep=SPLICE_SWEEP):
    """The eval forward's ms by route (pad, in-step splice, cached zero-run)
    at each bucket width of ``sweep``, bf16, batch ``B``; at batch 32, where
    the gates were measured, fails where the route SPLICE_MAX_T /
    SPLICE_MAX_T_CACHED pick is over SPLICE_GATE_SLACK times the fastest ->
    {T: {route: ms}}."""
    cfg = C3D_CFG
    spec = get_model(cfg.model)
    gen = torch.Generator(device=dev).manual_seed(42)
    params, state = spec.init(torch.Generator().manual_seed(0), cfg, dev)
    state = c3d_state(state, gen)
    v_len = torch.ones(B, dtype=torch.long, device=dev)
    video = seeded_video(B, max(sweep), gen, dev)
    out = {}
    with torch.inference_mode():
        zc = c3d_mod.precompute_c3d_zero_slices(params, state, cfg, sweep)
        for T in sweep:
            out[T] = {r: time_ms(c3d_route(spec, params, state, video[:, :T], v_len, cfg, r, zc),
                                 3, 1) for r in ("pad", "splice", "cached")}
    S, Cd = c3d_mod.SPLICE_MAX_T, c3d_mod.SPLICE_MAX_T_CACHED
    log(f"  v_only_cnn3d splice sweep, bf16 batch {B} (T: pad / splice / cached ms a forward);"
        f" gates SPLICE_MAX_T {S}, SPLICE_MAX_T_CACHED {Cd}: "
        + ", ".join(f"T{T}: {r['pad']:.2f} / {r['splice']:.2f} / {r['cached']:.2f}"
                    for T, r in out.items()))
    for T, r in out.items():
        if B != 32:
            break
        cached_pick = r["cached"] if T <= Cd else (r["splice"] if T <= S else r["pad"])
        plain_pick = r["splice"] if T <= S else r["pad"]
        if cached_pick > SPLICE_GATE_SLACK * min(r.values()) or \
                plain_pick > SPLICE_GATE_SLACK * min(r["pad"], r["splice"]):
            raise AssertionError(f"v_only_cnn3d at T{T}, batch {B}: the gates pick a route over"
                                 f" {SPLICE_GATE_SLACK}x the fastest ({r})")
    del video
    torch.cuda.empty_cache()
    return out


def serve_cnn3d(dev, tally):
    """v_only_cnn3d through the engine from seeded uint8 video with the frame
    buckets (the zero-run computed at load for every bucket the cached
    splice takes), batch 32 at buckets 8, 16, 24 and 35 and batch 1 at 8 and
    35, counted (no kernel); ms/video per bucket."""
    cfg = C3D_CFG
    eng32 = InferenceEngine(cfg, seed=0, max_batch=32, device=dev)
    eng1 = InferenceEngine(cfg, seed=0, max_batch=1, device=dev)
    log(f"  v_only_cnn3d engines: zero-run columns at load for buckets"
        f" {sorted(eng32.state['c3d_zero'], key=lambda k: int(k[1:]))}")
    gen = torch.Generator(device=dev).manual_seed(43)
    video = seeded_video(33, 35, gen, dev)
    runs = []
    for eng, T in ((eng32, 8), (eng32, 16), (eng32, 24), (eng32, 35), (eng1, 8), (eng1, 35)):
        n = eng.B
        lens = torch.randint(1, T + 1, (n,), generator=gen, device=dev).tolist()
        lens[0] = T
        its = []
        for i, v in enumerate(lens):
            frames = video[i].clone()
            frames[v:] = 0
            its.append((frames, v, [1, 2, 3]))
        runs.append((eng, T, its))
    for eng, _, its in runs:   # warm-up
        eng.run_batch(its)
    reset_counters()
    outs = [eng.run_batch(its) for eng, _, its in runs]
    torch.cuda.synchronize()
    launches = read_counters()
    expect_launches("v_only_cnn3d", launches, {})
    for probs, (_, _, its) in zip(outs, runs):
        check_probs(probs, len(its))
    ms = {}
    for eng, T, its in runs:
        route = "cached" if T <= c3d_mod.SPLICE_MAX_T_CACHED else (
            "splice" if T <= c3d_mod.SPLICE_MAX_T else "pad" if T < 35 else "full")
        label = f"v_only_cnn3d batch {eng.B} T{T} ({route})"
        ms[label] = time_paths(label, eng, its, 3 if eng.B > 1 else 5, tally, top=5)
    return launches, ms, 0.0


def serve(dev):
    """Every served path in turn -> (launches summed over the paths, ms, worst
    |dprob|, each port kernel's device ms summed over the profiled batches:
    one batch of each timed configuration, and v_only_cnn3d's route checks
    and sweeps)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    feats = torch.relu(torch.randn((32 * 3 + 1, 35, 10, 13, 512), generator=gen, device=dev)
                       ).to(torch.bfloat16)
    video = torch.randint(0, 256, (66, 35, 160, 208, 3), generator=gen, device=dev,
                          dtype=torch.uint8)
    total = dict.fromkeys(COUNTERS, 0)
    ms, worst, tally = {}, 0.0, dict.fromkeys(KERNEL_NAMES, 0.0)
    paths = [lambda: serve_film_attn_features(dev, feats, tally),
             lambda: serve_film_attn_video(dev, video, tally),
             lambda: serve_film_attn_video(
                 dev, video, tally, stem=int8_stem_fn(dev, normalize_video(video[64:65])),
                 label="from video, int8 stem"),
             lambda: serve_time_multi_hop(dev, feats, tally)]
    paths += [lambda m=m, n=n: serve_zoo_model(dev, m, feats, n, tally)
              for m, n in (("lstm", 1), ("v_only_cnn2d_lstm", 1), ("concat2d", 2), ("mac", 3))]
    paths.append(lambda: serve_mac_batch64(dev, feats, tally))
    paths += [lambda: serve_film_gp(dev, feats, tally),
              lambda: serve_film_attn_bow(dev, feats, tally),
              lambda: serve_zoo_model(dev, "concat3d", feats, 1, tally),
              lambda: serve_cnn3d(dev, tally), lambda: serve_bow(dev, tally)]
    for path in paths:
        launches, path_ms, path_worst = path()
        for name, n in launches.items():
            total[name] += n
        ms.update(path_ms)
        worst = max(worst, path_worst)
        torch.cuda.empty_cache()
    del feats, video
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    c3d = {"routes": check_c3d_routes(dev), "sweep 32": sweep_splice_gate(dev),
           "sweep 1": sweep_splice_gate(dev, B=1, sweep=(8, 16, 24))}
    log(f"  v_only_cnn3d route checks and sweeps in {time.perf_counter() - t0:.1f} s")
    return total, ms, worst, tally, c3d


# The small film_attn_pt of tests/test_torch_film_attn.py (f32).
TRAIN_SMALL = dict(num_classes=7, vocab_size=19, embed_size=8, hidden_size=8, at_hidden_size=8,
                   num_res_blocks=2, num_res_block_channels=16, num_input_channels=12,
                   num_tail_channels=4, max_num_frames=6, max_q_len=9,
                   compute_dtype="float32")
# The small widths of tests/test_torch_lstm_models.py (f32, the kernels asked
# for, which no train forward takes): the parity runs of the other models.
ZOO_SMALL = dict(num_classes=7, vocab_size=19, embed_size=8, hidden_size=8,
                 num_res_blocks=2, num_res_block_channels=16, num_input_channels=12,
                 num_tail_channels=4, mac_dim=8, mac_max_step=2, max_num_frames=6,
                 max_q_len=9, compute_dtype="float32", use_pallas_kernels=True)
FRAME_MODELS = ("v_only_cnn2d_lstm", "concat2d")


def seeded_class_weights(num_classes, seed):
    """The question-only harness's class weights stand-in: numpy-seeded, in
    [0.25, 1.25)."""
    return torch.from_numpy(
        (np.random.default_rng(seed).random(num_classes) + 0.25).astype(np.float32))


def train_batch(B, T, q_max, vocab, classes, seed, feat_shape=None, video=False):
    """Numpy-seeded train batch (question, lengths, labels; features of
    ``feat_shape`` [10, 13, C], or with ``video`` uint8 frames [160, 208, 3],
    zero past each v_len), as CPU tensors; one example runs all T frames and
    one all q_max tokens."""
    r = np.random.default_rng(seed)
    v_len = r.integers(1, T + 1, B)
    q_len = r.integers(1, q_max + 1, B)
    v_len[0], q_len[-1] = T, q_max
    q = r.integers(1, vocab, (B, q_max))
    q[np.arange(q_max)[None, :] >= q_len[:, None]] = 0
    batch = {"question": torch.from_numpy(q.astype(np.int64)),
             "q_len": torch.from_numpy(q_len.astype(np.int64)),
             "v_len": torch.from_numpy(v_len.astype(np.int64)),
             "label": torch.from_numpy(r.integers(0, classes, B).astype(np.int64))}
    if feat_shape is not None:
        v = np.maximum(r.standard_normal((B, T, *feat_shape)), 0).astype(np.float32)
        v[np.arange(T)[None, :] >= v_len[:, None]] = 0.0
        batch["v_features"] = torch.from_numpy(v)
    if video:
        v = r.integers(0, 256, (B, T, 160, 208, 3)).astype(np.uint8)
        v[np.arange(T)[None, :] >= v_len[:, None]] = 0
        batch["video"] = torch.from_numpy(v)
    return batch


def run_train_steps(cfg, dev, batches, lr, class_weights=None):
    """Steps of make_train_step (the model's TRAIN_STEP_OPTIONS) over
    ``batches`` from the model's weights of seed 0 on ``dev``, step i drawing
    from a generator on ``dev`` seeded i -> (losses, step 1's gradients,
    params, state)."""
    spec = get_model(cfg.model)
    params, state = spec.init(torch.Generator().manual_seed(0), cfg, dev)
    train = make_train_step(spec, cfg, make_optimizer(params, lr),
                            class_weights=None if class_weights is None else class_weights.to(dev),
                            **TRAIN_STEP_OPTIONS[cfg.model])
    losses, grads = [], None
    for i, b in enumerate(batches):
        state, m = train(params, state, tree_to(b, dev), torch.Generator(device=dev).manual_seed(i))
        losses.append(float(m["loss"]))
        if grads is None:
            grads = [p.grad.detach().cpu().clone() for p in tree_leaves(params)]
    return losses, grads, params, state


def drawn_on_cpu(draw):
    """A model's draw seam (concat2d's ``dropout_mask``, the question-only
    LSTM's ``initial_state``: ``(generator, shape, ..., device)``) that draws
    on the CPU from a generator seeded as the caller's, then moves the draw to
    the caller's device: the card's step and the CPU's draw alike."""

    def draw_there(generator, shape, *args):
        *rest, device = args
        out = draw(torch.Generator().manual_seed(generator.initial_seed()), shape, *rest,
                   torch.device("cpu"))
        return tree_to(list(out), device) if isinstance(out, tuple) else out.to(device)

    return draw_there


@contextlib.contextmanager
def cpu_draws():
    """The draw seams of concat2d and concat3d (``dropout_mask``) and of the
    question-only LSTM (``initial_state``) drawn on the CPU for the block."""
    seams = [(concat_mod, "dropout_mask"), (q_only_lstm, "initial_state")]
    draws = [getattr(mod, name) for mod, name in seams]
    for mod, name in seams:
        setattr(mod, name, drawn_on_cpu(getattr(mod, name)))
    try:
        yield
    finally:
        for (mod, name), draw in zip(seams, draws):
            setattr(mod, name, draw)


def parity_errors(card, cpu, frame_model):
    """Card vs CPU of run_train_steps' results -> ({measure: value}, passed).
    A frame model's trunk (its ReLUs and pools flip on ulps) is held to the
    FRAME_* bounds, the rest to the TRAIN_* bounds."""
    names = [n for n, _ in tree_items(cpu[2])]
    top = max(float(g.abs().max()) for g in cpu[1])
    trunk = [frame_model and n.startswith(("trunk/", "input_bn/")) for n in names]
    noise = [frame_model and n.startswith("trunk/conv") and n.endswith("/bias") for n in names]
    errs = {"loss": abs(card[0][0] - cpu[0][0]) / abs(cpu[0][0])}
    errs["later losses"] = max(abs(a - b) / abs(b) for a, b in zip(card[0][1:], cpu[0][1:]))
    errs["gradients"] = max((float((a - b).abs().max()) / top
                             for a, b, t in zip(card[1], cpu[1], trunk) if not t), default=0.0)
    pairs = list(zip(tree_leaves(card[2]) + tree_leaves(card[3]),
                     tree_leaves(cpu[2]) + tree_leaves(cpu[3])))
    diffs = [(a.detach().cpu() - b.detach()).abs() for a, b in pairs]
    if not frame_model:
        errs["params and state"] = max(float(d.max()) for d in diffs)
        return errs, (errs["loss"] <= TRAIN_LOSS_RTOL and errs["later losses"] <= TRAIN_LOSS_RTOL
                      and errs["gradients"] <= TRAIN_GRAD_TOL
                      and errs["params and state"] <= TRAIN_PARAM_ATOL)
    errs["noise leaves' gradients"] = max(max(float(a.abs().max()), float(b.abs().max())) / top
                                          for a, b, n in zip(card[1], cpu[1], noise) if n)
    errs["trunk gradients (rel. L2)"] = max(
        float((a - b).norm() / b.norm()) for a, b, t, n in zip(card[1], cpu[1], trunk, noise)
        if t and not n)
    param_diffs = torch.cat([d.flatten() for d in diffs[:len(names)]])
    errs["params within bound (share)"] = float((param_diffs <= TRAIN_PARAM_ATOL).float().mean())
    return errs, (errs["loss"] <= TRAIN_LOSS_RTOL
                  and errs["later losses"] <= FRAME_LATER_LOSS_RTOL
                  and errs["gradients"] <= TRAIN_GRAD_TOL
                  and errs["noise leaves' gradients"] <= FRAME_NOISE_GRAD_TOL
                  and errs["trunk gradients (rel. L2)"] <= FRAME_TRUNK_GRAD_RTOL
                  and errs["params within bound (share)"] >= FRAME_PARAM_SHARE)


def train_parity(dev):
    """(a): 3 train steps on the card against the same 3 on the CPU, f32,
    TF32 off: film_attn_pt at TRAIN_SMALL, the other five models at
    ZOO_SMALL (the frame models on seeded uint8 frames [3, 6, 160, 208, 3]),
    MAC without dropout (the card's generator and the CPU's draw different
    masks; the dropout is held to JAX on the CPU), concat2d's dropout and the
    question-only LSTM's (h0, c0) drawn on the CPU for both devices alike,
    the question-only LSTM with seeded class weights. Raises beyond the
    TRAIN_* bounds (a frame model's trunk: the FRAME_* bounds), or where a
    kernel was launched. Also film_gp_pt (LSTM and BoW encoders) at
    TRAIN_SMALL and bow at ZOO_SMALL with seeded class weights."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    feature_batches = [train_batch(3, 6, 9, 19, 7, 60 + i, (10, 13, 12)) for i in range(3)]
    video_batches = [train_batch(3, 6, 9, 19, 7, 63 + i, video=True) for i in range(3)]
    with cpu_draws():
        for cfg in (ModelConfig(**TRAIN_SMALL), ModelConfig(model="time_multi_hop", **ZOO_SMALL),
                    ModelConfig(model="mac", mac_dropout=0.0, **ZOO_SMALL),
                    *(ModelConfig(model=m, **ZOO_SMALL) for m in (*FRAME_MODELS, "lstm")),
                    *(ModelConfig(**{**TRAIN_SMALL, "model": "film_gp_pt", "q_encoder": e})
                      for e in ("lstm", "bow")),
                    ModelConfig(model="bow", **ZOO_SMALL)):
            t0 = time.perf_counter()
            frame_model = cfg.model in FRAME_MODELS
            batches = video_batches if frame_model else feature_batches
            weights = seeded_class_weights(7, 64) if cfg.model in ("lstm", "bow") else None
            cpu = run_train_steps(cfg, torch.device("cpu"), batches, 1e-3, weights)
            reset_counters()
            card = run_train_steps(cfg, dev, batches, 1e-3, weights)
            torch.cuda.synchronize()
            expect_launches(f"{cfg.model} train parity", read_counters(), {})
            errs, passed = parity_errors(card, cpu, frame_model)
            log(f"  train parity, {cfg.model} ({cfg.q_encoder} encoder), card vs CPU, small config"
                f" f32, 3 steps"
                f" ({time.perf_counter() - t0:.1f} s): losses {card[0]} vs {cpu[0]}; "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f" (bounds: {'FRAME_*, ' if frame_model else ''}TRAIN_*); no kernel launched")
            if not passed:
                raise AssertionError(f"{cfg.model} train step: the card disagrees with the CPU")


def train_preset(dev, cfg, label, batch, stem_fn, steps, profile_at, top=10,
                 class_weights=None, unit="training videos"):
    """make_train_step at a preset (the model's TRAIN_STEP_OPTIONS and
    PRESET_L_RATE) over ``batch`` (on the card) for ``steps`` steps from the weights of seed 0,
    step i drawing from a generator on the card seeded i; steps 2-4 timed by
    the host clock around synchronized steps, step ``profile_at`` profiled
    (none for 0). -> (losses, grad_norms, ms/step, launches over the timed
    steps, the trained params)."""
    spec = get_model(cfg.model)
    params, state = spec.init(torch.Generator().manual_seed(0), cfg, dev)
    train = make_train_step(spec, cfg, make_optimizer(params, PRESET_L_RATE[cfg.model]),
                            stem_fn=stem_fn, class_weights=class_weights,
                            **TRAIN_STEP_OPTIONS[cfg.model])
    gen = torch.Generator(device=dev)
    losses, norms, times, launches = [], [], [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(1, steps + 1):
        if i == 2:
            reset_counters()
        gen.manual_seed(i)
        if i == profile_at:
            out, t0 = [], time.perf_counter()
            busy, wall, rows = device_breakdown(
                lambda: out.append(train(params, state, batch, gen)), top)
            state, m = out[0]
            log(f"  {label}: one profiled step, device busy {busy:.3f} ms of {wall:.3f} ms"
                f" wall (idle share {max(0.0, 1 - busy / wall):.3f}; the profiler's step took"
                f" {time.perf_counter() - t0:.1f} s with its trace); top device ops:")
            for name, t in rows:
                log(f"    {t:9.4f} ms  {name[:110]}")
        else:
            t0 = time.perf_counter()
            state, m = train(params, state, batch, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i == 4:
            launches = read_counters()
    ms = sum(times[1:4]) / 3
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"  {label}: {ms:.1f} ms/step ({[round(t, 1) for t in times[1:4]]}), "
        f"{len(batch['label']) / ms * 1e3:.2f} {unit}/s, peak memory {peak:.2f} GiB,"
        f" launches over steps 2-4 {launches}; losses {[round(x, 4) for x in losses]},"
        f" grad_norms {[round(x, 4) for x in norms]}")
    return losses, norms, ms, launches, params


def check_losses(label, losses, norms, falls=True, window=1):
    """Every loss and grad norm finite, and (``falls``) the mean of the last
    ``window`` losses under that of the first ``window``."""
    fell = np.mean(losses[-window:]) < np.mean(losses[:window])
    if not all(np.isfinite(losses + norms)) or (falls and not fell):
        raise AssertionError(f"{label}: losses {losses}, grad norms {norms}: not all finite"
                             + (f", or the last {window} losses are not under the first"
                                if falls else ""))


def check_stem_untouched(label, stem):
    if any(t.requires_grad or t.grad is not None for t in tree_leaves(list(stem))):
        raise AssertionError(f"{label}: a gradient reached the frozen stem")


def fwd_bwd_ms(params, fn, iters=3, warmup=True):
    """Host ms (synchronized) of ``fn()``, a plain function of ``params``
    (which require grad), and the backward of its sum; without ``warmup``
    where train steps of the same shapes have run just before."""

    def run():
        for p in tree_leaves(params):
            p.grad = None
        fn().sum().backward()
        torch.cuda.synchronize()

    if warmup:
        run()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    return (time.perf_counter() - t0) / iters * 1e3


def stem_ms_of(stem_fn, video):
    with torch.no_grad():
        return time_ms(lambda: stem_fn(normalize_video(video)), 3, 1)


def seeded_features(B, T, cfg, gen, dev):
    return torch.relu(torch.randn((B, T, 10, 13, cfg.num_input_channels), generator=gen,
                                  device=dev)).to(torch.bfloat16)


def seeded_video(B, T, gen, dev):
    return torch.randint(0, 256, (B, T, 160, 208, 3), generator=gen, device=dev,
                         dtype=torch.uint8)


def train_film_attn(dev, stem_fn):
    """(b) and (c) -> (launches over (c)'s counted steps, features ms/step,
    video ms/step, stem ms)."""
    cfg = FILM_ATTN_CFG
    B, T = 32, cfg.max_num_frames
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(21)
    batch = tree_to(train_batch(B, T, cfg.max_q_len, cfg.vocab_size, cfg.num_classes, 22), dev)
    batch["v_features"] = seeded_features(B, T, cfg, gen, dev)
    losses, norms, feat_ms, feat_launches, params = train_preset(
        dev, cfg, f"(b) film_attn_pt train step from bf16 features, batch {B} T{T}", batch, None,
        8, 5)
    expect_launches("film_attn_pt train from features", feat_launches, {})
    check_losses("film_attn_pt train from features", losses, norms)
    reenc_ms = fwd_bwd_ms(params, lambda: film_values_over_frames(
        params, batch["question"], batch["q_len"], T, cfg))
    log(f"  (b) in {time.perf_counter() - t0:.1f} s; loss {losses[0]:.4f} -> {losses[-1]:.4f}"
        f" over 8 steps on one batch; the plain re-encode's forward and backward alone"
        f" {reenc_ms:.1f} ms, {reenc_ms / feat_ms:.3f} of a step")
    del batch, params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    batch = tree_to(train_batch(B, T, cfg.max_q_len, cfg.vocab_size, cfg.num_classes, 23), dev)
    batch["video"] = seeded_video(B, T, gen, dev)
    losses, norms, video_ms, video_launches, _ = train_preset(
        dev, cfg, f"(c) film_attn_pt train step from uint8 video, batch {B} T{T}", batch, stem_fn,
        5, 5)
    expect_launches("film_attn_pt train from video", video_launches, {"vgg_block1": 3})
    check_losses("film_attn_pt train from video", losses, norms, falls=False)
    check_stem_untouched("film_attn_pt train from video", stem_fn.args)
    stem_ms = stem_ms_of(stem_fn, batch["video"])
    log(f"  (c) in {time.perf_counter() - t0:.1f} s; the stem alone {stem_ms:.1f} ms (CUDA"
        f" events), {stem_ms / video_ms:.3f} of a {video_ms:.1f} ms step; vgg_block1 1"
        f" launch a step")
    return video_launches, feat_ms, video_ms, stem_ms


def train_time_multi_hop(dev):
    """(d): the eval.sh preset from bf16 features, 5 steps on one batch (the
    fifth profiled), the LSTM kernel never launched -> ms/step."""
    cfg = TIME_MULTI_HOP_CFG
    B, T = 16, cfg.max_num_frames
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(24)
    batch = tree_to(train_batch(B, T, cfg.max_q_len, cfg.vocab_size, cfg.num_classes, 25), dev)
    batch["v_features"] = seeded_features(B, T, cfg, gen, dev)
    label = f"(d) time_multi_hop train step from bf16 features, batch {B} T{T}"
    losses, norms, ms, launches, params = train_preset(dev, cfg, label, batch, None, 5, 5)
    expect_launches("time_multi_hop train from features", launches, {})
    check_losses("time_multi_hop train from features", losses, norms)
    hop_ms = fwd_bwd_ms(params, lambda: film_values_all_frames(
        params, batch["question"], batch["q_len"], T, cfg), iters=1, warmup=False)
    log(f"  (d) in {time.perf_counter() - t0:.1f} s; loss {losses[0]:.4f} -> {losses[-1]:.4f}"
        f" over 5 steps on one batch; the plain hop encoder's LSTM chain and hops, forward and"
        f" backward alone {hop_ms:.1f} ms, {hop_ms / ms:.3f} of a step")
    return ms


def train_mac(dev, stem_fn):
    """(e): MAC at batch 32 T35 with dropout, from bf16 features (6 steps) and
    from uint8 video through the stem (5 steps), each on one batch, the LSTM
    kernel never launched -> (launches over the video form's counted steps,
    features ms/step, video ms/step, stem ms)."""
    cfg = MAC_CFG
    B, T = 32, cfg.max_num_frames
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(26)
    batch = tree_to(train_batch(B, T, cfg.max_q_len, cfg.vocab_size, cfg.num_classes, 27), dev)
    batch["v_features"] = seeded_features(B, T, cfg, gen, dev)
    losses, norms, feat_ms, launches, _ = train_preset(
        dev, cfg, f"(e) mac train step from bf16 features, batch {B} T{T}", batch, None, 6, 5)
    expect_launches("mac train from features", launches, {})
    check_losses("mac train from features", losses, norms)
    log(f"  (e) features in {time.perf_counter() - t0:.1f} s; loss {losses[0]:.4f} ->"
        f" {losses[-1]:.4f} over 6 steps on one batch")
    del batch
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    batch = tree_to(train_batch(B, T, cfg.max_q_len, cfg.vocab_size, cfg.num_classes, 28), dev)
    batch["video"] = seeded_video(B, T, gen, dev)
    losses, norms, video_ms, video_launches, _ = train_preset(
        dev, cfg, f"(e) mac train step from uint8 video, batch {B} T{T}", batch, stem_fn, 5, 5)
    expect_launches("mac train from video", video_launches, {"vgg_block1": 3})
    check_losses("mac train from video", losses, norms)
    check_stem_untouched("mac train from video", stem_fn.args)
    stem_ms = stem_ms_of(stem_fn, batch["video"])
    log(f"  (e) video in {time.perf_counter() - t0:.1f} s; loss {losses[0]:.4f} ->"
        f" {losses[-1]:.4f} over 5 steps; the stem alone {stem_ms:.1f} ms (CUDA events),"
        f" {stem_ms / video_ms:.3f} of a {video_ms:.1f} ms step; vgg_block1 1 launch a step")
    return video_launches, feat_ms, video_ms, stem_ms


def train_three_models(dev):
    """(f): v_only_cnn2d_lstm and concat2d at the ModelConfig defaults (hidden
    128, bf16 trunk, the kernels asked for) at batch 32 T35 from seeded uint8
    video (concat2d with 56-token questions and dropout 0.5 from the step's
    generator), and the question-only lstm at its harness default (batch
    1,024, 56 tokens, lr 1e-5, seeded class weights; 30 steps: each draws
    other (h0, c0), which move its loss by ~2e-3, and a step at lr 1e-5 takes
    ~4e-4 off it, so its mean over the last 10 steps must fall under that over
    the first 10); each on one batch, its fifth step profiled, no kernel
    launched -> {label: (batch, ms/step)}."""
    out = {}
    gen = torch.Generator(device=dev)
    for model, B, steps in (("v_only_cnn2d_lstm", 32, 5), ("concat2d", 32, 5), ("lstm", 1024, 30)):
        t0 = time.perf_counter()
        cfg = ModelConfig(model=model, use_pallas_kernels=True)
        spec = get_model(model)
        T = cfg.max_num_frames
        batch = tree_to(train_batch(B, T, cfg.max_q_len, cfg.vocab_size, cfg.num_classes,
                                    70 + len(out)), dev)
        weights = None
        if spec.needs_video:
            gen.manual_seed(71 + len(out))
            video = seeded_video(B, T, gen, dev)
            video[~length_mask(batch["v_len"], T)] = 0   # padding frames are zero
            batch["video"] = video
            label = f"(f) {model} train step from uint8 video, batch {B} T{T}"
        else:
            weights = seeded_class_weights(cfg.num_classes, 72).to(dev)
            label = f"(f) {model} train step, batch {B}, {cfg.max_q_len} tokens, class weights"
        losses, norms, ms, launches, _ = train_preset(
            dev, cfg, label, batch, None, steps, 5, class_weights=weights,
            unit="training videos" if spec.needs_video else "training questions")
        expect_launches(f"{model} train", launches, {})
        window = 1 if spec.needs_video else 10   # lstm: means over 10 steps' draws
        check_losses(f"{model} train", losses, norms, window=window)
        log(f"  (f) {model} in {time.perf_counter() - t0:.1f} s; loss (mean of {window})"
            f" {np.mean(losses[:window]):.4f} -> {np.mean(losses[-window:]):.4f} over {steps}"
            f" steps on one batch; lstm launches 0")
        out[f"{model} from {'video' if spec.needs_video else 'questions'}"] = (B, ms)
        del batch
        torch.cuda.empty_cache()
    return out


# The C3D models card vs CPU: their geometry is fc6's (160x208x35), at batch
# 2. At batch 2 the train step's head BatchNorms amplify float noise (sums
# taken in another order): tests/test_torch_cnn3d.py measures the JAX step
# against itself on swapped rows (gradients 7.5e-3 of a leaf's largest, the
# loss 9.1e-5) and holds the port to 1e-2 and 2e-2; the card and the CPU
# differ by up to 1.6e-2 (PERF.md, section 6), within the trunk's bound, which
# holds every leaf here.
C3D_SMALL = dict(num_classes=7, vocab_size=19, embed_size=8, max_q_len=9,
                 compute_dtype="float32", use_pallas_kernels=True)
C3D_LOSS_RTOL = 2e-4
C3D_GRAD_TOL = 2e-2   # of each leaf's largest


def c3d_parity(dev):
    """One train step of v_only_cnn3d and concat3d (dropout on, its mask drawn
    on the CPU for both) on the card against the CPU, f32, TF32 off, from
    seeded uint8 video [2, 35, 160, 208, 3]: the loss and each leaf's
    gradient to the C3D_* bounds, no kernel launched."""
    batch = train_batch(2, 35, 9, 19, 7, 90, video=True)
    for model in ("v_only_cnn3d", "concat3d"):
        t0 = time.perf_counter()
        cfg = ModelConfig(model=model, **C3D_SMALL)
        with cpu_draws():
            cpu = run_train_steps(cfg, torch.device("cpu"), [batch], 1e-4)
            reset_counters()
            card = run_train_steps(cfg, dev, [batch], 1e-4)
            torch.cuda.synchronize()
        expect_launches(f"{model} train parity", read_counters(), {})
        loss_err = abs(card[0][0] - cpu[0][0]) / abs(cpu[0][0])
        errs = {}
        for (name, _), a, b in zip(tree_items(cpu[2]), card[1], cpu[1]):
            errs[name] = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)
        worst = max(errs, key=errs.get)
        log(f"  train parity, {model}, card vs CPU, batch 2 T35 f32, 1 step"
            f" ({time.perf_counter() - t0:.1f} s): loss {card[0][0]:.6f} vs {cpu[0][0]:.6f}"
            f" (rel. {loss_err:.3e}, bound {C3D_LOSS_RTOL}); gradients within"
            f" {errs[worst]:.3e} of a leaf's largest ({worst}; bound {C3D_GRAD_TOL}); no kernel"
            " launched")
        if loss_err > C3D_LOSS_RTOL or errs[worst] > C3D_GRAD_TOL:
            raise AssertionError(f"{model} train step: the card disagrees with the CPU")


def train_zoo_rest(dev):
    """(h): film_gp_pt at its eval.sh preset from bf16 features, v_only_cnn3d
    and concat3d at the ModelConfig defaults (batch 32, mean loss, clip 1.0,
    Adam 1e-4) from seeded uint8 video at T35 and at bucket 12 through the
    splice (videos of up to 12 frames), 5 steps each, and bow at its harness
    default (batch 1,024, class weights, Adam 1e-5, no clip), 30 steps; each
    on one batch, every loss and grad_norm finite, no kernel launched;
    v_only_cnn3d's full-volume fifth step profiled -> {label: (batch,
    ms/step)}."""
    out = {}
    gen = torch.Generator(device=dev)
    cfg = FILM_GP_CFG
    batch = tree_to(train_batch(32, 35, cfg.max_q_len, cfg.vocab_size, cfg.num_classes, 91), dev)
    gen.manual_seed(92)
    batch["v_features"] = seeded_features(32, 35, cfg, gen, dev)
    losses, norms, ms, launches, _ = train_preset(
        dev, cfg, "(h) film_gp_pt train step from bf16 features, batch 32 T35", batch, None, 5, 0)
    expect_launches("film_gp_pt train", launches, {})
    check_losses("film_gp_pt train", losses, norms, falls=False)
    out["film_gp_pt from features"] = (32, ms)
    del batch
    torch.cuda.empty_cache()
    for model in ("v_only_cnn3d", "concat3d"):
        cfg = ModelConfig(model=model, use_pallas_kernels=True)
        for T in (35, 12):
            batch = tree_to(train_batch(32, 35, cfg.max_q_len, cfg.vocab_size, cfg.num_classes,
                                        93), dev)
            batch["v_len"] = torch.clamp(batch["v_len"], max=T)
            gen.manual_seed(94)
            video = seeded_video(32, 35, gen, dev)
            video[~length_mask(batch["v_len"], 35)] = 0
            batch["video"] = video[:, :T].contiguous()
            del video
            label = f"(h) {model} train step from uint8 video, batch 32 T{T}"
            with c3d_gates(35, 0):   # bucket 12 through the in-step splice
                losses, norms, ms, launches, _ = train_preset(
                    dev, cfg, label, batch, None, 5,
                    5 if (model, T) == ("v_only_cnn3d", 35) else 0)
            expect_launches(f"{model} train", launches, {})
            check_losses(f"{model} train", losses, norms, falls=False)
            out[f"{model} from video T{T}"] = (32, ms)
            del batch
            torch.cuda.empty_cache()
    cfg = ModelConfig(model="bow", use_pallas_kernels=True)
    batch = tree_to(train_batch(1024, 35, cfg.max_q_len, cfg.vocab_size, cfg.num_classes, 95),
                    dev)
    losses, norms, ms, launches, _ = train_preset(
        dev, cfg, "(h) bow train step, batch 1024, 56 tokens, class weights", batch, None, 30, 0,
        class_weights=seeded_class_weights(cfg.num_classes, 96).to(dev),
        unit="training questions")
    expect_launches("bow train", launches, {})
    check_losses("bow train", losses, norms, window=10)
    out["bow from questions"] = (1024, ms)
    return out


def train(dev):
    """(a)-(f) -> (launches over (c)'s and (e)'s counted steps, {label:
    (batch, ms/step)}, {label: stem ms})."""
    t0 = time.perf_counter()
    train_parity(dev)
    c3d_parity(dev)
    log(f"  (a) in {time.perf_counter() - t0:.1f} s")

    sgen = torch.Generator().manual_seed(STEM_SEED)
    stem = [tree_to(t, dev) for t in (init_vgg_partial(sgen),
                                      *init_obj_detector(
                                          sgen, num_filters=FILM_ATTN_CFG.num_input_channels))]
    stem_fn = functools.partial(stem_features, *stem, dtype=torch.bfloat16, use_kernel=True)
    film_launches, film_feat, film_video, film_stem = train_film_attn(dev, stem_fn)
    tmh_ms = train_time_multi_hop(dev)
    torch.cuda.empty_cache()
    mac_launches, mac_feat, mac_video, mac_stem = train_mac(dev, stem_fn)
    torch.cuda.empty_cache()
    launches = {k: film_launches[k] + mac_launches[k] for k in film_launches}
    ms = {"film_attn_pt from features": (32, film_feat),
          "film_attn_pt from video": (32, film_video),
          "time_multi_hop from features": (16, tmh_ms), "mac from features": (32, mac_feat),
          "mac from video": (32, mac_video), **train_three_models(dev)}
    torch.cuda.empty_cache()
    ms.update(train_zoo_rest(dev))
    return launches, ms, {"film_attn_pt": film_stem, "mac": mac_stem}


def eval_steps(dev):
    """(g): make_eval_step of v_only_cnn2d_lstm, concat2d, lstm and concat3d at
    the serve phase's configs (the ModelConfig defaults, kernels on) and of
    film_gp_pt at its eval.sh preset (bf16 trunk, no int8), batch 32 at
    bucket 35 (seeded uint8 video, zero past v_len, or seeded bf16
    features), its last 3 rows marked invalid, the model's loss reduction (lstm: seeded class weights and a
    generator seeded 12 on both routes): once on the kernel route, counted,
    and once on the plain route. Raises where the losses differ by more than
    EVAL_LOSS_RTOL, where a row's hit differs whose plain top-2 logit margin
    is over ARGMAX_MARGIN, or where the kernel (the re-encode for film_gp_pt,
    else lstm) did not launch its count a forward. -> launches over the
    kernel-route steps."""
    total = dict.fromkeys(COUNTERS, 0)
    gen = torch.Generator(device=dev)
    film_gp = dataclasses.replace(FILM_GP_CFG, use_int8_trunk=False)
    for i, (cfg, kernel, per_forward) in enumerate((
            (ModelConfig(model="v_only_cnn2d_lstm", use_pallas_kernels=True), "lstm", 1),
            (ModelConfig(model="concat2d", use_pallas_kernels=True), "lstm", 2),
            (ModelConfig(model="lstm", use_pallas_kernels=True), "lstm", 1),
            (film_gp, "film_reencode", 1),
            (ModelConfig(model="concat3d", use_pallas_kernels=True), "lstm", 1))):
        model = cfg.model
        spec = get_model(model)
        params, state = spec.init(torch.Generator().manual_seed(0), cfg, dev)
        T = cfg.max_num_frames
        batch = tree_to(train_batch(32, T, cfg.max_q_len, cfg.vocab_size, cfg.num_classes,
                                    80 + i), dev)
        batch["valid"] = torch.arange(32, device=dev) < 29
        if spec.uses_stem:
            gen.manual_seed(81 + i)
            batch["v_features"] = seeded_features(32, T, cfg, gen, dev)
        elif spec.needs_video:
            gen.manual_seed(81 + i)
            batch["video"] = seeded_video(32, T, gen, dev)
            batch["video"][~length_mask(batch["v_len"], T)] = 0
        weights = seeded_class_weights(cfg.num_classes, 82).to(dev) if model == "lstm" else None
        outs = {}
        for route, route_cfg in (("kernel", cfg),
                                 ("plain", dataclasses.replace(cfg, use_pallas_kernels=False))):
            def eval_step():
                return make_eval_step(spec, route_cfg, torch.Generator(device=dev).manual_seed(12),
                                      class_weights=weights,
                                      reduction=TRAIN_STEP_OPTIONS[model]["reduction"])
            eval_step()(params, state, batch)   # warm-up
            torch.cuda.synchronize()
            reset_counters()
            outs[route] = eval_step()(params, state, batch)
            torch.cuda.synchronize()
            launches = read_counters()
            expect_launches(f"{model} eval step, {route} route", launches,
                            {kernel: per_forward} if route == "kernel" else {})
            if route == "kernel":
                total = {k: total[k] + launches[k] for k in total}
        kern, plain = outs["kernel"], outs["plain"]
        loss_err = abs(float(kern["loss"]) - float(plain["loss"])) / abs(float(plain["loss"]))
        top2 = plain["logits"].float().topk(2, dim=-1).values
        wide = (top2[:, 0] - top2[:, 1]) > ARGMAX_MARGIN
        hit_k, hit_p = kern["preds"] == batch["label"], plain["preds"] == batch["label"]
        dlogit = float((kern["logits"].float() - plain["logits"].float()).abs().max())
        log(f"  (g) {model} eval step, batch 32 T{T} (3 rows invalid): loss kernel route"
            f" {float(kern['loss']):.7f}, plain route {float(plain['loss']):.7f}, rel. diff"
            f" {loss_err:.3e} (bound {EVAL_LOSS_RTOL}), max |dlogit| {dlogit:.3e};"
            f" hits {int(kern['hits'])} /"
            f" {int(plain['hits'])} ({int(wide.sum())} rows with margin > {ARGMAX_MARGIN});"
            f" {kernel} launches {per_forward} on the kernel route, 0 on the plain")
        if loss_err > EVAL_LOSS_RTOL or not bool((hit_k == hit_p)[wide].all()):
            raise AssertionError(f"{model} eval step: the kernel route disagrees with the plain")
        del batch, params
        torch.cuda.empty_cache()
    return total


# The harness phase's runs: (label, entry point, arguments, kernels that must
# launch at least this often in the run). film_attn_pt at its eval.sh preset
# (5 blocks x 1024 channels, batch 32, sum loss, lr 1e-4) through the native
# loader with frame buckets: the stem's vgg_block1 once a train step and once
# a val batch, the re-encode and the tail once a val batch.
FILM_PRESET = ["--model", "film_attn_pt", "--num_res_blocks", "5",
               "--num_res_block_channels", "1024", "--batch_size", "32",
               "--loss_reduction", "sum", "--l_rate", "1e-4", "--use_pallas_kernels", "true",
               "--use_vnr", "true", "--bucket_frames", "true"]
# film_gp_pt at its eval.sh preset (4 blocks x 1024 channels, 32 tail
# channels, batch 32, sum loss, lr 1e-4) from raw video through the Python
# loader: vgg_block1 once a train step and once a val or test batch, the
# re-encode once a val or test batch.
FILM_GP_PRESET = ["--model", "film_gp_pt", "--num_res_blocks", "4",
                  "--num_res_block_channels", "1024", "--num_tail_channels", "32",
                  "--batch_size", "32", "--loss_reduction", "sum", "--l_rate", "1e-4",
                  "--use_pallas_kernels", "true"]
HARNESS_DATA = dict(num_houses=4, trajs_per_house=32, seed=0, video_format="npy",
                    max_frames=140)   # 64 train, 32 val, 32 test examples; v_len to 35
RESUME_LOSS_RTOL = 1e-6


@contextlib.contextmanager
def recorded_epochs():
    """[(train, summary)] of every Harness.run_epoch inside the block."""
    seen = []
    orig = harness_mod.Harness.run_epoch

    def run_epoch(self, *a, **k):
        out = orig(self, *a, **k)
        seen.append((k["train"], out[1]))
        return out

    harness_mod.Harness.run_epoch = run_epoch
    try:
        yield seen
    finally:
        harness_mod.Harness.run_epoch = orig


def check_entry_launches(label, launches, want):
    """``want``: {kernel: least count, or 0 for 'never'}."""
    for name, least in want.items():
        if (launches[name] != 0) if least == 0 else (launches[name] < least):
            raise AssertionError(f"{label}: {name} launched {launches[name]} times,"
                                 f" expected {'none' if least == 0 else f'at least {least}'}")


def run_entry(label, main_fn, argv, want, metrics_file):
    """Run one entry point on the card, its launches counted from 0 ->
    (launches, [(train, summary)]). Raises where a kernel of ``want``
    ({kernel: least count, 0: never}) launched fewer times (or at all), where
    a loss is not finite, or where the JSONL stream lacks an epoch event."""
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    with recorded_epochs() as seen:
        main_fn(argv + ["--metrics_file", metrics_file])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    check_entry_launches(label, launches, want)
    for train, summary in seen:
        if not math.isfinite(summary["loss"]) or summary["num_examples"] < 1:
            raise AssertionError(f"{label}: epoch summary {summary['loss']} over"
                                 f" {summary['num_examples']} examples")
    with open(metrics_file) as f:
        events = [json.loads(line)["event"] for line in f]
    need = {"run_start", "eval_epoch"} | ({"train_epoch"} if any(t for t, _ in seen) else set())
    if not need <= set(events):
        raise AssertionError(f"{label}: JSONL events {sorted(set(events))} lack {need}")
    rates = ", ".join(f"{'train' if t else 'val'} {s['examples_per_sec']:.2f} ex/s"
                      for t, s in seen)
    log(f"  {label}: {wall:.1f} s wall; {rates}; launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
    return launches, seen


def run_test_entry(label, main_fn, argv, want):
    """Run one test-split entry point on the card, its launches counted from
    0, then results_analysis over the dumps it wrote -> launches. Raises where
    a kernel of ``want`` launched fewer times (0: at all), where the summary's loss is not
    finite or counts no example, or where results_analysis prints no
    category."""
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    summary = main_fn(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    check_entry_launches(label, launches, want)
    if not math.isfinite(summary["loss"]) or summary["num_examples"] < 1:
        raise AssertionError(f"{label}: summary {summary['loss']} over"
                             f" {summary['num_examples']} examples")
    ckpt = argv[argv.index("--checkpoint_path") + 1]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results_analysis.main(["--checkpoint_path", ckpt])
    lines = buf.getvalue().splitlines()
    if not any(line.startswith(">>> Stats for") for line in lines):
        raise AssertionError(f"{label}: results_analysis printed {lines}")
    log(f"  {label}: {wall:.1f} s wall, {summary['num_examples']} test examples"
        f" ({summary['num_examples'] / wall:.2f} ex/s), loss {summary['loss']:.6f}, accuracy"
        f" {summary['hit']}/{summary['num_examples']}; launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        + f"; results_analysis: {len(lines)} lines, e.g. {lines[-1]!r}")
    return launches


@contextlib.contextmanager
def synthetic_dataset():
    """(temporary directory, the HARNESS_DATA dataset in it): ~1 GB of npy
    videos, removed afterwards."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_harness_") as tmp:
        t0 = time.perf_counter()
        data = os.path.join(tmp, "data")
        generate_synthetic_dataset(data, **HARNESS_DATA)
        log(f"  wrote the dataset ({HARNESS_DATA}) in {time.perf_counter() - t0:.1f} s")
        yield tmp, data


def harness(card, tmp=None, data=None):
    """Phase 7: the training and test entry points on the card, from the
    synthetic npy dataset ``data`` (HARNESS_DATA; written here when not
    given); its checkpoints and test dumps go to ``tmp``. -> launches summed
    over every run."""
    if data is None:
        with synthetic_dataset() as (tmp, data):
            return harness(card, tmp, data)
    total = dict.fromkeys(COUNTERS, 0)
    t0 = time.perf_counter()
    ckpt_path = os.path.join(tmp, "film.npz")
    common = ["--data_dir", data]
    runs = [
        ("q_and_v_eval film_attn_pt, eval.sh preset, VNR loader, 1 epoch",
         q_and_v_eval.main, FILM_PRESET + common + ["--checkpoint_path", ckpt_path],
         {"vgg_block1": 3, "film_reencode": 1, "attn_tail": 1}),
        ("the same resumed from e0_, --val_only",
         q_and_v_eval.main, FILM_PRESET + common + [
             "--checkpoint_path", os.path.join(tmp, "e0_film.npz"), "--val_only", "true"],
         {"vgg_block1": 1, "film_reencode": 1, "attn_tail": 1}),
        ("q_and_v_eval film_attn_pt, eval.sh preset, --int8_stem true (improved), 1 epoch",
         q_and_v_eval.main, FILM_PRESET + common + [
             "--int8_stem", "true", "--checkpoint_path", os.path.join(tmp, "film_int8.npz")],
         {"vgg_block1": 0, "film_reencode": 1, "attn_tail": 1}),
        ("q_and_v_eval concat2d, Python loader, 1 epoch",
         q_and_v_eval.main, ["--model", "concat2d", "--batch_size", "32",
                             "--use_pallas_kernels", "true"] + common, {"lstm": 2}),
        ("v_only_eval cnn2d_lstm, 1 epoch", v_only_eval.main,
         ["--model", "cnn2d_lstm"] + common, {}),
        ("q_only_eval lstm, batch 32, 2 epochs", q_only_eval.main,
         ["--model", "lstm", "--batch_size", "32", "--num_epochs", "2",
          "--stats_after_every", "1"] + common, {}),
        ("q_and_v_eval film_gp_pt, eval.sh preset, from raw video, 1 epoch", q_and_v_eval.main,
         FILM_GP_PRESET + common + ["--checkpoint_path", os.path.join(tmp, "gp.npz")],
         {"vgg_block1": 3, "film_reencode": 1}),
        ("v_only_eval cnn3d, frame buckets, 1 epoch", v_only_eval.main,
         ["--model", "cnn3d", "--bucket_frames", "true",
          "--checkpoint_path", os.path.join(tmp, "cnn3d.npz")] + common, {}),
        ("q_only_eval bow, batch 32, 2 epochs", q_only_eval.main,
         ["--model", "bow", "--batch_size", "32", "--num_epochs", "2", "--stats_after_every",
          "1", "--checkpoint_path", os.path.join(tmp, "bow.npz")] + common, {}),
    ]
    tests = [
        ("q_and_v_test film_gp_pt from its e0_ checkpoint", q_and_v_test.main,
         FILM_GP_PRESET + common + ["--checkpoint_path", os.path.join(tmp, "e0_gp.npz")],
         {"vgg_block1": 1, "film_reencode": 1}),
        ("q_and_v_test film_attn_pt, --int8_stem true (absmax), from e0_film",
         q_and_v_test.main, FILM_PRESET + common + [
             "--int8_stem", "true", "--int8_stem_calibration", "absmax",
             "--checkpoint_path", os.path.join(tmp, "e0_film.npz")],
         {"vgg_block1": 0, "film_reencode": 1, "attn_tail": 1}),
        ("v_only_test cnn3d from its e0_ checkpoint", v_only_test.main,
         ["--model", "cnn3d", "--bucket_frames", "true",
          "--checkpoint_path", os.path.join(tmp, "e0_cnn3d.npz")] + common, {}),
        ("q_only_test bow", q_only_test.main,
         ["--model", "bow", "--batch_size", "32",
          "--checkpoint_path", os.path.join(tmp, "bow.npz")] + common, {}),
    ]
    summaries = []
    for i, (label, main_fn, argv, want) in enumerate(runs):
        launches, seen = run_entry(label, main_fn, argv, want,
                                   os.path.join(tmp, f"metrics_{i}.jsonl"))
        total = {k: total[k] + launches[k] for k in total}
        summaries.append(seen)
    for label, main_fn, argv, want in tests:
        launches = run_test_entry(label, main_fn, argv, want)
        total = {k: total[k] + launches[k] for k in total}
    first = [s for t, s in summaries[0] if not t][0]
    resumed = [s for t, s in summaries[1] if not t][0]
    err = abs(resumed["loss"] - first["loss"]) / abs(first["loss"])
    log(f"  resumed --val_only: val loss {resumed['loss']:.7f} against"
        f" {first['loss']:.7f} (rel. {err:.2e}, bound {RESUME_LOSS_RTOL}), hits"
        f" {resumed['hit']} / {first['hit']}")
    if err > RESUME_LOSS_RTOL or resumed["hit"] != first["hit"] or \
            not np.array_equal(resumed["y_pred"], first["y_pred"]):
        raise AssertionError("the resumed --val_only run does not reproduce the validation")
    log(f"  harness phase on {card} in {time.perf_counter() - t0:.1f} s")
    return total


# The FiLM trunk's 1x1 convs, which reference checkpoints do not hold
INTERCHANGE_MISSING = [f"trunk/conv1x1_{k}" for k in range(FILM_ATTN_CFG.num_res_blocks)]


def _same_leaves(label, got, want):
    """Raises unless every leaf of ``want`` but the conv1x1 ones is in
    ``got`` with the same bits."""
    got = {k: t.cpu() for k, t in tree_items(got)}
    for k, t in tree_items(want):
        if "conv1x1" not in k and not torch.equal(got[k], t.cpu()):
            raise AssertionError(f"{label}: leaf {k} differs")


def interchange(dev, card, tmp=None, data=None):
    """The reference checkpoint interchange at film_attn_pt's eval.sh preset
    (5 x 1024, int8 trunk, kernels on), on the synthetic dataset ``data``
    (HARNESS_DATA; written here when not given): the seeded weights written
    as a reference ``.pt`` (``save_reference_checkpoint``); engines started
    from it on the card (every imported leaf bit-equal to the exported one,
    the five conv1x1 leaves named as drawn) serve batch 32 at buckets 20 and
    35 and batch 1 from seeded bf16 features, the three FiLM kernels
    counted, held to the plain path; one harness epoch (q_and_v_eval)
    resumed from the ``.pt``: its epoch 1, Adam fresh (as many steps as the
    epoch has batches); ``cli/export_checkpoint`` from that epoch's npz, read
    back bit-equal on every leaf but conv1x1. -> launches."""
    if data is None:
        with synthetic_dataset() as (tmp, data):
            return interchange(dev, card, tmp, data)
    t0 = time.perf_counter()
    cfg = FILM_ATTN_CFG
    params, state = get_model(cfg.model).init(torch.Generator().manual_seed(0), cfg,
                                              torch.device("cpu"))
    pt = os.path.join(tmp, "reference.pt")
    save_reference_checkpoint(pt, cfg.model, params, state, cfg, epoch=0)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eng = InferenceEngine(cfg, checkpoint_path=pt, seed=0, max_batch=1, device=dev)
    if str(INTERCHANGE_MISSING) not in buf.getvalue():
        raise AssertionError(f"the engine's import named {buf.getvalue()!r}")
    _same_leaves("the engine from the .pt", eng.params, params)
    _same_leaves("the engine from the .pt (state)", eng.state, state)
    del eng
    log(f"  wrote {pt} ({os.path.getsize(pt) / 2 ** 20:.1f} MiB) and started an engine from it"
        f" on {card}: every leaf as exported, {INTERCHANGE_MISSING} drawn from seed 0")

    gen = torch.Generator(device=dev).manual_seed(40)
    feats = torch.relu(torch.randn((32 * 3 + 1, 35, 10, 13, 512), generator=gen, device=dev)
                       ).to(torch.bfloat16)
    label = "film_attn_pt from a reference .pt"
    tally = dict.fromkeys(KERNEL_NAMES, 0.0)
    launches, ms, worst = serve_stem_model(dev, cfg, feats, 32, 41, tally, label=label,
                                           checkpoint_path=pt)
    expect_launches(label, launches, dict(
        FILM_ATTN_KERNELS, int8_matmul_fused=fused_1x1_launches(5, 32 * 20 * 130,
                                                                 32 * 35 * 130, 35 * 130)))
    log(f"  {label}: kernel path (plain path) ms/video "
        + ", ".join(f"{k} {a:.4f} ({b:.4f})" for k, (a, b) in ms.items())
        + f"; worst |dprob| {worst:.3e}")
    del feats
    torch.cuda.empty_cache()

    resumed = os.path.join(tmp, "resume_reference.pt")
    shutil.copy(pt, resumed)
    metrics = os.path.join(tmp, "metrics_interchange.jsonl")
    entry_launches, _ = run_entry(
        "q_and_v_eval film_attn_pt, eval.sh preset, resumed from a reference .pt",
        q_and_v_eval.main, FILM_PRESET + ["--data_dir", data, "--checkpoint_path", resumed,
                                          "--stats_after_every", "1"],
        {"vgg_block1": 1, "film_reencode": 1, "attn_tail": 1}, metrics)
    launches = {k: launches[k] + entry_launches[k] for k in launches}
    with open(metrics) as f:
        events = [json.loads(line) for line in f]
    steps = max(e["iteration"] for e in events if e["event"] == "train_progress")
    epochs = {e["epoch"] for e in events if e["event"] == "train_epoch"}
    e1 = epoch_path(resumed, 1)
    flat, meta = read_npz(e1)
    count = int(flat[OPT_INNER_COUNT])
    log(f"  resumed from the .pt: trained epoch {sorted(epochs)}, {e1} holds epoch"
        f" {meta['epoch']} and Adam's count {count} after the epoch's {steps} steps")
    if epochs != {1} or meta["epoch"] != 1 or count != steps:
        raise AssertionError("the harness did not resume at epoch 1 with a fresh Adam")

    out = os.path.join(tmp, "exported.pt")
    export_cli.main(FILM_PRESET + ["--data_dir", data, "--checkpoint_path", e1, "--out", out])
    obj = torch.load(out, map_location="cpu", weights_only=False)
    got_p, got_s, missing = import_model_checkpoint(cfg.model, obj["state_dict"], cfg)
    want_p, want_s = params_from_jax(flat)
    _same_leaves("cli/export_checkpoint's .pt", got_p, want_p)
    _same_leaves("cli/export_checkpoint's .pt (state)", got_s, want_s)
    if (obj["epoch"], obj["model"], missing) != (1, cfg.model, INTERCHANGE_MISSING):
        raise AssertionError(f"cli/export_checkpoint wrote {obj['epoch']}, {obj['model']},"
                             f" {missing}")
    log(f"  cli/export_checkpoint {e1} -> {out}: {len(obj['state_dict'])} tensors, read back"
        f" bit-equal but for conv1x1; interchange phase on {card} in"
        f" {time.perf_counter() - t0:.1f} s")
    return launches


# The daemon phase: film_attn_pt at the eval.sh preset served over a feature
# cache (cli/serve.py), the int8 trunk and the kernels on, auto frame buckets.
# The clients are a process of their own (serve/loadgen.py), so that their
# interpreter lock is not the daemon's.
DAEMON_PRESET = ["--model", "film_attn_pt", "--num_res_blocks", "5",
                 "--num_res_block_channels", "1024", "--int8_trunk", "true",
                 "--use_pallas_kernels", "true", "--feature_cache", "true",
                 "--bucket_frames", "auto", "--max_batch", "32", "--pipeline_depth", "2",
                 "--batch_wait_ms", "5", "--port", "0"]
# The same preset from the stored videos through the int8 stem (video mode,
# --int8_stem true: calibrated at start-up on the first stored video).
_CACHE_FLAG = DAEMON_PRESET.index("--feature_cache")
INT8_STEM_DAEMON = DAEMON_PRESET[:_CACHE_FLAG] + DAEMON_PRESET[_CACHE_FLAG + 2:] + [
    "--int8_stem", "true"]
INT8_STEM_REQUESTS, INT8_STEM_CLIENTS = 64, 16
DAEMON_REQUESTS, DAEMON_CLIENTS = 256, 64   # bf16 cache; more until a /reload is answered
AFTER_RELOAD = 64                           # ... and this many requests after it
FP8_REQUESTS, FP8_CLIENTS = 64, 16          # fp8 cache
DRAIN_REQUESTS = 64
VOCAB_WORDS = 133                           # word1 .. word133: the token ids 1 .. 133
HERE = os.path.dirname(os.path.abspath(__file__))


def question_text(i):
    """A question unique to request ``i``: its first two words encode i, so
    its tokens name the request."""
    words = [1 + i % VOCAB_WORDS, 1 + (i // VOCAB_WORDS) % VOCAB_WORDS]
    words += [1 + (31 * i + 7 * k) % VOCAB_WORDS for k in range(1 + i % 13)]
    return " ".join(f"word{w}" for w in words)


def loadgen(tmp, port, jobs, n, clients, until_file=None):
    """Start serve/loadgen.py on ``jobs`` (a list of /predict bodies) in a
    process of its own -> the Popen; ``collect`` reads its result."""
    path = os.path.join(tmp, f"jobs_{port}_{n}.json")
    with open(path, "w") as f:
        json.dump(jobs, f)
    cmd = [sys.executable, "-m", "videonavqa_tpu_torch.serve.loadgen", "--port", str(port),
           "--jobs", path, "--n", str(n), "--clients", str(clients)]
    if until_file:
        cmd += ["--until_file", until_file]
    return subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def collect(proc, timeout=600):
    """(wall s, [(job index, status, body)]) of a loadgen process."""
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"the load generator failed ({proc.returncode}): {err[-2000:]}")
    got = json.loads(out)
    return got["wall_s"], got["results"]


class Recorder:
    """Records what a live daemon runs: each micro-batch's request keys (the
    tokens), each request's (frames, v_len, tokens, probabilities) and the
    calibration forwards."""

    def __init__(self, engine, batcher):
        self.engine, self.batcher = engine, batcher
        self.batches, self.requests, self.calibrations = [], {}, 0
        dispatch, calibrate, submit = (engine.dispatch_batch, engine._forward_calibrate,
                                       batcher.submit)

        def on_dispatch(items):
            self.batches.append([tuple(t) for _, _, t in items])
            return dispatch(items)

        def on_calibrate(*a, **k):
            self.calibrations += 1
            return calibrate(*a, **k)

        def on_submit(frames, v_len, tokens):
            probs = submit(frames, v_len, tokens)
            self.requests[tuple(tokens)] = (frames, v_len, tokens, probs)
            return probs

        engine.dispatch_batch, engine._forward_calibrate = on_dispatch, on_calibrate
        batcher.submit = on_submit

    def stop(self):
        del self.engine.dispatch_batch, self.engine._forward_calibrate, self.batcher.submit


def prob_errors(got, want):
    """(max |dprob|, rows whose argmax differs where the top-2 logit margin of
    ``want`` exceeds ARGMAX_MARGIN): log-probabilities differ as the logits do."""
    got, want = np.asarray(got), np.asarray(want)
    top2 = np.sort(np.log(want), axis=-1)[..., -2:]
    wide = (top2[..., 1] - top2[..., 0]) > ARGMAX_MARGIN
    bad = wide & (got.argmax(-1) != want.argmax(-1))
    return float(np.abs(got - want).max()), int(bad.sum())


def check_served(label, engine, rec, jobs, results, vocab):
    """Every answer against its request's recorded probabilities (the same
    top 5), each micro-batch run again through ``engine.run_batch`` (an
    answer depends on its micro-batch's longest video: the reference's
    attention mask) and each request that was the longest of its
    micro-batch run alone -> max |dprob| over the re-runs."""
    for i, status, body in results:
        if status != 200:
            raise AssertionError(f"{label}: request {i} answered {status}: {body}")
        probs = rec.requests[tuple(vocab[w] for w in jobs[i]["question"].split())][3]
        top = np.argsort(-probs)[:5]
        if [p for _, p in body["top"]] != [float(probs[k]) for k in top]:
            raise AssertionError(f"{label}: the answer to request {i} is not its row")
    worst, rows, alone = 0.0, 0, 0
    for keys in rec.batches:
        items = [rec.requests[k][:3] for k in keys]
        want = np.stack([rec.requests[k][3] for k in keys])
        err, bad = prob_errors(engine.run_batch(items), want)
        longest = max(v for _, v, _ in items)
        for k, (f, v, t) in zip(keys, items):
            if v == longest and alone < 64:
                e, b = prob_errors(engine.run_batch([(f, v, t)]), rec.requests[k][3][None])
                err, bad, alone = max(err, e), bad + b, alone + 1
        worst, rows = max(worst, err), rows + len(keys)
        if err > PROB_ATOL or bad:
            raise AssertionError(f"{label}: a micro-batch run again gives max |dprob| {err:.3e}"
                                 f" and {bad} argmax changes")
    log(f"  {label}: {len(results)} answers equal their micro-batch rows; {len(rec.batches)}"
        f" micro-batches ({rows} rows) and {alone} longest items alone run again through"
        f" run_batch: max |dprob| {worst:.3e} (bound {PROB_ATOL}), argmax equal where the"
        f" margin exceeds {ARGMAX_MARGIN}")
    return worst


def film_launches(forwards, plain):
    """film_attn_pt's launches over ``forwards`` micro-batches, ``plain`` of
    them not calibrating."""
    return {"film_reencode": forwards, "attn_tail": forwards, "int8_matmul_fused": 5 * plain}


def serve_load(label, args, tmp, jobs, n, clients, vocab, reload_at=None, want=film_launches,
               on_reload=None, after_reload=AFTER_RELOAD):
    """Build, warm up and start a daemon, send it ``n`` of ``jobs`` (with a
    /reload of the startup checkpoint once ``reload_at`` are answered, going
    on until ``after_reload`` more are; ``on_reload(engine, state before)``
    checks what it swapped), hold every answer against ``want(forwards,
    non-calibrating forwards)``'s launches, then drain it under a last burst.
    -> (launches during the load, stats, requests/s, max |dprob|, one
    profiled batch's (busy, wall) ms)."""
    t0 = time.perf_counter()
    engine, batcher, server = serve_mod.build_server(args)
    engine.warmup()
    torch.cuda.synchronize()
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    log(f"  {label}: the daemon up in {time.perf_counter() - t0:.1f} s (built, calibrated on"
        f" a stored example, buckets {engine.frame_buckets}, int8_stem {engine.stem_is_int8})")
    rec = Recorder(engine, batcher)
    until = None if reload_at is None else os.path.join(tmp, f"reloaded_{port}")
    torch.cuda.synchronize()
    reset_counters()
    proc = loadgen(tmp, port, jobs, n, clients, until)
    if until is not None:
        while batcher.stats["requests"] < reload_at and proc.poll() is None:
            time.sleep(0.002)
        before, state_before = engine.weights_version, engine.state
        reload_reply = http(port, "/reload", {})
        after, at = engine.weights_version, batcher.stats["requests"]
        if on_reload is not None:
            on_reload(engine, state_before)
        while batcher.stats["requests"] < at + after_reload and proc.poll() is None:
            time.sleep(0.002)
        open(until, "w").close()
    wall, results = collect(proc)
    torch.cuda.synchronize()
    launches = read_counters()
    rec.stop()
    stats = http(port, "/stats")[1]
    forwards, plain = len(rec.batches), len(rec.batches) - rec.calibrations
    log(f"  {label}: {len(results)} requests from {clients} clients (another process) in"
        f" {wall:.2f} s ({len(results) / wall:.2f} requests/s); {forwards} micro-batches"
        f" ({rec.calibrations} calibrating), avg batch {stats['avg_batch']:.2f},"
        f" avg_forward_ms {stats['avg_forward_ms']:.2f}, latency p50 / p95 / p99"
        f" {stats['latency_p50_ms']:.1f} / {stats['latency_p95_ms']:.1f} /"
        f" {stats['latency_p99_ms']:.1f} ms; launches {launches}")
    expect_launches(label, launches, want(forwards, plain))
    if stats["errors"] or stats["requests"] != len(results) or len(results) < n:
        raise AssertionError(f"{label}: {len(results)} answers, stats {stats}")
    if until is not None:
        log(f"  {label}: /reload after {reload_at} answers: {reload_reply}, weights_version"
            f" {before} -> {after}; {len(results) - at} requests answered after it,"
            f" {rec.calibrations} calibrating forward(s)")
        calibrated = rec.calibrations >= 1 or not engine.cfg.use_int8_trunk
        if reload_reply[0] != 200 or after != before + 1 or not calibrated or \
                len(results) - at < after_reload:
            raise AssertionError(f"{label}: the reload did not swap the weights mid-load")
    worst = check_served(label, engine, rec, jobs, results, vocab)
    items = [rec.requests[k][:3] for k in max(rec.batches, key=len)]
    busy, bwall, rows = device_breakdown(lambda: engine.run_batch(items), 6)
    log(f"  {label}: one micro-batch of {len(items)} by torch.profiler: device busy {busy:.3f}"
        f" ms of {bwall:.3f} ms wall (idle share {max(0.0, 1 - busy / bwall):.3f})")
    for name, t in rows:
        log(f"    {t:9.4f} ms  {name[:110]}")

    # drain: stop accepting under a burst; every accepted request is answered
    before_drain = batcher.stats["requests"]
    proc = loadgen(tmp, port, jobs, DRAIN_REQUESTS, DRAIN_REQUESTS)
    deadline = time.monotonic() + 120
    while batcher.pending() < 8 and proc.poll() is None and time.monotonic() < deadline:
        time.sleep(0.001)
    server.shutdown()
    left = serve_mod.drain(server, batcher)
    _, burst = collect(proc)
    answered = sum(s == 200 for _, s, _ in burst)
    if left or any(s not in (200, None) for _, s, _ in burst) or \
            batcher.stats["requests"] - before_drain != answered or batcher.stats["errors"]:
        raise AssertionError(f"{label}: the drain lost requests ({left} pending,"
                             f" {answered} answered, stats {batcher.stats})")
    log(f"  {label}: drained under a burst of {DRAIN_REQUESTS}: {answered} accepted and"
        f" answered, {DRAIN_REQUESTS - answered} refused at the closed socket; the batcher's"
        " threads ended")
    del engine, batcher, server, rec
    torch.cuda.empty_cache()
    return launches, stats, len(results) / wall, worst, (busy, bwall)


# v_only_cnn3d served from stored videos (cli/serve.py, --bucket_frames auto:
# in video mode the default bucket grid), the zero-run computed with each
# weights version; no kernel on its path.
C3D_DAEMON = ["--model", "v_only_cnn3d", "--bucket_frames", "auto", "--max_batch", "32",
              "--pipeline_depth", "2", "--batch_wait_ms", "5", "--port", "0"]
C3D_REQUESTS, C3D_CLIENTS, C3D_AFTER_RELOAD = 96, 16, 32


def check_zero_run_swapped(engine, state_before):
    """After a /reload: the weights' zero-run is a new one, computed from the
    new weights (each column equal to a recomputation)."""
    old, new = state_before.get("c3d_zero"), engine.state.get("c3d_zero")
    if not old or not new or new is old:
        raise AssertionError("the reload did not recompute the C3D's zero-run")
    widths = sorted(int(k[1:]) for k in new)
    state = {k: v for k, v in engine.state.items() if k != "c3d_zero"}
    want = c3d_mod.precompute_c3d_zero_slices(engine.params, state, engine.cfg, widths)
    for T, cols in want.items():
        for k, w in cols.items():
            if not torch.equal(new[T][k], w):
                raise AssertionError(f"the reloaded zero-run's {T}/{k} is not the new weights'")
    log(f"  v_only_cnn3d daemon: the reload recomputed the zero-run for buckets {widths}"
        " (each column equal to one computed from the new weights)")


def daemon_cnn3d(tmp, data, ckpt, vocab):
    """v_only_cnn3d from the harness phase's checkpoint under load with a
    mid-load /reload -> (launches, requests/s, stats, worst, busy)."""
    ids = sorted(load_json(DataPaths(data).split_file)["test"])
    rng = np.random.default_rng(18)
    jobs = [{"video": ids[int(rng.integers(len(ids)))] + ".npy", "question": question_text(i)}
            for i in range(4 * C3D_REQUESTS)]
    args = serve_mod.build_parser().parse_args(C3D_DAEMON + ["--data_dir", data,
                                                             "--checkpoint_path", ckpt])
    launches, stats, rate, worst, busy = serve_load(
        "daemon v_only_cnn3d from video", args, tmp, jobs, C3D_REQUESTS, C3D_CLIENTS, vocab,
        C3D_REQUESTS // 4, want=lambda forwards, plain: {}, on_reload=check_zero_run_swapped,
        after_reload=C3D_AFTER_RELOAD)
    return launches, rate, stats, worst, busy


def daemon(card, tmp=None, data=None, ckpt=None):
    """Phase 8: the serving half on the card over the synthetic dataset
    ``data`` (written here when not given): extract_features of the test
    split in bf16 and fp8 (vgg_block1 counted; two videos' planes against
    the stem, bit for bit), the daemon at the eval.sh preset over each
    cache under load (a /reload and a drain in the bf16 run), then predict
    from one raw video through the stem, and, where the harness phase left
    its cnn3d checkpoint in ``tmp``, v_only_cnn3d from the stored videos
    under load with a /reload (daemon_cnn3d). ``ckpt``: the model's weights
    (the harness phase's epoch checkpoint; seeded here when not given).
    -> launches summed over the phase."""
    if data is None:
        with synthetic_dataset() as (tmp, data):
            return daemon(card, tmp, data)
    t_phase = time.perf_counter()
    total = dict.fromkeys(COUNTERS, 0)
    if ckpt is None:
        cfg = harness_mod.cfg_from_args(serve_mod.build_parser().parse_args(DAEMON_PRESET),
                                        "film_attn_pt")
        params, state = get_model("film_attn_pt").init(torch.Generator().manual_seed(0), cfg,
                                                       torch.device("cpu"))
        ckpt = os.path.join(tmp, "daemon.npz")
        save_checkpoint(ckpt, params=params, state=state, meta={"epoch": 0})
    with open(os.path.join(data, "vocab.json"), "w") as f:
        json.dump({f"word{i}": i for i in range(1, VOCAB_WORDS + 1)}, f)
    vocab = load_json(os.path.join(data, "vocab.json"))

    # extraction, both dtypes, counted
    for dtype in ("bfloat16", "float8_e4m3"):
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        extract_mod.main(["--data_dir", data, "--splits", "test", "--feature_dtype", dtype])
        torch.cuda.synchronize()
        launches = read_counters()
        path = extract_mod.feature_file(data, "test", dtype)
        loader = VNRBatchLoader(path, 1, shuffle=False, mode="test")
        frames = sum(int(loader.example_frames(i).shape[0]) for i in range(loader.n))
        wall = time.perf_counter() - t0
        log(f"  extract_features --feature_dtype {dtype}: {loader.n} videos, {frames} frames in"
            f" {wall:.2f} s ({frames / wall:.1f} frames/s), {os.path.getsize(path) / 1e6:.1f} MB;"
            f" launches {launches}")
        expect_launches("extract_features", launches, {"vgg_block1": None})
        total = {k: total[k] + launches[k] for k in total}
        # two videos' planes against the stem, chunk by chunk as extraction runs it
        args = extract_mod.build_parser().parse_args(["--data_dir", data])
        stem_fn = harness_mod.load_stem(args, DataPaths(data), torch.device("cuda"))
        store, bits, _ = extract_mod.STORE_DTYPES[dtype]
        src = VNRBatchLoader(os.path.join(data, "test.vnr"), 1, shuffle=False, mode="test")
        chunk = extract_mod.chunk_frames(src.lengths)
        for i in (0, src.n - 1):
            video = torch.from_numpy(src.example_frames(i)).cuda()
            t = video.shape[0]
            padded = torch.zeros((-(-t // chunk) * chunk, *video.shape[1:]), dtype=torch.uint8,
                                 device="cuda")
            padded[:t] = video
            want = torch.cat([stem_fn(normalize_video(c[None]))[0] for c in padded.split(chunk)])
            want = want[:t].to(store).view(bits).cpu()
            got = torch.from_numpy(loader.example_frames(i)).view(bits)
            if not torch.equal(got, want):
                raise AssertionError(f"extract_features {dtype}: video {i}'s planes are not the"
                                     " stem's")
        log(f"  extract_features {dtype}: videos 0 and {src.n - 1} ({chunk}-frame chunks) equal"
            " the stem's features on the card, bit for bit")
        loader.close()
        src.close()
        del stem_fn
        torch.cuda.empty_cache()

    ids = sorted(load_json(DataPaths(data).split_file)["test"])
    rng = np.random.default_rng(17)
    jobs = [{"example": ids[int(rng.integers(len(ids)))], "question": question_text(i)}
            for i in range(8 * DAEMON_REQUESTS)]
    common = DAEMON_PRESET + ["--data_dir", data, "--checkpoint_path", ckpt]
    results = {}
    for label, extra, n, clients, reload_at in (
            ("daemon bf16 cache", [], DAEMON_REQUESTS, DAEMON_CLIENTS, DAEMON_REQUESTS // 4),
            ("daemon fp8 cache", ["--feature_dtype", "float8_e4m3"], FP8_REQUESTS, FP8_CLIENTS,
             None)):
        args = serve_mod.build_parser().parse_args(common + extra)
        launches, stats, rate, worst, busy = serve_load(label, args, tmp, jobs, n, clients,
                                                        vocab, reload_at)
        total = {k: total[k] + launches[k] for k in total}
        results[label] = (rate, stats, worst, busy)

    # predict: one stored video and one question, through the stem
    video = os.path.join(data, "videos", ids[0] + ".npy")
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    probs = predict_mod.main(FILM_PRESET[:6] + ["--data_dir", data, "--checkpoint_path", ckpt,
                                                "--video", video, "--question", question_text(0)])
    torch.cuda.synchronize()
    launches = read_counters()
    log(f"  predict {ids[0]}: {time.perf_counter() - t0:.2f} s, launches {launches}")
    expect_launches("predict", launches, {"vgg_block1": 1, "film_reencode": 1, "attn_tail": 1})
    check_probs(probs[None], 1)
    total = {k: total[k] + launches[k] for k in total}
    # with --int8_stem true predict has no calibration batch: the bf16 stem, as in JAX
    reset_counters()
    probs8 = predict_mod.main(FILM_PRESET[:6] + ["--data_dir", data, "--checkpoint_path", ckpt,
                                                 "--video", video, "--question", question_text(0),
                                                 "--int8_stem", "true"])
    torch.cuda.synchronize()
    launches = read_counters()
    err = float(np.abs(probs8 - probs).max())
    log(f"  predict --int8_stem true: the bf16 stem's answer, max |dprob| {err:.3e}; launches"
        f" {launches}")
    expect_launches("predict --int8_stem true", launches,
                    {"vgg_block1": 1, "film_reencode": 1, "attn_tail": 1})
    if err > 1e-6 or probs8.argmax() != probs.argmax():
        raise AssertionError("predict --int8_stem true does not answer as the bf16 stem")
    total = {k: total[k] + launches[k] for k in total}

    # the daemon from the stored videos through the int8 stem: vgg_block1 never
    vjobs = [{"video": ids[int(rng.integers(len(ids)))] + ".npy", "question": question_text(i)}
             for i in range(4 * INT8_STEM_REQUESTS)]
    args = serve_mod.build_parser().parse_args(INT8_STEM_DAEMON + ["--data_dir", data,
                                                                   "--checkpoint_path", ckpt])
    launches, stats, rate, worst, busy = serve_load("daemon int8 stem from video", args, tmp,
                                                    vjobs, INT8_STEM_REQUESTS, INT8_STEM_CLIENTS,
                                                    vocab)
    total = {k: total[k] + launches[k] for k in total}
    results["daemon int8 stem from video"] = (rate, stats, worst, busy)
    cnn3d = os.path.join(tmp, "e0_cnn3d.npz")
    if os.path.exists(cnn3d):
        launches, rate, stats, worst, busy = daemon_cnn3d(tmp, data, cnn3d, vocab)
        results["daemon v_only_cnn3d"] = (rate, stats, worst, busy)
    log(f"  daemon phase on {card} in {time.perf_counter() - t_phase:.1f} s: "
        + "; ".join(f"{k} {r:.2f} requests/s, p50 / p95 / p99 {s['latency_p50_ms']:.1f} /"
                    f" {s['latency_p95_ms']:.1f} / {s['latency_p99_ms']:.1f} ms, avg batch"
                    f" {s['avg_batch']:.2f}, avg_forward_ms {s['avg_forward_ms']:.2f}, idle share"
                    f" {max(0.0, 1 - b / w):.3f}, max |dprob| {e:.3e}"
                    for k, (r, s, e, (b, w)) in results.items()))
    return total


# --- phase 9: the rest of the stem ------------------------------------------
#
# The int8 stem (stem/quant.py) at full width, calibrated both ways: the
# VGG stage bit-equal between the card and the CPU on one qstem, the feature
# error against the port's f32 stem under the JAX package's own test bounds
# (relative L2), and its time and peak memory at 1,120 frames against the
# bf16 stem; the detector's trainer at full width; MAC's write variants
# served and trained, card against CPU.

INT8_FEATURE_RTOL = {"absmax": 0.06, "improved": 0.03}
INT8_STEM_BATCH = (32, 35)      # 1,120 frames: the presets' batch
INT8_CPU_FRAMES = 4             # card vs CPU on the first frames
DETECTOR_ARGS = ["--batch_size", "32", "--num_epochs", "2", "--tail_dropout_p", "0.5"]
DETECTOR_FRAMES, DETECTOR_CLASSES = 96, 27   # 3 steps an epoch
MAC_VARIANT_LOGIT_ATOL = 1e-4   # the LSTM-kernel models' port-vs-JAX bound


def _tensors_to(tree, device):
    """A nested dict, tuple or list with its tensors moved to ``device`` (other
    leaves kept)."""
    if isinstance(tree, dict):
        return {k: _tensors_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tensors_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def seeded_stem(dev):
    """The engine's stem without weights on disk: the reference init from a
    generator seeded STEM_SEED, 512 filters."""
    gen = torch.Generator().manual_seed(STEM_SEED)
    vgg = init_vgg_partial(gen)
    det, det_state = init_obj_detector(gen)
    return tuple(tree_to(t, dev) for t in (vgg, det, det_state))


def int8_stem_fn(dev, calib, mode="improved"):
    """The int8 stem of ``seeded_stem`` calibrated on ``calib`` (f32 /255
    [B, T, 160, 208, 3]) -> stem_fn(video /255) -> features."""
    vgg, det, det_state = seeded_stem(dev)
    calibrate = quant.calibrate_stem_quant if mode == "improved" else quant.calibrate_act_scales
    qstem = quant.quantize_stem(vgg, det, act_scales=calibrate(vgg, det, det_state, calib))
    return lambda video: quant.stem_features_int8(qstem, det, det_state, video)


def check_int8_stem(dev, card):
    """Both calibrations at full width over seeded uint8 video [32, 35, 160,
    208, 3] (no kernel launched): card vs CPU on one qstem, the feature error
    against the f32 stem; then the int8 and the bf16 stem timed at 1,120
    frames, their peak memory and top device ops. -> {label: ms}."""
    vgg, det, det_state = seeded_stem(dev)
    B, T = INT8_STEM_BATCH
    x = normalize_video(seeded_video(B, T, torch.Generator(device=dev).manual_seed(31), dev))
    with torch.no_grad():
        f32 = stem_features(vgg, det, det_state, x, dtype=torch.float32, frame_chunk=160)
    det_cpu = _tensors_to((det, det_state), "cpu")
    frames = x.reshape(-1, *x.shape[2:])[:INT8_CPU_FRAMES]
    qstems = {}
    for mode in ("absmax", "improved"):
        calibrate = quant.calibrate_stem_quant if mode == "improved" else \
            quant.calibrate_act_scales
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        qstem = quant.quantize_stem(vgg, det, act_scales=calibrate(vgg, det, det_state, x))
        torch.cuda.synchronize()
        cal_s = time.perf_counter() - t0
        feats = quant.stem_features_int8(qstem, det, det_state, x)
        torch.cuda.synchronize()
        expect_launches(f"int8 stem ({mode})", read_counters(), {})
        rel = float(torch.linalg.norm(feats - f32) / torch.linalg.norm(f32))
        q_cpu = _tensors_to(qstem, "cpu")
        with torch.no_grad():
            vgg_card = quant.vgg_features_int8(qstem, frames).cpu()
            vgg_cpu = quant.vgg_features_int8(q_cpu, frames.cpu())
            got = quant.stem_features_int8(qstem, det, det_state, frames[None]).cpu()
            want = quant.stem_features_int8(q_cpu, *det_cpu, frames.cpu()[None])
        same = float((got == want).float().mean())
        stem_err = float((got - want).abs().max() / want.abs().max())
        log(f"  int8 stem, {mode} calibration over {B * T} frames: {cal_s:.2f} s; features vs"
            f" the f32 stem rel. L2 {rel:.4f} (bound {INT8_FEATURE_RTOL[mode]}); card vs CPU on"
            f" one qstem, {INT8_CPU_FRAMES} frames: the VGG stage"
            f" {'bit-equal' if torch.equal(vgg_card, vgg_cpu) else 'DIFFERENT'}, the whole stem"
            f" {same:.4f} of features bit-equal, max |d| {stem_err:.3e} of the largest; no"
            " kernel launched")
        if not torch.equal(vgg_card, vgg_cpu):
            raise AssertionError(f"int8 stem ({mode}): the card's VGG stage is not the CPU's")
        if not (math.isfinite(rel) and rel <= INT8_FEATURE_RTOL[mode]):
            raise AssertionError(f"int8 stem ({mode}): feature error {rel} past its bound")
        qstems[mode] = qstem
        del feats, q_cpu
    del f32
    torch.cuda.empty_cache()

    qstem = qstems["improved"]
    ms = {}
    for label, fn in (("int8 stem (improved)",
                       lambda: quant.stem_features_int8(qstem, det, det_state, x)),
                      ("bf16 stem, vgg_block1",
                       lambda: stem_features(vgg, det, det_state, x, use_kernel=True))):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            ms[label] = time_ms(fn, 3, 1)
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            busy, wall, rows = device_breakdown(fn, 8)
        log(f"  {label} at {B * T} frames on {card}: {ms[label]:.2f} ms (CUDA events), peak"
            f" {peak:.2f} GiB above the inputs; one call busy {busy:.2f} ms of {wall:.2f} ms"
            " wall, by kernel:")
        for name, t in rows:
            log(f"    {t:9.4f} ms  {name[:110]}")
    return ms


def train_detector(dev, card, tmp, synthetic=False):
    """train_obj_detector at full width (512 filters, tail 1,024, batch 32,
    dropout 0.5), 2 epochs of 3 steps on DETECTOR_FRAMES frames: with
    ``--data`` seeded frames, with ``--synthetic`` frames rendered from
    synthetic houses (timed, with their positive rate). vgg_block1 once a
    step, every loss finite, the second epoch's mean under the first's; the
    checkpoint and the export written. -> launches."""
    if synthetic:
        source = ["--synthetic", str(DETECTOR_FRAMES)]
    else:
        r = np.random.default_rng(41)
        data = os.path.join(tmp, "detector.npz")
        np.savez(data, images=r.integers(0, 256, (DETECTOR_FRAMES, 160, 208, 3), dtype=np.uint8),
                 targets=(r.random((DETECTOR_FRAMES, DETECTOR_CLASSES)) < 0.1).astype(np.float32))
        source = ["--data", data]
    losses, step_ms, rendered = [], [], []
    real = detector_mod.make_train_step
    real_render = detector_mod.make_synthetic_detector_data

    def timed_render(n, seed=0):
        t0 = time.perf_counter()
        frames, targets = real_render(n, seed)
        rendered.append((time.perf_counter() - t0, frames.shape[0], float(targets.mean())))
        return frames, targets

    def timed(*a, **k):
        step = real(*a, **k)

        def run(state, images, targets):
            t0 = time.perf_counter()
            out = step(state, images, targets)
            losses.append(float(out[1]))     # synchronizes
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        return run

    detector_mod.make_train_step = timed
    detector_mod.make_synthetic_detector_data = timed_render
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    try:
        detector_mod.main([*source, *DETECTOR_ARGS,
                           "--checkpoint_path", os.path.join(tmp, "det.npz"),
                           "--export_pt", os.path.join(tmp, "obj_detect.pt")])
    finally:
        detector_mod.make_train_step = real
        detector_mod.make_synthetic_detector_data = real_render
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    steps = len(losses)
    if synthetic:
        render_s, n, positive = rendered[0]
        made = (f"rendered {n} frames in {render_s:.2f} s ({n / render_s:.1f} frames/s),"
                f" positive rate {positive:.4f}; ")
    else:
        made = ""
    log(f"  train_obj_detector {source[0]}, 512 filters, tail 1,024, batch 32, dropout 0.5, on"
        f" {card}: {made}{steps} steps in {wall:.1f} s; ms/step {np.mean(step_ms[1:]):.1f}"
        f" (steps 2-{steps}), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses"
        f" {', '.join(f'{v:.4f}' for v in losses)}; launches {launches}")
    if synthetic and not (len(rendered) == 1 and 0 < rendered[0][2] < 1):
        raise AssertionError(f"train_obj_detector --synthetic: rendered {rendered}")
    expect_launches("train_obj_detector", launches, {"vgg_block1": steps})
    half = steps // 2
    if steps != 6 or not np.all(np.isfinite(losses)) or \
            not np.mean(losses[half:]) < np.mean(losses[:half]):
        raise AssertionError(f"train_obj_detector: losses {losses}")
    sd = torch.load(os.path.join(tmp, "obj_detect.pt"), weights_only=False)["state_dict"]
    if list(sd)[:2] != ["bn_input.weight", "bn_input.bias"] or "fc_tail2.bias" not in sd:
        raise AssertionError("train_obj_detector: the export lacks the reference's keys")
    return launches


def mac_write_variants(dev):
    """MAC with both write variants on (self-attention and the memory gate):
    the eval forward at ZOO_SMALL with the kernels on the card (lstm 3 a
    forward) against the plain one on the CPU, and 3 train steps card vs
    CPU (TRAIN_* bounds). -> launches of the served forward."""
    saved = mac_model.SELF_ATTENTION, mac_model.MEMORY_GATE
    mac_model.SELF_ATTENTION = mac_model.MEMORY_GATE = True
    try:
        cfg = ModelConfig(model="mac", mac_dropout=0.0, **ZOO_SMALL)
        spec = get_model("mac")
        params, state = spec.init(torch.Generator().manual_seed(0), cfg, torch.device("cpu"))
        if not {"write_attn", "write_mem", "write_control"} <= set(params["mac"]):
            raise AssertionError("mac: the write variants' parameters are missing")
        batch = train_batch(3, 6, 9, 19, 7, 70, (10, 13, 12))
        torch.cuda.synchronize()
        reset_counters()
        with torch.inference_mode():
            got, _ = spec.apply(tree_to(params, dev), tree_to(state, dev), tree_to(batch, dev),
                                cfg, train=False)
            torch.cuda.synchronize()
            launches = read_counters()
            want, _ = spec.apply(params, state, batch,
                                 dataclasses.replace(cfg, use_pallas_kernels=False), train=False)
        err = float((got.cpu() - want).abs().max())
        expect_launches("mac with its write variants", launches, {"lstm": 3})
        batches = [train_batch(3, 6, 9, 19, 7, 60 + i, (10, 13, 12)) for i in range(3)]
        cpu = run_train_steps(cfg, torch.device("cpu"), batches, 1e-3)
        reset_counters()
        on_card = run_train_steps(cfg, dev, batches, 1e-3)
        torch.cuda.synchronize()
        expect_launches("mac with its write variants, train", read_counters(), {})
        errs, passed = parity_errors(on_card, cpu, False)
    finally:
        mac_model.SELF_ATTENTION, mac_model.MEMORY_GATE = saved
    log(f"  mac with both write variants, small config: served logits, kernels on the card vs"
        f" plain on the CPU, max |d| {err:.3e} (bound {MAC_VARIANT_LOGIT_ATOL}), launches"
        f" {launches}; 3 train steps card vs CPU: losses {on_card[0]} vs {cpu[0]}; "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + " (TRAIN_* bounds)")
    if err > MAC_VARIANT_LOGIT_ATOL or not passed:
        raise AssertionError("mac with its write variants: the card disagrees with the CPU")
    return launches


def stem_rest(dev, card):
    """Phase 9 -> (launches summed over its counted paths, {label: ms})."""
    t0 = time.perf_counter()
    ms = check_int8_stem(dev, card)
    total = dict.fromkeys(COUNTERS, 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_detector_") as tmp:
        for name, n in train_detector(dev, card, tmp).items():
            total[name] += n
    for name, n in mac_write_variants(dev).items():
        total[name] += n
    log(f"  stem phase on {card} in {time.perf_counter() - t0:.1f} s")
    return total, ms


# Phase 10: the dataset generator (cli/generate_dataset.py) run as a user runs
# it, in a process of its own on the card's host, then film_attn_pt trained,
# validated and tested from what it wrote and the detector trained from
# rendered frames. 10 houses split 8 / 1 / 1 (datagen/split.py); npy videos,
# since the card's machine has no OpenCV to write mp4.
DATAGEN_TRAJS = 8
DATAGEN_ARGS = ["--num_houses", "10", "--trajs_per_house", str(DATAGEN_TRAJS), "--seed", "0",
                "--workers", "4", "--video_format", "npy"]
# film_attn_pt at FILM_PRESET's widths, at the harness's default batch of 8
# (or the val split's size where that is smaller): the val and test splits
# are one house each (at most 8 examples), and the val loader drops a partial
# batch, as the JAX package's does.
DATAGEN_BATCH = 8


def generate_dataset(tmp, card):
    """cli/generate_dataset.py with DATAGEN_ARGS in a process of its own, then
    its output checked (labels in [0, 70), every split non-empty, every video
    uint8 [T, 160, 208, 3] with T its recorded length) and cli/dataset_stats.py
    run over it (its totals against labels.json and split.json). -> (data
    directory, split)."""
    out = os.path.join(tmp, "generated")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "videonavqa_tpu_torch.cli.generate_dataset",
                           "--out", out, *DATAGEN_ARGS], cwd=HERE, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"generate_dataset exited {proc.returncode}:"
                             f" {proc.stdout[-2000:]} {proc.stderr[-4000:]}")
    labels = load_json(os.path.join(out, "labels.json"))
    split = load_json(os.path.join(out, "split.json"))
    if not labels or not all(0 <= v < 70 for v in labels.values()):
        raise AssertionError(f"generate_dataset: labels {sorted(set(labels.values()))}")
    if sorted(sum(split.values(), [])) != sorted(labels) or not all(split.values()):
        raise AssertionError("generate_dataset: split sizes "
                             + str({k: len(v) for k, v in split.items()}))
    lengths = {}
    for name in os.listdir(os.path.join(out, "trajectories")):
        if name.endswith("_video_lengths.json"):
            house = name[: -len("_video_lengths.json")]
            lengths.update({f"{house}_{int(t):04d}": n
                            for t, n in load_json(os.path.join(out, "trajectories",
                                                               name)).items()})
    frames = 0
    for ex in labels:
        video = np.load(os.path.join(out, "videos", ex + ".npy"), mmap_mode="r")
        if video.dtype != np.uint8 or video.shape != (lengths[ex], 160, 208, 3):
            raise AssertionError(f"generate_dataset: {ex} is {video.dtype} {video.shape}")
        frames += video.shape[0]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        stats_cli.main(["--data_dir", os.path.join(out, "questions"),
                        "--split_file", os.path.join(out, "split.json")])
    lines = buf.getvalue().splitlines()
    sizes = {line.split()[0]: int(line.split()[1]) for line in lines[1:4]}
    total = [line for line in lines if line.startswith(">>> STATS:")]
    if lines[0] != "Examples in each dataset split:" or \
            sizes != {k: len(v) for k, v in split.items()} or \
            [line.split()[2] for line in total] != [str(len(labels))]:
        raise AssertionError(f"dataset_stats printed {lines[:6]}")
    log(f"  generate_dataset {' '.join(DATAGEN_ARGS)} on {card}'s host: {len(labels)} examples"
        f" ({frames} frames, {len(load_json(os.path.join(out, 'vocab.json')))} vocab tokens),"
        f" split {sizes}, in {wall:.2f} s wall ({len(labels) / wall:.2f} examples/s,"
        f" {frames / wall:.1f} frames/s), the process's start included; dataset_stats:"
        f" {total[0]!r}")
    return out, split


@contextlib.contextmanager
def timed_methods(*methods):
    """{(class, name): [(seconds, raised) of each call]} of the given
    (class, name) methods inside the block."""
    spent = {m: [] for m in methods}
    saved = {m: getattr(*m) for m in methods}

    def timed(key, orig):
        def run(*a, **k):
            t0, raised = time.perf_counter(), True
            try:
                out = orig(*a, **k)
                raised = False
                return out
            finally:
                spent[key].append((time.perf_counter() - t0, raised))

        return run

    for key, orig in saved.items():
        setattr(*key, timed(key, orig))
    try:
        yield spent
    finally:
        for key, orig in saved.items():
            setattr(*key, orig)


def generation_breakdown(tmp, card):
    """One house of DATAGEN_ARGS generated in this process, its wall time
    split into question generation (the attempts that timed out apart), the
    observation passes and the videos' rendering."""
    gen = (generator_mod.QuestionGenerator, "generate_example")
    observe = (trajectory_mod.TrajectoryObserver, "observe")
    render = (trajectory_mod.TrajectoryObserver, "render_video")
    t0 = time.perf_counter()
    with timed_methods(gen, observe, render) as spent:
        _, n = generate_cli.generate_house(0, os.path.join(tmp, "one_house"), seed=0,
                                           trajs_per_house=DATAGEN_TRAJS, num_rooms=4,
                                           video_format="npy")
    wall = time.perf_counter() - t0
    timed_out = [t for t, raised in spent[gen] if raised]
    answered = [t for t, raised in spent[gen] if not raised]
    observed, rendered = (sum(t for t, _ in spent[k]) for k in (observe, render))
    rest = wall - sum(answered) - sum(timed_out) - observed - rendered
    log(f"  one house ({DATAGEN_TRAJS} trajectories, {n} examples) in this process on {card}'s"
        f" host: {wall:.2f} s; generate_example {len(answered)} answered in"
        f" {sum(answered):.2f} s, {len(timed_out)} timed out in {sum(timed_out):.2f} s (the"
        f" 0.5 / 0.8 s budgets); observe (the semantic and depth passes) {observed:.2f} s;"
        f" render_video {len(spent[render])} videos in {rendered:.2f} s; the rest {rest:.2f} s")


def datagen(dev, card):
    """Phase 10 -> launches summed over its counted runs."""
    t0 = time.perf_counter()
    total = dict.fromkeys(COUNTERS, 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_datagen_") as tmp:
        data, split = generate_dataset(tmp, card)
        generation_breakdown(tmp, card)
        B = min(DATAGEN_BATCH, len(split["val"]))
        steps, val, test = len(split["train"]) // B, len(split["val"]) // B, \
            -(-len(split["test"]) // B)
        if not (steps and val and test):
            raise AssertionError(f"datagen: {steps} train steps, {val} val and {test} test"
                                 f" batches at batch {B}")
        preset = FILM_PRESET + ["--batch_size", str(B), "--data_dir", data]
        launches, _ = run_entry(
            f"q_and_v_eval film_attn_pt (FILM_PRESET at batch {B}) on the generated set,"
            " 1 epoch", q_and_v_eval.main,
            preset + ["--checkpoint_path", os.path.join(tmp, "film.npz")],
            {"vgg_block1": steps + val, "film_reencode": val, "attn_tail": val},
            os.path.join(tmp, "metrics.jsonl"))
        total = {k: total[k] + launches[k] for k in total}
        launches = run_test_entry(
            "q_and_v_test film_attn_pt from its e0_ checkpoint", q_and_v_test.main,
            preset + ["--checkpoint_path", os.path.join(tmp, "e0_film.npz")],
            {"vgg_block1": test, "film_reencode": test, "attn_tail": test})
        total = {k: total[k] + launches[k] for k in total}
        for name, n in train_detector(dev, card, tmp, synthetic=True).items():
            total[name] += n
    log(f"  datagen phase on {card} in {time.perf_counter() - t0:.1f} s")
    return total


# --- phase 11: the mesh ----------------------------------------------------
#
# The card's machine holds one H100, so nothing here measures scaling. (a) the
# harness on NCCL worlds of one; (b) two gloo ranks sharing the one card,
# against one process (their times say nothing about scaling); (c) the daemon
# on a one-device mesh. film_attn_pt at its eval.sh preset widths, batch 32.

MESH_LOSS_RTOL = 1e-5     # losses, mesh against none
MESH_PARAM_ATOL = 2.5e-3  # params after one Adam step: the JAX DP test's bound
# the step's gradients (summed over 'data', and clipped) as a relative L2
# error over every leaf, and the norm after the clip, against one process;
# Adam's first step is ~lr * sign(g) and hides a wrong gradient's scale.
# The gradients may move MESH_ORDER_FACTOR times as far as the one-process
# step's own move when only the rows' order changes: at these widths that
# alone moves the trunk's conv weight gradients (cuDNN's weight-gradient
# sums over 145,600 positions a channel) by ~8e-4 over all leaves
MESH_GRAD_RTOL = 1e-4
MESH_ORDER_FACTOR = 4
MESH_STATE_ATOL = 1e-5    # BN running statistics
MESH_BATCH = 32
MESH_TRAIN_CFG = dataclasses.replace(FILM_ATTN_CFG, compute_dtype="float32",
                                     use_pallas_kernels=False, use_int8_trunk=False)
MESH_REQUESTS = 8
SHARED_CARD = "(b) runs two ranks on ONE card through gloo: its times say nothing about scaling"


@contextlib.contextmanager
def timed_grad_sums(keep=None):
    """[(ms, bytes)] of each gradient sum over 'data' in the block (the card
    synchronized before and after); ``keep``, a list, also gets each sum's
    gradients."""
    seen, orig = [], collectives.sum_grads_over_data

    def timed(grads):
        sync(grads[0].device)
        t0 = time.perf_counter()
        out = orig(grads)
        sync(grads[0].device)
        seen.append(((time.perf_counter() - t0) * 1e3, 4 * sum(g.numel() for g in grads)))
        if keep is not None:
            keep.append(out)
        return out

    collectives.sum_grads_over_data = timed
    try:
        yield seen
    finally:
        collectives.sum_grads_over_data = orig


def mesh_batch(dev, B, cfg):
    return tree_to(train_batch(B, cfg.max_num_frames, cfg.max_q_len, cfg.vocab_size,
                               cfg.num_classes, 51, feat_shape=(10, 13, cfg.num_input_channels)),
                   dev)


def mesh_train(dev, batch, rank, ref, cfg):
    """One train step of ``cfg`` on ``rank``'s rows (a one-process step
    without ``rank``) -> (results, whole params, state, the step's
    gradients: {'summed', 'clipped'}, each {path: whole leaf})."""
    spec = get_model(cfg.model)
    params, state = spec.init(torch.Generator().manual_seed(0), cfg, dev)
    if rank is not None:
        params = put_global(params, param_shardings(params, rank), rank)
        start, per = multihost.host_batch_slice(len(batch["label"]), rank)
        batch = {k: v[start:start + per] for k, v in batch.items()}
    step = make_train_step(spec, cfg, make_optimizer(params, PRESET_L_RATE[cfg.model]),
                           **TRAIN_STEP_OPTIONS[cfg.model])
    summed = []
    with timed_grad_sums(summed) as sums:
        sync(dev)
        t0 = time.perf_counter()
        state, m = step(params, state, batch, torch.Generator(device=dev).manual_seed(3))
        sync(dev)
        wall = time.perf_counter() - t0
    items = tree_items(params)
    whole = {k: collectives.full_leaf(v).detach() for k, v in items}
    # the gradients the step summed over 'data' (before the clip), and the
    # clipped ones it applied
    grads = {"summed": {k: collectives.full_leaf(g, like=p)
                        for (k, p), g in zip(items, summed[0])},
             "clipped": {k: collectives.full_leaf(p.grad, like=p) for k, p in items}}
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "step_s": wall,
           "grad_sum": sums[0]}
    if ref is not None:
        rloss, rnorm, rparams, rstate, rgrads = ref
        out["loss_err"] = abs(out["loss"] - rloss) / abs(rloss)
        out["norm_err"] = abs(out["grad_norm"] - rnorm) / rnorm
        for kind, g in grads.items():
            r = rgrads[kind]
            out[f"{kind}_err"] = float(torch.sqrt(
                sum(torch.sum(torch.square(g[k].float() - r[k].float())) for k in r)
                / sum(torch.sum(torch.square(r[k].float())) for k in r)))
        out["param_err"] = max(float((whole[k] - rparams[k]).abs().max()) for k in rparams)
        out["state_err"] = max(float((v - rstate[k]).abs().max())
                               for k, v in tree_items(state))
    return out, whole, dict(tree_items(state)), grads


def mesh_eval_probs(dev, batch, rank, cfg):
    """``cfg``'s calibration forward, then its eval step (on the card the
    kernels, the calibrated int8 trunk) on ``rank``'s rows -> the global
    batch's probabilities on the host."""
    spec = get_model(cfg.model)
    params, state = spec.init(torch.Generator().manual_seed(0), cfg, dev)
    feats = dict(batch, v_features=batch["v_features"].to(torch.bfloat16))
    if rank is not None:
        start, per = multihost.host_batch_slice(len(batch["label"]), rank)
        feats = {k: v[start:start + per] for k, v in feats.items()}
    with torch.inference_mode():
        _, state = forward(spec, dataclasses.replace(cfg, int8_trunk_calibrate=True), params,
                           state, feats)
        probs = torch.softmax(make_eval_step(spec, cfg)(params, state, feats)["logits"],
                              dim=-1).float().cpu().numpy()
    if rank is not None:
        probs = np.concatenate(rank.data.all_gather_object(probs))
    return probs


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mesh_shared_card_rank(r, port, results, plan):
    """One of (b)'s two gloo ranks, both on ``plan.device`` (the card).
    Rank 0 first runs the one-process train step and eval on the whole
    batch of ``plan.batch`` rows, and the train step again on the same rows
    with the two halves swapped (how far the summation order alone moves
    the gradients); then both ranks run data 2 (train, eval) and model 2
    (train) on the mesh; rank 0 compares."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(plan.device)
    batch = mesh_batch(dev, plan.batch, plan.train_cfg)
    ref = ref_probs = None
    if r == 0:
        ref_out, rparams, rstate, rgrads = mesh_train(dev, batch, None, None, plan.train_cfg)
        ref = (ref_out["loss"], ref_out["grad_norm"], rparams, rstate, rgrads)
        ref_probs = mesh_eval_probs(dev, batch, None, plan.eval_cfg)
        half = plan.batch // 2
        swapped = {k: torch.cat([v[half:], v[:half]]) for k, v in batch.items()}
        order = mesh_train(dev, swapped, None, ref, plan.train_cfg)[0]
    reset_counters()
    multihost.initialize(f"127.0.0.1:{port}", 2, r, backend="gloo", device=dev)
    try:
        out = {"rows reordered": order} if r == 0 else {}
        rank = make_mesh(2, 1).local
        collectives.set_process_rank(rank)
        out["train dp 2"] = mesh_train(dev, batch, rank, ref, plan.train_cfg)[0]
        probs = mesh_eval_probs(dev, batch, rank, plan.eval_cfg)
        if r == 0:
            out["eval dp 2"] = prob_errors(probs, ref_probs)
        rank = make_mesh(2, 2).local
        collectives.set_process_rank(rank)
        out["train model 2"] = mesh_train(dev, batch, rank, ref, plan.train_cfg)[0]
        out["launches"] = read_counters()
        results.put((r, out))
    finally:
        collectives.set_process_rank(None)
        multihost.shutdown()


def mesh_shared_card(plan):
    """(b): two ranks spawned on the one card -> (rank 0's results, launches
    summed over both ranks' mesh work)."""
    results = torch_mp.get_context("spawn").Queue()
    procs = launch.spawn_ranks(mesh_shared_card_rank, (launch.free_port(), results, plan),
                               nprocs=2, first=0, quiet=False)
    got, deadline = {}, time.monotonic() + 900
    while len(got) < 2:
        try:
            r, out = results.get(timeout=1.0)
            got[r] = out
        except Exception:   # queue.Empty: see whether a rank failed
            if procs.join(timeout=0) and len(got) < 2:
                raise AssertionError("(b): the ranks ended without their results")
            if time.monotonic() > deadline:
                launch.kill(procs)
                raise AssertionError("(b): no results within 900 s")
    launch.join(procs, 120)
    launches = {k: got[0]["launches"][k] + got[1]["launches"][k] for k in COUNTERS}
    return got[0], launches


def mesh_served_model_parallel(dev, card):
    """(b)'s served batch: the engine on a mesh of model 2 over the one card
    (two threads) against the engine without one -> (max |dprob|, launches)."""
    gen = torch.Generator(device=dev).manual_seed(52)
    feats = seeded_features(2 * MESH_BATCH, 35, FILM_ATTN_CFG, gen, dev).cpu()
    items = [(feats[i], 35 - i % 7, [1 + (i * 7 + k) % 133 for k in range(3 + i % 9)])
             for i in range(2 * MESH_BATCH)]
    one = InferenceEngine(FILM_ATTN_CFG, max_batch=MESH_BATCH, frame_buckets=(), seed=0,
                          device=dev)
    two = InferenceEngine(FILM_ATTN_CFG, max_batch=MESH_BATCH, frame_buckets=(), seed=0,
                          mesh=make_mesh(2, 2, devices=[dev, dev]))
    for eng in (one, two):   # the first batch calibrates the int8 trunk
        eng.run_batch(items[:MESH_BATCH])
    want = one.run_batch(items[MESH_BATCH:])
    sync(dev)
    reset_counters()
    got = two.run_batch(items[MESH_BATCH:])
    sync(dev)
    launches = read_counters()
    err, bad = prob_errors(got, want)
    log(f"  (b) served batch of {MESH_BATCH} on model 2 (two threads on the one card): max"
        f" |dprob| {err:.3e} against the engine without a mesh (bound {PROB_ATOL}), {bad}"
        f" argmax changes where the margin exceeds {ARGMAX_MARGIN}; launches {launches}")
    if err > PROB_ATOL or bad:
        raise AssertionError("(b): the model-parallel engine does not serve as one device")
    expect_launches("(b) served batch, model 2", launches,
                    {"film_reencode": 2, "attn_tail": 2, "int8_matmul_fused": 10})
    return launches


def mesh_daemon(card, data, ckpt, vocab):
    """(c): the daemon with --mesh_devices 1 over the bf16 cache, answering
    MESH_REQUESTS /predict requests one at a time, each against run_batch of
    the engine without a mesh -> launches."""
    common = DAEMON_PRESET + ["--data_dir", data, "--checkpoint_path", ckpt]
    engine, batcher, server = serve_mod.build_server(
        serve_mod.build_parser().parse_args(common + ["--mesh_devices", "1"]))
    single = InferenceEngine.from_args(serve_mod.build_parser().parse_args(common))
    if engine.mesh is None or engine.mesh.shape != {"data": 1, "model": 1}:
        raise AssertionError("(c): the daemon is not on a mesh")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    ids = sorted(engine.id_to_idx)
    worst, total = 0.0, dict.fromkeys(COUNTERS, 0)
    t0 = time.perf_counter()
    try:
        port = server.server_address[1]
        for i in range(MESH_REQUESTS):
            q = question_text(i)
            ex = ids[(5 * i) % len(ids)]
            engine.rng, single.rng = np.random.RandomState(i), np.random.RandomState(i)
            frames, vl = single.load_example(ex)
            want = single.run_batch([(frames, vl, single.encode_question(q))])[0]
            torch.cuda.synchronize()
            reset_counters()
            status, body = http(port, "/predict", {"example": ex, "question": q})
            torch.cuda.synchronize()
            total = {k: total[k] + v for k, v in read_counters().items()}
            if status != 200:
                raise AssertionError(f"(c): request {i} answered {status}: {body}")
            got = np.full_like(want, np.inf)   # a class outside the answer's top 5
            for a, p in body["top"]:
                got[ANSWER_VOCAB[a]] = p
            top = np.argsort(-want)[:5]
            err = float(np.abs(got[top] - want[top]).max())
            worst = max(worst, err)
            if err > PROB_ATOL or int(np.argmax(want)) != ANSWER_VOCAB[body["answer"]] and \
                    np.diff(np.sort(np.log(want))[-2:])[0] > ARGMAX_MARGIN:
                raise AssertionError(f"(c): request {i} answered {body} against {want[top]}")
    finally:
        server.shutdown()
        serve_mod.drain(server, batcher)
    wall = time.perf_counter() - t0
    expect_launches("(c) the daemon on a one-device mesh", total,
                    {"film_reencode": MESH_REQUESTS, "attn_tail": MESH_REQUESTS,
                     "int8_matmul_fused": 5 * (MESH_REQUESTS - 1)})
    log(f"  (c) the daemon --mesh_devices 1 on {card}: {MESH_REQUESTS} requests one at a time in"
        f" {wall:.2f} s, each against run_batch of the engine without a mesh: max |dprob| of"
        f" the top 5 {worst:.3e} (bound {PROB_ATOL}); launches {total}")
    return total


def mesh(card, tmp, data, ckpt):
    """Phase 11 -> launches summed over its counted runs."""
    t_phase = time.perf_counter()
    total = dict.fromkeys(COUNTERS, 0)
    log(f"  card: {card}")

    # (a) NCCL worlds of one, through the harness, against the run without a mesh
    preset = FILM_PRESET + ["--feature_cache", "true", "--data_dir", data]
    runs = {}
    for label, extra in (
            ("no mesh", []), ("--mesh_devices 1", ["--mesh_devices", "1"]),
            ("--mesh_devices 1 --distributed (one process)",
             ["--mesh_devices", "1", "--distributed", "true", "--num_processes", "1",
              "--process_id", "0", "--coordinator_address",
             f"127.0.0.1:{launch.free_port()}"])):
        with timed_grad_sums() as sums:
            launches, seen = run_entry(f"(a) q_and_v_eval film_attn_pt, bf16 cache, {label}",
                                       q_and_v_eval.main, preset + extra,
                                       {"film_reencode": 1, "attn_tail": 1},
                                       os.path.join(tmp, f"mesh_{len(runs)}.jsonl"))
        total = {k: total[k] + launches[k] for k in total}
        runs[label] = (seen, sums)
    base = runs["no mesh"][0]
    for label, (seen, sums) in runs.items():
        errs = []
        for (train, s), (_, b) in zip(seen, base):
            errs.append(abs(s["loss"] - b["loss"]) / abs(b["loss"]))
            if errs[-1] > MESH_LOSS_RTOL or (not train and (
                    s["hit"] != b["hit"] or not np.array_equal(s["y_pred"], b["y_pred"]))):
                raise AssertionError(f"(a) {label}: the {'train' if train else 'val'} epoch"
                                     f" differs from the run without a mesh (loss rel."
                                     f" {errs[-1]:.2e})")
        rates = ", ".join(f"{'train' if t else 'val'} {s['examples_per_sec']:.2f} ex/s"
                          for t, s in seen)
        grad = (f"; the gradient sum over 'data' {', '.join(f'{m:.3f}' for m, _ in sums)} ms"
                f" (each step's), {sums[0][1]} bytes" if label != "no mesh" else "")
        log(f"  (a) {label} on {card}: {rates}{grad}; epoch losses rel."
            f" {', '.join(f'{e:.2e}' for e in errs)} from the run without a mesh (bound"
            f" {MESH_LOSS_RTOL}), val hits and predictions equal")

    # (b) two gloo ranks sharing the one card
    log(f"  {SHARED_CARD}")
    t0 = time.perf_counter()
    got, launches = mesh_shared_card(SimpleNamespace(
        device="cuda:0", batch=MESH_BATCH, train_cfg=MESH_TRAIN_CFG, eval_cfg=FILM_ATTN_CFG))
    total = {k: total[k] + launches[k] for k in total}
    order = got["rows reordered"]
    bound = {kind: max(MESH_GRAD_RTOL, MESH_ORDER_FACTOR * order[f"{kind}_err"])
             for kind in ("summed", "clipped")}
    log(f"  (b) one process, the batch's halves swapped, on {card}: the gradients rel. L2"
        f" {order['summed_err']:.2e} (summed), {order['clipped_err']:.2e} (clipped) from the"
        f" rows in order, params max |d| {order['param_err']:.3e}; the mesh's gradient bounds"
        f" {bound['summed']:.2e}, {bound['clipped']:.2e}")
    for label in ("train dp 2", "train model 2"):
        g = got[label]
        if not (g["loss_err"] <= MESH_LOSS_RTOL and g["param_err"] <= MESH_PARAM_ATOL
                and g["state_err"] <= MESH_STATE_ATOL and g["norm_err"] <= MESH_GRAD_RTOL
                and g["summed_err"] <= bound["summed"]
                and g["clipped_err"] <= bound["clipped"]):
            raise AssertionError(f"(b) {label}: {g}")
        log(f"  (b) {label}, 16 rows a rank on {card} (shared): loss rel. {g['loss_err']:.2e}"
            f" (bound {MESH_LOSS_RTOL}); the gradient summed over 'data' rel. L2"
            f" {g['summed_err']:.2e}, the clipped one {g['clipped_err']:.2e} (bounds above),"
            f" the norm after the clip {g['grad_norm']:.6f} rel. {g['norm_err']:.2e} (bound"
            f" {MESH_GRAD_RTOL}); params max |d| {g['param_err']:.3e} (bound"
            f" {MESH_PARAM_ATOL}), BN state {g['state_err']:.3e} (bound {MESH_STATE_ATOL});"
            f" its one step {g['step_s'] * 1e3:.1f} ms (the first in its process), the gradient"
            f" sum over gloo {g['grad_sum'][0]:.2f} ms for {g['grad_sum'][1]} bytes")
    err, bad = got["eval dp 2"]
    log(f"  (b) eval dp 2 (kernels, calibrated int8 trunk, bf16) on {card} (shared): max |dprob|"
        f" {err:.3e} against one process (bound {PROB_ATOL}), {bad} argmax changes where the"
        f" margin exceeds {ARGMAX_MARGIN}; both ranks' launches {launches}")
    if err > PROB_ATOL or bad:
        raise AssertionError("(b): the data-parallel eval step does not match one process")
    for name in ("film_reencode", "attn_tail", "int8_matmul_fused"):
        if launches[name] < 1:
            raise AssertionError(f"(b): {name} was not launched on the mesh")
    launches = mesh_served_model_parallel(torch.device("cuda"), card)
    total = {k: total[k] + launches[k] for k in total}
    log(f"  (b) in {time.perf_counter() - t0:.1f} s")

    # (c) the daemon on a one-device mesh
    vocab = load_json(os.path.join(data, "vocab.json"))
    launches = mesh_daemon(card, data, ckpt, vocab)
    total = {k: total[k] + launches[k] for k in total}
    log(f"  mesh phase on {card} in {time.perf_counter() - t_phase:.1f} s; launches {total}")
    return total


# ------------------------------------------------------------ phase 12: widths
# Widths the served presets do not use, each kernel's own flag: the lstm's
# hidden size (padded to 8 and 100 as is; 1,600 past 12 units an SM; 2,048
# at 16 rows a launch), the re-encode's (12 and 64 padded to the cluster's
# 128; 256 and 512 on the wide chain), the tail's attention size (20 padded
# to 128; the rest on the wide chain) and the trunk's channels (the streamed
# int8 route: 48 and 200 padded to 128 and 256, 1,536 and 2,048 past the
# panels' 1,024).
WIDTH_LSTM = (6, 100, 1600, 2048)
WIDTH_REENCODE = (12, 64, 256, 512)
WIDTH_ATTN = (20, 300, 512, 1024)
WIDTH_INT8 = (48, 200, 1536, 2048)
WIDTH_INT8_ROWS = (4550, 145600)   # folded rows of batch 1 and 32 at T35


def call_device_ms(fn, subs, launches, iters=5, windows=3):
    """Device ms of one ``fn()``: the profiler's time of every launch of the
    kernels whose names hold one of ``subs``, over ``iters`` calls. A window
    counts only where it saw all ``launches`` launches of each call; up to
    ``windows`` tries, then the last window's mean launch time, scaled (and
    said so). Late in a long run a window has missed the first kernel
    launched in it, so each window opens with a launch of its own."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for window in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device="cuda").add_(1.0)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and any(sub in e.key for sub in subs)]
        seen = sum(e.count for e in hits)
        total = sum(e.self_device_time_total for e in hits)
        if seen == launches * iters:
            return total / iters / 1e3
        log(f"  profiler window {window + 1} of {windows} saw {seen} of"
            f" {launches * iters} launches of {subs}")
    if not seen:
        raise AssertionError(f"the profiler saw no launch of {subs}")
    log(f"  {subs}: scaled from the last window's {seen} of {launches * iters} launches")
    return total / seen * launches / 1e3


def launches_of(mod, fn):
    """(result of fn(), launches of ``mod``'s kernel it made)."""
    before = mod.launches
    out = fn()
    return out, mod.launches - before


def widths_lstm(dev, card):
    """lstm_frames at each hidden size of WIDTH_LSTM, F 1, T 56, B 1 and 32
    (ragged lens, non-zero (h0, c0)): outs, h_f, c_f within RECURRENCE_ATOL
    of the plain version, outs zero past len; at B 32 timed, with
    torch.nn.LSTM (cuDNN, unmasked) of the same shape as the library call."""
    gen = torch.Generator().manual_seed(12)
    T, E = 56, 128
    out = {}
    for H in WIDTH_LSTM:
        cell = init.torch_default_lstm(gen, E, H)
        for B in (1, 32):
            lens = torch.randint(1, T + 1, (B,), generator=gen, dtype=torch.int32)
            lens[0] = T
            x = torch.randn((B, T, E), generator=gen)
            xw = (x @ cell["w_ih"].t() + cell["b_ih"]).transpose(0, 1).contiguous()
            h0, c0 = torch.randn((B, H), generator=gen), torch.randn((B, H), generator=gen)
            args = [t.to(dev) for t in (xw, cell["w_hh"], cell["b_hh"], lens, h0, c0)] + [1]
            got, n = launches_of(lstm_mod, lambda: lstm_mod.lstm_frames(*args))
            want = lstm_mod.lstm_frames_plain(*args)
            torch.cuda.synchronize()
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            past = torch.arange(T, device=dev)[:, None] >= args[3][None, :]
            stray = float((got[0][0].abs() * past[..., None]).max())
            tag = f"lstm H={H} B={B}"
            log(f"  {tag}: max_abs_err {err:.3e} (atol {RECURRENCE_ATOL}), largest |out| at"
                f" t >= len {stray}, {n} launches")
            if not err <= RECURRENCE_ATOL or stray != 0.0:
                raise AssertionError(f"{tag} disagrees: {err}, {stray}")
            if B == 1:
                continue
            Hp = lstm_mod.padded_hidden(H)
            steps = int(lens.sum())
            nbytes = 4 * (xw.numel() + 4 * H * H + 4 * H + B + 2 * B * H + T * B * H + 2 * B * H)
            b_ms, b_by = bound_ms(nbytes, steps * (2 * 4 * H * H + 12 * H), F32_FLOPS)
            lib = torch.nn.LSTM(E, H, batch_first=True).to(dev)
            with torch.no_grad():
                for name, key in (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh"),
                                  ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh")):
                    getattr(lib, name).copy_(cell[key])
            x_dev, state = x.to(dev), (args[4][None], args[5][None])

            def library():
                with torch.no_grad():
                    return lib(x_dev, state)
            run = lambda: lstm_mod.lstm_frames(*args)
            out[H] = row = dict(
                max_abs_err=err, launches=n, bound_ms=b_ms, bound_by=b_by,
                ms=call_device_ms(run, ("lstm_wide_kernel",), n), wrapper_ms=time_ms(run, 5),
                plain_ms=time_ms(lambda: lstm_mod.lstm_frames_plain(*args), 2, warmup=1),
                library_ms=time_ms(library, 5))
            log(f"  {tag} T={T} (hidden run as {Hp}) on {card}: {row['ms']:.4f} ms in"
                f" {n} launches (wrapper {row['wrapper_ms']:.4f}), plain {row['plain_ms']:.3f} ms,"
                f" torch.nn.LSTM {row['library_ms']:.4f} ms, bound {b_ms:.5f} ms by {b_by}")
    return out


def widths_reencode(dev, card):
    """film_reencode at each hidden size of WIDTH_REENCODE, Tq 56, F 35, B 32
    and 1 (ragged q_len): finals within RECURRENCE_ATOL of the plain version;
    at B 32 timed, with 35 chained cuDNN torch.nn.LSTM calls
    (reencode_library) as the library call."""
    gen = torch.Generator().manual_seed(13)
    E, Tq, n_frames = 128, 56, 35
    out = {}
    for H in WIDTH_REENCODE:
        cell = init.reference_lstm(gen, E, H)
        for B in (32, 1):
            lens = torch.randint(1, Tq + 1, (B,), generator=gen, dtype=torch.int32)
            lens[0] = Tq
            emb = torch.randn((B, Tq, E), generator=gen)
            xw = (emb @ cell["w_ih"].t() + cell["b_ih"]).transpose(0, 1).contiguous()
            args = [t.to(dev) for t in (xw, cell["w_hh"], cell["b_hh"], lens)] + [n_frames]
            got, n = launches_of(reenc_mod, lambda: reenc_mod.film_reencode(*args))
            want = reenc_mod.film_reencode_plain(*args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tag = f"film_reencode H={H} B={B}"
            log(f"  {tag}: max_abs_err {err:.3e} (atol {RECURRENCE_ATOL}), {n} launches")
            if not err <= RECURRENCE_ATOL:
                raise AssertionError(f"{tag} disagrees: {err}")
            if B == 1:
                continue
            steps = n_frames * int(lens.sum())
            nbytes = 4 * (xw.numel() + 4 * H * H + 4 * H + B) + 4 * n_frames * B * H
            b_ms, b_by = bound_ms(nbytes, steps * (2 * 4 * H * H + 12 * H), F32_FLOPS)
            library = reencode_library({k: v.to(dev) for k, v in cell.items()}, emb.to(dev),
                                       lens, n_frames)
            run = lambda: reenc_mod.film_reencode(*args)
            out[H] = row = dict(
                max_abs_err=err, launches=n, bound_ms=b_ms, bound_by=b_by,
                ms=call_device_ms(run, ("film_reencode_kernel", "film_reencode_wide_kernel"),
                                  n, iters=2),
                wrapper_ms=time_ms(run, 2, warmup=1),
                plain_ms=time_ms(lambda: reenc_mod.film_reencode_plain(*args), 1, warmup=0),
                library_ms=time_ms(library, 2, warmup=1))
            log(f"  {tag} on {card}: {row['ms']:.4f} ms in {n} launches (wrapper"
                f" {row['wrapper_ms']:.4f}), plain {row['plain_ms']:.3f} ms, cuDNN yardstick"
                f" {row['library_ms']:.4f} ms, bound {b_ms:.5f} ms by {b_by}; the serial chain"
                f" is {n_frames * int(lens.max())} dependent steps")
    return out


def widths_attn(dev, card):
    """attn_tail at each attention size of WIDTH_ATTN, T 35 (ragged v_len, the
    phantom frames of the shorter rows), 35 steps, B 32 and 1: hs within
    RECURRENCE_ATOL of the plain version; at B 32 timed (no single PyTorch
    call computes it), and at the most frames the wide kernels hold at 300
    (B 1)."""
    gen = torch.Generator().manual_seed(14)
    S = 35
    out = {}
    for A in WIDTH_ATTN:
        params = {"fc_hidden_attn": init.reference_linear(gen, 1, A),
                  "lstm_attn": init.reference_lstm(gen, A, A)}
        params = {k: {n: t.to(dev) for n, t in v.items()} for k, v in params.items()}
        shapes = [(32, 35), (1, 35)]
        if A == 300:
            shapes.append((1, _build.function("attn_tail", "attn_tail_max_frames",
                                              [ctypes.c_int])(attn_mod.padded_size(A))))
        for B, T in shapes:
            v_lens = torch.randint(1, T + 1, (B,), generator=gen, dtype=torch.int32)
            v_lens[0] = T
            v_lens = v_lens.to(dev)
            fmask = length_mask(v_lens, T)
            feats = torch.randn((B, T, A), generator=gen).to(dev) * fmask[..., None]
            scores = torch.where(fmask, torch.randn((B, T), generator=gen).to(dev), 0.0)
            args = (params, feats, scores, attn_frame_mask(v_lens, T), S, float(max(0, S - T)))
            got, n = launches_of(attn_mod, lambda: attn_mod.attn_tail(*args))
            want = attn_mod.attn_tail_plain(*args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tag = f"attn_tail A={A} B={B} T={T}"
            log(f"  {tag}: max_abs_err {err:.3e} (atol {RECURRENCE_ATOL}), {n} launches")
            if not err <= RECURRENCE_ATOL:
                raise AssertionError(f"{tag} disagrees: {err}")
            if (B, T) != (32, 35):
                continue
            nbytes = 4 * (B * T * A + 2 * B * T + 2 * 4 * A * A + 4 * A + B * S * A)
            ops = B * (6 * T + 2 * T * A + 2 * 4 * A * A + 4 * A + S * (2 * 4 * A * A + 12 * A))
            b_ms, b_by = bound_ms(nbytes, ops, F32_FLOPS)
            run = lambda: attn_mod.attn_tail(*args)
            out[A] = row = dict(
                max_abs_err=err, launches=n, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                ms=call_device_ms(run, ("attn_tail_",), n), wrapper_ms=time_ms(run, 5),
                plain_ms=time_ms(lambda: attn_mod.attn_tail_plain(*args), 2, warmup=1))
            log(f"  {tag} (run as {attn_mod.padded_size(A)}) on {card}: {row['ms']:.4f} ms in"
                f" {n} launches (wrapper {row['wrapper_ms']:.4f}), plain {row['plain_ms']:.3f}"
                f" ms, bound {b_ms:.5f} ms by {b_by}")
    return out


def widths_int8(dev, card):
    """The fused int8 1x1 at N = K in WIDTH_INT8 over WIDTH_INT8_ROWS, bf16 x
    and y with ReLU, on both requant sources: y within one bf16 ulp of the
    plain version's, yq within one step on at most YQ_MAX_FRACTION of its
    elements (and, from the stored source, equal to quantize_act of the y
    the kernel stored); at 145,600 rows timed with the f32 source, with
    torch._int_mm of the quantized operands as the library call."""
    gen = torch.Generator().manual_seed(15)
    out = {}
    for C in WIDTH_INT8:
        w = init.reference_conv2d(gen, 1, 1, C, C)["weight"]
        wq, w_scale = quantize_weight_channelwise(w)
        wq2, w_scale = wq[:, :, 0, 0].contiguous().to(dev), w_scale.to(dev)
        bias = (0.1 * torch.randn(C, generator=gen)).to(dev)
        for M in WIDTH_INT8_ROWS:
            x = torch.relu(torch.randn((M, C), generator=gen)).to(dev).to(torch.bfloat16)
            sx = act_scale(1.25 * x.float().abs().amax())
            comb = (sx * w_scale).contiguous()
            y_ref, _ = int8_mod.int8_matmul_plain(x, wq2, comb, bias, sx, None, relu=True,
                                                  out_dtype=torch.float32)
            nx = act_scale(1.25 * y_ref.abs().amax())
            del y_ref
            args = (x, wq2, comb, bias, sx, nx)
            for stored in (False, True):
                (y, yq), n = launches_of(int8_mod, lambda: int8_mod.int8_matmul_2d(
                    *args, relu=True, requant_stored=stored))
                y_p, yq_p = int8_mod.int8_matmul_plain(*args, relu=True,
                                                       out_dtype=torch.bfloat16,
                                                       requant_stored=stored)
                torch.cuda.synchronize()
                off_ulp = int(((y.float() - y_p.float()).abs() > _bf16_ulp(y_p.float())).sum())
                step = (yq.int() - yq_p.int()).abs()
                frac = float((step > 0).float().mean())
                own = int((yq != quantize_act(y.float(), nx)).sum()) if stored else 0
                tag = f"int8_matmul_fused N=K={C} M={M} requant_stored={stored}"
                log(f"  {tag}: y elements beyond 1 bf16 ulp {off_ulp}, yq max step"
                    f" {int(step.max())}, share differing {frac:.2e}"
                    + (f", differing from quantize_act(stored y) {own}" if stored else "")
                    + f"; {n} launches")
                if off_ulp or int(step.max()) > YQ_MAX_STEP or frac > YQ_MAX_FRACTION or own:
                    raise AssertionError(f"{tag}: disagrees")
                del y, yq, y_p, yq_p, step
            if M == WIDTH_INT8_ROWS[-1]:
                nbytes = M * C * 2 + C * C + 2 * C * 4 + 8 + M * C * 2 + M * C
                b_ms, b_by = bound_ms(nbytes, 2 * M * C * C, INT8_OPS)
                xq, wt = quantize_act(x, sx), wq2.t()
                run = lambda: int8_mod.int8_matmul_2d(*args, relu=True)
                out[C] = row = dict(
                    launches=n, bound_ms=b_ms, bound_by=b_by,
                    ms=call_device_ms(run, ("int8_matmul_kernel", "int8_quantize_kernel"),
                                      n, iters=10),
                    wrapper_ms=time_ms(run, 10),
                    plain_ms=time_ms(lambda: int8_mod.int8_matmul_plain(
                        *args, relu=True, out_dtype=torch.bfloat16), 3, warmup=1),
                    library_ms=time_ms(lambda: torch._int_mm(xq, wt), 10))
                log(f"  int8_matmul_fused N=K={C} M={M} on {card}"
                    f" ({'panel' if int8_mod.panel_route(C, C) else 'streamed'} route):"
                    f" {row['ms']:.4f} ms in {n} launches (wrapper {row['wrapper_ms']:.4f}),"
                    f" plain {row['plain_ms']:.4f} ms, torch._int_mm alone"
                    f" {row['library_ms']:.4f} ms, bound {b_ms:.5f} ms by {b_by}")
                del xq
            del x, args
            torch.cuda.empty_cache()
    return out


# The served widths of phase 12: film_attn_pt at the eval.sh preset's depth
# with the widest flags (a), film_gp_pt at the preset's depth with odd
# widths (b), MAC at mac_dim 2,048 (c), the question-only lstm at an odd and
# a wide hidden size (d).
WIDTH_FILM_ATTN_CFG = dataclasses.replace(FILM_ATTN_CFG, num_res_block_channels=2048,
                                          hidden_size=256, at_hidden_size=512)
WIDTH_FILM_GP_CFG = dataclasses.replace(FILM_GP_CFG, num_res_block_channels=200,
                                        hidden_size=100)
WIDTH_MAC_CFG = ModelConfig(model="mac", mac_dim=2048, use_pallas_kernels=True)


def lstm_launches(H, *batches):
    """Launches of the lstm kernel for one pass at hidden size H over each
    batch: one at 128, else one a slice of wide_rows rows."""
    if H == 128:
        return len(batches)
    rows = lstm_mod.wide_rows(lstm_mod.padded_hidden(H), torch.device("cuda"))
    return sum(-(-b // rows) for b in batches)


def width_launches(cfg):
    """Each kernel's launches over one forward at batch 32 and one at batch 1
    of ``cfg`` (T35, kernels on, int8 trunk calibrated)."""
    if cfg.model == "lstm":
        return {"lstm": lstm_launches(cfg.hidden_size, 32, 1)}
    if cfg.model == "mac":
        return {"lstm": 2 * lstm_launches(cfg.mac_dim, 32, 1)
                + lstm_launches(3 * cfg.mac_dim, 32, 1)}
    C = cfg.num_res_block_channels
    per_block = 1 if int8_mod.panel_route(C, C) else 2
    want = {"int8_matmul_fused": per_block * fused_1x1_launches(
        cfg.num_res_blocks, 32 * 35 * 130, 35 * 130)}
    H = cfg.hidden_size
    want["film_reencode"] = 2 if H <= 128 else 35 * lstm_launches(H, 32, 1)
    if cfg.model == "film_attn_pt":
        A = cfg.at_hidden_size
        want["attn_tail"] = 2 if A <= 256 else 4 + lstm_launches(A, 32, 1)
    return want


def serve_width(dev, cfg, label):
    """InferenceEngine with ``cfg`` at batch 32 and batch 1, T35, seeded
    weights and features: calibrated on a first micro-batch (int8 trunk),
    then one forward of each counted against width_launches, probabilities
    checked, each held to the plain path, ms/video of each path timed."""
    t0 = time.perf_counter()
    eng32 = InferenceEngine(cfg, seed=0, max_batch=32, device=dev)
    eng1 = InferenceEngine(cfg, seed=0, max_batch=1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(16)
    cpu_gen = torch.Generator().manual_seed(16)
    visual = eng32.visual_key is not None
    feats = seeded_features(65, 35, cfg, gen, dev) if visual else [None] * 65
    its = feature_items(feats, cpu_gen, 0, 65, 35)
    for i in (32, 64):   # bucket 35 for both counted forwards
        its[i] = (its[i][0], 35, its[i][2])
    if not visual:
        its = [(None, 0, q) for _, _, q in its]
    cal, b35, one = its[:32], its[32:64], its[64:65]
    eng32.run_batch(cal)   # the int8 trunk's calibration, where it has one
    eng1.run_batch(one)
    runs = ((eng32, b35), (eng1, one))
    for eng, b in runs:   # warm-up
        eng.run_batch(b)
    reset_counters()
    outs = [eng.run_batch(b) for eng, b in runs]
    torch.cuda.synchronize()
    launches = read_counters()
    log(f"  {label} launches (batch 32 and batch 1, T35): {launches}")
    expect_launches(label, launches, width_launches(cfg))
    for probs, (_, b) in zip(outs, runs):
        check_probs(probs, len(b), cfg.num_classes)
    worst = max(compare_paths(eng, b) for eng, b in runs)
    ms = {f"{label} batch {eng.B}": (per_video_ms(eng, b, 2, True),
                                      per_video_ms(eng, b, 1, False)) for eng, b in runs}
    log(f"  {label}: " + ", ".join(f"{k} kernel path {a:.3f} ms/video, plain path {p:.3f}"
                                   for k, (a, p) in ms.items())
        + f" ({time.perf_counter() - t0:.1f} s with set-up)")
    del eng32, eng1
    torch.cuda.empty_cache()
    return launches, ms, worst


WIDTH_SERVED = (
    (WIDTH_FILM_ATTN_CFG, "(a) film_attn_pt C2048 H256 A512"),
    (WIDTH_FILM_GP_CFG, "(b) film_gp_pt C200 H100"),
    (WIDTH_MAC_CFG, "(c) mac dim 2048"),
    (ModelConfig(model="lstm", hidden_size=100, use_pallas_kernels=True), "(d) lstm H100"),
    (ModelConfig(model="lstm", hidden_size=2048, use_pallas_kernels=True), "(d) lstm H2048"))


def serve_widths(dev):
    """(a)-(d) of WIDTH_SERVED through serve_width -> (launches, worst |dprob|)."""
    total, worst = dict.fromkeys(COUNTERS, 0), 0.0
    for cfg, label in WIDTH_SERVED:
        launches, _, path_worst = serve_width(dev, cfg, label)
        for name, n in launches.items():
            total[name] += n
        worst = max(worst, path_worst)
    return total, worst


def widths_grid(dev, card):
    """Phase 12's grid: the four width-bound kernels -> {kernel: {width: row}}."""
    t0 = time.perf_counter()
    rows = {"lstm": widths_lstm(dev, card), "film_reencode": widths_reencode(dev, card),
            "attn_tail": widths_attn(dev, card), "int8_matmul_fused": widths_int8(dev, card)}
    log(f"  the width grid in {time.perf_counter() - t0:.1f} s")
    return rows


def widths(dev, card):
    """Phase 12 alone -> (launches of the served widths, the grid's rows)."""
    rows = widths_grid(dev, card)
    return serve_widths(dev)[0], rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    start = time.perf_counter()
    log("phase build")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"  built {', '.join(_build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma", "arning")):
                log(f"  ptxas {name}: {line.strip()}")

    log("phase card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)

    log("phase kernels")
    reenc = check_film_reencode(dev)
    attn = check_attn_tail(dev)
    check_bits_unchanged(dev)
    int8 = check_int8_matmul(dev)
    gate = sweep_int8_gate(dev)
    lstm = check_lstm(dev)
    block1 = check_vgg_block1(dev)
    log("phase widths (the grid; its times need the profiler before the train phase's traces)")
    widths_grid(dev, card)

    log("phase serve")
    launches, ms, worst, served_ms, c3d = serve(dev)
    log("  port kernels' device ms over the serve phase's profiled batches (one batch of each"
        " timed configuration): " + ", ".join(f"{k} {v:.4f}" for k, v in served_ms.items()))
    log(f"  film_reencode on {card}, B: kernel ms, cuDNN yardstick ms: "
        + ", ".join(f"{b}: {r['ms']:.4f}, {r['library_ms']:.4f}" for b, r in reenc.items()))
    log(f"  int8 gate sweep on {card} (rows: fused route ms, plain route ms, kernel ms): "
        + ", ".join(f"{r}: {f:.4f}, {p:.4f}, {d:.4f}" for r, (f, p, d) in gate.items()))
    log(f"  serving on {card}, kernel path (plain path) ms/video: "
        + ", ".join(f"{k} {a:.4f} ({b:.4f})" for k, (a, b) in ms.items())
        + f"; worst kernel-vs-plain |dprob| {worst:.3e}")
    for b in (32, 1):
        log(f"  v_only_cnn3d splice sweep on {card}, batch {b} (T: pad / splice / cached ms a"
            " forward): " + ", ".join(f"T{T}: {r['pad']:.3f} / {r['splice']:.3f} /"
                                      f" {r['cached']:.3f}" for T, r in c3d[f"sweep {b}"].items())
            + f"; gates SPLICE_MAX_T {c3d_mod.SPLICE_MAX_T}, SPLICE_MAX_T_CACHED"
            f" {c3d_mod.SPLICE_MAX_T_CACHED}; f32 routes vs the full volume max |dlogit|"
            f" {c3d['routes']:.3e}")

    log("phase train")
    t0 = time.perf_counter()
    train_launches, trained, stem_ms = train(dev)
    for name, n in train_launches.items():
        launches[name] += n
    log(f"  training on {card} (phase {time.perf_counter() - t0:.1f} s), ms/step (training"
        " videos/s; lstm: questions/s): " + ", ".join(f"{k} {t:.1f} ({b * 1e3 / t:.2f})"
                                   for k, (b, t) in trained.items())
        + "; the stem's ms of a video step: "
        + ", ".join(f"{k} {t:.1f}" for k, t in stem_ms.items()))

    log("phase eval")
    t0 = time.perf_counter()
    for name, n in eval_steps(dev).items():
        launches[name] += n
    log(f"  (g) in {time.perf_counter() - t0:.1f} s")

    log("phase widths (served)")
    t0 = time.perf_counter()
    width_counts, worst = serve_widths(dev)
    for name, n in width_counts.items():
        launches[name] += n
    log(f"  served widths in {time.perf_counter() - t0:.1f} s; worst kernel-vs-plain |dprob|"
        f" {worst:.3e}")

    with synthetic_dataset() as (tmp, data):
        log("phase harness")
        for name, n in harness(card, tmp, data).items():
            launches[name] += n
        log("phase interchange")
        for name, n in interchange(dev, card, tmp, data).items():
            launches[name] += n
        log("phase daemon")
        for name, n in daemon(card, tmp, data, os.path.join(tmp, "e0_film.npz")).items():
            launches[name] += n
        log("phase mesh")
        for name, n in mesh(card, tmp, data, os.path.join(tmp, "e0_film.npz")).items():
            launches[name] += n

    log("phase stem")
    stem_launches, stem_times = stem_rest(dev, card)
    for name, n in stem_launches.items():
        launches[name] += n
    log(f"  int8 stem vs bf16 stem on {card}, 1,120 frames: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in stem_times.items()))

    log("phase datagen")
    for name, n in datagen(dev, card).items():
        launches[name] += n


    def entry(name, row, err):
        src, repl = REPO_SOURCE[name]
        return {"name": name, "route": "cuda", "source": src, "replaces": repl,
                "launches": launches[name], "max_abs_err": err, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    kernels = [
        entry("film_reencode", reenc[32], max(r["max_abs_err"] for r in reenc.values())),
        entry("attn_tail", attn[(32, 35)], max(r["max_abs_err"] for r in attn.values())),
        entry("int8_matmul_fused", int8["main"], max(int8["errs"])),
        entry("lstm", lstm[LSTM_MAIN], max(r["max_abs_err"] for r in lstm.values())),
        entry("vgg_block1", block1[BLOCK1_RUNS[0]],
              max(r["max_abs_err"] for r in block1.values())),
    ]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was launched on no served path")
    log(f"chip_smoke: all phases passed in {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
