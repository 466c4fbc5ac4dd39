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
             against recorded digests of their outputs' bits; then the
             int8 row gate: both routes of a trunk block's 1x1 conv (the
             fused kernel; conv2d_int8_prequant, ReLU and the 3x3 conv's
             quantize) timed at the served folded row counts and above
             them, held against INT8_FUSED_MAX_ROWS;
4. serve   — InferenceEngine at the film_attn_pt eval.sh preset (5 FiLM
             blocks x 1024 channels, hidden/attention/embed 128, 512 input
             channels, bf16, 35 frames, 56 tokens, 134 words, 70 classes)
             with the static int8 trunk and the kernels on, twice: from
             seeded bf16 features, and from seeded uint8 video
             [35, 160, 208, 3] through the engine's video mode (the frozen
             stem from seed 1234, VGG block 1 through its kernel; the model
             from seed 0). Each calibrates on its first micro-batch, then
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
             steps). The train forward runs no kernel but the stem's: no
             kernel has a backward pass, and the LSTM kernel launches 0
             times in (a), (d) and (e).

Run one kernel's check alone (it builds only that source), e.g.
``python3 -c "import torch, chip_smoke as cs; cs.check_vgg_block1(torch.device('cuda'))"``.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it holds the per-kernel JSON record.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from videonavqa_tpu_torch.cli.common import PRESET_L_RATE, TRAIN_STEP_OPTIONS
from videonavqa_tpu_torch.kernels import _build
from videonavqa_tpu_torch.kernels import attn_tail as attn_mod
from videonavqa_tpu_torch.kernels import film_reencode as reenc_mod
from videonavqa_tpu_torch.kernels import int8_matmul as int8_mod
from videonavqa_tpu_torch.kernels import lstm as lstm_mod
from videonavqa_tpu_torch.kernels import vgg_block1 as block1_mod
from videonavqa_tpu_torch.models import ModelConfig, get_model
from videonavqa_tpu_torch.models.film import INT8_FUSED_MAX_ROWS, film_values_over_frames
from videonavqa_tpu_torch.models.time_multi_hop import film_values_all_frames
from videonavqa_tpu_torch.ops import initializers as init
from videonavqa_tpu_torch.ops.masking import attn_frame_mask, length_mask
from videonavqa_tpu_torch.ops.quant import (
    act_scale, conv2d_int8_prequant, quantize_act, quantize_weight_channelwise)
from videonavqa_tpu_torch.ops.video import normalize_video
from videonavqa_tpu_torch.serve.engine import STEM_SEED, InferenceEngine
from videonavqa_tpu_torch.stem import init_obj_detector, init_vgg_partial, stem_features
from videonavqa_tpu_torch.train.step import (
    make_optimizer, make_train_step, tree_items, tree_leaves)
from videonavqa_tpu_torch.utils.device import tree_to

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
KERNEL_NAMES = {"film_reencode": ("film_reencode_kernel",), "attn_tail": ("attn_tail_kernel",),
                "int8_matmul_fused": ("int8_matmul_kernel",),
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
                f" {-(-B // lstm_mod.MAX_BATCH_WIDE)} launches a pass, wrapper"
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
    return rows


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

    Holds the two against each other (y within one bf16 ulp; yq within one
    int8 step, since the kernel requantizes the f32 y and the plain route the
    stored bf16 one), and INT8_FUSED_MAX_ROWS against the times: raises
    unless the fused route is the faster at every count at or under the gate
    and the plain route at every count above it.
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

        def fused():
            return int8_mod.matmul_int8_fused(x, wq2, w_scale, bias, a1, relu=True,
                                              next_absmax=a3, out_dtype=torch.bfloat16)

        (y, yq), (yp, yqp) = fused(), plain()
        torch.cuda.synchronize()
        off_ulp = int(((y.float() - yp.float()).abs() > _bf16_ulp(yp.float())).sum())
        step = (yq.int() - yqp.int()).abs()
        log(f"  int8 gate sweep rows={rows}: fused vs plain route: y elements beyond 1 bf16 ulp"
            f" {off_ulp}, yq max step {int(step.max())}, share differing"
            f" {float((step > 0).float().mean()):.2e}")
        if off_ulp or int(step.max()) > YQ_MAX_STEP:
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


def compare_paths(eng, its):
    """Max |dprob| between the kernel path and the plain path of one padded
    batch on the engine's state (the same generator seed for both); raises
    beyond PROB_ATOL or on a differing argmax where the margin is wide."""
    cfg = eng.cfg
    plain_cfg = dataclasses.replace(cfg, use_pallas_kernels=False)
    batch = eng.make_batch(its)
    with torch.inference_mode():
        lk, _ = eng.forward(batch, cfg, torch.Generator(device=eng.device).manual_seed(11))
        lp, _ = eng.forward(batch, plain_cfg, torch.Generator(device=eng.device).manual_seed(11))
    n = len(its)
    lk, lp = lk[:n].float(), lp[:n].float()
    pdiff = (torch.softmax(lk, -1) - torch.softmax(lp, -1)).abs().max().item()
    top2 = lp.topk(2, dim=-1).values
    wide = (top2[:, 0] - top2[:, 1]) > ARGMAX_MARGIN
    agree = (lk.argmax(-1) == lp.argmax(-1))
    frames = f" T{batch[eng.visual_key].shape[1]}" if eng.visual_key else ""
    log(f"  {cfg.model} kernel vs plain path, batch {eng.B}{frames}:"
        f" max |dprob| {pdiff:.3e} (bound {PROB_ATOL}), argmax agree"
        f" {int(agree.sum())}/{n} ({int(wide.sum())} rows with margin > {ARGMAX_MARGIN})")
    if pdiff > PROB_ATOL or not bool(agree[wide].all()):
        raise AssertionError(f"{cfg.model}: the kernel path disagrees with the plain path")
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


def serve_stem_model(dev, cfg, feats, big, seed, tally):
    """One int8-trunk model over cached features: calibrate, then batch ``big``
    at frame buckets 20 and 35 and batch 1 at 35 frames, counted; the kernel
    path against the plain path; ms/video. -> (launches, ms, worst |dprob|)."""
    t0 = time.perf_counter()
    eng_big = InferenceEngine(cfg, seed=0, max_batch=big, device=dev)
    eng1 = InferenceEngine(cfg, seed=0, max_batch=1, device=dev)
    log(f"  {cfg.model} weights: 2 engines from seed 0 in {time.perf_counter() - t0:.1f} s")
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
    log(f"  int8 calibration on each engine's first micro-batch: {time.perf_counter() - t0:.2f} s")
    if eng_big.needs_int8_calibration or eng1.needs_int8_calibration:
        raise AssertionError("the engines did not calibrate")
    runs = ((eng_big, b20), (eng_big, b35), (eng1, one))
    for eng, its in runs:   # warm-up
        eng.run_batch(its)

    reset_counters()
    outs = [eng.run_batch(its) for eng, its in runs]
    torch.cuda.synchronize()
    launches = read_counters()
    log(f"  {cfg.model} launches on its path (batch {big} at buckets 20 and 35, batch 1 at 35):"
        f" {launches}")
    for probs, (_, its) in zip(outs, runs):
        check_probs(probs, len(its))
    worst = max(compare_paths(eng, its) for eng, its in runs)
    ms = {f"{cfg.model} batch {big} T35": time_paths(f"{cfg.model} batch {big} T35",
                                                     eng_big, b35, 3, tally),
          f"{cfg.model} batch 1 T35": time_paths(f"{cfg.model} batch 1 T35", eng1, one, 10,
                                                 tally)}
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


def serve_film_attn_video(dev, video, tally):
    """The eval.sh preset from raw uint8 video through the engine's video mode:
    calibrate on one set of videos, then serve batch 32 and batch 1 at 35
    frames from others, counted; the kernel path against the plain path;
    ms/video and the stem's share."""
    cfg = FILM_ATTN_CFG
    t0 = time.perf_counter()
    eng_big = InferenceEngine(cfg, seed=0, max_batch=32, device=dev, from_video=True)
    eng1 = InferenceEngine(cfg, seed=0, max_batch=1, device=dev, from_video=True,
                           stem=eng_big.stem)
    log(f"  {cfg.model} weights: stem from seed 1234, 2 engines from seed 0 in"
        f" {time.perf_counter() - t0:.1f} s")
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
    log(f"  {cfg.model} from video, launches on its path (batch 32 and batch 1 at 35 frames):"
        f" {launches}")
    expect_launches(cfg.model, launches, dict(
        FILM_ATTN_KERNELS, vgg_block1=2,
        int8_matmul_fused=fused_1x1_launches(5, 32 * 35 * 130, 35 * 130)))
    for probs, (_, its) in zip(outs, runs):
        check_probs(probs, len(its))
    worst = max(compare_paths(eng, its) for eng, its in runs)
    ms = {}
    for label, eng, its, iters in ((f"{cfg.model} video batch 32 T35", eng_big, b35, 3),
                                   (f"{cfg.model} video batch 1 T35", eng1, one, 10)):
        ms[label] = time_paths(label, eng, its, iters, tally)
        stem_share(label, eng, its)
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


def serve(dev):
    """Every served path in turn -> (launches summed over the paths, ms, worst
    |dprob|, each port kernel's device ms summed over the profiled batches:
    one batch of each timed configuration)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    feats = torch.relu(torch.randn((32 * 3 + 1, 35, 10, 13, 512), generator=gen, device=dev)
                       ).to(torch.bfloat16)
    video = torch.randint(0, 256, (66, 35, 160, 208, 3), generator=gen, device=dev,
                          dtype=torch.uint8)
    total = dict.fromkeys(COUNTERS, 0)
    ms, worst, tally = {}, 0.0, dict.fromkeys(KERNEL_NAMES, 0.0)
    paths = [lambda: serve_film_attn_features(dev, feats, tally),
             lambda: serve_film_attn_video(dev, video, tally),
             lambda: serve_time_multi_hop(dev, feats, tally)]
    paths += [lambda m=m, n=n: serve_zoo_model(dev, m, feats, n, tally)
              for m, n in (("lstm", 1), ("v_only_cnn2d_lstm", 1), ("concat2d", 2), ("mac", 3))]
    paths.append(lambda: serve_mac_batch64(dev, feats, tally))
    for path in paths:
        launches, path_ms, path_worst = path()
        for name, n in launches.items():
            total[name] += n
        ms.update(path_ms)
        worst = max(worst, path_worst)
        torch.cuda.empty_cache()
    return total, ms, worst, tally


# The small film_attn_pt of tests/test_torch_film_attn.py (f32).
TRAIN_SMALL = dict(num_classes=7, vocab_size=19, embed_size=8, hidden_size=8, at_hidden_size=8,
                   num_res_blocks=2, num_res_block_channels=16, num_input_channels=12,
                   num_tail_channels=4, max_num_frames=6, max_q_len=9,
                   compute_dtype="float32")
# The small widths of tests/test_torch_lstm_models.py (f32, the kernels asked
# for, which no train forward takes): time_multi_hop's and MAC's parity runs.
ZOO_SMALL = dict(num_classes=7, vocab_size=19, embed_size=8, hidden_size=8,
                 num_res_blocks=2, num_res_block_channels=16, num_input_channels=12,
                 num_tail_channels=4, mac_dim=8, mac_max_step=2, max_num_frames=6,
                 max_q_len=9, compute_dtype="float32", use_pallas_kernels=True)


def train_batch(B, T, q_max, vocab, classes, seed, feat_shape=None):
    """Numpy-seeded train batch (question, lengths, labels, and features of
    ``feat_shape`` [10, 13, C] zero past each v_len), as CPU tensors; one
    example runs all T frames and one all q_max tokens."""
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
    return batch


def run_train_steps(cfg, dev, batches, lr):
    """Steps of make_train_step (the model's TRAIN_STEP_OPTIONS) over
    ``batches`` from the model's weights of seed 0 on ``dev``, step i drawing
    from a generator on ``dev`` seeded i -> (losses, step 1's gradients,
    params, state)."""
    spec = get_model(cfg.model)
    params, state = spec.init(torch.Generator().manual_seed(0), cfg, dev)
    train = make_train_step(spec, cfg, make_optimizer(params, lr),
                            **TRAIN_STEP_OPTIONS[cfg.model])
    losses, grads = [], None
    for i, b in enumerate(batches):
        state, m = train(params, state, tree_to(b, dev), torch.Generator(device=dev).manual_seed(i))
        losses.append(float(m["loss"]))
        if grads is None:
            grads = [p.grad.detach().cpu().clone() for p in tree_leaves(params)]
    return losses, grads, params, state


def train_parity(dev):
    """(a): 3 train steps on the card against the same 3 on the CPU, f32,
    TF32 off: film_attn_pt at TRAIN_SMALL, time_multi_hop and MAC at
    ZOO_SMALL, MAC without dropout (the card's generator and the CPU's draw
    different masks; the dropout is held to JAX on the CPU). Raises beyond
    the TRAIN_* bounds, or where a kernel was launched."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batches = [train_batch(3, 6, 9, 19, 7, 60 + i, (10, 13, 12)) for i in range(3)]
    for cfg in (ModelConfig(**TRAIN_SMALL), ModelConfig(model="time_multi_hop", **ZOO_SMALL),
                ModelConfig(model="mac", mac_dropout=0.0, **ZOO_SMALL)):
        cpu = run_train_steps(cfg, torch.device("cpu"), batches, 1e-3)
        reset_counters()
        card = run_train_steps(cfg, dev, batches, 1e-3)
        torch.cuda.synchronize()
        expect_launches(f"{cfg.model} train parity", read_counters(), {})
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
        top = max(float(g.abs().max()) for g in cpu[1])
        grad_err = max(float((a - b).abs().max()) for a, b in zip(card[1], cpu[1])) / top
        names = [n for n, _ in tree_items(cpu[2])] + [n for n, _ in tree_items(cpu[3])]
        pairs = list(zip(tree_leaves(card[2]) + tree_leaves(card[3]),
                         tree_leaves(cpu[2]) + tree_leaves(cpu[3])))
        errs = [float((a.detach().cpu() - b.detach()).abs().max()) for a, b in pairs]
        worst = max(range(len(errs)), key=errs.__getitem__)
        log(f"  train parity, {cfg.model}, card vs CPU, small config f32, 3 steps: losses"
            f" {card[0]} vs {cpu[0]}, worst loss rel. error {loss_err:.3e} (bound"
            f" {TRAIN_LOSS_RTOL}); step 1 gradients within {grad_err:.3e} of the largest"
            f" {top:.4f} (bound {TRAIN_GRAD_TOL}); params and BN state within"
            f" {errs[worst]:.3e} (bound {TRAIN_PARAM_ATOL}; worst leaf {names[worst]});"
            f" no kernel launched")
        if (loss_err > TRAIN_LOSS_RTOL or grad_err > TRAIN_GRAD_TOL
                or errs[worst] > TRAIN_PARAM_ATOL):
            raise AssertionError(f"{cfg.model} train step: the card disagrees with the CPU")


def train_preset(dev, cfg, label, batch, stem_fn, steps, profile_at, top=10):
    """make_train_step at a preset (the model's TRAIN_STEP_OPTIONS and
    PRESET_L_RATE) over ``batch`` (on the card) for ``steps`` steps from the weights of seed 0,
    step i drawing from a generator on the card seeded i; steps 2-4 timed by
    the host clock around synchronized steps, step ``profile_at`` profiled
    (none for 0). -> (losses, grad_norms, ms/step, launches over the timed
    steps, the trained params)."""
    spec = get_model(cfg.model)
    params, state = spec.init(torch.Generator().manual_seed(0), cfg, dev)
    train = make_train_step(spec, cfg, make_optimizer(params, PRESET_L_RATE[cfg.model]),
                            stem_fn=stem_fn, **TRAIN_STEP_OPTIONS[cfg.model])
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
        f"{len(batch['label']) / ms * 1e3:.2f} training videos/s, peak memory {peak:.2f} GiB,"
        f" launches over steps 2-4 {launches}; losses {[round(x, 4) for x in losses]},"
        f" grad_norms {[round(x, 4) for x in norms]}")
    return losses, norms, ms, launches, params


def check_losses(label, losses, norms, falls=True):
    """Every loss and grad norm finite, and (``falls``) the last loss under the first."""
    if not all(np.isfinite(losses + norms)) or (falls and not losses[-1] < losses[0]):
        raise AssertionError(f"{label}: losses {losses}, grad norms {norms}: not all finite"
                             + (", or the last loss is not under the first" if falls else ""))


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


def train(dev):
    """(a)-(e) -> (launches over (c)'s and (e)'s counted steps, {label:
    (batch, ms/step)}, {label: stem ms})."""
    t0 = time.perf_counter()
    train_parity(dev)
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
    launches = {k: film_launches[k] + mac_launches[k] for k in film_launches}
    ms = {"film_attn_pt from features": (32, film_feat),
          "film_attn_pt from video": (32, film_video),
          "time_multi_hop from features": (16, tmh_ms), "mac from features": (32, mac_feat),
          "mac from video": (32, mac_video)}
    return launches, ms, {"film_attn_pt": film_stem, "mac": mac_stem}


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

    log("phase serve")
    launches, ms, worst, served_ms = serve(dev)
    log("  port kernels' device ms over the serve phase's profiled batches (one batch of each"
        " timed configuration): " + ", ".join(f"{k} {v:.4f}" for k, v in served_ms.items()))
    log(f"  film_reencode on {card}, B: kernel ms, cuDNN yardstick ms: "
        + ", ".join(f"{b}: {r['ms']:.4f}, {r['library_ms']:.4f}" for b, r in reenc.items()))
    log(f"  int8 gate sweep on {card} (rows: fused route ms, plain route ms, kernel ms): "
        + ", ".join(f"{r}: {f:.4f}, {p:.4f}, {d:.4f}" for r, (f, p, d) in gate.items()))
    log(f"  serving on {card}, kernel path (plain path) ms/video: "
        + ", ".join(f"{k} {a:.4f} ({b:.4f})" for k, (a, b) in ms.items())
        + f"; worst kernel-vs-plain |dprob| {worst:.3e}")

    log("phase train")
    t0 = time.perf_counter()
    train_launches, trained, stem_ms = train(dev)
    for name, n in train_launches.items():
        launches[name] += n
    log(f"  training on {card} (phase {time.perf_counter() - t0:.1f} s), ms/step (training"
        " videos/s): " + ", ".join(f"{k} {t:.1f} ({b * 1e3 / t:.2f})"
                                   for k, (b, t) in trained.items())
        + "; the stem's ms of a video step: "
        + ", ".join(f"{k} {t:.1f}" for k, t in stem_ms.items()))

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
