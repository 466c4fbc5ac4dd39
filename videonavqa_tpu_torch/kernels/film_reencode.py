"""FiLM question re-encode: the kernel of csrc/film_reencode.cu and its plain version.

Replaces ``videonavqa_tpu/kernels/film_reencode_pallas.py`` (film_reencode_pallas).
The FiLM generator re-encodes the question once per frame with a carried
(h, c): F chained masked LSTM passes (35 x 56 = 1,960 steps at full width),
h0 = c0 = 0 only before frame 0, each pass's last valid h collected. The
serial chain, not bytes, bounds it on an H100. Up to hidden size 128 the
kernel spreads W_hh over a thread-block cluster per batch row; above it, the
re-encode runs as chained passes of the wide chain over all SMs (the source
note in the .cu file).
"""

from __future__ import annotations

import ctypes

import torch

from videonavqa_tpu_torch.kernels import _build
from videonavqa_tpu_torch.kernels import lstm as lstm_kernels
from videonavqa_tpu_torch.ops.lstm import last_valid, lstm

launches = 0

# The hidden size of the cluster chain; a smaller one is zero-padded up to it.
CHAIN_HIDDEN = 128
# The cluster chain runs one batch row per cluster along the grid's y.
MAX_BATCH_CHAIN = 65535

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_WIDE_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                  + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])


def film_reencode_plain(xw, w_hh, b_hh, lens, num_frames):
    """xw [Tq, B, 4H] f32, lens [B] -> finals [F, B, H] f32 (plain PyTorch)."""
    params = {"w_hh": w_hh, "b_hh": b_hh}
    xw_b = xw.transpose(0, 1)
    h = c = None
    finals = []
    for _ in range(num_frames):
        outs, (h, c) = lstm(params, None, lens, h, c, precomputed_xw=xw_b)
        finals.append(last_valid(outs, lens))
    return torch.stack(finals)


def padded_hidden(H):
    """The hidden size the kernel runs for H: 128 (the cluster chain) up to
    128, the next multiple of 4 (the wide chain) above."""
    return CHAIN_HIDDEN if H <= CHAIN_HIDDEN else lstm_kernels.padded_hidden(H)


def check_shape(B, H):
    """Raises unless the kernel takes B batch rows at hidden size H: the
    cluster chain (H up to 128) takes at most 65,535 rows, the grid's y; the
    wide chain any batch, at any hidden size whose row of h fits one SM's
    shared memory."""
    if B < 1 or H < 1:
        raise ValueError(f"film_reencode kernel: bad shape B={B}, H={H}")
    if H <= CHAIN_HIDDEN and B > MAX_BATCH_CHAIN:
        raise ValueError(f"film_reencode kernel up to hidden size {CHAIN_HIDDEN} takes at most"
                         f" {MAX_BATCH_CHAIN:,} batch rows, got {B}")
    lstm_kernels.check_hidden(H)


def film_reencode(xw, w_hh, b_hh, lens, num_frames):
    """xw [Tq, B, 4H] f32, w_hh [4H, H], b_hh [4H] f32,
    lens [B] int32 -> finals [F, B, H] f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel: up
    to hidden size 128 the cluster chain, once (H zero-padded to 128); above
    it F chained passes of the wide chain."""
    if xw.device.type == "cpu":
        return film_reencode_plain(xw, w_hh, b_hh, lens, num_frames)
    Tq, B, G = xw.shape
    H = G // 4
    check_shape(B, H)
    Hp = padded_hidden(H)
    xw, w_hh, b_hh = (t.contiguous() for t in lstm_kernels.pad_units(Hp, xw, w_hh, b_hh))
    run = _launch_chain if Hp == CHAIN_HIDDEN else _launch_wide
    finals = run(xw, w_hh, b_hh, lens, int(num_frames))
    return finals if Hp == H else finals[..., :H].contiguous()


def _require(xw, w_hh, b_hh, lens):
    Tq, B, G = xw.shape
    dev = xw.device
    _build.require(xw, "xw", torch.float32, device=dev)
    _build.require(w_hh, "w_hh", torch.float32, (G, G // 4), dev)
    _build.require(b_hh, "b_hh", torch.float32, (G,), dev)
    _build.require(lens, "lens", torch.int32, (B,), dev)


def _launch_chain(xw, w_hh, b_hh, lens, num_frames):
    global launches
    _require(xw, w_hh, b_hh, lens)
    Tq, B, G = xw.shape
    finals = torch.empty((num_frames, B, G // 4), dtype=torch.float32, device=xw.device)
    fn = _build.function("film_reencode", "film_reencode", _ARGTYPES)
    err = fn(xw.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), lens.data_ptr(),
             finals.data_ptr(), Tq, B, num_frames, G // 4, _build.stream_ptr(xw.device))
    _build.check(err, "film_reencode launch")
    launches += 1
    return finals


def _launch_wide(xw, w_hh, b_hh, lens, num_frames):
    global launches
    _require(xw, w_hh, b_hh, lens)
    Tq, B, G = xw.shape
    H, dev = G // 4, xw.device
    finals = torch.empty((num_frames, B, H), dtype=torch.float32, device=dev)
    # zero h0, the carried c and h between steps, zeroed
    rows = max(min(lstm_kernels.wide_rows(H, dev), B), 1)
    scratch = torch.zeros(2 * B * H + 2 * rows * H, dtype=torch.float32, device=dev)
    launched = ctypes.c_int(0)
    fn = _build.function("film_reencode", "film_reencode_wide", _WIDE_ARGTYPES)
    err = fn(xw.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), lens.data_ptr(),
             finals.data_ptr(), scratch.data_ptr(), Tq, B, num_frames, H,
             ctypes.byref(launched), _build.stream_ptr(dev))
    launches += launched.value
    _build.check(err, "film_reencode wide launch")
    return finals
