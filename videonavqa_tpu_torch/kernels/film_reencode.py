"""FiLM question re-encode: the kernel of csrc/film_reencode.cu and its plain version.

Replaces ``videonavqa_tpu/kernels/film_reencode_pallas.py`` (film_reencode_pallas).
The FiLM generator re-encodes the question once per frame with a carried
(h, c): F chained masked LSTM passes (35 x 56 = 1,960 steps at full width),
h0 = c0 = 0 only before frame 0, each pass's last valid h collected. The
serial chain, not bytes, bounds it on an H100; the kernel spreads W_hh over
a thread-block cluster per batch row (the source note in the .cu file).
"""

from __future__ import annotations

import ctypes

import torch

from videonavqa_tpu_torch.kernels import _build
from videonavqa_tpu_torch.ops.lstm import last_valid, lstm

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


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


def check_shape(B, H):
    """Raises unless the kernel takes B batch rows at hidden size H."""
    if H != 128:
        raise ValueError(f"film_reencode kernel needs hidden size 128, got {H}")
    if not 1 <= B <= 65535:
        raise ValueError(f"film_reencode kernel takes 1 to 65,535 batch rows, got {B}")


def film_reencode(xw, w_hh, b_hh, lens, num_frames):
    """xw [Tq, B, 4H] f32, w_hh [4H, H], b_hh [4H] f32,
    lens [B] int32 -> finals [F, B, H] f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    global launches
    if xw.device.type == "cpu":
        return film_reencode_plain(xw, w_hh, b_hh, lens, num_frames)
    Tq, B, G = xw.shape
    H = G // 4
    dev = xw.device
    check_shape(B, H)
    _build.require(xw, "xw", torch.float32, device=dev)
    _build.require(w_hh, "w_hh", torch.float32, (G, H), dev)
    _build.require(b_hh, "b_hh", torch.float32, (G,), dev)
    _build.require(lens, "lens", torch.int32, (B,), dev)
    finals = torch.empty((num_frames, B, H), dtype=torch.float32, device=dev)
    fn = _build.function("film_reencode", "film_reencode", _ARGTYPES)
    err = fn(xw.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), lens.data_ptr(),
             finals.data_ptr(), Tq, B, int(num_frames), H, _build.stream_ptr(dev))
    _build.check(err, "film_reencode launch")
    launches += 1
    return finals

