"""Masked LSTM over one sequence batch: the kernels of csrc/lstm.cu and the plain version.

Replaces ``videonavqa_tpu/kernels/lstm_pallas.py`` (lstm_pallas): one masked
LSTM pass over ``xw = x W_ih^T + b_ih`` (one matmul outside), from a given
(h0, c0). The carry freezes at ``t >= len``, outputs are zero there, and the
final carry is returned. The recurrent product ``h W_hh^T`` is inside the
kernel. ``lstm_frames`` chains F such passes over the same ``xw``, each from
the last one's final carry, as the JAX time_multi_hop's scan over frames
calls lstm_pallas once a frame: at hidden size 128 that is one launch. The
serial chain of steps bounds it on an H100; the source note in the .cu file
says how the two designs (hidden size 128, and wider) spread a step over
the card.
"""

from __future__ import annotations

import ctypes

import torch

from videonavqa_tpu_torch.kernels import _build
from videonavqa_tpu_torch.ops.linear import linear

launches = 0

# The wide kernel serves one batch row per lane of a warp, so a launch takes
# at most 32 rows (a wider batch goes in launches of 32 rows); the
# hidden-128 kernel one row per cluster along the grid's y.
MAX_BATCH_WIDE = 32
MAX_BATCH_H128 = 65535

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def gates_to_state(gates, c):
    """(h, c) of one LSTM step from the summed gates [B, 4H] in (i, f, g, o) order."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def lstm_plain(xw, w_hh, b_hh, lens, h0, c0):
    """xw [T, B, 4H], lens [B], h0 and c0 [B, H] -> (outs [T, B, H] zero at
    t >= len, h_f, c_f), in plain PyTorch."""
    hh = {"weight": w_hh, "bias": b_hh}
    h, c = h0, c0
    outs = []
    for t in range(xw.shape[0]):
        h_new, c_new = gates_to_state(xw[t] + linear(hh, h), c)
        valid = (t < lens)[:, None]
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        outs.append(torch.where(valid, h_new, torch.zeros_like(h_new)))
    return torch.stack(outs), h, c


def lstm_frames_plain(xw, w_hh, b_hh, lens, h0, c0, num_frames):
    """``num_frames`` chained passes of ``lstm_plain`` over the same xw, each
    from the last one's final carry -> (outs [F, T, B, H], h_f, c_f)."""
    h, c = h0, c0
    frames = []
    for _ in range(num_frames):
        outs, h, c = lstm_plain(xw, w_hh, b_hh, lens, h, c)
        frames.append(outs)
    return torch.stack(frames), h, c


def lstm(xw, w_hh, b_hh, lens, h0, c0):
    """xw [T, B, 4H] f32, w_hh [4H, H], b_hh [4H], h0 and c0 [B, H] f32,
    lens [B] int32 -> (outs [T, B, H], h_f [B, H], c_f [B, H]) f32: one pass
    of ``lstm_frames``.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    outs, h_f, c_f = lstm_frames(xw, w_hh, b_hh, lens, h0, c0, 1)
    return outs[0], h_f, c_f


def lstm_frames(xw, w_hh, b_hh, lens, h0, c0, num_frames):
    """xw [T, B, 4H] f32, w_hh [4H, H], b_hh [4H], h0 and c0 [B, H] f32,
    lens [B] int32 -> (outs [F, T, B, H], h_f [B, H], c_f [B, H]) f32:
    ``num_frames`` = F chained masked passes over xw, the first from
    (h0, c0), each later one from the last one's frozen final carry; outs
    are zero at t >= len in every pass.

    CPU tensors take the plain version; CUDA tensors launch the kernel: one
    launch at hidden size 128; at any other, one a pass of up to 32 batch
    rows (the wide kernel runs one pass; ``_wide_pass``)."""
    if xw.device.type == "cpu":
        return lstm_frames_plain(xw, w_hh, b_hh, lens, h0, c0, num_frames)
    T, B, G = xw.shape
    H = G // 4
    if T < 1 or B < 1 or H < 1 or G != 4 * H or num_frames < 1:
        raise ValueError(f"lstm kernel: bad shape xw {tuple(xw.shape)} or pass count {num_frames}")
    if H == 128 and B > MAX_BATCH_H128:
        raise ValueError(f"lstm kernel at hidden size 128 takes at most {MAX_BATCH_H128} batch"
                         f" rows a launch, got {B}")
    if H != 128 and H % 4 != 0:
        raise ValueError(f"lstm kernel at a hidden size other than 128 needs a multiple of 4"
                         f" (it moves h and W_hh 16 bytes at a time), got hidden {H}")
    if H == 128:
        return _launch(xw, w_hh, b_hh, lens, h0, c0, num_frames)
    frames, h, c = [], h0, c0
    for _ in range(num_frames):
        outs, h, c = _wide_pass(xw, w_hh, b_hh, lens, h, c)
        frames.append(outs)
    return torch.stack(frames), h, c


def _wide_pass(xw, w_hh, b_hh, lens, h0, c0):
    """One pass at a hidden size other than 128 -> (outs [T, B, H], h_f, c_f):
    batch rows are independent, so a batch wider than MAX_BATCH_WIDE runs as
    one launch per slice of at most that many rows."""
    B, n = xw.shape[1], MAX_BATCH_WIDE
    if B <= n:
        outs, h, c = _launch(xw, w_hh, b_hh, lens, h0, c0, 1)
        return outs[0], h, c
    parts = [_launch(xw[:, s:s + n].contiguous(), w_hh, b_hh, lens[s:s + n], h0[s:s + n],
                     c0[s:s + n], 1) for s in range(0, B, n)]
    return (torch.cat([p[0][0] for p in parts], dim=1), torch.cat([p[1] for p in parts]),
            torch.cat([p[2] for p in parts]))


def _launch(xw, w_hh, b_hh, lens, h0, c0, num_frames):
    global launches
    T, B, G = xw.shape
    H = G // 4
    dev = xw.device
    _build.require(xw, "xw", torch.float32, device=dev)
    _build.require(w_hh, "w_hh", torch.float32, (G, H), dev)
    _build.require(b_hh, "b_hh", torch.float32, (G,), dev)
    _build.require(lens, "lens", torch.int32, (B,), dev)
    _build.require(h0, "h0", torch.float32, (B, H), dev)
    _build.require(c0, "c0", torch.float32, (B, H), dev)
    outs = torch.empty((num_frames, T, B, H), dtype=torch.float32, device=dev)
    h_f = torch.empty((B, H), dtype=torch.float32, device=dev)
    c_f = torch.empty((B, H), dtype=torch.float32, device=dev)
    # the wide kernel hands h from step to step through device memory
    h_steps = torch.empty((2, B, H), dtype=torch.float32, device=dev)
    fn = _build.function("lstm", "lstm_forward", _ARGTYPES)
    err = fn(xw.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), lens.data_ptr(),
             h0.data_ptr(), c0.data_ptr(), outs.data_ptr(), h_f.data_ptr(), c_f.data_ptr(),
             h_steps.data_ptr(), T, B, H, num_frames, _build.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"lstm kernel launch at T={T}, B={B}, H={H}, F={num_frames}: CUDA"
                           f" error {err} (1 = a shape the kernel does not take)")
    launches += 1
    return outs, h_f, c_f
