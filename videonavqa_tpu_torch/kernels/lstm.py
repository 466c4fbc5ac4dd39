"""Masked LSTM over one sequence batch: the kernels of csrc/lstm.cu and the plain version.

Replaces ``videonavqa_tpu/kernels/lstm_pallas.py`` (lstm_pallas): one masked
LSTM pass over ``xw = x W_ih^T + b_ih`` (one matmul outside), from a given
(h0, c0). The carry freezes at ``t >= len``, outputs are zero there, and the
final carry is returned. The recurrent product ``h W_hh^T`` is inside the
kernel. ``lstm_frames`` chains F such passes over the same ``xw``, each from
the last one's final carry, as the JAX time_multi_hop's scan over frames
calls lstm_pallas once a frame: at hidden size 128 that is one launch. The
serial chain of steps bounds it on an H100; the source notes in the .cu
file and in csrc/lstm_wide.cuh say how the two designs (hidden size 128,
and any other) spread a step over the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from videonavqa_tpu_torch.kernels import _build
from videonavqa_tpu_torch.ops.linear import linear

launches = 0

# The hidden-128 kernel runs one batch row per cluster along the grid's y.
MAX_BATCH_H128 = 65535
# The shared memory one block of the wide kernel can use on sm_90: a launch's
# h [rows, H] must fit there (csrc/lstm_wide.cuh), so one row of h bounds the
# hidden size (the launch's C entry also counts c, there above 1,584 units).
SMEM_LIMIT = 232448

_H128_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_WIDE_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
                  + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])


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


def padded_hidden(H):
    """The hidden size the wide kernel runs for H: the next multiple of 4 (it
    moves h and W_hh 16 bytes at a time)."""
    return -(-H // 4) * 4


def check_hidden(H):
    """Raise unless the wide kernel takes hidden size H: one batch row of h,
    zero-padded to a multiple of 4, must fit the shared memory of one block
    (the hardware's 227 KB; ~58,000 units)."""
    if 4 * padded_hidden(H) > SMEM_LIMIT:
        raise ValueError(f"lstm kernel: a row of h at hidden size {H} does not fit one SM's"
                         f" {SMEM_LIMIT} bytes of shared memory")


def pad_units(Hp, xw, w_hh, b_hh, *state):
    """xw [T, B, 4H], w_hh [4H, H], b_hh [4H] and each state [B, H],
    zero-padded from H to Hp hidden units: gate g of unit u is column (row)
    g*Hp + u. A padded unit's inputs, weights and biases are zero, so its c
    and h stay exactly 0 (sigmoid(0) 0 + sigmoid(0) tanh(0)), and the real
    units see the same sums."""
    H = w_hh.shape[1]
    if Hp == H:
        return (xw, w_hh, b_hh, *state)
    p = Hp - H
    gates = lambda t: F.pad(t.reshape(*t.shape[:-1], 4, H), (0, p)).reshape(*t.shape[:-1], 4 * Hp)
    w = F.pad(w_hh.reshape(4, H, H), (0, p, 0, p)).reshape(4 * Hp, Hp)
    return (gates(xw), w, gates(b_hh), *(F.pad(t, (0, p)) for t in state))


def lstm_frames(xw, w_hh, b_hh, lens, h0, c0, num_frames):
    """xw [T, B, 4H] f32, w_hh [4H, H], b_hh [4H], h0 and c0 [B, H] f32,
    lens [B] int32 -> (outs [F, T, B, H], h_f [B, H], c_f [B, H]) f32:
    ``num_frames`` = F chained masked passes over xw, the first from
    (h0, c0), each later one from the last one's frozen final carry; outs
    are zero at t >= len in every pass.

    CPU tensors take the plain version; CUDA tensors launch the kernel: one
    launch at hidden size 128; at any other, the wide kernel (the hidden
    units zero-padded to a multiple of 4), one pass at a time, in launches
    of as many batch rows as its shared memory holds (32 up to hidden 1,816,
    then 16, 8, ...)."""
    if xw.device.type == "cpu":
        return lstm_frames_plain(xw, w_hh, b_hh, lens, h0, c0, num_frames)
    T, B, G = xw.shape
    H = G // 4
    if T < 1 or B < 1 or H < 1 or G != 4 * H or num_frames < 1:
        raise ValueError(f"lstm kernel: bad shape xw {tuple(xw.shape)} or pass count {num_frames}")
    if H == 128:
        if B > MAX_BATCH_H128:
            raise ValueError(f"lstm kernel at hidden size 128 takes at most {MAX_BATCH_H128}"
                             f" batch rows a launch, got {B}")
        return _launch(xw, w_hh, b_hh, lens, h0, c0, num_frames)
    check_hidden(H)
    Hp = padded_hidden(H)
    xw, w_hh, b_hh, h, c = pad_units(Hp, xw, w_hh, b_hh, h0, c0)
    frames = []
    for _ in range(num_frames):
        outs, h, c = wide_pass(xw.contiguous(), w_hh.contiguous(), b_hh.contiguous(), lens,
                               h.contiguous(), c.contiguous())
        frames.append(outs)
    outs = torch.stack(frames)
    if Hp == H:
        return outs, h, c
    return outs[..., :H].contiguous(), h[:, :H].contiguous(), c[:, :H].contiguous()


def wide_rows(H, device):
    """The most batch rows one launch of the wide kernel takes at hidden size
    H (a multiple of 4) on ``device``, from the kernel's library."""
    with torch.cuda.device(device):
        return _build.function("lstm", "lstm_wide_rows", [ctypes.c_int])(H)


def wide_pass(xw, w_hh, b_hh, lens, h0, c0):
    """One pass of the wide kernel at hidden size H, a multiple of 4 ->
    (outs [T, B, H], h_f, c_f); its C entry runs the batch as launches of
    ``wide_rows`` rows, each counted."""
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
    outs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    h_f = torch.empty((B, H), dtype=torch.float32, device=dev)
    c_f = torch.empty((B, H), dtype=torch.float32, device=dev)
    # h between steps, through device memory
    h_steps = torch.empty((2, max(min(wide_rows(H, dev), B), 1), H), dtype=torch.float32,
                          device=dev)
    launched = ctypes.c_int(0)
    fn = _build.function("lstm", "lstm_wide_forward", _WIDE_ARGTYPES)
    err = fn(xw.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), lens.data_ptr(), h0.data_ptr(),
             c0.data_ptr(), outs.data_ptr(), h_f.data_ptr(), c_f.data_ptr(), h_steps.data_ptr(),
             T, B, H, ctypes.byref(launched), _build.stream_ptr(dev))
    launches += launched.value
    if err != 0:
        raise RuntimeError(f"lstm wide kernel launch at T={T}, B={B}, H={H}: CUDA error {err}"
                           " (1 = a shape the kernel does not take)")
    return outs, h_f, c_f


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
    fn = _build.function("lstm", "lstm_forward", _H128_ARGTYPES)
    err = fn(xw.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), lens.data_ptr(),
             h0.data_ptr(), c0.data_ptr(), outs.data_ptr(), h_f.data_ptr(), c_f.data_ptr(),
             T, B, H, num_frames, _build.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"lstm kernel launch at T={T}, B={B}, H={H}, F={num_frames}: CUDA"
                           f" error {err} (1 = a shape the kernel does not take)")
    launches += 1
    return outs, h_f, c_f
