"""film_attn attention tail: the kernel of csrc/attn_tail.cu and its plain version.

Replaces ``videonavqa_tpu/kernels/attn_tail_pallas.py`` (attn_tail_pallas):
``num_steps`` (35) steps of phantom-corrected masked softmax over frames,
context reduction and an LSTMCell update. The serial chain of 35 steps, not
bytes, bounds it on an H100. The attention weights do not depend on the
step (the rank-1 projection v shifts every logit and the phantom frames'
alike, so it cancels in the softmax): the kernel forms the context and the
input gates once per launch, and a cluster of 8 SMs per batch row runs the
35 LSTMCell steps up to attention size 256; above it, the wide chain over
all SMs runs them (the source note in the .cu file).
"""

from __future__ import annotations

import ctypes

import torch

from videonavqa_tpu_torch.kernels import _build
from videonavqa_tpu_torch.kernels import lstm as lstm_kernels
from videonavqa_tpu_torch.ops.linear import linear
from videonavqa_tpu_torch.ops.lstm import lstm_cell

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_void_p])
_WIDE_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                  + [ctypes.c_float, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])


def attn_tail_plain(params, feats, scores, mask, num_steps, n_phantom):
    """feats [B, T, A], scores and mask [B, T] -> hs [B, num_steps, A] f32."""
    B, T, A = feats.shape
    feats = feats.float()
    sm = scores.float() + mask.float()
    h = c = torch.zeros((B, A), dtype=torch.float32, device=feats.device)
    hs = []
    for _ in range(num_steps):
        v = linear(params["fc_hidden_attn"], h)                    # [B, 1]
        logits = v + sm
        # the max over the frames and the phantom frames, each at v, where there
        # are some (with none, a max with v lets every exp underflow to 0 / 0
        # where all scores are far under v)
        m = logits.amax(dim=1, keepdim=True)
        if n_phantom > 0:
            m = torch.maximum(m, v)
        e = torch.exp(logits - m)
        denom = e.sum(dim=1, keepdim=True)
        if n_phantom > 0:
            denom = denom + n_phantom * torch.exp(v - m)
        ctxt = torch.einsum("bt,bta->ba", e / denom, feats)
        h, c = lstm_cell(params["lstm_attn"], ctxt, h, c)
        hs.append(h)
    return torch.stack(hs, dim=1)


# The hidden sizes the cluster kernel is built for; a smaller attention size
# is zero-padded up to the next one, a larger one to a multiple of 4 for the
# wide chain.
KERNEL_SIZES = (128, 256)


def padded_size(A):
    """The hidden size the kernel runs for attention size A."""
    for size in KERNEL_SIZES:
        if A <= size:
            return size
    lstm_kernels.check_hidden(A)
    return lstm_kernels.padded_hidden(A)


def check_frames(ap, T):
    """Raise ValueError for more frames than the kernel's shared memory holds
    at hidden size ``ap`` (its library says how many)."""
    size = _build.function("attn_tail", "attn_tail_max_frames", [ctypes.c_int])
    most = size(ap)
    if T > most:
        raise ValueError(f"attn_tail kernel takes at most {most} frames at hidden size {ap},"
                         f" got {T}")


def pad_inputs(params, feats, ap):
    """(w_ih [4ap, ap], w_hh [4ap, ap], bias [4ap] = b_ih + b_hh, feats
    [B, T, ap]) f32, zero-padded from attention size A to ``ap``: gate g of
    unit u is row g*ap + u; padded units and columns are zero, so a padded
    unit's c and h stay exactly 0 and the real units see the same sums."""
    B, T, A = feats.shape
    cell = params["lstm_attn"]
    bias = (cell["b_ih"].float() + cell["b_hh"].float()).contiguous()
    if A == ap:   # nothing to pad (the served size)
        return (cell["w_ih"].float().contiguous(), cell["w_hh"].float().contiguous(), bias,
                feats.float().contiguous())

    def pad(x, shape, index):
        out = x.new_zeros(shape, dtype=torch.float32)
        out[index] = x.float()
        return out

    def rows(w):  # [4A, A] -> [4ap, ap]
        return pad(w.reshape(4, A, A), (4, ap, ap), (slice(None), slice(0, A), slice(0, A)))

    return (rows(cell["w_ih"]).reshape(4 * ap, ap), rows(cell["w_hh"]).reshape(4 * ap, ap),
            pad(bias.reshape(4, A), (4, ap), (slice(None), slice(0, A))).reshape(-1),
            pad(feats, (B, T, ap), (Ellipsis, slice(0, A))))


def attn_tail(params, all_features, scores, mask, num_steps, n_phantom):
    """all_features [B, T, A], scores and mask [B, T] -> hs [B, num_steps, A] f32.

    params: fc_hidden_attn {'weight' [1, A], 'bias' [1]} and lstm_attn
    {'w_ih' [4A, A], 'w_hh' [4A, A], 'b_ih', 'b_hh' [4A]}. CPU tensors take
    the plain version; CUDA tensors launch the kernel: up to A 256 the
    cluster kernel, A zero-padded to 128 or 256 (any T its shared memory
    holds: 28,862 frames at 128, 28,670 at 256); above, the context and
    gate kernels and the wide chain (A padded to a multiple of 4; 29,056
    frames)."""
    if all_features.device.type == "cpu":
        return attn_tail_plain(params, all_features, scores, mask, num_steps, n_phantom)
    B, T, A = all_features.shape
    if A < 1 or T < 1 or num_steps < 1:
        raise ValueError(f"attn_tail kernel: bad shape A={A}, T={T} or num_steps {num_steps}")
    dev = all_features.device
    ap = padded_size(A)
    w_ih, w_hh, bias, feats = pad_inputs(params, all_features, ap)
    scores = scores.float().contiguous()
    mask = mask.float().contiguous()
    for name, t, shape in (("feats", feats, (B, T, ap)), ("scores", scores, (B, T)),
                           ("mask", mask, (B, T)), ("w_ih", w_ih, (4 * ap, ap)),
                           ("w_hh", w_hh, (4 * ap, ap)), ("bias", bias, (4 * ap,))):
        _build.require(t, name, torch.float32, shape, dev)
    check_frames(ap, T)
    hs = torch.empty((B, num_steps, ap), dtype=torch.float32, device=dev)
    launch = _launch_cluster if ap in KERNEL_SIZES else _launch_wide
    launch(feats, scores, mask, w_ih, w_hh, bias, hs, int(num_steps), float(n_phantom))
    return hs if ap == A else hs[..., :A]


def _launch_cluster(feats, scores, mask, w_ih, w_hh, bias, hs, num_steps, n_phantom):
    global launches
    B, T, ap = feats.shape
    fn = _build.function("attn_tail", "attn_tail", _ARGTYPES)
    err = fn(feats.data_ptr(), scores.data_ptr(), mask.data_ptr(), w_ih.data_ptr(),
             w_hh.data_ptr(), bias.data_ptr(), hs.data_ptr(), B, T, num_steps, ap, n_phantom,
             _build.stream_ptr(feats.device))
    _build.check(err, "attn_tail launch")
    launches += 1


def _launch_wide(feats, scores, mask, w_ih, w_hh, bias, hs, num_steps, n_phantom):
    global launches
    B, T, ap = feats.shape
    dev = feats.device
    lens = torch.full((B,), num_steps, dtype=torch.int32, device=dev)
    # ctx, gin, zeros (b_hh, h0), c, h_f, h_steps; zeroed
    rows = max(min(lstm_kernels.wide_rows(ap, dev), B), 1)
    scratch = torch.zeros(B * ap * 8 + 4 * ap + 2 * rows * ap, dtype=torch.float32,
                          device=dev)
    launched = ctypes.c_int(0)
    fn = _build.function("attn_tail", "attn_tail_wide", _WIDE_ARGTYPES)
    err = fn(feats.data_ptr(), scores.data_ptr(), mask.data_ptr(), w_ih.data_ptr(),
             w_hh.data_ptr(), bias.data_ptr(), lens.data_ptr(), scratch.data_ptr(),
             hs.data_ptr(), B, T, num_steps, ap, n_phantom, ctypes.byref(launched),
             _build.stream_ptr(dev))
    launches += launched.value
    _build.check(err, "attn_tail wide launch")
