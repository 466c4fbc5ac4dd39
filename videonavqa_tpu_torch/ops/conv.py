"""Channels-last 2-D and 3-D convolution with SAME padding over OIHW / OIDHW
weights, and max pooling.

The JAX package leaves these convs to XLA, so the port leaves them to
PyTorch: ``F.conv2d`` / ``F.conv3d`` on a channels-last view (no layout copy
of the activation), and a 1x1 stride-1 2-D conv as a channel matmul.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(params, x, *, dtype=None):
    """x [N, H, W, Cin], weight [Cout, Cin, kh, kw] (odd kh, kw) -> [N, H, W, Cout].

    ``dtype`` sets the compute and output dtype (x and the weight are cast);
    the bias is added at the output dtype."""
    w = params["weight"]
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    elif x.dtype != w.dtype:
        w = w.to(x.dtype)
    kh, kw = w.shape[2:]
    if kh == 1 and kw == 1:
        y = torch.matmul(x, w[:, :, 0, 0].t())
    else:
        y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=(kh // 2, kw // 2))
        y = y.permute(0, 2, 3, 1).contiguous()
    b = params.get("bias")
    if b is not None:
        y = y + b.to(y.dtype)
    return y


# cuDNN's implicit-GEMM convolutions index with 32 bits: a 3-D conv whose
# output has more elements falls to a direct kernel, ~50x slower on an H100
# (the C3D's conv1 at batch 32: 287 ms against 5.8 for half the frames;
# PERF.md, section 6), so ``conv3d`` runs such a batch in chunks under it.
MAX_CONV_OUTPUT = 2**31 - 1


def conv3d(params, x, *, dtype=None):
    """x [N, D, H, W, Cin], weight [Cout, Cin, kd, kh, kw] (odd sizes) ->
    [N, D, H, W, Cout], with ``conv2d``'s dtype and bias rules; a batch whose
    output would exceed MAX_CONV_OUTPUT elements runs in chunks of rows."""
    w = params["weight"]
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    elif x.dtype != w.dtype:
        w = w.to(x.dtype)
    pad = tuple(k // 2 for k in w.shape[2:])
    w = w.contiguous(memory_format=torch.channels_last_3d)
    rows = max(1, MAX_CONV_OUTPUT // (x[0, ..., :1].numel() * w.shape[0]))
    ys = [F.conv3d(xc.permute(0, 4, 1, 2, 3), w, padding=pad) for xc in x.split(rows)]
    y = (ys[0] if len(ys) == 1 else torch.cat(ys)).permute(0, 2, 3, 4, 1).contiguous()
    b = params.get("bias")
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def max_pool3d(x, window):
    """Max pool of x [N, D, H, W, C] over D, H, W with stride = ``window``
    (VALID, torch's floor mode). As ``max_pool2d``: where autograd records,
    ``F.max_pool3d``, whose gradient goes to the first maximum of a window,
    as XLA's ``reduce_window`` gives it (the C3D's zero-padded tail makes
    exact ties on nearly every window there); elsewhere one ``amax``."""
    a, b, c = window
    N, D, H, W, C = x.shape
    if torch.is_grad_enabled() and x.requires_grad:
        y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), window)
        return y.permute(0, 2, 3, 4, 1)
    x = x[:, :D // a * a, :H // b * b, :W // c * c]
    return x.reshape(N, D // a, a, H // b, b, W // c, c, C).amax(dim=(2, 4, 6))


def max_pool2d(x):
    """2x2 max pool, stride 2, over H and W of x [..., H, W, C] (floor mode:
    an odd last row or column is dropped).

    Where autograd records, ``F.max_pool2d`` on the channels-last view: its
    gradient goes to the first maximum of a window in row-major order, as
    XLA's and the reference's do (``amax``'s would split it among tied
    maxima, which flat regions of frames make). Elsewhere (serving, the
    frozen stem) one ``amax`` over the windows gives the same values without
    the indices ``F.max_pool2d`` writes on the card, which made the stem's
    forward slower (PERF.md, section 6)."""
    H, W, C = x.shape[-3:]
    if torch.is_grad_enabled() and x.requires_grad:
        y = F.max_pool2d(x.reshape(-1, H, W, C).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        return y.reshape(*x.shape[:-3], H // 2, W // 2, C)
    x = x[..., :H // 2 * 2, :W // 2 * 2, :]
    return x.reshape(*x.shape[:-3], H // 2, 2, W // 2, 2, C).amax(dim=(-4, -2))
