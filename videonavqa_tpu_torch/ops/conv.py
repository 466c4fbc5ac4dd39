"""Channels-last 2-D convolution with SAME padding over OIHW weights, and max pooling.

The JAX package leaves these convs to XLA, so the port leaves them to
PyTorch: ``F.conv2d`` on a channels-last view (no layout copy of the
activation), and a 1x1 stride-1 conv as a channel matmul.
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


def max_pool2d(x):
    """2x2 max pool, stride 2, over H and W of x [..., H, W, C] (floor mode:
    an odd last row or column is dropped)."""
    H, W, C = x.shape[-3:]
    x = x[..., :H // 2 * 2, :W // 2 * 2, :]
    return x.reshape(*x.shape[:-3], H // 2, 2, W // 2, 2, C).amax(dim=(-4, -2))
