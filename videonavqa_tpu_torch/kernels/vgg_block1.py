"""The stem's first VGG block, fused: the kernel of csrc/vgg_block1.cu and the plain version.

Replaces ``videonavqa_tpu/kernels/vgg_block1_pallas.py`` (vgg_block1_pallas):
``pool2x2(relu(conv1_2(relu(conv1_1(x)))))`` with SAME padding and f32 sums,
over frames ``[M, 160, 208, 3]`` (pixels already /255) to ``[M, 80, 104, 64]``.
The kernel takes the OIHW weights and NHWC frames as they are; the 64-channel
activations at 160x208 never reach device memory. Operations bound it on an
H100; the source note in the .cu file gives the design.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from videonavqa_tpu_torch.kernels import _build

launches = 0

FRAME = (160, 208, 3)
C = 64
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def _weights(params, dtype):
    """(w1, b1, w2, b2): OIHW weights in ``dtype``, f32 biases."""
    c1, c2 = params["conv1_1"], params["conv1_2"]
    return (c1["weight"].to(dtype), c1["bias"].float(), c2["weight"].to(dtype),
            c2["bias"].float())


def h1_plain(params, x, *, dtype=torch.bfloat16):
    """conv1_1 -> ReLU of x [M, H, W, 3] -> h1 [M, H, W, 64] in ``dtype``, as
    the kernel computes it: x and w1 in ``dtype``, the 27 products summed in
    f32 tap by tap, then input channel, bias and ReLU in f32, one rounding to
    ``dtype``. In bf16 every product is exact in f32, so the kernel's FMAs
    give the same h1 bit for bit."""
    w1, b1, _, _ = _weights(params, dtype)
    w1 = w1.float()
    x = x.to(dtype).float()
    M, H, W, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((M, H, W, C), dtype=torch.float32, device=x.device)
    for u in range(3):
        for v in range(3):
            for c in range(3):
                acc.addcmul_(xp[:, u:u + H, v:v + W, c:c + 1], w1[:, c, u, v])
    return acc.add_(b1).relu_().to(dtype)


def vgg_block1_plain(params, x, *, dtype=torch.bfloat16):
    """x [M, H, W, 3] -> [M, H/2, W/2, 64] in ``dtype``, in plain PyTorch.

    It rounds where the kernel rounds: h1 as ``h1_plain``; conv1_2 with f32
    sums, bias, ReLU and the 2x2 max in f32, the result stored in ``dtype``."""
    _, _, w2, b2 = _weights(params, dtype)
    h1 = h1_plain(params, x, dtype=dtype)
    y = F.conv2d(h1.float().permute(0, 3, 1, 2), w2.float(), padding=1)
    del h1
    y = F.max_pool2d(y.add_(b2[:, None, None]).relu_(), 2)
    return y.permute(0, 2, 3, 1).to(dtype).contiguous()


def vgg_block1(params, x, *, dtype=torch.bfloat16):
    """x [M, 160, 208, 3] -> [M, 80, 104, 64] in ``dtype`` (bf16 or f32).

    Frames of any other shape raise. CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    global launches
    if x.dim() != 4 or tuple(x.shape[1:]) != FRAME or x.shape[0] < 1:
        raise ValueError(f"vgg_block1: frames must be [M, 160, 208, 3], got {tuple(x.shape)}")
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"vgg_block1: dtype must be bfloat16 or float32, got {dtype}")
    if x.device.type == "cpu":
        return vgg_block1_plain(params, x, dtype=dtype)
    dev = x.device
    M = x.shape[0]
    x = x.to(dtype).contiguous()
    _build.require(x, "x", dtype, (M, *FRAME))
    w1, b1, w2, b2 = (t.contiguous() for t in _weights(params, dtype))
    _build.require(w1, "conv1_1 weight", dtype, (C, 3, 3, 3), dev)
    _build.require(b1, "conv1_1 bias", torch.float32, (C,), dev)
    _build.require(w2, "conv1_2 weight", dtype, (C, C, 3, 3), dev)
    _build.require(b2, "conv1_2 bias", torch.float32, (C,), dev)
    out = torch.empty((M, FRAME[0] // 2, FRAME[1] // 2, C), dtype=dtype, device=dev)
    fn = _build.function("vgg_block1", "vgg_block1_forward", _ARGTYPES)
    _build.check(fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                    out.data_ptr(), M, int(dtype == torch.float32), _build.stream_ptr(dev)),
                 f"vgg_block1 kernel launch at M={M}")
    launches += 1
    return out
