"""The calibrated int8 trunk's 3x3 conv: the kernel of csrc/conv3x3_int8.cu and its plain twin.

Replaces no Pallas kernel: the JAX package leaves this conv to XLA, which
fuses its dequantization into the convolution; eager PyTorch runs it as an
im2col copy, ``torch._int_mm`` and one elementwise pass per step of the
epilogue (``ops/quant.py``). The kernel computes the SAME 3x3 conv of an
int8 NHWC activation as an implicit GEMM on the int8 tensor cores (the taps
read by TMA in im2col mode: no im2col and no padded copy in device memory)
and runs the epilogue on chip: the f32 dequantization and bias, then
either a ReLU (the trunk's conv_init) or a FiLM block's tail
``relu(a * y + b) + res`` (each residual block's 3x3 conv), stored in bf16.
Operations bound it on an H100; the source note in the .cu file gives the
design. Every step rounds where the plain twin rounds, and int32 sums are
exact, so the two are bit-equal.
"""

from __future__ import annotations

import ctypes

import torch

from videonavqa_tpu_torch.kernels import _build
from videonavqa_tpu_torch.ops.quant import act_scale, conv2d_int8_preq_act

launches = 0

# TMA's global strides are multiples of 16 bytes: C and O (int8 and bf16
# rows) must be multiples of 16.
WIDTH_MULTIPLE = 16

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def film_tail(y, a, b, res):
    """A FiLM block's ``relu(a * y + b) + res`` in the dtype of y, a and b
    [N, O] one row a frame, y and res [N, H, W, O]."""
    return torch.relu(a[:, None, None, :] * y + b[:, None, None, :]) + res


def conv3x3_int8_plain(wq, w_scale, bias, xq, act_absmax, *, relu=False, film=None,
                       out_dtype=torch.bfloat16):
    """The im2col route: ``conv2d_int8_preq_act`` (conv_i8 and _dequant),
    then a ReLU, or with ``film = (a, b, res)`` a FiLM block's tail."""
    y = conv2d_int8_preq_act(wq, w_scale, bias, xq, act_absmax, out_dtype=out_dtype)
    if film is not None:
        return film_tail(y, *film)
    return torch.relu(y) if relu else y


def check_shape(wq, xq):
    """Raises unless the kernel takes this conv: a 3x3 weight [O, C, 3, 3]
    over x [N, H, W, C], C and O multiples of WIDTH_MULTIPLE, fewer than
    2**31 rows."""
    O, C, kh, kw = wq.shape
    if xq.dim() != 4 or xq.shape[-1] != C or (kh, kw) != (3, 3):
        raise ValueError(f"conv3x3_int8 kernel needs wq [O, C, 3, 3] over x [N, H, W, C], got"
                         f" {tuple(wq.shape)} and {tuple(xq.shape)}")
    if C % WIDTH_MULTIPLE or O % WIDTH_MULTIPLE or C < 1 or O < 1:
        raise ValueError(f"conv3x3_int8 kernel needs C and O multiples of {WIDTH_MULTIPLE},"
                         f" got C={C}, O={O}")
    if xq.numel() == 0 or xq.numel() // C >= 2 ** 31:
        raise ValueError(f"conv3x3_int8 kernel needs 1 to 2**31 - 1 rows, got {xq.numel() // C}")


def takes(device, wq, out_dtype):
    """Whether the trunk routes a conv of int8 weight ``wq`` over a tensor on
    ``device`` to the kernel: CUDA, a 3x3 kernel, C and O multiples of
    WIDTH_MULTIPLE and a bf16 output. Every other conv keeps the im2col
    route."""
    O, C, kh, kw = wq.shape
    return (torch.device(device).type == "cuda" and (kh, kw) == (3, 3)
            and C % WIDTH_MULTIPLE == 0 and O % WIDTH_MULTIPLE == 0
            and out_dtype == torch.bfloat16)


def _launch(wq, w_scale, bias, xq, act_absmax, *, relu, film, out_dtype):
    global launches
    dev = xq.device
    check_shape(wq, xq)
    if out_dtype != torch.bfloat16:
        raise ValueError(f"conv3x3_int8 kernel stores bfloat16, got {out_dtype}")
    N, H, W, C = xq.shape
    O = wq.shape[0]
    _build.require(xq, "xq", torch.int8, (N, H, W, C), dev)
    _build.require(wq, "wq", torch.int8, (O, C, 3, 3), dev)
    # _dequant's scale, formed the same way
    scale = (act_scale(act_absmax) * w_scale.float()).contiguous()
    _build.require(scale, "scale", torch.float32, (O,), dev)
    b = None if bias is None else bias.float().contiguous()
    if b is not None:
        _build.require(b, "bias", torch.float32, (O,), dev)
    ptrs = (None, None, None)
    if film is not None:
        fa, fb, res = film
        _build.require(fa, "a", torch.bfloat16, (N, O), dev)
        _build.require(fb, "b", torch.bfloat16, (N, O), dev)
        _build.require(res, "res", torch.bfloat16, (N, H, W, O), dev)
        ptrs = (fa.data_ptr(), fb.data_ptr(), res.data_ptr())
    w2 = wq.permute(0, 2, 3, 1).reshape(O, 9 * C)   # conv_i8's (i, j, c) order, a copy
    y = torch.empty((N, H, W, O), dtype=torch.bfloat16, device=dev)
    if any(p % 16 for p in (xq.data_ptr(), y.data_ptr()) + (ptrs if film is not None else ())):
        raise ValueError("conv3x3_int8 kernel needs 16-byte aligned tensors")
    fn = _build.function("conv3x3_int8", "conv3x3_int8", _ARGTYPES)
    err = fn(xq.data_ptr(), w2.data_ptr(), scale.data_ptr(), None if b is None else b.data_ptr(),
             *ptrs, y.data_ptr(), N, H, W, C, O, int(relu), _build.stream_ptr(dev))
    _build.check(err, f"conv3x3_int8 launch at N={N}, H={H}, W={W}, C={C}, O={O}")
    launches += 1
    return y


def conv3x3_int8(wq, w_scale, bias, xq, act_absmax, *, relu=False, film=None,
                 out_dtype=torch.bfloat16):
    """int8 SAME 3x3 conv with a calibrated activation absmax, as
    ``conv2d_int8_preq_act`` takes it: wq [O, C, 3, 3] int8, w_scale [O], bias
    [O] or None, xq [N, H, W, C] int8, act_absmax 0-d -> [N, H, W, O] at
    ``out_dtype``, with a ReLU where ``relu`` is set, or with ``film = (a, b,
    res)`` (a, b [N, O] and res [N, H, W, O] at ``out_dtype``) a FiLM
    block's ``relu(a * y + b) + res``.

    CPU tensors take the plain twin; CUDA tensors launch the kernel (bf16
    out; any other width or dtype raises: ``takes`` says which convs the
    trunk sends here)."""
    fn = conv3x3_int8_plain if xq.device.type == "cpu" else _launch
    return fn(wq, w_scale, bias, xq, act_absmax, relu=relu, film=film, out_dtype=out_dtype)
