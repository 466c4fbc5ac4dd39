"""Fused int8 1x1 conv: the kernel of csrc/int8_matmul.cu and its plain version.

Replaces ``videonavqa_tpu/kernels/int8_matmul_pallas.py``
(matmul_int8_fused_pallas): quantize x with the calibrated activation scale,
int8 x int8 -> int32 product against the pre-quantized weight, dequant and
bias in f32, optional ReLU, a store at the compute dtype and, optionally, an
int8 requantization of the result with the NEXT conv's calibrated scale, from
the f32 value (the Pallas kernel's source) or from the stored one
(``requant_stored``: the source of the JAX package's plain route).
Bytes bound it on an H100; fusing keeps the int8 copy of x and the int32
accumulator out of device memory. The kernel is persistent (one block per SM
over 64 x 128 items), quantizes each row panel once into shared memory, and
runs the product on wgmma with the weight tiles brought in by TMA. That
panel route takes N and K in multiples of 128 with K up to 1,024; every
other width takes the streamed route: x quantized into an int8 copy by one
kernel, its tiles then streamed by TMA beside the weights (source note in
the .cu file).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from videonavqa_tpu_torch.kernels import _build
from videonavqa_tpu_torch.ops.quant import act_scale, quantize_act

launches = 0

# The panel route's widths: N and K multiples of TILE, K at most PANEL_MAX_K
# (two int8 row panels [64, K] sit in shared memory beside the weight ring).
# Every other width takes the streamed route.
TILE = 128
PANEL_MAX_K = 1024

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
             + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_STREAMED_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
                      + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def int8_matmul_plain(x2, wq, comb, bias, sx, nx, *, relu, out_dtype, requant_stored=False):
    """x2 [M, K] -> y [M, N] at out_dtype (and yq [M, N] int8 when nx is
    given: of the f32 y, or with ``requant_stored`` of y as stored)."""
    acc = torch._int_mm(quantize_act(x2, sx), wq.t())
    y = acc.float() * comb + bias
    if relu:
        y = torch.relu(y)
    stored = y.to(out_dtype)
    if nx is None:
        return stored, None
    return stored, quantize_act(stored if requant_stored else y, nx)


def check_shape(M, N, K):
    """Raises unless the kernel takes an [M, K] x [N, K] product: any M, N
    and K of at least 1 (the streamed route's bound is device memory)."""
    if M < 1 or N < 1 or K < 1:
        raise ValueError(f"int8_matmul kernel needs M, N, K >= 1, got M={M}, N={N}, K={K}")


def padded(n):
    """n rounded up to the kernel's tile of 128."""
    return -(-n // TILE) * TILE


def panel_route(N, K):
    """Whether an [M, K] x [N, K] product takes the panel route (else the
    streamed one)."""
    return N % TILE == 0 and K % TILE == 0 and K <= PANEL_MAX_K


def pad_weights(wq, comb, bias):
    """wq [N, K] int8 and comb, bias [N] f32, zero-padded to multiples of 128
    in N and K: a padded column of x quantizes to 0 and meets zero weights,
    a padded output row gets comb 0 and bias 0, so the int32 sums of the real
    outputs are unchanged, and the padded outputs (0) are dropped."""
    N, K = wq.shape
    Np, Kp = padded(N), padded(K)
    if (Np, Kp) == (N, K):
        return wq, comb, bias
    return (F.pad(wq, (0, Kp - K, 0, Np - N)).contiguous(),
            F.pad(comb, (0, Np - N)).contiguous(), F.pad(bias, (0, Np - N)).contiguous())


def _launch(x2, wq, comb, bias, sx, nx, *, relu, out_dtype, requant_stored=False):
    global launches
    M, K = x2.shape
    N = wq.shape[0]
    dev = x2.device
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x: expected bfloat16 or float32, got {x2.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype: expected bfloat16 or float32, got {out_dtype}")
    check_shape(M, N, K)
    _build.require(x2, "x", x2.dtype, (M, K), dev)
    _build.require(wq, "wq", torch.int8, (N, K), dev)
    _build.require(comb, "comb", torch.float32, (N,), dev)
    _build.require(bias, "bias", torch.float32, (N,), dev)
    _build.require(sx, "sx", torch.float32, (), dev)
    if nx is not None:
        _build.require(nx, "nx", torch.float32, (), dev)
    if x2.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("int8_matmul kernel needs 16-byte aligned x and wq")
    panels = panel_route(N, K)
    if not panels:
        wq, comb, bias = pad_weights(wq, comb, bias)
    Np, Kp = wq.shape
    y = torch.empty((M, Np), dtype=out_dtype, device=dev)
    yq = None if nx is None else torch.empty((M, Np), dtype=torch.int8, device=dev)
    tail = (None if nx is None else nx.data_ptr(), y.data_ptr(),
            int(out_dtype == torch.float32), None if yq is None else yq.data_ptr(), M, Np, Kp,
            int(relu), int(requant_stored), _build.stream_ptr(dev))
    x_f32 = int(x2.dtype == torch.float32)
    if panels:
        fn = _build.function("int8_matmul", "int8_matmul_fused", _ARGTYPES)
        err = fn(x2.data_ptr(), x_f32, wq.data_ptr(), comb.data_ptr(), bias.data_ptr(),
                 sx.data_ptr(), *tail)
        _build.check(err, "int8_matmul launch")
        launches += 1
        return y, yq
    xq = torch.empty((M, Kp), dtype=torch.int8, device=dev)
    fn = _build.function("int8_matmul", "int8_matmul_streamed", _STREAMED_ARGTYPES)
    err = fn(x2.data_ptr(), x_f32, K, xq.data_ptr(), wq.data_ptr(), comb.data_ptr(),
             bias.data_ptr(), sx.data_ptr(), *tail)
    _build.check(err, "int8_matmul streamed launch")
    launches += 2   # the quantize kernel, then the product
    if Np == N:
        return y, yq
    return y[:, :N].contiguous(), None if yq is None else yq[:, :N].contiguous()


def int8_matmul_2d(x2, wq, comb, bias, sx, nx=None, *, relu=False, out_dtype=torch.bfloat16,
                   requant_stored=False):
    """The kernel's own interface: x2 [M, K] bf16/f32, wq [N, K] int8, comb and
    bias [N] f32, sx (and nx) 0-d f32 -> (y [M, N], yq [M, N] int8 or None);
    ``requant_stored`` quantizes yq from y as stored rather than from f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    fn = int8_matmul_plain if x2.device.type == "cpu" else _launch
    return fn(x2, wq, comb, bias, sx, nx, relu=relu, out_dtype=out_dtype,
              requant_stored=requant_stored)


def matmul_int8_fused(x, wq, w_scale, bias, act_absmax, *, relu=False, next_absmax=None,
                      out_dtype=torch.bfloat16, requant_stored=False):
    """Fused quantize -> int8 matmul -> dequant(+bias)(+relu) over channels.

    x [..., Cin] (bf16/f32), wq [Cout, Cin] int8, w_scale [Cout] per-output
    -channel weight scales, bias [Cout] or None, act_absmax a 0-d calibrated
    activation absmax. Returns x.shape[:-1] + [Cout] at ``out_dtype``; with
    ``next_absmax`` also the result requantized to int8 with that absmax, as
    ``(y, yq)``: from the f32 value, as the JAX package's Pallas kernel does,
    or with ``requant_stored`` from the value stored at ``out_dtype``, as its
    plain route (``conv2d_int8_prequant`` into the next conv) does."""
    cout, cin = wq.shape
    lead = x.shape[:-1]
    sx = act_scale(act_absmax)
    comb = (sx * w_scale.float()).contiguous()
    b = (torch.zeros(cout, dtype=torch.float32, device=x.device) if bias is None
         else bias.float().contiguous())
    nx = None if next_absmax is None else act_scale(next_absmax)
    y, yq = int8_matmul_2d(x.reshape(-1, cin).contiguous(), wq.contiguous(), comb, b, sx, nx,
                           relu=relu, out_dtype=out_dtype, requant_stored=requant_stored)
    if yq is None:
        return y.reshape(*lead, cout)
    return y.reshape(*lead, cout), yq.reshape(*lead, cout)
