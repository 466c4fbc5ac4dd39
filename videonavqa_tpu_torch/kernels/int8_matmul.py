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
runs the product on wgmma with the weight tiles brought in by TMA (source
note in the .cu file).
"""

from __future__ import annotations

import ctypes

import torch

from videonavqa_tpu_torch.kernels import _build
from videonavqa_tpu_torch.ops.quant import act_scale, quantize_act

launches = 0

# The deepest reduction the kernel takes: two int8 row panels [64, K] sit in
# shared memory beside the weight ring.
MAX_K = 1024

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
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
    """Raises unless the kernel takes an [M, K] x [N, K] product."""
    if M < 1 or N < 128 or N % 128 or K < 128 or K % 128 or K > MAX_K:
        raise ValueError(f"int8_matmul kernel needs M >= 1, N % 128 == 0, K % 128 == 0 and"
                         f" K <= {MAX_K}, got M={M}, N={N}, K={K}")


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
    if x2.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("int8_matmul kernel needs 16-byte aligned x and wq")
    y = torch.empty((M, N), dtype=out_dtype, device=dev)
    yq = None
    if nx is not None:
        _build.require(nx, "nx", torch.float32, (), dev)
        yq = torch.empty((M, N), dtype=torch.int8, device=dev)
    fn = _build.function("int8_matmul", "int8_matmul_fused", _ARGTYPES)
    err = fn(x2.data_ptr(), int(x2.dtype == torch.float32), wq.data_ptr(), comb.data_ptr(),
             bias.data_ptr(), sx.data_ptr(), None if nx is None else nx.data_ptr(),
             y.data_ptr(), int(out_dtype == torch.float32),
             None if yq is None else yq.data_ptr(), M, N, K, int(relu), int(requant_stored),
             _build.stream_ptr(dev))
    _build.check(err, "int8_matmul launch")
    launches += 1
    return y, yq


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
