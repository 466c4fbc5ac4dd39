"""int8 convolutions of the serving trunk and the int8 stem, in plain PyTorch.

Weights quantize per output channel (symmetric absmax); activations per
tensor with a calibrated absmax. The int8 product is exact: ``torch._int_mm``
(int8 x int8 -> int32) over the channel axis, with a 3x3 conv written as an
im2col of nine shifted views of a zero-padded tensor (``F.unfold`` refuses
int8 on the CPU). The JAX package leaves this conv to XLA outside any Pallas
kernel, and XLA fuses its dequantization into it; eager PyTorch does not.
So the calibrated trunk's 3x3 convs, where the fused int8 1x1 kernel runs,
take the hand-written ``kernels/conv3x3_int8.py`` on the card (an implicit
GEMM with the epilogue fused), whose plain twin is this im2col route. Every other int8 conv runs here in plain PyTorch: the dynamic and
static trunk modes, the int8 stem (``stem/quant.py``), the calibrated trunk
on the CPU or at widths the kernel does not take, and training (which runs
no int8).

Rounding is half to even (``torch.round``), the division by the activation
scale a true division, as in the JAX package.

Three forms serve the FiLM trunk: ``conv2d_int8_prequant`` (weights and the
activation absmax both from a calibration pass), ``conv2d_int8_static`` (a
calibrated absmax, the weights quantized from the live ones each call) and
``conv2d_int8_dynamic`` (both quantized each call, the activation scale from
this batch's absmax).
"""

from __future__ import annotations

import torch

from videonavqa_tpu_torch.parallel.collectives import max_over_batch

# Bytes of one im2col chunk: bounds the int8 copy of a 3x3 conv's input
# (1.34 GB unchunked at batch 32 x 35 frames x 1024 channels).
_IM2COL_CHUNK_BYTES = 1 << 28


def quantize_weight_channelwise(w):
    """OIHW weight -> (int8 OIHW weight, [Cout] f32 scales), symmetric absmax."""
    w = w.float()
    absmax = torch.amax(torch.abs(w), dim=(1, 2, 3), keepdim=True)
    scale = torch.clamp_min(absmax, 1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.reshape(-1)


def act_scale(act_absmax):
    """Per-tensor activation scale ``max(absmax, 1e-8) / 127`` in f32."""
    return torch.clamp_min(act_absmax.float(), 1e-8) / 127.0


def quantize_act(x, sx):
    return torch.clamp(torch.round(x.float() / sx), -127, 127).to(torch.int8)


def quantize_act_dynamic(x):
    """Activations -> (int8, scalar f32 scale), per-tensor absmax (under a
    mesh, the global batch's)."""
    sx = act_scale(max_over_batch(torch.amax(torch.abs(x.float()))))
    return quantize_act(x, sx), sx


def conv_i8(xq, wq):
    """int8 SAME conv, stride 1 -> int32. xq [N, H, W, C], wq [O, C, kh, kw].

    ``torch._int_mm`` on the card wants the contraction a multiple of 8 (and
    more than 16 rows); a 3x3 conv over 3 channels (VGG's conv1_1, 27) runs
    with its im2col and weight padded with zero columns to the next multiple,
    which leaves every sum as it is."""
    N, H, W, Cin = xq.shape
    O, _, kh, kw = wq.shape
    if kh == 1 and kw == 1:
        acc = torch._int_mm(xq.reshape(-1, Cin), wq[:, :, 0, 0].contiguous().t())
        return acc.reshape(N, H, W, O)
    ph, pw = kh // 2, kw // 2
    xp = xq.new_zeros((N, H + 2 * ph, W + 2 * pw, Cin))
    xp[:, ph:ph + H, pw:pw + W] = xq
    K = kh * kw * Cin
    Kp = -(-K // 8) * 8
    # im2col as one strided view [N, H, W, kh, kw, C] of the padded input, in
    # the (i, j, c) order of the weight below; reshape copies it per chunk.
    # The copy costs per element, so it moves 4-byte words where it can.
    xw = xp.view(torch.int32) if Cin % 4 == 0 and Kp == K else xp
    sN, sH, sW, _ = xw.stride()
    cols = xw.as_strided((N, H, W, kh, kw, xw.shape[-1]), (sN, sH, sW, sH, sW, 1))
    w2 = wq.permute(0, 2, 3, 1).reshape(O, K)  # [O, kh*kw*Cin]
    if Kp != K:
        w2 = torch.cat([w2, w2.new_zeros((O, Kp - K))], dim=1)
    acc = torch.empty((N * H * W, O), dtype=torch.int32, device=xq.device)
    step = max(1, _IM2COL_CHUNK_BYTES // (H * W * Kp))
    for n0 in range(0, N, step):
        n1 = min(N, n0 + step)
        if Kp == K:
            a = cols[n0:n1].reshape((n1 - n0) * H * W, -1).view(torch.int8)
        else:
            a = xq.new_zeros(((n1 - n0) * H * W, Kp))
            a.view(n1 - n0, H, W, Kp)[..., :K].unflatten(-1, (kh, kw, Cin)).copy_(cols[n0:n1])
        torch._int_mm(a, w2.t(), out=acc[n0 * H * W:n1 * H * W])
    return acc.reshape(N, H, W, O)


def _dequant(acc, sx, w_scale, bias, out_dtype):
    # int32 * f32 promotes: each element is cast to f32 and multiplied in one
    # kernel, the same arithmetic as acc.float() * scale without its pass
    y = acc * (sx * w_scale.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def conv2d_int8_prequant(wq, w_scale, bias, x, act_absmax, *, out_dtype=torch.float32):
    """int8 conv in its serving steady state: pre-quantized weights (from the
    calibration pass) and a calibrated activation absmax. Dequant and bias
    run in f32; the output is stored at ``out_dtype``."""
    sx = act_scale(act_absmax)
    return _dequant(conv_i8(quantize_act(x, sx), wq), sx, w_scale, bias, out_dtype)


def conv2d_int8_preq_act(wq, w_scale, bias, xq, act_absmax, *, out_dtype=torch.float32):
    """conv2d_int8_prequant with the activation already int8 (requantized by
    the fused 1x1 kernel with this conv's calibrated absmax)."""
    sx = act_scale(act_absmax)
    return _dequant(conv_i8(xq, wq), sx, w_scale, bias, out_dtype)


def conv2d_int8_static(params, x, act_absmax, *, out_dtype=torch.float32):
    """int8 conv with a calibrated per-tensor activation absmax; the weights
    quantize per output channel from ``params["weight"]`` each call."""
    wq, sw = quantize_weight_channelwise(params["weight"])
    return conv2d_int8_prequant(wq, sw, params.get("bias"), x, act_absmax,
                                out_dtype=out_dtype)


def conv2d_int8_dynamic(params, x, *, out_dtype=torch.float32):
    """int8 conv with both operands quantized each call: the weights per
    output channel, the activations per tensor from this batch's absmax."""
    wq, sw = quantize_weight_channelwise(params["weight"])
    xq, sx = quantize_act_dynamic(x)
    return _dequant(conv_i8(xq, wq), sx, sw, params.get("bias"), out_dtype)
