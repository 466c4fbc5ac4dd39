"""Plain PyTorch operations of the benchmark's reference models.

Written from the models' published descriptions and the reference code's
semantics, not from the measured package: nothing here imports it. Tensors
are channels last ([N, H, W, C]); weights are torch's layouts (Linear
[out, in], Conv OIHW, LSTM gates in (i, f, g, o) order).

``Precision`` says how each part computes. ``REF`` is what the configuration
states; the lower settings are the controls (``CONTROLS``): ``int4_trunk``
quantizes the FiLM trunk's convs to 4 bits, ``fp8_stem`` rounds the stem's
conv operands to float8 e4m3, ``fp8_convs`` those of the stem and of MAC's
knowledge convs, and ``tf32`` the operands of every float32 matrix product to
TF32.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F

NEG_MASK = -float(1 << 31)
BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class Precision:
    trunk_levels: int = 127      # int8 trunk: codes in [-127, 127]; int4: [-7, 7]
    stem_fp8: bool = False       # stem conv operands rounded to float8 e4m3
    convs_fp8: bool = False      # the model's own bf16 conv operands too
    tf32: bool = False           # float32 matmul operands rounded to TF32


REF = Precision()
CONTROLS = {"int4_trunk": Precision(trunk_levels=7), "fp8_stem": Precision(stem_fp8=True),
            "fp8_convs": Precision(stem_fp8=True, convs_fp8=True), "tf32": Precision(tf32=True)}


@contextlib.contextmanager
def exact_f32():
    """float32 products in float32, not TF32, for the duration."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def tf32_round(x):
    """x f32 with its mantissa rounded to TF32's 10 bits (nearest, ties away);
    the gradient passes through as through the identity."""
    bits = x.detach().contiguous().view(torch.int32)
    return x + (((bits + 0x1000) & ~0x1FFF).view(torch.float32) - x).detach()


def matmul(x, w_t, prec=REF):
    """f32 product x @ w_t; with ``prec.tf32`` both operands rounded to TF32."""
    x, w_t = x.float(), w_t.float()
    if prec.tf32:
        x, w_t = tf32_round(x), tf32_round(w_t)
    return x @ w_t


def linear(p, x, prec=REF):
    y = matmul(x, p["weight"].t(), prec)
    return y + p["bias"].float() if "bias" in p else y


def fp8_round(x):
    """x rounded to float8 e4m3 under a per-tensor scale (amax to 448)."""
    x = x.float()
    scale = x.abs().amax().clamp_min(1e-12) / 448.0
    return x + ((x / scale).to(torch.float8_e4m3fn).float() * scale - x).detach()


def conv2d(p, x, dtype, fp8=False):
    """SAME conv, stride 1, of x [N, H, W, C]: operands and output in
    ``dtype`` (float32 sums), the bias added at ``dtype``; with ``fp8`` the
    operands are first rounded to float8 e4m3."""
    w = p["weight"]
    if fp8:
        x, w = fp8_round(x), fp8_round(w)
    k = w.shape[-1]
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), w.to(dtype), padding=k // 2)
    return y.permute(0, 2, 3, 1) + p["bias"].to(dtype)


def max_pool2(x):
    N, H, W, C = x.shape
    return x[:, :H // 2 * 2, :W // 2 * 2].reshape(N, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def batch_norm_eval(p, s, x):
    x = x.float()
    return (x - s["mean"]) * torch.reciprocal(torch.sqrt(s["var"] + BN_EPS)) * p["weight"] \
        + p["bias"]


def quantize(x, absmax, levels):
    """Symmetric per-tensor codes of x with a calibrated absmax."""
    sx = absmax.float().clamp_min(1e-8) / levels
    return torch.clamp(torch.round(x.float() / sx), -levels, levels).to(torch.int8), sx


def quantize_weight(w, levels):
    """Per-output-channel symmetric codes of an OIHW weight."""
    w = w.float()
    sw = w.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-8) / levels
    return torch.clamp(torch.round(w / sw), -levels, levels).to(torch.int8), sw.reshape(-1)


def int_conv(xq, wq, chunk_rows=1 << 16):
    """Exact integer SAME conv of int8 codes: xq [N, H, W, C], wq [O, C, k, k]
    -> int32 [N, H, W, O], as products summed in int32 (an im2col of the k*k
    shifted windows, then one integer matrix product per chunk of rows)."""
    N, H, W, C = xq.shape
    O, _, k, _ = wq.shape
    pad = k // 2
    xp = F.pad(xq, (0, 0, pad, pad, pad, pad)) if pad else xq
    w2 = wq.permute(0, 2, 3, 1).reshape(O, k * k * C)
    out = torch.empty((N * H * W, O), dtype=torch.int32, device=xq.device)
    frames = max(1, chunk_rows // (H * W))
    for n0 in range(0, N, frames):
        n1 = min(N, n0 + frames)
        cols = torch.cat([xp[n0:n1, i:i + H, j:j + W] for i in range(k) for j in range(k)],
                         dim=-1).reshape(-1, k * k * C)
        out[n0 * H * W:n1 * H * W] = torch._int_mm(cols.contiguous(), w2.t())
    return out.reshape(N, H, W, O)


def int8_conv(p, x, absmax, out_dtype, levels=127):
    """The static int8 conv: x quantized with its calibrated absmax, the
    weight per output channel, exact integer sums, dequantized and biased in
    f32, stored at ``out_dtype``."""
    xq, sx = quantize(x, absmax, levels)
    wq, sw = quantize_weight(p["weight"], levels)
    return (int_conv(xq, wq).float() * (sx * sw) + p["bias"].float()).to(out_dtype)


def lstm_step(p, x, h, c, prec=REF):
    gates = (matmul(x, p["w_ih"].t(), prec) + p["b_ih"].float()
             + matmul(h, p["w_hh"].t(), prec) + p["b_hh"].float())
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def packed_lstm(p, x, lens, h=None, c=None, prec=REF):
    """An LSTM over x [B, T, E] as over a packed batch: the state stops at
    each row's length, outputs past it are zero. -> (outs [B, T, H], h, c)."""
    B, T, _ = x.shape
    H = p["w_hh"].shape[1]
    if h is None:
        h = x.new_zeros((B, H), dtype=torch.float32)
        c = x.new_zeros((B, H), dtype=torch.float32)
    outs = []
    for t in range(T):
        h2, c2 = lstm_step(p, x[:, t], h, c, prec)
        live = (t < lens)[:, None]
        h, c = torch.where(live, h2, h), torch.where(live, c2, c)
        outs.append(torch.where(live, h2, 0.0))
    return torch.stack(outs, dim=1), h, c


def cross_entropy_mean(logits, labels):
    return -torch.log_softmax(logits.float(), dim=-1).gather(1, labels.long()[:, None]).mean()
