"""The frozen visual stem, plain: VGG-16 cut after conv2_2, then ObjDetectCNN's
features (VideoNavQA's pretrained-features mode).

    pixels /255 -> [conv3-64, relu] x2, pool -> [conv3-128, relu] x2, pool
    -> BN(128) -> [conv3-512 -> conv3-512 -> BN -> relu (-> pool)] x3, no pool
       after the third block -> f32 [N, 10, 13, 512]

The convs compute in bfloat16 as the configuration states: bf16 operands,
float32 sums, bf16 outputs. VGG block 1 keeps its sums, bias, ReLU and pool in
float32 and rounds once per conv (its bf16 operands' products are exact in
float32); the later convs round their sums to bf16 and add the bias in bf16.
The reference sums as the measured package's kernels and library calls do
where it can (block 1 tap by tap; each later conv over all the batch's frames
in one call), so that its own roundings do not hide a lower precision.
BN in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vnqa_bench.reference.ops import (
    REF, batch_norm_eval, conv2d, exact_f32, fp8_round, max_pool2)

VGG = (("conv1_1", "conv1_2"), ("conv2_1", "conv2_2"))


def vgg_shapes():
    return {name: {"weight": (cout, cin, 3, 3), "bias": (cout,)}
            for name, cin, cout in (("conv1_1", 3, 64), ("conv1_2", 64, 64),
                                    ("conv2_1", 64, 128), ("conv2_2", 128, 128))}


def detector_shapes(filters=512):
    params = {"bn_input": {"weight": (128,), "bias": (128,)}}
    state = {"bn_input": {"mean": (128,), "var": (128,)}}
    cin = 128
    for b in (1, 2, 3):
        params[f"conv{b}1"] = {"weight": (filters, cin, 3, 3), "bias": (filters,)}
        params[f"conv{b}2"] = {"weight": (filters, filters, 3, 3), "bias": (filters,)}
        params[f"bn{b}"] = {"weight": (filters,), "bias": (filters,)}
        state[f"bn{b}"] = {"mean": (filters,), "var": (filters,)}
        cin = filters
    return params, state


def block1(vgg, frames, prec=REF, dtype=torch.bfloat16):
    """VGG block 1: frames [N, 160, 208, 3] in [0, 1] -> bf16 [N, 80, 104, 64].
    conv1_1's 27 products are summed one at a time in float32, tap by tap
    (row, column, then channel), as a fused kernel does; conv1_2's sums are
    the library's."""
    fp8 = prec.stem_fp8
    p = vgg["conv1_1"]
    x, w = frames.to(dtype).float(), p["weight"].to(dtype).float()
    if fp8:
        x, w = fp8_round(x), fp8_round(w)
    N, H, W, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = x.new_zeros((N, H, W, w.shape[0]))
    for u in range(3):
        for v in range(3):
            for c in range(3):
                acc.addcmul_(xp[:, u:u + H, v:v + W, c:c + 1], w[:, c, u, v])
    h = torch.relu(acc.add_(p["bias"].float())).to(dtype)
    h = torch.relu(_conv_f32_sums(vgg["conv1_2"], h, dtype, fp8)).to(dtype)
    return max_pool2(h)


def after_block1(vgg, det, det_state, h, prec=REF, dtype=torch.bfloat16):
    """The rest of the stem: bf16 [N, 80, 104, 64] -> f32 [N, 10, 13, 512]."""
    fp8 = prec.stem_fp8
    for name in VGG[1]:
        h = torch.relu(conv2d(vgg[name], h, dtype, fp8=fp8))
    h = max_pool2(h)
    h = batch_norm_eval(det["bn_input"], det_state["bn_input"], h)
    for b in (1, 2, 3):
        h = conv2d(det[f"conv{b}1"], h, dtype, fp8=fp8)
        h = conv2d(det[f"conv{b}2"], h, dtype, fp8=fp8)
        h = torch.relu(batch_norm_eval(det[f"bn{b}"], det_state[f"bn{b}"], h))
        if b < 3:
            h = max_pool2(h)
    return h


def _conv_f32_sums(p, x, dtype, fp8):
    """SAME 3x3 conv of bf16 operands with float32 sums and a float32 bias."""
    w = p["weight"]
    if fp8:
        x, w = fp8_round(x), fp8_round(w)
    y = F.conv2d(x.to(dtype).float().permute(0, 3, 1, 2), w.to(dtype).float(), padding=1)
    return y.permute(0, 2, 3, 1) + p["bias"].float()


def features(vgg, det, det_state, frames, prec=REF):
    """frames [N, 160, 208, 3] float in [0, 1] -> f32 [N, 10, 13, 512]."""
    return after_block1(vgg, det, det_state, block1(vgg, frames, prec), prec)


def video_features(stem, video_u8, prec=REF, chunk=280):
    """video [B, T, 160, 208, 3] uint8 -> f32 [B, T, 10, 13, 512]. Block 1
    (float32 sums) runs in chunks of frames so that its float32 activations
    fit; the bf16 convs after it take all B x T frames in one call, as the
    measured package's stem does, so that the convolution library sums them
    in the same order (an order of its choosing for each shape)."""
    B, T = video_u8.shape[:2]
    vgg, det, det_state = stem
    frames = video_u8.reshape(B * T, *video_u8.shape[2:])
    with exact_f32():
        h = torch.cat([block1(vgg, f.float() / 255.0, prec) for f in frames.split(chunk)])
        out = after_block1(vgg, det, det_state, h, prec)
    return out.reshape(B, T, 10, 13, -1)
