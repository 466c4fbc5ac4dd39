"""ObjDetectCNN in its pretrained-features mode: the second stage of the frozen
stem (the counterpart of videonavqa_tpu/stem/obj_detector.py).

    BN(128) -> [conv3x3 -> conv3x3 -> BN -> ReLU -> maxpool2] x3

with the reference's quirks kept: the two convs of a block run back to back
with no activation between them, and the features are taken after block 3's
ReLU, skipping pool3, giving 512 channels at 10x13 from the VGG stem's 128 at
40x52. It runs frozen, in eval mode. The classification tail (flatten,
fc_tail1, BN, ReLU, fc_tail2) is initialized so the parameter tree matches,
but its forward is not ported.

``stem_features`` runs the whole frozen stem over a video batch, frames folded
into the batch axis.
"""

from __future__ import annotations

import torch

from videonavqa_tpu_torch.ops import initializers as init
from videonavqa_tpu_torch.ops.conv import conv2d, max_pool2d
from videonavqa_tpu_torch.ops.norm import batch_norm
from videonavqa_tpu_torch.stem.vgg import vgg_partial, vgg_partial_block1_kernel


def init_obj_detector(generator, nb_classes=27, num_filters=512, tail_hidden_dim=1024):
    """(params, state) with the reference init, CPU tensors."""
    params, state = {}, {}
    params["bn_input"], state["bn_input"] = init.init_bn(128)
    cin = 128
    for b in range(1, 4):
        params[f"conv{b}1"] = init.reference_conv2d(generator, 3, 3, cin, num_filters)
        params[f"conv{b}2"] = init.reference_conv2d(generator, 3, 3, num_filters, num_filters)
        params[f"bn{b}"], state[f"bn{b}"] = init.init_bn(num_filters)
        cin = num_filters
    params["fc_tail1"] = init.reference_linear(generator, tail_hidden_dim, num_filters * 6 * 5)
    params["bn_tail1"], state["bn_tail1"] = init.init_bn(tail_hidden_dim)
    params["fc_tail2"] = init.reference_linear(generator, nb_classes, tail_hidden_dim)
    return params, state


def obj_detector_features(params, state, x, *, dtype=torch.bfloat16):
    """[N, 40, 52, 128] -> f32 [N, 10, 13, num_filters], eval BatchNorm."""
    h, _ = batch_norm(params["bn_input"], state["bn_input"], x, train=False)
    for b in range(1, 4):
        h = conv2d(params[f"conv{b}1"], h, dtype=dtype)
        h = conv2d(params[f"conv{b}2"], h, dtype=dtype)
        h, _ = batch_norm(params[f"bn{b}"], state[f"bn{b}"], h, train=False)
        h = torch.relu(h)
        if b < 3:
            h = max_pool2d(h)
    return h


def stem_features(vgg_params, det_params, det_state, video, *, dtype=torch.bfloat16,
                  frame_chunk=None, use_kernel=False):
    """The frozen stem over a video batch, with no gradient.

    video [B, T, 160, 208, 3] float (pixels /255, BGR) -> f32 features
    [B, T, 10, 13, num_filters]. ``frame_chunk`` bounds the peak activation
    memory: the folded frames are padded to a multiple of the chunk, run
    chunk by chunk and trimmed. ``use_kernel`` runs VGG block 1 through the
    fused kernel (one launch per chunk)."""
    vgg = vgg_partial_block1_kernel if use_kernel else vgg_partial

    def run(frames):
        return obj_detector_features(det_params, det_state, vgg(vgg_params, frames, dtype=dtype),
                                     dtype=dtype)

    B, T = video.shape[:2]
    n = B * T
    frames = video.reshape(n, *video.shape[2:])
    with torch.no_grad():
        if frame_chunk is not None and frame_chunk < n:
            pad = (-n) % frame_chunk
            if pad:
                frames = torch.cat([frames, frames.new_zeros((pad, *frames.shape[1:]))])
            feats = torch.cat([run(chunk) for chunk in frames.split(frame_chunk)])[:n]
        else:
            feats = run(frames)
        return feats.reshape(B, T, *feats.shape[1:]).float()
