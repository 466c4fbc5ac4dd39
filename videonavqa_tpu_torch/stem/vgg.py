"""Frozen VGG-16 partial stem (the counterpart of videonavqa_tpu/stem/vgg.py).

The reference's VGG-16 is cut after conv2_2 and two 2x2 max pools, so a
160x208 frame gives 128 channels at 40x52:

    conv3-64, relu, conv3-64, relu, pool2 -> conv3-128, relu, conv3-128, relu, pool2

Inputs are the raw decoded BGR pixels scaled by 1/255, with no mean
subtraction. Channels last; bf16 by default. ``vgg_partial_block1_kernel``
runs block 1 through the fused kernel of ``kernels/vgg_block1.py``; the
JAX package's block-1 relayouts (space-to-depth, width-to-depth) are at the
end, in plain PyTorch.
"""

from __future__ import annotations

import torch

from videonavqa_tpu_torch.kernels.vgg_block1 import vgg_block1
from videonavqa_tpu_torch.ops import initializers as init
from videonavqa_tpu_torch.ops.conv import conv2d, max_pool2d

# (name, cin, cout); 'M' = 2x2/2 max pool.
VGG_PARTIAL_CFG = [
    ("conv1_1", 3, 64), ("conv1_2", 64, 64), "M",
    ("conv2_1", 64, 128), ("conv2_2", 128, 128), "M",
]


def init_vgg_partial(generator):
    """Reference conv init (Xavier-uniform OIHW, zero bias) for each conv, in
    order, from one ``torch.Generator``; CPU tensors."""
    return {item[0]: init.reference_conv2d(generator, 3, 3, item[1], item[2])
            for item in VGG_PARTIAL_CFG if item != "M"}


BLOCK1 = ("conv1_1", "conv1_2")
BLOCK2 = ("conv2_1", "conv2_2")


def _vgg_block(params, h, names, *, dtype):
    """conv -> relu for each conv of ``names``, then the 2x2 pool."""
    for name in names:
        h = torch.relu(conv2d(params[name], h, dtype=dtype))
    return max_pool2d(h)


def vgg_partial(params, x, *, dtype=torch.bfloat16):
    """x [N, 160, 208, 3] (pixels already /255) -> [N, 40, 52, 128]."""
    return _vgg_block(params, _vgg_block(params, x, BLOCK1, dtype=dtype), BLOCK2, dtype=dtype)


def vgg_partial_block1_kernel(params, x, *, dtype=torch.bfloat16):
    """vgg_partial with block 1 fused in one kernel launch, then block 2."""
    return _vgg_block(params, vgg_block1(params, x, dtype=dtype), BLOCK2, dtype=dtype)


# --- block 1 in other layouts ---------------------------------------------
#
# The JAX package re-lays block 1's two convs so the TPU's matrix unit sees
# wider contractions (space-to-depth: 2x2 pixel blocks as 4x the channels;
# width-to-depth: column pairs as 2x). The re-laid kernels hold the same
# products plus structural zeros, so the results are those of ``vgg_partial``
# up to the order of f32 sums. They are pure functions of the weights; on the
# card block 1 runs through the fused kernel instead, so these stay plain.


def _relay_s2d(w, bias):
    """OIHW [cout, cin, 3, 3] conv -> its exact block-2 space-to-depth form
    [4cout, 4cin, 3, 3]: output phase (a, b), tap (u, v) reads input phase
    (a', b') = ((u-1+a) % 2, (v-1+b) % 2) at s2d offset (s, t) =
    ((u-1+a-a') // 2, (v-1+b-b') // 2); channels pack as (phase * C + c)."""
    w = w.detach().float()
    cout, cin = w.shape[:2]
    wp = w.new_zeros((4 * cout, 4 * cin, 3, 3))
    for a in (0, 1):
        for b in (0, 1):
            for u in range(3):
                ap = (u - 1 + a) % 2
                s = (u - 1 + a - ap) // 2
                for v in range(3):
                    bp = (v - 1 + b) % 2
                    t = (v - 1 + b - bp) // 2
                    wp[(a * 2 + b) * cout:(a * 2 + b + 1) * cout,
                       (ap * 2 + bp) * cin:(ap * 2 + bp + 1) * cin, s + 1, t + 1] = w[:, :, u, v]
    return {"weight": wp, "bias": bias.detach().float().repeat(4)}


def relay_s2d_conv1_1(params):
    """conv1_1 re-laid for a space-to-depth input: [64, 3, 3, 3] ->
    [256, 12, 3, 3] over [H/2, W/2, 12] (a 108-long contraction instead of
    27; SAME padding on the s2d grid zero-fills what the original did)."""
    return _relay_s2d(params["conv1_1"]["weight"], params["conv1_1"]["bias"])


def relay_s2d_block1(params):
    """Both block-1 convs in space-to-depth form: conv1_1 -> [256, 12, 3, 3],
    conv1_2 -> [256, 256, 3, 3] (75% structural zeros); pool1 becomes the max
    over the four phases of one s2d pixel."""
    return {name: _relay_s2d(params[name]["weight"], params[name]["bias"])
            for name in BLOCK1}


def relay_w2d_block1(params):
    """Both block-1 convs in width-to-depth form (column pairs as channels):
    conv1_1 -> [128, 6, 3, 3], conv1_2 -> [128, 128, 3, 3] (50% structural
    zeros). Output column 2j+b reads input column 2j+b+v-1, which is w2d
    column j+t, phase b' = (v-1+b) % 2, t = (v-1+b-b') // 2."""
    out = {}
    for name in BLOCK1:
        w = params[name]["weight"].detach().float()
        cout, cin = w.shape[:2]
        wp = w.new_zeros((2 * cout, 2 * cin, 3, 3))
        for b in (0, 1):
            for v in range(3):
                bp = (v - 1 + b) % 2
                t = (v - 1 + b - bp) // 2
                wp[b * cout:(b + 1) * cout, bp * cin:(bp + 1) * cin, :, t + 1] = w[:, :, :, v]
        out[name] = {"weight": wp, "bias": params[name]["bias"].detach().float().repeat(2)}
    return out


def _space_to_depth(x, dtype):
    N, H, W, C = x.shape
    h = x.to(dtype).reshape(N, H // 2, 2, W // 2, 2, C)
    return h.permute(0, 1, 3, 2, 4, 5).reshape(N, H // 2, W // 2, 4 * C)


def vgg_partial_s2d(relaid, params, x, *, dtype=torch.bfloat16):
    """``vgg_partial`` with conv1_1 in space-to-depth layout (``relaid``:
    ``relay_s2d_conv1_1``'s), its output put back to [N, H, W, 64]."""
    N, H, W, _ = x.shape
    h = torch.relu(conv2d(relaid, _space_to_depth(x, dtype), dtype=dtype))
    cout = h.shape[-1] // 4
    h = h.reshape(N, H // 2, W // 2, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
    h = max_pool2d(torch.relu(conv2d(params["conv1_2"], h.reshape(N, H, W, cout), dtype=dtype)))
    return _vgg_block(params, h, BLOCK2, dtype=dtype)


def vgg_partial_s2d_block1(relaid, params, x, *, dtype=torch.bfloat16):
    """``vgg_partial`` with all of block 1 in space-to-depth layout
    (``relay_s2d_block1``'s): pool1 is the max over the four phases."""
    N, H, W, _ = x.shape
    h = torch.relu(conv2d(relaid["conv1_1"], _space_to_depth(x, dtype), dtype=dtype))
    h = torch.relu(conv2d(relaid["conv1_2"], h, dtype=dtype))
    h = h.reshape(N, H // 2, W // 2, 4, -1).amax(dim=3)
    return _vgg_block(params, h, BLOCK2, dtype=dtype)


def vgg_partial_w2d_block1(relaid, params, x, *, dtype=torch.bfloat16):
    """``vgg_partial`` with block 1 in width-to-depth layout
    (``relay_w2d_block1``'s): the relayout is a reshape; pool1 is the max of
    the two width phases, then of row pairs."""
    N, H, W, C = x.shape
    h = torch.relu(conv2d(relaid["conv1_1"], x.to(dtype).reshape(N, H, W // 2, 2 * C),
                          dtype=dtype))
    h = torch.relu(conv2d(relaid["conv1_2"], h, dtype=dtype))
    h = h.reshape(N, H, W // 2, 2, -1).amax(dim=3)
    h = torch.maximum(h[:, 0::2], h[:, 1::2])
    return _vgg_block(params, h, BLOCK2, dtype=dtype)
