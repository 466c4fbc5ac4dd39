"""Frozen VGG-16 partial stem (the counterpart of videonavqa_tpu/stem/vgg.py).

The reference's VGG-16 is cut after conv2_2 and two 2x2 max pools, so a
160x208 frame gives 128 channels at 40x52:

    conv3-64, relu, conv3-64, relu, pool2 -> conv3-128, relu, conv3-128, relu, pool2

Inputs are the raw decoded BGR pixels scaled by 1/255, with no mean
subtraction. Channels last; bf16 by default. ``vgg_partial_block1_kernel``
runs block 1 through the fused kernel of ``kernels/vgg_block1.py``.
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
