"""Linear / embedding ops over torch-layout parameter dicts (weights ``[out, in]``)."""

from __future__ import annotations

import torch


def linear(params, x):
    """y = x @ W^T + b in f32 (the JAX op accumulates and returns f32)."""
    y = torch.matmul(x.float(), params["weight"].float().t())
    b = params.get("bias")
    if b is not None:
        y = y + b.float()
    return y


def linear_chw(params, x):
    """``linear(params, flatten_chw(x))`` without transposing the activation.

    The reference flattens conv activations in NCHW order before its Linear,
    so the weight ``[out, C*H*W]`` expects (C, H, W)-ordered features. The
    channels-last activation ``x [..., H, W, C]`` is contracted directly
    against the weight re-laid as ``[out, H, W, C]``: the same dot products,
    with the (much smaller) weight moved instead of the activation.
    """
    H, W, C = x.shape[-3:]
    w = params["weight"].float().reshape(-1, C, H, W).permute(0, 2, 3, 1)
    y = torch.matmul(x.reshape(*x.shape[:-3], H * W * C).float(),
                     w.reshape(w.shape[0], -1).t())
    b = params.get("bias")
    if b is not None:
        y = y + b.float()
    return y


def embedding(params, tokens, *, padding_idx=None):
    """Token lookup; ``weight`` is [vocab, dim]. With ``padding_idx`` the
    output is zero at that token (torch's nn.Embedding(padding_idx=...) with
    the row kept at zero). Models whose embedding has none (film_attn, the
    concat models, mac) pass None: padded positions look up the live row 0."""
    out = params["weight"][tokens.long()]
    if padding_idx is not None:
        out = out * (tokens != padding_idx)[..., None].to(out.dtype)
    return out
