"""BatchNorm (eval branches) and LayerNorm.

The reference applies BatchNorm2d per frame to the examples still running at
that frame. In eval mode that is the running statistics applied everywhere,
so ``frame_batch_norm`` and ``batch_norm`` compute the same thing here. The
train branches (batch statistics, per-frame masked statistics and the
closed-form EMA) come with the training slice.
"""

from __future__ import annotations

import torch

EPS = 1e-5


def frame_batch_norm(params, state, x, frame_mask, *, train: bool):
    """x [B, T, H, W, C] -> (f32 normalized x, state). Eval only."""
    if train:
        raise NotImplementedError("frame_batch_norm: the train branch is not ported yet")
    x = x.float()
    y = (x - state["mean"]) * torch.reciprocal(torch.sqrt(state["var"] + EPS))
    return y * params["weight"] + params["bias"], state


def batch_norm(params, state, x, *, train: bool):
    """BatchNorm over all axes but the last (channels last) -> (f32 y, state). Eval only."""
    if train:
        raise NotImplementedError("batch_norm: the train branch is not ported yet")
    x = x.float()
    y = (x - state["mean"]) * torch.reciprocal(torch.sqrt(state["var"] + EPS))
    return y * params["weight"] + params["bias"], state


def init_layer_norm(c: int):
    return {"weight": torch.ones(c), "bias": torch.zeros(c)}


def layer_norm(params, x, *, eps: float = EPS):
    """torch.nn.LayerNorm over the last dim (biased variance)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return y * params["weight"] + params["bias"]
