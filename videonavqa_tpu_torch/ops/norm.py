"""Per-frame BatchNorm, eval branch.

The reference applies BatchNorm2d per frame to the examples still running at
that frame. In eval mode that is the running statistics applied everywhere.
The train branch (per-frame masked statistics and the closed-form EMA) comes
with the training slice.
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
