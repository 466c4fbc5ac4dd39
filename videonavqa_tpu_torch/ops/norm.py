"""BatchNorm (torch semantics), per-frame masked BatchNorm, LayerNorm.

The reference applies BatchNorm2d per frame to the examples still running at
that frame. In eval mode that is the running statistics applied everywhere.
In train mode ``frame_batch_norm`` takes frame t's statistics over the valid
examples x H x W only, and folds the reference's one EMA update per
processed frame (frames t < the batch's longest video, in order) into the
closed form ``r_K = (1-m)^K r_0 + m * sum_t (1-m)^(K-1-t) s_t``.
Statistics are taken in f32 whatever the input dtype; the new running
statistics carry no gradient.
"""

from __future__ import annotations

import torch

EPS = 1e-5
MOMENTUM = 0.1


def frame_batch_norm(params, state, x, frame_mask, *, train: bool):
    """x [B, T, H, W, C], frame_mask [B, T] bool -> (f32 normalized x, state).

    In train mode, outputs at invalid (b, t) are normalized with frame t's
    valid statistics (finite; callers mask them downstream)."""
    x = x.float()
    if not train:
        y = (x - state["mean"]) * torch.reciprocal(torch.sqrt(state["var"] + EPS))
        return y * params["weight"] + params["bias"], state

    T = x.shape[1]
    fm = frame_mask.float()
    m = fm[:, :, None, None, None]
    count = fm.sum(dim=0) * (x.shape[2] * x.shape[3])          # [T]
    safe = torch.clamp(count, min=1.0)
    mean = (x * m).sum(dim=(0, 2, 3)) / safe[:, None]          # [T, C]
    centered = x - mean[None, :, None, None, :]
    var = (torch.square(centered) * m).sum(dim=(0, 2, 3)) / safe[:, None]
    y = centered * torch.reciprocal(torch.sqrt(var[None, :, None, None, :] + EPS))
    y = y * params["weight"] + params["bias"]

    # the sequential EMA over the processed frames t < K, K = the longest video
    K = frame_mask.sum(dim=1).max().float()
    t_idx = torch.arange(T, dtype=torch.float32, device=x.device)
    decay = torch.pow(1.0 - MOMENTUM, torch.clamp(K - 1.0 - t_idx, min=0.0)) * (t_idx < K).float()
    w = (MOMENTUM * decay)[:, None]
    unbiased = var.detach() * (safe / torch.clamp(safe - 1.0, min=1.0))[:, None]
    keep = torch.pow(1.0 - MOMENTUM, K)
    new_state = {"mean": keep * state["mean"] + (w * mean.detach()).sum(dim=0),
                 "var": keep * state["var"] + (w * unbiased).sum(dim=0)}
    return y, new_state


def batch_norm(params, state, x, *, train: bool):
    """BatchNorm over all axes but the last (channels last) -> (f32 y, state),
    as torch.nn.BatchNorm{1,2,3}d: the biased variance normalizes, the
    unbiased one enters the running-stat EMA."""
    x = x.float()
    if train:
        axes = tuple(range(x.ndim - 1))
        mean = x.mean(dim=axes)
        var = torch.square(x - mean).mean(dim=axes)
        n = x.numel() // x.shape[-1]
        unbiased = var.detach() * (n / max(n - 1, 1))
        new_state = {"mean": (1 - MOMENTUM) * state["mean"] + MOMENTUM * mean.detach(),
                     "var": (1 - MOMENTUM) * state["var"] + MOMENTUM * unbiased}
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (x - mean) * torch.reciprocal(torch.sqrt(var + EPS))
    return y * params["weight"] + params["bias"], new_state


def init_layer_norm(c: int):
    return {"weight": torch.ones(c), "bias": torch.zeros(c)}


def layer_norm(params, x, *, eps: float = EPS):
    """torch.nn.LayerNorm over the last dim (biased variance)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return y * params["weight"] + params["bias"]
