"""Length-mask helpers for the fixed-shape [B, T] world."""

from __future__ import annotations

import torch

from videonavqa_tpu_torch.parallel.collectives import max_over_batch
from videonavqa_tpu_torch.utils.constants import NEG_MASK_VALUE


def length_mask(lens, t: int):
    """[B, T] bool mask: position t valid iff t < len."""
    return torch.arange(t, device=lens.device)[None, :] < lens[:, None]


def attn_frame_mask(v_lens, t: int):
    """The reference's attention mask: -2^31 where the frame is within the
    *batch's* processed range (t < max(v_lens)) but beyond the example's own
    length; 0 elsewhere. Frames beyond the batch max are NOT masked: they take
    part in attention with zero features. Under a mesh the batch is the
    global one. Returns [B, T] f32."""
    t_idx = torch.arange(t, device=v_lens.device)[None, :]
    masked = (t_idx < max_over_batch(v_lens.max())) & (t_idx >= v_lens[:, None])
    return torch.where(masked, NEG_MASK_VALUE, 0.0).float()


def word_softmax_mask(q_lens, t: int):
    """[1, T] f32 additive mask of a softmax over words: 0 within the *batch's*
    max question length (torch's pad_packed width; under a mesh, the global
    batch's), -inf beyond it."""
    t_idx = torch.arange(t, device=q_lens.device)[None, :]
    return torch.where(t_idx < max_over_batch(q_lens.max()), 0.0, -torch.inf)


def mask_invalid(x, lens):
    """Zero positions t >= len of x: [B, T, ...]."""
    mask = length_mask(lens, x.shape[1])
    mask = mask.reshape(mask.shape + (1,) * (x.ndim - 2))
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))
