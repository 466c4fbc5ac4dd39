"""Video normalization on the device.

Hosts hand over raw uint8 frames (a quarter of the bytes of f32); the /255
happens in the forward. Float inputs pass through unchanged.
"""

from __future__ import annotations

import torch


def normalize_video(video):
    if video.dtype == torch.uint8:
        return video.float() / 255.0
    return video
