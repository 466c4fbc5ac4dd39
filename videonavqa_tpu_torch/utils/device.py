"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU by name. There
is no silent CPU carry-on: with no CUDA device and no explicit ``"cpu"``,
``resolve_device`` raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device must exist for any CUDA choice."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def tree_to(tree, device):
    """A nested dict (and list) of tensors, moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)
