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


def tree_map(fn, tree):
    """``fn`` of each leaf of a nested dict (and list), in the same nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_to(tree, device):
    """A nested dict (and list) of tensors, moved to ``device``."""
    return tree_map(lambda t: t.to(device), tree)
