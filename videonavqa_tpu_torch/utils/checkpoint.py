"""The weight bridge: JAX-package checkpoints into the port's parameter dicts.

A JAX checkpoint is one .npz of '/'-joined pytree paths (``params/...``,
``state/...``, ``opt/...``) plus a JSON ``__meta__`` entry. It is read here
with numpy alone. Layouts: conv kernels go from HWIO to OIHW (every 4-D
leaf, the calibrated ``int8_wq`` kernels included); Linear and LSTM weights
are already ``[out, in]`` and pass as they are, as do ``int8_scales``. A list
in the JAX pytree (MAC's twelve ``position_aware`` linears) is saved under the
keys ``0``, ``1``, ...; it comes back as a list. ``stem_from_jax`` carries the
frozen stem's trees (as numpy) across the same way.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from videonavqa_tpu_torch.utils.device import tree_to


def read_npz(path):
    """(flat {path: array}, meta dict) of a JAX-package checkpoint."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    meta_raw = flat.pop("__meta__", None)
    meta = json.loads(bytes(meta_raw.tobytes()).decode("utf-8")) if meta_raw is not None else {}
    return flat, meta


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.ndim == 4:  # HWIO -> OIHW
        a = a.transpose(3, 2, 0, 1)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _nest(flat, prefix):
    tree = {}
    for key, a in flat.items():
        if not key.startswith(prefix):
            continue
        *parents, leaf = key[len(prefix):].split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _to_torch(a)
    return _lists(tree)


def _lists(node):
    """Dicts keyed '0'..'n-1' (a saved list) become lists, at any depth."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node) and \
            sorted(int(k) for k in node) == list(range(len(node))):
        return [node[str(i)] for i in range(len(node))]
    return node


def params_from_jax(flat: dict[str, np.ndarray]):
    """(params, state) as nested dicts of CPU tensors in the port's layouts."""
    return _nest(flat, "params/"), _nest(flat, "state/")


def load_jax_checkpoint(path, device):
    """(params, state, meta) of a JAX checkpoint, on ``device``."""
    flat, meta = read_npz(path)
    params, state = params_from_jax(flat)
    return tree_to(params, device), tree_to(state, device), meta


def _tree_to_torch(node):
    if isinstance(node, dict):
        return {k: _tree_to_torch(v) for k, v in node.items()}
    return _to_torch(np.asarray(node))


def stem_from_jax(vgg_np, det_params_np, det_state_np, device):
    """(vgg_params, det_params, det_state) on ``device`` from the JAX stem's
    trees as numpy: ``init_vgg_partial`` and ``init_obj_detector`` (or the
    weights that ``load_stem`` imports). HWIO conv kernels become OIHW."""
    return tuple(tree_to(_tree_to_torch(t), device)
                 for t in (vgg_np, det_params_np, det_state_np))
