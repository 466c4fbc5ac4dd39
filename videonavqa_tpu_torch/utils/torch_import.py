"""Importers of the reference's PyTorch files (the JAX package's
utils/torch_import.py): the per-layer helpers that ``utils/zoo_import.py``
builds every model from, and the frozen stem's two files:

- ``vgg16_caffe.pth``, the Caffe-weights VGG-16 of the Faster R-CNN fork
  (``features.N.*`` keys, perhaps under a module prefix): its first four
  convs are the partial VGG stem;
- ``obj_detect.pt``, the trained ObjDetectCNN (``{'state_dict': ...}``),
  which ``export_obj_detector_pt`` writes from a detector trained here.

The port keeps torch's layouts (conv OIHW and OIDHW, Linear and LSTM
``[out, in]``), so the helpers rename and copy where the JAX ones transpose;
the result is what ``utils/checkpoint.py params_from_jax`` / ``stem_from_jax``
make of the JAX importers' trees.
"""

from __future__ import annotations

import numpy as np
import torch


def load_torch_state_dict(path: str, key: str | None = "state_dict"):
    """{name: CPU tensor} of a torch checkpoint, ``obj[key]`` where the file
    holds a dict with that key."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if key is not None and isinstance(obj, dict) and key in obj:
        obj = obj[key]
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(v)
            for k, v in obj.items()}


def tensor_from_torch(v):
    """A CPU copy of one state_dict entry (a tensor or a numpy array). f64
    becomes f32, as JAX's ``jnp.asarray`` makes it."""
    t = v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor) else \
        torch.from_numpy(np.array(v))
    return t.float() if t.dtype == torch.float64 else t


# The per-layer importers: a torch module's state_dict entries under
# ``prefix`` -> the port's leaves. Both keep torch's layouts (conv OIHW and
# OIDHW, Linear and LSTM [out, in]), so they rename and copy.

def conv2d_from_torch(sd, prefix):
    """Conv2d -> {'weight' OIHW, 'bias' where present}."""
    out = {"weight": tensor_from_torch(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = tensor_from_torch(sd[f"{prefix}.bias"])
    return out


def conv3d_from_torch(sd, prefix):
    """Conv3d -> {'weight' OIDHW, 'bias'}."""
    return {"weight": tensor_from_torch(sd[f"{prefix}.weight"]),
            "bias": tensor_from_torch(sd[f"{prefix}.bias"])}


def linear_from_torch(sd, prefix):
    out = {"weight": tensor_from_torch(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = tensor_from_torch(sd[f"{prefix}.bias"])
    return out


def bn_from_torch(sd, prefix):
    """BatchNorm -> (params, state) of ops/norm.py batch_norm."""
    return ({"weight": tensor_from_torch(sd[f"{prefix}.weight"]),
             "bias": tensor_from_torch(sd[f"{prefix}.bias"])},
            {"mean": tensor_from_torch(sd[f"{prefix}.running_mean"]),
             "var": tensor_from_torch(sd[f"{prefix}.running_var"])})


def lstm_from_torch(sd, prefix, suffix="l0"):
    """One direction of one layer of an nn.LSTM (``suffix`` 'l0' or
    'l0_reverse')."""
    return {"w_ih": tensor_from_torch(sd[f"{prefix}.weight_ih_{suffix}"]),
            "w_hh": tensor_from_torch(sd[f"{prefix}.weight_hh_{suffix}"]),
            "b_ih": tensor_from_torch(sd[f"{prefix}.bias_ih_{suffix}"]),
            "b_hh": tensor_from_torch(sd[f"{prefix}.bias_hh_{suffix}"])}


def lstm_cell_from_torch(sd, prefix):
    return {"w_ih": tensor_from_torch(sd[f"{prefix}.weight_ih"]),
            "w_hh": tensor_from_torch(sd[f"{prefix}.weight_hh"]),
            "b_ih": tensor_from_torch(sd[f"{prefix}.bias_ih"]),
            "b_hh": tensor_from_torch(sd[f"{prefix}.bias_hh"])}


def embedding_from_torch(sd, prefix):
    return {"weight": tensor_from_torch(sd[f"{prefix}.weight"])}


def layer_norm_from_torch(sd, prefix):
    return {"weight": tensor_from_torch(sd[f"{prefix}.weight"]),
            "bias": tensor_from_torch(sd[f"{prefix}.bias"])}


def import_vgg_partial(sd):
    """A VGG-16 state_dict (``[prefix]features.N.*``) -> the partial stem's
    four convs."""
    keys = [k for k in sd if k.endswith("features.0.weight")]
    prefix = keys[0][: -len("features.0.weight")] if keys else ""
    name_to_idx = {"conv1_1": 0, "conv1_2": 2, "conv2_1": 5, "conv2_2": 7}
    return {name: conv2d_from_torch(sd, f"{prefix}features.{idx}")
            for name, idx in name_to_idx.items()}


def import_obj_detector(sd):
    """obj_detect.pt's state_dict -> (params, state) of stem/obj_detector.py."""
    params, state = {}, {}
    params["bn_input"], state["bn_input"] = bn_from_torch(sd, "bn_input")
    for b in range(1, 4):
        params[f"conv{b}1"] = conv2d_from_torch(sd, f"conv{b}1")
        params[f"conv{b}2"] = conv2d_from_torch(sd, f"conv{b}2")
        params[f"bn{b}"], state[f"bn{b}"] = bn_from_torch(sd, f"bn{b}")
    if "fc_tail1.weight" in sd:
        params["fc_tail1"] = linear_from_torch(sd, "fc_tail1")
        params["bn_tail1"], state["bn_tail1"] = bn_from_torch(sd, "bn_tail1")
        params["fc_tail2"] = linear_from_torch(sd, "fc_tail2")
    return params, state


def export_obj_detector_pt(params, state, path):
    """The inverse of ``import_obj_detector``: ``{'state_dict': ...}`` with the
    reference's keys, in its order, and torch's layouts (CPU tensors), so a
    detector trained here drops into the reference's ``obj_detect.pt`` slot."""
    sd = {}

    def put(prefix, tensors):
        for key, t in tensors.items():
            sd[f"{prefix}.{key}"] = t.detach().to("cpu", copy=True).contiguous()

    def put_bn(prefix, p, s):
        put(prefix, {"weight": p["weight"], "bias": p["bias"], "running_mean": s["mean"],
                     "running_var": s["var"]})
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    put_bn("bn_input", params["bn_input"], state["bn_input"])
    for b in range(1, 4):
        put(f"conv{b}1", params[f"conv{b}1"])
        put(f"conv{b}2", params[f"conv{b}2"])
        put_bn(f"bn{b}", params[f"bn{b}"], state[f"bn{b}"])
    put("fc_tail1", params["fc_tail1"])
    put_bn("bn_tail1", params["bn_tail1"], state["bn_tail1"])
    put("fc_tail2", params["fc_tail2"])
    torch.save({"state_dict": sd}, path)
