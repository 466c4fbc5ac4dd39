"""The frozen stem's weights from the reference's PyTorch files (the stem part
of the JAX package's utils/torch_import.py).

- ``vgg16_caffe.pth``, the Caffe-weights VGG-16 of the Faster R-CNN fork
  (``features.N.*`` keys, perhaps under a module prefix): its first four
  convs are the partial VGG stem;
- ``obj_detect.pt``, the trained ObjDetectCNN (``{'state_dict': ...}``),
  which ``export_obj_detector_pt`` writes from a detector trained here.

The port keeps torch's layouts (conv OIHW, Linear ``[out, in]``), so the
tensors pass as they are; the result is what ``stem_from_jax`` makes of the
JAX importers' trees.
"""

from __future__ import annotations

import torch


def load_torch_state_dict(path: str, key: str | None = "state_dict"):
    """{name: CPU tensor} of a torch checkpoint, ``obj[key]`` where the file
    holds a dict with that key."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if key is not None and isinstance(obj, dict) and key in obj:
        obj = obj[key]
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(v)
            for k, v in obj.items()}


def _weight_bias(sd, prefix):
    """A conv's or a Linear's ``weight`` (and ``bias``)."""
    out = {"weight": sd[f"{prefix}.weight"]}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _bn(sd, prefix):
    """-> (params, state) of ops/norm.py batch_norm."""
    return ({"weight": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]},
            {"mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]})


def import_vgg_partial(sd):
    """A VGG-16 state_dict (``[prefix]features.N.*``) -> the partial stem's
    four convs."""
    keys = [k for k in sd if k.endswith("features.0.weight")]
    prefix = keys[0][: -len("features.0.weight")] if keys else ""
    name_to_idx = {"conv1_1": 0, "conv1_2": 2, "conv2_1": 5, "conv2_2": 7}
    return {name: _weight_bias(sd, f"{prefix}features.{idx}")
            for name, idx in name_to_idx.items()}


def import_obj_detector(sd):
    """obj_detect.pt's state_dict -> (params, state) of stem/obj_detector.py."""
    params, state = {}, {}
    params["bn_input"], state["bn_input"] = _bn(sd, "bn_input")
    for b in range(1, 4):
        params[f"conv{b}1"] = _weight_bias(sd, f"conv{b}1")
        params[f"conv{b}2"] = _weight_bias(sd, f"conv{b}2")
        params[f"bn{b}"], state[f"bn{b}"] = _bn(sd, f"bn{b}")
    if "fc_tail1.weight" in sd:
        params["fc_tail1"] = _weight_bias(sd, "fc_tail1")
        params["bn_tail1"], state["bn_tail1"] = _bn(sd, "bn_tail1")
        params["fc_tail2"] = _weight_bias(sd, "fc_tail2")
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
