"""Model-zoo checkpoint exporters: the port's parameter trees -> reference
PyTorch state_dicts (the JAX package's utils/zoo_export.py).

The inverse of ``zoo_import.import_model_checkpoint``: a model trained here
exports to the layer names and layouts the reference's torch classes declare
(models/*.py), so it drops into the reference's resume and eval slots
(``torch.load`` of ``{'epoch', 'model', 'state_dict'}``). The port keeps
torch's layouts, so nothing is transposed. Integer leaves stay integers and
every other leaf is written in f32.

Reference fidelity note: the FiLM models' conv1x1 skip layers live in plain
Python lists OUTSIDE the reference's state_dict, so reference checkpoints
never contain them. Exports mirror that (the leaves are dropped, and a
re-import draws them anew from a seed, exactly as for a real reference
checkpoint). Round-trip fidelity for ALL leaves is the job of the npz
checkpoints (utils/checkpoint.py), not of this interchange format.

Usage:
    sd = export_model_checkpoint('film_gp_pt', params, state, cfg)
    save_reference_checkpoint('model.pt', 'film_gp_pt', params, state, cfg, epoch=3)
"""

from __future__ import annotations

import numpy as np
import torch

from videonavqa_tpu_torch.utils.zoo_import import VGG11_CONV_IDX


def _np(t):
    """A host numpy copy of a leaf (floats in f32)."""
    t = t.detach().to("cpu")
    return (t.float() if t.dtype.is_floating_point else t).numpy()


def _finish(v):
    """Integers stay integers, the rest f32, as the JAX package writes them;
    ``np.ascontiguousarray`` returns at least one dimension, so the 0-d
    ``num_batches_tracked`` is written as shape (1,), which torch's
    ``load_state_dict`` takes into its 0-d buffer."""
    if np.issubdtype(v.dtype, np.integer):
        return np.ascontiguousarray(v)
    return np.ascontiguousarray(v.astype(np.float32))


def _weight_bias(sd, prefix, p):
    """A conv's (any rank) or a Linear's weight, and its bias where it has one."""
    sd[f"{prefix}.weight"] = _np(p["weight"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = _np(p["bias"])


def _bn(sd, prefix, p, s):
    sd[f"{prefix}.weight"] = _np(p["weight"])
    sd[f"{prefix}.bias"] = _np(p["bias"])
    sd[f"{prefix}.running_mean"] = _np(s["mean"])
    sd[f"{prefix}.running_var"] = _np(s["var"])
    # torch's BatchNorm state_dicts carry this buffer, and the reference's
    # load_state_dict is strict: without it every BN-bearing model is refused
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def _lstm(sd, prefix, p, suffix="l0"):
    sd[f"{prefix}.weight_ih_{suffix}"] = _np(p["w_ih"])
    sd[f"{prefix}.weight_hh_{suffix}"] = _np(p["w_hh"])
    sd[f"{prefix}.bias_ih_{suffix}"] = _np(p["b_ih"])
    sd[f"{prefix}.bias_hh_{suffix}"] = _np(p["b_hh"])


def _lstm_cell(sd, prefix, p):
    sd[f"{prefix}.weight_ih"] = _np(p["w_ih"])
    sd[f"{prefix}.weight_hh"] = _np(p["w_hh"])
    sd[f"{prefix}.bias_ih"] = _np(p["b_ih"])
    sd[f"{prefix}.bias_hh"] = _np(p["b_hh"])


def _frame_trunk(sd, prefix, p, s):
    for i, idx in enumerate(VGG11_CONV_IDX):
        _weight_bias(sd, f"{prefix}.{idx}", p[f"conv{i}"])
        _bn(sd, f"{prefix}.{idx + 1}", p[f"bn{i}"], s[f"bn{i}"])


def _c3d_trunk(sd, p, s):
    _bn(sd, "bn_input", p["bn_input"], s["bn_input"])
    for name in ("conv1", "conv2", "conv3a"):
        _weight_bias(sd, name, p[name])
    for b in ("bn1", "bn2", "bn3", "bn6", "bn7"):
        _bn(sd, b, p[b], s[b])
    _weight_bias(sd, "fc6", p["fc6"])
    _weight_bias(sd, "fc7", p["fc7"])


def _film_trunk(sd, trunk, trunk_state, cfg):
    _weight_bias(sd, "conv_init", trunk["conv_init"])
    _bn(sd, "bn_init", trunk["bn_init"], trunk_state["bn_init"])
    for k in range(cfg.num_res_blocks):
        _weight_bias(sd, f"film_pipeline.{k}", trunk[f"conv3x3_{k}"])
        # conv1x1_{k} dropped: absent from reference checkpoints


def _film_common(sd, params, state, cfg):
    _weight_bias(sd, "embed", params["embed"])
    if "w_ih" in params["encoder"]:
        _lstm(sd, "film_layer.0", params["encoder"])
    else:
        _weight_bias(sd, "film_layer.0", params["encoder"])
    _weight_bias(sd, "film_layer.1", params["decoder"])
    _film_trunk(sd, params["trunk"], state["trunk"], cfg)


def export_model_checkpoint(model_name, params, state, cfg):
    """The port's trees -> {reference layer name: np.ndarray} state_dict."""
    sd = {}
    p = params
    if model_name == "bow":
        _weight_bias(sd, "embed", p["embed"])
        _weight_bias(sd, "out_linear", p["out_linear"])
    elif model_name == "lstm":
        _weight_bias(sd, "embed", p["embed"])
        _lstm(sd, "lstm", p["lstm"])
        _weight_bias(sd, "out_linear", p["out_linear"])
    elif model_name == "v_only_cnn3d":
        _c3d_trunk(sd, p, state)
        _weight_bias(sd, "fc8", p["fc8"])
    elif model_name == "v_only_cnn2d_lstm":
        _bn(sd, "input_bn", p["input_bn"], state["input_bn"])
        _frame_trunk(sd, "per_frame_feature_extractor", p["trunk"], state["trunk"])
        _lstm(sd, "lstm", p["lstm"])
        _weight_bias(sd, "out_linear", p["out_linear"])
    elif model_name == "concat2d":
        _frame_trunk(sd, "per_frame_feature_extractor", p["trunk"], state["trunk"])
        _lstm(sd, "v_lstm", p["v_lstm"])
        _weight_bias(sd, "embed", p["embed"])
        _lstm(sd, "q_lstm", p["q_lstm"])
        _weight_bias(sd, "fc_tail", p["fc_tail"])
        _weight_bias(sd, "out_linear", p["out_linear"])
    elif model_name == "concat3d":
        _c3d_trunk(sd, p, state)
        _weight_bias(sd, "embed", p["embed"])
        _lstm(sd, "q_lstm", p["q_lstm"])
        _weight_bias(sd, "fc_tail", p["fc_tail"])
        _weight_bias(sd, "out_linear", p["out_linear"])
    elif model_name == "film_gp_pt":
        _film_common(sd, p, state, cfg)
        _weight_bias(sd, "c1x1_tail", p["c1x1_tail"])
        _weight_bias(sd, "out_linear", p["out_linear"])
    elif model_name == "film_attn_pt":
        _film_common(sd, p, state, cfg)
        for name in ("fc_embed_attn", "fc_attn_1", "fc_hidden_attn"):
            _weight_bias(sd, name, p[name])
        _lstm_cell(sd, "lstm_attn", p["lstm_attn"])
        _weight_bias(sd, "out_linear", p["out_linear"])
    elif model_name == "time_multi_hop":
        _weight_bias(sd, "embed", p["embed"])
        _lstm(sd, "q_encoder", p["q_encoder"])
        for name in ("encoder_norm", "fc_hidden_attn", "fc_attn_out", "decoder_norm"):
            _weight_bias(sd, name, p[name])
        _film_trunk(sd, p["trunk"], state["trunk"], cfg)
        _weight_bias(sd, "c1x1_tail", p["c1x1_tail"])
        _weight_bias(sd, "out_linear", p["out_linear"])
    elif model_name == "mac":
        _weight_bias(sd, "embed", p["embed"])
        _lstm(sd, "lstm", p["lstm_fwd"])
        _lstm(sd, "lstm", p["lstm_bwd"], suffix="l0_reverse")
        _weight_bias(sd, "lstm_proj", p["lstm_proj"])
        for i, name in enumerate(("conv0", "conv1", "conv2")):
            _weight_bias(sd, f"conv.{2 * i}", p[name])
        _lstm(sd, "lstm_tail", p["lstm_tail"])
        _weight_bias(sd, "classifier.0", p["classifier0"])
        _weight_bias(sd, "classifier.2", p["classifier2"])
        mac = p["mac"]
        for i in range(cfg.mac_max_step):
            _weight_bias(sd, f"mac.control.position_aware.{i}", mac["position_aware"][i])
        for ref, name in (("mac.control.control_question", "control_question"),
                          ("mac.control.attn", "control_attn"), ("mac.read.mem", "read_mem"),
                          ("mac.read.concat", "read_concat"), ("mac.read.attn", "read_attn"),
                          ("mac.write.concat", "write_concat")):
            _weight_bias(sd, ref, mac[name])
        sd["mac.mem_0"] = _np(mac["mem_0"])
        sd["mac.control_0"] = _np(mac["control_0"])
    else:
        raise KeyError(f"no exporter for model {model_name!r}")
    return {k: _finish(v) for k, v in sd.items()}


def save_reference_checkpoint(path, model_name, params, state, cfg, *, epoch=0):
    """``torch.save`` a checkpoint in the reference harness's format
    (``{'epoch', 'model', 'state_dict'}``), which its resume and eval tooling
    loads unmodified. -> ``path``."""
    sd = export_model_checkpoint(model_name, params, state, cfg)
    obj = {"epoch": int(epoch), "model": model_name,
           "state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}
    torch.save(obj, path)
    return path
