"""Model-zoo checkpoint importers: reference PyTorch state_dicts -> the
port's parameter trees (the JAX package's utils/zoo_import.py).

Layer names follow the reference's class definitions (models/*.py). The
port keeps torch's layouts, so every leaf is renamed and copied, never
transposed. The FiLM models' 1x1-conv skip layers are absent from reference
checkpoints (they live in plain Python lists outside state_dict), so those
leaves are drawn anew from ``torch.Generator().manual_seed(seed)`` and
reported back under the JAX package's names (``trunk/conv1x1_{k}``); the
two packages' generators give other values for the same seed.

Usage:
    params, state, missing = import_model_checkpoint('film_gp_pt', sd, cfg)
"""

from __future__ import annotations

import torch

from videonavqa_tpu_torch.ops import initializers as init
from videonavqa_tpu_torch.train.step import tree_items
from videonavqa_tpu_torch.utils.torch_import import (
    bn_from_torch, conv2d_from_torch, conv3d_from_torch, embedding_from_torch,
    layer_norm_from_torch, linear_from_torch, lstm_cell_from_torch, lstm_from_torch,
    tensor_from_torch,
)

# torchvision make_layers indices for cfg [16,'M',32,'M',64,'M',128,'M',128,'M']
# with batch_norm=True (the reference's models/v_only_cnn2d_lstm.py): a conv
# at 0, 4, 8, 12, 16, its BatchNorm one after.
VGG11_CONV_IDX = (0, 4, 8, 12, 16)


def _import_frame_trunk(sd, prefix):
    params, state = {}, {}
    for i, idx in enumerate(VGG11_CONV_IDX):
        params[f"conv{i}"] = conv2d_from_torch(sd, f"{prefix}.{idx}")
        params[f"bn{i}"], state[f"bn{i}"] = bn_from_torch(sd, f"{prefix}.{idx + 1}")
    return params, state


def _import_c3d_trunk(sd):
    params, state = {}, {}
    params["bn_input"], state["bn_input"] = bn_from_torch(sd, "bn_input")
    for name in ("conv1", "conv2", "conv3a"):
        params[name] = conv3d_from_torch(sd, name)
    for b in ("bn1", "bn2", "bn3", "bn6", "bn7"):
        params[b], state[b] = bn_from_torch(sd, b)
    params["fc6"] = linear_from_torch(sd, "fc6")
    params["fc7"] = linear_from_torch(sd, "fc7")
    return params, state


def _import_film_trunk(sd, cfg, gen):
    """conv_init, bn_init and the blocks' 3x3 convs from ``sd``; the 1x1
    convs drawn from ``gen`` -> (trunk, trunk_state, missing)."""
    ch = cfg.num_res_block_channels
    trunk, trunk_state, missing = {}, {}, []
    trunk["conv_init"] = conv2d_from_torch(sd, "conv_init")
    trunk["bn_init"], trunk_state["bn_init"] = bn_from_torch(sd, "bn_init")
    for k in range(cfg.num_res_blocks):
        trunk[f"conv3x3_{k}"] = conv2d_from_torch(sd, f"film_pipeline.{k}")
        # not in reference checkpoints: plain-list layers outside state_dict
        trunk[f"conv1x1_{k}"] = init.reference_conv2d(gen, 1, 1, ch, ch)
        missing.append(f"trunk/conv1x1_{k}")
    return trunk, trunk_state, missing


def _import_film_common(sd, cfg, gen):
    """Embedding + FiLM generator (an LSTM or the BoW Linear as
    ``film_layer.0``) + trunk -> (params, state, missing)."""
    params = {"embed": embedding_from_torch(sd, "embed")}
    if "film_layer.0.weight_ih_l0" in sd:
        params["encoder"] = lstm_from_torch(sd, "film_layer.0")
    else:
        params["encoder"] = linear_from_torch(sd, "film_layer.0")
    params["decoder"] = linear_from_torch(sd, "film_layer.1")
    params["trunk"], trunk_state, missing = _import_film_trunk(sd, cfg, gen)
    return params, {"trunk": trunk_state}, missing


def import_model_checkpoint(model_name, sd, cfg, seed=0):
    """A reference state_dict (tensors or numpy arrays) -> (params, state,
    missing_leaves) as CPU tensors. The leaves reference checkpoints lack are
    drawn from ``seed`` and listed in missing_leaves."""
    gen = torch.Generator().manual_seed(seed)

    if model_name == "bow":
        return {"embed": embedding_from_torch(sd, "embed"),
                "out_linear": linear_from_torch(sd, "out_linear")}, {}, []

    if model_name == "lstm":
        return {"embed": embedding_from_torch(sd, "embed"),
                "lstm": lstm_from_torch(sd, "lstm"),
                "out_linear": linear_from_torch(sd, "out_linear")}, {}, []

    if model_name == "v_only_cnn3d":
        params, state = _import_c3d_trunk(sd)
        params["fc8"] = linear_from_torch(sd, "fc8")
        return params, state, []

    if model_name == "v_only_cnn2d_lstm":
        params, state = {}, {}
        params["input_bn"], state["input_bn"] = bn_from_torch(sd, "input_bn")
        params["trunk"], state["trunk"] = _import_frame_trunk(sd, "per_frame_feature_extractor")
        params["lstm"] = lstm_from_torch(sd, "lstm")
        params["out_linear"] = linear_from_torch(sd, "out_linear")
        return params, state, []

    if model_name == "concat2d":
        params, state = {}, {}
        params["trunk"], state["trunk"] = _import_frame_trunk(sd, "per_frame_feature_extractor")
        params["v_lstm"] = lstm_from_torch(sd, "v_lstm")
        params["embed"] = embedding_from_torch(sd, "embed")
        params["q_lstm"] = lstm_from_torch(sd, "q_lstm")
        params["fc_tail"] = linear_from_torch(sd, "fc_tail")
        params["out_linear"] = linear_from_torch(sd, "out_linear")
        return params, state, []

    if model_name == "concat3d":
        params, state = _import_c3d_trunk(sd)
        params["embed"] = embedding_from_torch(sd, "embed")
        params["q_lstm"] = lstm_from_torch(sd, "q_lstm")
        params["fc_tail"] = linear_from_torch(sd, "fc_tail")
        params["out_linear"] = linear_from_torch(sd, "out_linear")
        return params, state, []

    if model_name == "film_gp_pt":
        params, state, missing = _import_film_common(sd, cfg, gen)
        params["c1x1_tail"] = conv2d_from_torch(sd, "c1x1_tail")
        params["out_linear"] = linear_from_torch(sd, "out_linear")
        return params, state, missing

    if model_name == "film_attn_pt":
        params, state, missing = _import_film_common(sd, cfg, gen)
        params["fc_embed_attn"] = linear_from_torch(sd, "fc_embed_attn")
        params["fc_attn_1"] = linear_from_torch(sd, "fc_attn_1")
        params["fc_hidden_attn"] = linear_from_torch(sd, "fc_hidden_attn")
        params["lstm_attn"] = lstm_cell_from_torch(sd, "lstm_attn")
        params["out_linear"] = linear_from_torch(sd, "out_linear")
        return params, state, missing

    if model_name == "time_multi_hop":
        params = {"embed": embedding_from_torch(sd, "embed"),
                  "q_encoder": lstm_from_torch(sd, "q_encoder"),
                  "encoder_norm": layer_norm_from_torch(sd, "encoder_norm"),
                  "fc_hidden_attn": linear_from_torch(sd, "fc_hidden_attn"),
                  "fc_attn_out": linear_from_torch(sd, "fc_attn_out"),
                  "decoder_norm": layer_norm_from_torch(sd, "decoder_norm"),
                  "c1x1_tail": conv2d_from_torch(sd, "c1x1_tail"),
                  "out_linear": linear_from_torch(sd, "out_linear")}
        params["trunk"], trunk_state, missing = _import_film_trunk(sd, cfg, gen)
        return params, {"trunk": trunk_state}, missing

    if model_name == "mac":
        params = {
            "embed": embedding_from_torch(sd, "embed"),
            "lstm_fwd": lstm_from_torch(sd, "lstm"),
            "lstm_bwd": lstm_from_torch(sd, "lstm", suffix="l0_reverse"),
            "lstm_proj": linear_from_torch(sd, "lstm_proj"),
            "conv0": conv2d_from_torch(sd, "conv.0"),
            "conv1": conv2d_from_torch(sd, "conv.2"),
            "conv2": conv2d_from_torch(sd, "conv.4"),
            "lstm_tail": lstm_from_torch(sd, "lstm_tail"),
            "classifier0": linear_from_torch(sd, "classifier.0"),
            "classifier2": linear_from_torch(sd, "classifier.2"),
        }
        params["mac"] = {
            "position_aware": [linear_from_torch(sd, f"mac.control.position_aware.{i}")
                               for i in range(cfg.mac_max_step)],
            "control_question": linear_from_torch(sd, "mac.control.control_question"),
            "control_attn": linear_from_torch(sd, "mac.control.attn"),
            "read_mem": linear_from_torch(sd, "mac.read.mem"),
            "read_concat": linear_from_torch(sd, "mac.read.concat"),
            "read_attn": linear_from_torch(sd, "mac.read.attn"),
            "write_concat": linear_from_torch(sd, "mac.write.concat"),
            "mem_0": tensor_from_torch(sd["mac.mem_0"]),
            "control_0": tensor_from_torch(sd["mac.control_0"]),
        }
        return params, {}, []

    raise KeyError(f"no importer for model {model_name!r}")


def _leaf_shapes(tree):
    return {path: tuple(t.shape) for path, t in tree_items(tree)}


def verify_shapes(model_name, params, state, reference):
    """Raise unless the imported trees have the same paths and leaf shapes as
    ``reference`` (params, state): the model's ``spec.init`` trees, or the
    live ones a checkpoint is loaded into."""
    for name, got, want in (("params", params, reference[0]), ("state", state, reference[1])):
        got_map, want_map = _leaf_shapes(got), _leaf_shapes(want)
        if got_map != want_map:
            diff_shape = {k for k in set(got_map) & set(want_map) if got_map[k] != want_map[k]}
            raise ValueError(
                f"{name} mismatch for {model_name}: extra={sorted(set(got_map) - set(want_map))} "
                f"missing={sorted(set(want_map) - set(got_map))} "
                f"shape-diff={sorted(diff_shape)}")
    return True
