"""Video-only per-frame 2D CNN + LSTM, eval forward (the port of
models/v_only_cnn2d_lstm.py).

BatchNorm on the clip -> per-frame trunk of five [conv3x3 -> BN -> ReLU ->
pool] stages (16, 32, 64, 128, 128 channels) -> flatten 128*5*6 in CHW order
-> masked LSTM over frames -> last valid state -> Linear. The trunk runs once
over the folded [B*T] frames.
"""

from __future__ import annotations

from videonavqa_tpu_torch.models.base import DTYPES, eval_only, register_model
from videonavqa_tpu_torch.ops import initializers as init
from videonavqa_tpu_torch.ops.conv import conv2d, max_pool2d
from videonavqa_tpu_torch.ops.linear import linear
from videonavqa_tpu_torch.ops.lstm import last_valid, lstm
from videonavqa_tpu_torch.ops.masking import length_mask, mask_invalid
from videonavqa_tpu_torch.ops.norm import batch_norm, frame_batch_norm
from videonavqa_tpu_torch.ops.video import normalize_video
from videonavqa_tpu_torch.utils.device import tree_to

VGG11_CFG = (16, 32, 64, 128, 128)  # each followed by BN, ReLU, maxpool2
FRAME_FEAT_DIM = 128 * 5 * 6


def init_frame_trunk(gen, in_channels=3):
    """The [conv3x3 -> BN -> ReLU -> pool] x5 per-frame trunk (shared with concat2d)."""
    params, state = {}, {}
    cin = in_channels
    for i, cout in enumerate(VGG11_CFG):
        params[f"conv{i}"] = init.reference_conv2d(gen, 3, 3, cin, cout)
        params[f"bn{i}"], state[f"bn{i}"] = init.init_bn(cout)
        cin = cout
    return params, state


def frame_trunk(params, state, video, frame_mask, cfg):
    """video [B, T, 160, 208, 3] -> per-frame features [B, T, 128*5*6] (CHW
    flatten order), zero at invalid frames."""
    B, T = video.shape[:2]
    h = video
    for i in range(len(VGG11_CFG)):
        flat = conv2d(params[f"conv{i}"], h.reshape(B * T, *h.shape[2:]),
                      dtype=DTYPES[cfg.compute_dtype])
        h, _ = frame_batch_norm(params[f"bn{i}"], state[f"bn{i}"],
                                flat.reshape(B, T, *flat.shape[1:]), frame_mask, train=False)
        h = max_pool2d(h.relu_())
    feats = h.permute(0, 1, 4, 2, 3).reshape(B, T, -1)
    return mask_invalid(feats, frame_mask.sum(dim=1))


def init_fn(gen, cfg, device):
    params, state = {}, {}
    params["input_bn"], state["input_bn"] = init.init_bn(3)
    params["trunk"], state["trunk"] = init_frame_trunk(gen)
    params["lstm"] = init.reference_lstm(gen, FRAME_FEAT_DIM, cfg.hidden_size)
    params["out_linear"] = init.reference_linear(gen, cfg.num_classes, cfg.hidden_size)
    return tree_to(params, device), tree_to(state, device)


def apply_fn(params, state, batch, cfg, *, train=False, generator=None):
    eval_only(train)
    video, v_lens = normalize_video(batch["video"]), batch["v_len"]
    # the reference normalizes the whole padded clip, padding zeros included
    video, _ = batch_norm(params["input_bn"], state["input_bn"], video, train=False)
    feats = frame_trunk(params["trunk"], state["trunk"], video,
                        length_mask(v_lens, video.shape[1]), cfg)
    outs, _ = lstm(params["lstm"], feats, v_lens, use_kernel=cfg.use_pallas_kernels)
    return linear(params["out_linear"], last_valid(outs, v_lens)), state


register_model("v_only_cnn2d_lstm", init_fn, apply_fn,
               needs_video=True, needs_question=False, uses_stem=False)
