"""Late fusion: per-frame 2D CNN + LSTM video stream beside a question LSTM
stream, eval forward (the port of models/concat2d.py).

The v_only_cnn2d_lstm trunk without the input BatchNorm, in parallel with
Embedding -> LSTM(128) over the question; both last valid states ->
concat(256) -> Linear -> ReLU -> (dropout, the identity at eval) -> Linear.
The question embedding has no padding_idx: row 0 is a live parameter.
"""

from __future__ import annotations

import torch

from videonavqa_tpu_torch.models.base import eval_only, register_model
from videonavqa_tpu_torch.models.v_only_cnn2d_lstm import (
    FRAME_FEAT_DIM, frame_trunk, init_frame_trunk)
from videonavqa_tpu_torch.ops import initializers as init
from videonavqa_tpu_torch.ops.linear import embedding, linear
from videonavqa_tpu_torch.ops.lstm import last_valid, lstm
from videonavqa_tpu_torch.ops.masking import length_mask
from videonavqa_tpu_torch.ops.video import normalize_video
from videonavqa_tpu_torch.utils.device import tree_to

HIDDEN_SIZE = 128


def init_fn(gen, cfg, device):
    params, state = {}, {}
    params["trunk"], state["trunk"] = init_frame_trunk(gen)
    params["v_lstm"] = init.reference_lstm(gen, FRAME_FEAT_DIM, HIDDEN_SIZE)
    params["embed"] = {"weight": init.normal(gen, (cfg.vocab_size, cfg.embed_size))}
    params["q_lstm"] = init.reference_lstm(gen, cfg.embed_size, HIDDEN_SIZE)
    params["fc_tail"] = init.reference_linear(gen, 2 * HIDDEN_SIZE, 2 * HIDDEN_SIZE)
    params["out_linear"] = init.reference_linear(gen, cfg.num_classes, 2 * HIDDEN_SIZE)
    return tree_to(params, device), tree_to(state, device)


def apply_fn(params, state, batch, cfg, *, train=False, generator=None):
    eval_only(train)
    video, v_lens = normalize_video(batch["video"]), batch["v_len"]
    q, q_lens = batch["question"], batch["q_len"]
    feats = frame_trunk(params["trunk"], state["trunk"], video,
                        length_mask(v_lens, video.shape[1]), cfg)
    v_outs, _ = lstm(params["v_lstm"], feats, v_lens, use_kernel=cfg.use_pallas_kernels)
    q_outs, _ = lstm(params["q_lstm"], embedding(params["embed"], q), q_lens,
                     use_kernel=cfg.use_pallas_kernels)
    out = torch.cat([last_valid(v_outs, v_lens), last_valid(q_outs, q_lens)], dim=1)
    out = torch.relu(linear(params["fc_tail"], out))
    return linear(params["out_linear"], out), state


register_model("concat2d", init_fn, apply_fn,
               needs_video=True, needs_question=True, uses_stem=False)
