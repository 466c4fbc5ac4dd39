"""Late fusion: the C3D video stream beside a question LSTM stream (the port
of models/concat3d.py).

The v_only_cnn3d trunk to a 128-d video code; Embedding (no padding_idx: row
0 is a live parameter) -> LSTM(128) -> last valid state; concat(256) ->
Linear -> ReLU -> Dropout(0.5) -> Linear. Dropout draws its mask through
concat2d's ``dropout_mask`` seam in train mode, from the caller's generator;
without one it is the identity. The question LSTM runs through the kernel in
the eval forward where ``cfg.use_pallas_kernels`` asks for it, plain in
train mode.
"""

from __future__ import annotations

import torch

from videonavqa_tpu_torch.models import concat2d
from videonavqa_tpu_torch.models.base import register_model
from videonavqa_tpu_torch.models.v_only_cnn3d import c3d_trunk, init_c3d_trunk
from videonavqa_tpu_torch.ops import initializers as init
from videonavqa_tpu_torch.ops.linear import embedding, linear
from videonavqa_tpu_torch.ops.lstm import last_valid, lstm
from videonavqa_tpu_torch.ops.video import normalize_video
from videonavqa_tpu_torch.parallel.collectives import batch_rows, take_rows
from videonavqa_tpu_torch.utils.device import tree_to

HIDDEN_SIZE = concat2d.HIDDEN_SIZE


def init_fn(gen, cfg, device):
    params, state = init_c3d_trunk(gen, cfg)
    params["embed"] = {"weight": init.normal(gen, (cfg.vocab_size, cfg.embed_size))}
    params["q_lstm"] = init.reference_lstm(gen, cfg.embed_size, HIDDEN_SIZE)
    params["fc_tail"] = init.reference_linear(gen, 2 * HIDDEN_SIZE, 2 * HIDDEN_SIZE)
    params["out_linear"] = init.reference_linear(gen, cfg.num_classes, 2 * HIDDEN_SIZE)
    return tree_to(params, device), tree_to(state, device)


def apply_fn(params, state, batch, cfg, *, train=False, generator=None):
    h, new_state = c3d_trunk(params, state, normalize_video(batch["video"]), cfg, train=train)
    q, q_lens = batch["question"], batch["q_len"]
    q_outs, _ = lstm(params["q_lstm"], embedding(params["embed"], q), q_lens,
                     use_kernel=cfg.use_pallas_kernels and not train)
    out = torch.cat([h, last_valid(q_outs, q_lens)], dim=1)
    out = torch.relu(linear(params["fc_tail"], out))
    if train and generator is not None:
        B = out.shape[0]
        out = out * take_rows(concat2d.dropout_mask(generator, (batch_rows(B)[0], out.shape[1]),
                                                    1.0 - concat2d.DROPOUT, out.device), B)
    return linear(params["out_linear"], out), new_state


register_model("concat3d", init_fn, apply_fn,
               needs_video=True, needs_question=True, uses_stem=False)
