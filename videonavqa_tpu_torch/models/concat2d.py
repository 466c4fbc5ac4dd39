"""Late fusion: per-frame 2D CNN + LSTM video stream beside a question LSTM
stream (the port of models/concat2d.py).

The v_only_cnn2d_lstm trunk without the input BatchNorm, in parallel with
Embedding -> LSTM(128) over the question; both last valid states ->
concat(256) -> Linear -> ReLU -> Dropout(0.5) -> Linear.
The question embedding has no padding_idx: row 0 is a live parameter.

Dropout acts in train mode only, with a mask drawn from the caller's
generator through ``dropout_mask``; without a generator it is the identity,
as the JAX model's is without an rng. The LSTMs run plain in train mode (the
kernel serves the eval forward only: it has no backward pass).
"""

from __future__ import annotations

import torch

from videonavqa_tpu_torch.models.base import register_model
from videonavqa_tpu_torch.models.v_only_cnn2d_lstm import (
    FRAME_FEAT_DIM, frame_trunk, init_frame_trunk)
from videonavqa_tpu_torch.ops import initializers as init
from videonavqa_tpu_torch.ops.linear import embedding, linear
from videonavqa_tpu_torch.ops.lstm import last_valid, lstm
from videonavqa_tpu_torch.ops.masking import length_mask
from videonavqa_tpu_torch.ops.video import normalize_video
from videonavqa_tpu_torch.parallel.collectives import batch_rows, take_rows
from videonavqa_tpu_torch.utils.device import tree_to

HIDDEN_SIZE = 128
DROPOUT = 0.5


def dropout_mask(generator, shape, keep, device):
    """[shape] f32 of bernoulli(keep) / keep, drawn from ``generator``."""
    keep_probs = torch.full(shape, keep, dtype=torch.float32, device=device)
    return torch.bernoulli(keep_probs, generator=generator) / keep


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
    video, v_lens = normalize_video(batch["video"]), batch["v_len"]
    q, q_lens = batch["question"], batch["q_len"]
    new_state = dict(state)
    feats, new_state["trunk"] = frame_trunk(params["trunk"], state["trunk"], video,
                                            length_mask(v_lens, video.shape[1]), cfg, train=train)
    use_kernel = cfg.use_pallas_kernels and not train
    v_outs, _ = lstm(params["v_lstm"], feats, v_lens, use_kernel=use_kernel)
    q_outs, _ = lstm(params["q_lstm"], embedding(params["embed"], q), q_lens,
                     use_kernel=use_kernel)
    out = torch.cat([last_valid(v_outs, v_lens), last_valid(q_outs, q_lens)], dim=1)
    out = torch.relu(linear(params["fc_tail"], out))
    if train and generator is not None:
        # drawn over the global batch's rows; this rank takes its own
        B = out.shape[0]
        out = out * take_rows(dropout_mask(generator, (batch_rows(B)[0], out.shape[1]),
                                           1.0 - DROPOUT, out.device), B)
    return linear(params["out_linear"], out), new_state


register_model("concat2d", init_fn, apply_fn,
               needs_video=True, needs_question=True, uses_stem=False)
