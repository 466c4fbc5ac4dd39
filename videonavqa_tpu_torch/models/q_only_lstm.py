"""Question-only LSTM classifier, eval forward (the port of models/q_only_lstm.py).

Embedding(pad 0) -> one masked LSTM -> last valid state -> Linear.

The reference draws (h0, c0) from randn on every batch, at eval too. Here
they come from the ``torch.Generator`` the caller passes down (the engine
holds one); ``apply_with_state`` is the forward from given (h0, c0).
"""

from __future__ import annotations

import torch

from videonavqa_tpu_torch.models.base import eval_only, register_model
from videonavqa_tpu_torch.ops import initializers as init
from videonavqa_tpu_torch.ops.linear import embedding, linear
from videonavqa_tpu_torch.ops.lstm import last_valid, lstm
from videonavqa_tpu_torch.utils.device import tree_to


def init_fn(gen, cfg, device):
    embed = init.normal(gen, (cfg.vocab_size, cfg.embed_size))
    embed[0] = 0.0  # padding_idx=0
    params = {
        "embed": {"weight": embed},
        "lstm": init.reference_lstm(gen, cfg.embed_size, cfg.hidden_size),
        "out_linear": init.reference_linear(gen, cfg.num_classes, cfg.hidden_size),
    }
    return tree_to(params, device), {}


def apply_with_state(params, batch, cfg, h0, c0):
    """logits [B, num_classes] from given h0, c0 [B, hidden]."""
    emb = embedding(params["embed"], batch["question"], padding_idx=0)
    outs, _ = lstm(params["lstm"], emb, batch["q_len"], h0, c0,
                   use_kernel=cfg.use_pallas_kernels)
    return linear(params["out_linear"], last_valid(outs, batch["q_len"]))


def apply_fn(params, state, batch, cfg, *, train=False, generator=None):
    eval_only(train)
    q = batch["question"]
    if generator is None:
        generator = torch.Generator(device=q.device).manual_seed(0)
    shape = (q.shape[0], cfg.hidden_size)
    h0 = torch.randn(shape, generator=generator, device=q.device)
    c0 = torch.randn(shape, generator=generator, device=q.device)
    return apply_with_state(params, batch, cfg, h0, c0), state


register_model("lstm", init_fn, apply_fn, needs_video=False, needs_question=True,
               uses_stem=False)
