"""Question-only LSTM classifier (the port of models/q_only_lstm.py).

Embedding(pad 0) -> one masked LSTM -> last valid state -> Linear.

The reference draws (h0, c0) from randn on every batch, in train mode and at
eval alike. Here ``initial_state`` draws them from the ``torch.Generator``
the caller passes down (the train step's, the eval step's or the engine's);
``apply_with_state`` is the forward from given (h0, c0). The embedding's
row 0 is padding: it reads as zero and gets no gradient, so it stays zero
under training. The LSTM runs plain in train mode (the kernel serves the
eval forward only: it has no backward pass).
"""

from __future__ import annotations

import torch

from videonavqa_tpu_torch.models.base import register_model
from videonavqa_tpu_torch.ops import initializers as init
from videonavqa_tpu_torch.ops.linear import embedding, linear
from videonavqa_tpu_torch.ops.lstm import last_valid, lstm
from videonavqa_tpu_torch.parallel.collectives import batch_rows, take_rows
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


def initial_state(generator, shape, device):
    """(h0, c0), each [shape] f32 standard normal, drawn from ``generator``;
    without one, from a generator on ``device`` seeded 0 (the JAX model falls
    back to PRNGKey(0))."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    h0 = torch.randn(shape, generator=generator, device=device)
    c0 = torch.randn(shape, generator=generator, device=device)
    return h0, c0


def apply_with_state(params, batch, cfg, h0, c0, *, train=False):
    """logits [B, num_classes] from given h0, c0 [B, hidden]."""
    emb = embedding(params["embed"], batch["question"], padding_idx=0)
    outs, _ = lstm(params["lstm"], emb, batch["q_len"], h0, c0,
                   use_kernel=cfg.use_pallas_kernels and not train)
    return linear(params["out_linear"], last_valid(outs, batch["q_len"]))


def apply_fn(params, state, batch, cfg, *, train=False, generator=None):
    q = batch["question"]
    # drawn over the global batch's rows; this rank takes its own
    B = q.shape[0]
    h0, c0 = initial_state(generator, (batch_rows(B)[0], cfg.hidden_size), q.device)
    h0, c0 = take_rows(h0, B), take_rows(c0, B)
    return apply_with_state(params, batch, cfg, h0, c0, train=train), state


register_model("lstm", init_fn, apply_fn, needs_video=False, needs_question=True,
               uses_stem=False)
