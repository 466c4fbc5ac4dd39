"""Question-only bag-of-words classifier (the port of models/q_only_bow.py).

Embedding(pad 0) -> sum over the tokens -> Linear. The reference's intended
mean is a no-op (its division's result is discarded), so this is a sum. The
embedding keeps torch's N(0, 1) init with the padding row zeroed; row 0
reads as zero and gets no gradient.
"""

from __future__ import annotations

from videonavqa_tpu_torch.models.base import register_model
from videonavqa_tpu_torch.ops import initializers as init
from videonavqa_tpu_torch.ops.linear import embedding, linear
from videonavqa_tpu_torch.utils.device import tree_to


def init_fn(gen, cfg, device):
    embed = init.normal(gen, (cfg.vocab_size, cfg.embed_size))
    embed[0] = 0.0  # padding_idx=0
    params = {"embed": {"weight": embed},
              "out_linear": init.reference_linear(gen, cfg.num_classes, cfg.embed_size)}
    return tree_to(params, device), {}


def apply_fn(params, state, batch, cfg, *, train=False, generator=None):
    emb = embedding(params["embed"], batch["question"], padding_idx=0)
    return linear(params["out_linear"], emb.sum(dim=1)), state


register_model("bow", init_fn, apply_fn, needs_video=False, needs_question=True,
               uses_stem=False)
