"""The eval forward (the counterpart of the JAX package's _forward / make_eval_step).

Training (loss, gradient clipping, Adam) comes with the training slice.
"""

from __future__ import annotations

import torch

from videonavqa_tpu_torch.models.base import DTYPES


def forward(spec, cfg, params, state, batch, generator=None):
    """Eval forward -> (logits, new_state). fp8 e4m3 cached features are
    widened to the compute dtype first; raw video goes through as it is (the
    model divides uint8 frames by 255). ``generator`` feeds a model that
    draws at eval (the question-only LSTM's initial state)."""
    feats = batch.get("v_features")
    if feats is not None and feats.dtype == torch.float8_e4m3fn:
        batch = dict(batch, v_features=feats.to(DTYPES[cfg.compute_dtype]))
    return spec.apply(params, state, batch, cfg, train=False, generator=generator)


def make_eval_step(spec, cfg, generator=None):
    """(params, state, batch) -> {'logits', 'preds'}, with no state update."""

    def step(params, state, batch):
        with torch.inference_mode():
            logits, _ = forward(spec, cfg, params, state, batch, generator)
        return {"logits": logits, "preds": torch.argmax(logits, dim=-1)}

    return step
