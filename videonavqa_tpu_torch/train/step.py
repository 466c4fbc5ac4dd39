"""The eval forward (the counterpart of the JAX package's _forward / make_eval_step).

Training (loss, gradient clipping, Adam) comes with the training slice.
"""

from __future__ import annotations

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def forward(spec, cfg, params, state, batch):
    """Eval forward -> (logits, new_state). fp8 e4m3 cached features are
    widened to the compute dtype first."""
    feats = batch.get("v_features")
    if feats is not None and feats.dtype == torch.float8_e4m3fn:
        batch = dict(batch, v_features=feats.to(_DTYPES[cfg.compute_dtype]))
    return spec.apply(params, state, batch, cfg, train=False)


def make_eval_step(spec, cfg):
    """(params, state, batch) -> {'logits', 'preds'}, with no state update."""

    def step(params, state, batch):
        with torch.inference_mode():
            logits, _ = forward(spec, cfg, params, state, batch)
        return {"logits": logits, "preds": torch.argmax(logits, dim=-1)}

    return step
