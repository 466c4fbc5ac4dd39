"""The train step, the eval forward and the eval step (the counterparts of the
JAX package's train/step.py: make_train_step, _forward and make_eval_step).

One train step: the frozen stem when the batch holds raw video, the model's
train forward, the cross-entropy loss, the backward pass through autograd,
gradient clipping and Adam. Clipping follows the reference harness: the
q_and_v models clip the global norm at ``clip_value``; MAC also clamps every
gradient element to +-``elementwise_clamp`` before that clip.

Under a mesh (``parallel/``) each rank's loss is its rows' part, the
gradients are summed over 'data' in one flat buffer before the clip, and a
'model'-sharded leaf's squares are summed over 'model' once in the global
norm, so the clip and the step are one device's.
"""

from __future__ import annotations

import torch

from videonavqa_tpu_torch.models.base import DTYPES
from videonavqa_tpu_torch.ops.video import normalize_video
from videonavqa_tpu_torch.parallel import collectives
from videonavqa_tpu_torch.train.loss import cross_entropy_loss


def tree_items(tree, prefix=""):
    """[('/'-joined path, leaf)] of a nested dict (and list), in insertion order."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items() for item in tree_items(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [item for i, v in enumerate(tree) for item in tree_items(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def tree_leaves(tree):
    """The tensors of a nested dict (and list), in insertion order."""
    return [leaf for _, leaf in tree_items(tree)]


def make_optimizer(params, l_rate: float):
    """Adam with torch's defaults over the leaf tensors of ``params``, which
    it marks ``requires_grad``. (torch's optimizer holds its parameters, where
    optax's takes them at init; the moments start at zero on both sides.)"""
    leaves = tree_leaves(params)
    for p in leaves:
        if not p.is_leaf:
            raise ValueError("make_optimizer: every parameter must be a leaf tensor")
        p.requires_grad_(True)
    return torch.optim.Adam(leaves, lr=l_rate)


def set_learning_rate(optimizer, l_rate: float):
    for group in optimizer.param_groups:
        group["lr"] = l_rate


def global_norm(tensors, sharded=None):
    """sqrt of the sum of squares of every element, in f32. ``sharded``
    (bools like ``tensors``): the tensors whose rows are split over a mesh's
    'model' axis, whose squares are summed over it."""
    if not sharded or not any(sharded):
        return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))
    sq = [torch.sum(torch.square(t.float())) for t in tensors]
    whole = sum(s for s, sh in zip(sq, sharded) if not sh)
    return torch.sqrt(whole + collectives.sum_over_model(
        sum(s for s, sh in zip(sq, sharded) if sh)))


def clip_grads(grads, *, clip_value=None, elementwise_clamp=None, sharded=None):
    """A list of gradients -> the clipped list: first the optional
    +-elementwise_clamp of each element, then the scale
    min(1, clip_value / max(global norm, 1e-6)) (``sharded``: as in
    ``global_norm``)."""
    if elementwise_clamp is not None:
        grads = [torch.clamp(g, -elementwise_clamp, elementwise_clamp) for g in grads]
    if clip_value is not None:
        scale = torch.clamp(clip_value / torch.clamp(global_norm(grads, sharded), min=1e-6),
                            max=1.0)
        grads = [g * scale for g in grads]
    return grads


def _model_batch(spec, cfg, batch, stem_fn):
    """The batch as the model takes it: raw video through ``stem_fn`` (frames
    /255 first, no gradient) for a stem model without features, or fp8 e4m3
    cached features widened to the compute dtype."""
    feats = batch.get("v_features")
    if feats is None and stem_fn is not None and spec.uses_stem:
        with torch.no_grad():
            feats = stem_fn(normalize_video(batch["video"]))
        return dict(batch, v_features=feats)
    if feats is not None and feats.dtype == torch.float8_e4m3fn:
        return dict(batch, v_features=feats.to(DTYPES[cfg.compute_dtype]))
    return batch


def forward(spec, cfg, params, state, batch, generator=None, stem_fn=None):
    """Eval forward -> (logits, new_state). fp8 e4m3 cached features are
    widened to the compute dtype first; raw video goes through ``stem_fn``
    for a stem model without features (as in ``make_train_step``), or else
    as it is (a model that takes video divides uint8 frames by 255).
    ``generator`` feeds a model that draws at eval (the question-only LSTM's
    initial state)."""
    return spec.apply(params, state, _model_batch(spec, cfg, batch, stem_fn), cfg, train=False,
                      generator=generator)


def make_train_step(spec, cfg, optimizer, *, class_weights=None, reduction="mean",
                    clip_value=None, elementwise_clamp=None, stem_fn=None):
    """(params, state, batch, generator=None) -> (new_state, metrics), updating
    the leaves of ``params`` in place; they must be the tensors ``optimizer`` holds
    (``make_optimizer(params, ...)``). ``batch`` also holds ``label`` [B].

    ``stem_fn`` (video [B, T, 160, 208, 3] in [0, 1] -> features
    [B, T, 10, 13, C]) takes a batch with ``video`` and no ``v_features``
    through the frozen stem, under no_grad: its weights are no parameters
    here. A leaf the loss does not reach (a frozen 1x1 conv) gets a zero
    gradient, as it does under jax.grad. metrics: ``loss``, ``hits``,
    ``preds`` and ``grad_norm``, the global norm after clipping.

    ``generator`` (a ``torch.Generator`` on the batch's device) feeds the
    train forward's random draws (MAC's and concat2d's dropout masks, the
    question-only LSTM's (h0, c0)), as the JAX step's
    ``rng`` does; the harness gives each batch its own. A model that draws
    nothing ignores it."""
    leaves = [p for group in optimizer.param_groups for p in group["params"]]
    sharded = [collectives.is_model_sharded(p) for p in leaves]

    def step(params, state, batch, generator=None):
        if len(tree_leaves(params)) != len(leaves) or any(
                a is not b for a, b in zip(tree_leaves(params), leaves)):
            raise ValueError("make_train_step: params are not the optimizer's tensors")
        model_batch = _model_batch(spec, cfg, batch, stem_fn)
        optimizer.zero_grad(set_to_none=True)
        logits, new_state = spec.apply(params, state, model_batch, cfg, train=True,
                                       generator=generator)
        loss = cross_entropy_loss(logits, batch["label"], class_weights=class_weights,
                                  reduction=reduction)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
        grads = collectives.sum_grads_over_data(grads)
        grads = clip_grads(grads, clip_value=clip_value, elementwise_clamp=elementwise_clamp,
                           sharded=sharded)
        for p, g in zip(leaves, grads):
            p.grad = g
        optimizer.step()
        preds = torch.argmax(logits.detach(), dim=-1)
        metrics = {"loss": loss.detach(), "hits": torch.sum(preds == batch["label"]),
                   "preds": preds, "grad_norm": global_norm(grads, sharded)}
        return new_state, metrics

    return step


def make_eval_step(spec, cfg, generator=None, *, class_weights=None, reduction="mean",
                   stem_fn=None):
    """(params, state, batch) -> {'loss', 'hits', 'preds', 'logits'}, under
    inference mode with no state update, as the JAX package's eval step.

    ``loss`` is the cross-entropy over the rows the batch's optional
    ``valid`` mask keeps; ``hits`` counts every row, padding included (the
    harness slices padding rows off ``preds`` itself). ``stem_fn`` takes a
    batch of raw video through the frozen stem, as in ``make_train_step``.
    ``generator`` is the one every call draws from (the question-only LSTM's
    (h0, c0))."""

    def step(params, state, batch):
        with torch.inference_mode():
            logits, _ = forward(spec, cfg, params, state, batch, generator, stem_fn)
            loss = cross_entropy_loss(logits, batch["label"], class_weights=class_weights,
                                      reduction=reduction, valid=batch.get("valid"))
            preds = torch.argmax(logits, dim=-1)
            return {"loss": loss, "hits": torch.sum(preds == batch["label"]),
                    "preds": preds, "logits": logits}

    return step
