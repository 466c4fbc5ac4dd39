"""Serving engine: padded fixed-shape micro-batches through one loaded model.

The core of the JAX package's ``cli/serve.py`` InferenceEngine: the model
loads once, and each micro-batch is padded to ``max_batch`` rows (padding
rows have v_len = q_len = 1) and its frame axis trimmed to the smallest frame
bucket that covers its longest video. What an item carries depends on the
model and the mode: precomputed frozen-stem features for a model that
``uses_stem`` (the JAX daemon's ``--feature_cache true``), raw uint8 frames
``[T, 160, 208, 3]`` for one that takes video itself or, in video mode
(``from_video=True``), for a stem model too, and nothing visual for a
question-only model. In video mode a stem model's frames go /255, then
through the frozen stem (``stem/``) in ``cfg.compute_dtype``, VGG block 1
through its kernel where ``cfg.use_pallas_kernels`` asks for it, as the JAX
daemon's video mode does. With the int8 trunk, the FIRST micro-batch runs the
f32 calibration forward on the padded batch exactly as it stands (padding
rows enter the absmax; in video mode on the stem's output) and every later
batch serves static int8 from the recorded state.

The HTTP daemon, the micro-batcher, the feature-cache loader, the int8 stem
and hot reload are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from videonavqa_tpu_torch.models import get_model
from videonavqa_tpu_torch.models.base import DTYPES
from videonavqa_tpu_torch.ops.video import normalize_video
from videonavqa_tpu_torch.stem import (
    STEM_SEED, init_obj_detector, init_vgg_partial, stem_features)
from videonavqa_tpu_torch.train.step import forward
from videonavqa_tpu_torch.utils import constants as C
from videonavqa_tpu_torch.utils.checkpoint import load_jax_checkpoint
from videonavqa_tpu_torch.utils.device import resolve_device, tree_to


class InferenceEngine:
    """Loads the model once; serves padded fixed-shape micro-batches.

    Weights come from a JAX-package checkpoint (``checkpoint_path``) or from
    the reference init drawn from ``torch.Generator().manual_seed(seed)``.
    ``device`` defaults to the card; pass ``"cpu"`` to run the plain path.
    A model that draws at eval draws each batch from a generator reset to
    the seed, so a repeated request gets the same answer (the JAX daemon
    runs every batch with ``PRNGKey(0)``).

    ``from_video`` is the inverse of the JAX daemon's ``--feature_cache``: a
    stem model is then served from raw uint8 frames through the frozen stem,
    whose weights are ``stem`` (``(vgg_params, det_params, det_state)``, e.g.
    from ``utils.checkpoint.stem_from_jax``) or else the reference init drawn
    from ``torch.Generator().manual_seed(1234)``, the seed number of the JAX
    package's random stem (the two generators give different weights), with
    as many detector filters as the model has input channels. A model that
    takes video itself is served from frames either way; a question-only
    model has no video mode and raises."""

    def __init__(self, cfg, *, checkpoint_path=None, seed=0, max_batch=8,
                 frame_buckets=C.FRAME_BUCKETS, device=None, from_video=False, stem=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec = get_model(cfg.model)
        if from_video and not self.spec.needs_video:
            raise ValueError(f"{cfg.model} takes no video: video mode serves a model that "
                             "uses the frozen stem or takes raw frames")
        self.stem = None
        if from_video and self.spec.uses_stem:
            if stem is None:
                gen = torch.Generator().manual_seed(STEM_SEED)
                vgg = init_vgg_partial(gen)
                det, det_state = init_obj_detector(gen, num_filters=cfg.num_input_channels)
                stem = (vgg, det, det_state)
            self.stem = tuple(tree_to(t, self.device) for t in stem)
        self.visual_key = ("v_features" if self.spec.uses_stem and not from_video
                           else "video" if self.spec.needs_video else None)
        self.seed = seed
        self.generator = torch.Generator(device=self.device)
        self.B = max_batch
        self.frame_buckets = tuple(frame_buckets)
        if checkpoint_path:
            self.params, self.state, _ = load_jax_checkpoint(checkpoint_path, self.device)
        else:
            self.params, self.state = self.spec.init(
                torch.Generator().manual_seed(seed), cfg, self.device)
        self.needs_int8_calibration = cfg.use_int8_trunk
        self._calibrate_cfg = dataclasses.replace(cfg, int8_trunk_calibrate=True)

    def bucket_for(self, v_len):
        """Smallest frame bucket covering ``v_len`` (35 when none does)."""
        return min((t for t in self.frame_buckets if t >= max(v_len, 1)),
                   default=C.MAX_ALLOWED_NUM_FRAMES_DROPPING)

    def make_batch(self, items):
        """The padded batch of ``items`` on the engine's device.

        items: list of (visual, v_len, tokens); visual is the item's frames
        (features [35, 10, 13, C] bf16/fp8, or video [35, 160, 208, 3] uint8)
        and is ignored (pass None) for a question-only model."""
        n = len(items)
        if not 1 <= n <= self.B:
            raise ValueError(f"a micro-batch holds 1..{self.B} items, got {n}")
        question = torch.zeros((self.B, C.MAX_Q_LEN), dtype=torch.int32, device=self.device)
        v_len = torch.ones(self.B, dtype=torch.int32)
        q_len = torch.ones(self.B, dtype=torch.int32)
        for i, (_, vl, tokens) in enumerate(items):
            tokens = torch.as_tensor(tokens, dtype=torch.int32)[:C.MAX_Q_LEN]
            question[i, :len(tokens)] = tokens.to(self.device)
            v_len[i] = max(int(vl), 1)
            q_len[i] = max(len(tokens), 1)
        batch = {"question": question, "v_len": v_len.to(self.device),
                 "q_len": q_len.to(self.device)}
        if self.visual_key is not None:
            t_b = self.bucket_for(int(v_len[:n].max()))
            first = torch.as_tensor(items[0][0])
            visual = torch.zeros((self.B, t_b, *first.shape[1:]), dtype=first.dtype,
                                 device=self.device)
            for i, (frames, _, _) in enumerate(items):
                frames = torch.as_tensor(frames)
                t_i = min(frames.shape[0], t_b)
                visual[i, :t_i] = frames[:t_i].to(self.device)
            batch[self.visual_key] = visual
        return batch

    def features(self, batch, cfg=None):
        """Video mode: f32 stem features [B, T, 10, 13, C] of a padded batch's
        frames, the stem in ``cfg.compute_dtype`` and block 1 through its
        kernel where ``cfg.use_pallas_kernels`` (``cfg``: the engine's by default)."""
        cfg = cfg or self.cfg
        return stem_features(*self.stem, normalize_video(batch["video"]),
                             dtype=DTYPES[cfg.compute_dtype], use_kernel=cfg.use_pallas_kernels)

    def forward(self, batch, cfg=None, generator=None):
        """(logits, new_state) of one padded batch under ``cfg`` (the engine's
        by default). In video mode a stem model's frames first become features.
        Without ``generator`` the batch draws from the engine's, reset to its seed."""
        cfg = cfg or self.cfg
        if self.stem is not None:
            batch = dict(batch, v_features=self.features(batch, cfg))
            del batch["video"]
        return forward(self.spec, cfg, self.params, self.state, batch,
                       generator or self.generator.manual_seed(self.seed))

    def run_batch(self, items):
        """[n, num_classes] f32 probabilities of ``items`` (padding rows dropped)."""
        batch = self.make_batch(items)
        with torch.inference_mode():
            if self.needs_int8_calibration:
                logits, self.state = self.forward(batch, self._calibrate_cfg)
                self.needs_int8_calibration = False
            else:
                logits, _ = self.forward(batch)
            probs = torch.softmax(logits, dim=-1)
        return probs[:len(items)].cpu().numpy()
