"""Model registry and shared configuration.

A model is a pair of functions over plain dictionaries of tensors:

    init(generator, cfg, device)           -> (params, state)
    apply(params, state, batch, cfg, *, train, generator)
                                           -> (logits [B, num_classes], new_state)

``generator`` is the ``torch.Generator`` of a model that draws: the
question-only LSTM's initial state (at eval too), and MAC's and concat2d's
train-time dropout masks; the others ignore it.

``state`` holds BatchNorm running statistics and, after an int8 calibration
pass, the trunk's ``int8_scales`` and ``int8_wq``. ``batch`` is a dict with
    question [B, 56] int, q_len [B] int,
    v_features [B, T, 10, 13, 512] (frozen-stem output, channels last) for a
    model that ``uses_stem``, or video [B, T, 160, 208, 3] (uint8, or float
    already divided by 255) for one that takes raw frames,
    v_len [B] int.
"""

from __future__ import annotations

import dataclasses

import torch

from videonavqa_tpu_torch.utils import constants as C

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The same fields and defaults as the JAX package's ModelConfig."""

    model: str = "film_attn_pt"
    num_classes: int = C.NUM_CLASSES
    vocab_size: int = C.VOCAB_SIZE
    q_encoder: str = "lstm"            # 'lstm' | 'bow' (FiLM models)
    embed_size: int = 128
    hidden_size: int = 128
    at_hidden_size: int = 128
    num_res_blocks: int = 1
    num_res_block_channels: int = 512
    num_input_channels: int = 512
    num_tail_channels: int = 16
    mac_dim: int = 512
    mac_max_step: int = 12
    mac_dropout: float = 0.15
    max_num_frames: int = C.MAX_ALLOWED_NUM_FRAMES_DROPPING
    max_q_len: int = C.MAX_Q_LEN
    # Compute dtype of the conv trunk ('bfloat16' or 'float32').
    compute_dtype: str = "bfloat16"
    # Route the serving path through the hand-written kernels (kernels/).
    # The name is the JAX package's, where the kernels are Pallas.
    use_pallas_kernels: bool = False
    # Run the FiLM trunk convs int8 on the inference path. The port serves
    # only the static (calibrated, pre-quantized) form.
    use_int8_trunk: bool = False
    # f32 eval forward that records each trunk conv's input absmax (1.25x
    # headroom) and its pre-quantized int8 weights into the returned state.
    int8_trunk_calibrate: bool = False
    # Training options (the FiLM trunk's train forward): recompute each block in
    # the backward pass; keep the 1x1 convs frozen.
    remat_film_blocks: bool = False
    freeze_film_conv1x1: bool = False


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    init: object
    apply: object
    needs_video: bool
    needs_question: bool
    uses_stem: bool  # consumes v_features (frozen stem) rather than raw video


MODEL_REGISTRY: dict[str, ModelSpec] = {}


def register_model(name, init_fn, apply_fn, *, needs_video, needs_question, uses_stem):
    MODEL_REGISTRY[name] = ModelSpec(
        name, init_fn, apply_fn, needs_video, needs_question, uses_stem)


def get_model(name: str) -> ModelSpec:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]
