"""The FiLM models over the frozen stem, film_gp_pt and film_attn_pt (the port
of models/film.py).

Per frame: conv3x3(512->C) -> ReLU -> BN, then N residual FiLM blocks
    res = ReLU(conv1x1(x)); y = conv3x3(res); y = ReLU(alpha*y + beta) + res
with (alpha, beta) generated from the question. The question encoder is an
LSTM re-encoded once per frame with a carried state (the film_hidden drift),
or (``q_encoder='bow'``) a Linear per token summed over all 56 positions,
bias included at each, the same for every frame. film_gp_pt's tail is a 1x1
conv, a ReLU and a max over the valid frames; film_attn_pt's embeds each
frame, scores it, and runs a 35-step attention LSTM over the frames.

The trunk's convs run once over the folded [B*T] frame batch. The trunk has
these modes: plain (``compute_dtype``); the f32 calibration pass, which
records each conv's input absmax (1.25x headroom) and pre-quantized int8
weights into the state; and, under ``use_int8_trunk``, int8 in one of three
forms, as the state allows: calibrated (absmax and int8 weights from the
state; the 1x1 convs take the fused int8 kernel when the folded row count is
at or under ``INT8_FUSED_MAX_ROWS``, which requantizes the 3x3 conv's input
from the source the JAX package's route at that count uses,
``INT8_REQUANT_F32_MAX_ROWS``), static (an absmax but no int8 weights
in the state: the weights quantize each call) and dynamic (no absmax: each
conv quantizes its input by this batch's absmax, as the harness's eval step
runs ``--int8_trunk``).

The train forward (``train=True``) runs the plain trunk in ``compute_dtype``
and the plain re-encode and attention tail, whatever
``cfg.use_pallas_kernels`` says, as the JAX package does: no kernel has a
backward pass. Its frame BatchNorm takes batch statistics and returns the
new running ones.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from videonavqa_tpu_torch.kernels.attn_tail import attn_tail, attn_tail_plain
from videonavqa_tpu_torch.kernels.film_reencode import (
    check_shape as check_reencode_shape, film_reencode, film_reencode_plain)
from videonavqa_tpu_torch.kernels.int8_matmul import matmul_int8_fused
from videonavqa_tpu_torch.models.base import DTYPES, register_model
from videonavqa_tpu_torch.ops import initializers as init
from videonavqa_tpu_torch.ops.conv import conv2d
from videonavqa_tpu_torch.ops.linear import embedding, linear, linear_chw
from videonavqa_tpu_torch.ops.masking import attn_frame_mask, length_mask, mask_invalid
from videonavqa_tpu_torch.ops.norm import frame_batch_norm
from videonavqa_tpu_torch.parallel.collectives import batch_rows, max_over_batch
from videonavqa_tpu_torch.ops.quant import (
    conv2d_int8_dynamic, conv2d_int8_preq_act, conv2d_int8_prequant, conv2d_int8_static,
    quantize_weight_channelwise)
from videonavqa_tpu_torch.utils import constants as C
from videonavqa_tpu_torch.utils.device import tree_to

# Folded-row-count ceiling for the fused int8 1x1 kernel (rows = B*T*10*13).
# Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit by
# chip_smoke.py's sweep_int8_gate: the fused route (one kernel for the 1x1
# conv, its ReLU and the 3x3 conv's int8 input) beat the plain route
# (conv2d_int8_prequant, ReLU, the 3x3 conv's own quantize) at every count
# swept, from 4,550 rows (batch 1 x 35 frames) through every served count to
# 1,164,800 (batch 256 x 35), its lead growing with the rows. The gate is the
# largest count swept; above it the route is unmeasured. (The JAX package's
# 9,100 was measured on a TPU v5e.)
INT8_FUSED_MAX_ROWS = 1164800

# A parity rule taken from the JAX package, not a speed gate: at or under its
# INT8_FUSED_MAX_ROWS (9,100, videonavqa_tpu/models/film.py) the JAX package
# runs the 1x1 conv through its fused kernel, which requantizes the 3x3
# conv's input from the f32 result; above it, through its plain route, where
# the 3x3 conv quantizes the result as stored at the compute dtype. The fused
# kernel here takes either source, so every row count gets JAX's int8 codes.
INT8_REQUANT_F32_MAX_ROWS = 9100

def init_film_trunk(gen, cfg):
    """conv_init + bn_init + N x (conv3x3, conv1x1)."""
    ch = cfg.num_res_block_channels
    params = {"conv_init": init.reference_conv2d(gen, 3, 3, cfg.num_input_channels, ch)}
    params["bn_init"], bn_state = init.init_bn(ch)
    for k in range(cfg.num_res_blocks):
        params[f"conv3x3_{k}"] = init.reference_conv2d(gen, 3, 3, ch, ch)
        params[f"conv1x1_{k}"] = init.reference_conv2d(gen, 1, 1, ch, ch)
    return params, {"bn_init": bn_state}


def _trunk_convs(params, state, cfg, rows, new_state, train=False):
    """(conv, block_convs) of the trunk's mode; block_convs is None unless the
    fused int8 1x1 kernel runs (at any trunk width). Training takes the
    plain convs: no calibration and no int8."""
    dtype = DTYPES[cfg.compute_dtype]
    if train:
        return (lambda p, x, name: conv2d(p, x, dtype=dtype)), None
    if cfg.int8_trunk_calibrate:
        captured, captured_wq = {}, {}
        new_state["int8_scales"] = captured
        new_state["int8_wq"] = captured_wq

        def conv(p, x, name):
            captured[name] = 1.25 * max_over_batch(torch.amax(torch.abs(x.float())))
            wq, sw = quantize_weight_channelwise(p["weight"])
            captured_wq[name] = {"wq": wq, "scale": sw}
            return conv2d(p, x, dtype=torch.float32)

        return conv, None
    if not cfg.use_int8_trunk:
        return (lambda p, x, name: conv2d(p, x, dtype=dtype)), None

    scales, wqs = state.get("int8_scales"), state.get("int8_wq")
    if scales is None:   # dynamic: this batch's absmax, weights quantized each call
        return (lambda p, x, name: conv2d_int8_dynamic(p, x, out_dtype=dtype)), None
    if wqs is None:      # static: calibrated absmax, weights quantized each call
        return (lambda p, x, name: conv2d_int8_static(p, x, scales[name], out_dtype=dtype)), \
            None

    def conv(p, x, name):
        return conv2d_int8_prequant(wqs[name]["wq"], wqs[name]["scale"], p.get("bias"),
                                    x, scales[name], out_dtype=dtype)

    if not (cfg.use_pallas_kernels and rows <= INT8_FUSED_MAX_ROWS):
        return conv, None
    # the JAX package's route at the global batch's count
    requant_stored = batch_rows(rows)[0] > INT8_REQUANT_F32_MAX_ROWS

    def block_convs(k, x, p1x1, p3x3):
        n1, n3 = f"conv1x1_{k}", f"conv3x3_{k}"
        res, resq = matmul_int8_fused(
            x, wqs[n1]["wq"][:, :, 0, 0], wqs[n1]["scale"], p1x1.get("bias"),
            scales[n1], relu=True, next_absmax=scales[n3], out_dtype=dtype,
            requant_stored=requant_stored)
        y = conv2d_int8_preq_act(wqs[n3]["wq"], wqs[n3]["scale"], p3x3.get("bias"),
                                 resq, scales[n3], out_dtype=dtype)
        return res, y

    return conv, block_convs


def film_trunk(params, state, feats, film_values, frame_mask, cfg, *, train=False):
    """feats [B,T,10,13,Cin], film_values [B,T,2*C*N] -> ([B,T,10,13,C], new_state).

    Conv outputs are stored at the compute dtype, BN works in f32, and the
    FiLM values are cast to the conv output's dtype. ``cfg.freeze_film_conv1x1``
    detaches the 1x1 convs' parameters; ``cfg.remat_film_blocks`` recomputes
    each block in the backward pass instead of keeping its activations."""
    B, T = feats.shape[:2]
    ch = cfg.num_res_block_channels
    new_state = dict(state)
    conv, block_convs = _trunk_convs(params, state, cfg,
                                     B * T * feats.shape[2] * feats.shape[3], new_state, train)
    if block_convs is None:
        def block_convs(k, x, p1x1, p3x3):
            res = torch.relu(conv(p1x1, x, f"conv1x1_{k}"))
            return res, conv(p3x3, res, f"conv3x3_{k}")

    def block(k, x, p1x1, p3x3, alphas, betas):
        res, y = block_convs(k, x, p1x1, p3x3)
        a = alphas.to(y.dtype)[:, None, None, :]
        b = betas.to(y.dtype)[:, None, None, :]
        return torch.relu(a * y + b) + res

    if cfg.remat_film_blocks and train:
        run_block = lambda *args: checkpoint(block, *args, use_reentrant=False)
    else:
        run_block = block

    x = torch.relu(conv(params["conv_init"], feats.reshape(B * T, *feats.shape[2:]),
                        "conv_init"))
    x, new_state["bn_init"] = frame_batch_norm(
        params["bn_init"], state["bn_init"], x.reshape(B, T, *x.shape[1:]), frame_mask,
        train=train)
    x = x.reshape(B * T, *x.shape[2:])
    fv = film_values.reshape(B * T, -1)
    for k in range(cfg.num_res_blocks):
        p1x1 = params[f"conv1x1_{k}"]
        if cfg.freeze_film_conv1x1:
            p1x1 = {name: t.detach() for name, t in p1x1.items()}
        x = run_block(k, x, p1x1, params[f"conv3x3_{k}"],
                      fv[:, 2 * k * ch: 2 * k * ch + ch], fv[:, 2 * k * ch + ch: 2 * (k + 1) * ch])
    return x.reshape(B, T, *x.shape[1:]), new_state


def init_film_generator(gen, cfg, total_out):
    """Embedding + encoder (LSTM, or the BoW Linear) + decoder Linear."""
    params = {"embed": {"weight": init.normal(gen, (cfg.vocab_size, cfg.embed_size))}}
    if cfg.q_encoder == "lstm":
        params["encoder"] = init.reference_lstm(gen, cfg.embed_size, cfg.hidden_size)
    else:
        params["encoder"] = init.reference_linear(gen, cfg.hidden_size, cfg.embed_size)
    params["decoder"] = init.reference_linear(gen, total_out, cfg.hidden_size)
    return params


def film_values_over_frames(params, q, q_lens, num_frames, cfg, *, padding_idx=None,
                            use_kernel=False):
    """FiLM (gamma, beta) per frame: [B, T, total_out] f32.

    ``padding_idx`` is the embedding's: film_gp_pt's is 0 (padded positions
    embed to zero; under BoW they still add the encoder's bias), film_attn_pt
    has none (padded positions look up the live row 0).

    LSTM encoder: one question re-encode per frame with carried (h, c). The
    token projection is the same for every frame: one matmul, then the whole
    num_frames x q_len double recurrence, as one kernel with ``use_kernel``
    (kernels/film_reencode.py). BoW encoder: the Linear of each token summed
    over all positions (the reference's mean division is discarded), the
    same for every frame; it runs no kernel."""
    enc_p = params["encoder"]
    emb = embedding(params["embed"], q, padding_idx=padding_idx)
    if cfg.q_encoder != "lstm":
        enc = linear(enc_p, emb).sum(dim=1)   # [B,H]
        enc = enc[:, None, :].expand(enc.shape[0], num_frames, enc.shape[1])
        return torch.relu(linear(params["decoder"], enc))
    xw = linear({"weight": enc_p["w_ih"], "bias": enc_p["b_ih"]}, emb)  # [B,Tq,4H]
    run = film_reencode if use_kernel else film_reencode_plain
    enc = run(xw.transpose(0, 1).contiguous(), enc_p["w_hh"].float().contiguous(),
              enc_p["b_hh"].float().contiguous(), q_lens.to(torch.int32), num_frames)
    return torch.relu(linear(params["decoder"], enc.transpose(0, 1)))


def _check_reencode(cfg, q, use_kernels):
    """Off the CPU, refuse a re-encode shape the card cannot hold (more than
    65,535 batch rows up to hidden size 128, or a row of h past one SM's
    shared memory) before any kernel runs (the BoW encoder runs none)."""
    if use_kernels and cfg.q_encoder == "lstm" and q.device.type != "cpu":
        check_reencode_shape(q.shape[0], cfg.hidden_size)


def init_film_gp(gen, cfg, device):
    """(params, state) of film_gp_pt from a CPU ``torch.Generator``, moved to
    ``device``."""
    total_out = 2 * cfg.num_res_block_channels * cfg.num_res_blocks
    params = init_film_generator(gen, cfg, total_out)
    params["trunk"], trunk_state = init_film_trunk(gen, cfg)
    params["c1x1_tail"] = init.reference_conv2d(gen, 1, 1, cfg.num_res_block_channels,
                                                cfg.num_tail_channels)
    params["out_linear"] = init.reference_linear(
        gen, cfg.num_classes, C.STEM_OUT_POSITIONS * cfg.num_tail_channels)
    return tree_to(params, device), tree_to({"trunk": trunk_state}, device)


def apply_film_gp(params, state, batch, cfg, *, train=False, generator=None):
    """batch (see models/base.py) -> (logits [B, num_classes], new_state).
    The eval forward runs the re-encode (LSTM encoder) and the fused int8
    1x1 conv (calibrated int8 trunk) through their kernels where
    ``cfg.use_pallas_kernels`` asks for them; the train forward runs none."""
    feats, v_lens = batch["v_features"], batch["v_len"]
    q, q_lens = batch["question"], batch["q_len"]
    B, T = feats.shape[:2]
    use_kernels = cfg.use_pallas_kernels and not train
    _check_reencode(cfg, q, use_kernels)
    frame_mask = length_mask(v_lens, T)

    films = film_values_over_frames(params, q, q_lens, T, cfg, padding_idx=0,
                                    use_kernel=use_kernels)
    x, trunk_state = film_trunk(params["trunk"], state["trunk"], feats, films,
                                frame_mask, cfg, train=train)
    x = torch.relu(conv2d(params["c1x1_tail"], x.reshape(B * T, *x.shape[2:]),
                          dtype=DTYPES[cfg.compute_dtype]))
    # invalid frames zero, then the max over frames (post-ReLU values are >=
    # 0, so the zeros are the reference's zero-padded rows); the max commutes
    # with the CHW flatten, which linear_chw takes care of
    x = mask_invalid(x.reshape(B, T, *x.shape[1:]), v_lens)
    return linear_chw(params["out_linear"], x.amax(dim=1)), {"trunk": trunk_state}


register_model("film_gp_pt", init_film_gp, apply_film_gp,
               needs_video=True, needs_question=True, uses_stem=True)


def init_film_attn(gen, cfg, device):
    """(params, state) of film_attn_pt from a CPU ``torch.Generator``, moved
    to ``device``."""
    total_out = 2 * cfg.num_res_block_channels * cfg.num_res_blocks
    params = init_film_generator(gen, cfg, total_out)
    params["trunk"], trunk_state = init_film_trunk(gen, cfg)
    dim = C.STEM_OUT_POSITIONS * cfg.num_res_block_channels
    params["fc_embed_attn"] = init.reference_linear(gen, cfg.at_hidden_size, dim)
    params["fc_attn_1"] = init.reference_linear(gen, 1, cfg.at_hidden_size)
    params["fc_hidden_attn"] = init.reference_linear(gen, 1, cfg.at_hidden_size)
    params["lstm_attn"] = init.reference_lstm(gen, cfg.at_hidden_size, cfg.at_hidden_size)
    params["out_linear"] = init.reference_linear(
        gen, cfg.num_classes, cfg.max_num_frames * cfg.at_hidden_size)
    return tree_to(params, device), tree_to({"trunk": trunk_state}, device)


def apply_film_attn(params, state, batch, cfg, *, train=False, generator=None):
    """batch (see models/base.py) -> (logits [B, num_classes], new_state).
    The eval forward runs the kernels where ``cfg.use_pallas_kernels`` asks
    for them; off the CPU a re-encode shape the card cannot hold is refused
    here, before any kernel runs. The train forward runs none."""
    feats, v_lens = batch["v_features"], batch["v_len"]
    q, q_lens = batch["question"], batch["q_len"]
    B, T = feats.shape[:2]
    use_kernels = cfg.use_pallas_kernels and not train
    _check_reencode(cfg, q, use_kernels)
    frame_mask = length_mask(v_lens, T)

    # film_attn_pt's embedding has no padding_idx
    films = film_values_over_frames(params, q, q_lens, T, cfg, use_kernel=use_kernels)
    x, trunk_state = film_trunk(params["trunk"], state["trunk"], feats, films,
                                frame_mask, cfg, train=train)

    # per-frame feature embedding; invalid frames zero
    all_features = mask_invalid(linear_chw(params["fc_embed_attn"], x), v_lens)
    # scores at invalid frames stay exactly 0: the bias is not applied there
    scores = torch.where(frame_mask, linear(params["fc_attn_1"], all_features)[..., 0], 0.0)
    mask = attn_frame_mask(v_lens, T)  # [B,T], 0 beyond batch max (quirk)
    # frames trimmed away by a length bucket are the reference's "beyond batch
    # max" frames: zero features, score and mask; they add n_phantom * exp(v)
    # to the softmax normalizer and nothing to the context
    n_phantom = float(cfg.max_num_frames - T)

    run = attn_tail if use_kernels else attn_tail_plain
    # the LSTMCell runs all max_num_frames steps, whatever the trim
    hs = run(params, all_features, scores, mask, cfg.max_num_frames, n_phantom)
    return linear(params["out_linear"], hs.reshape(B, -1)), {"trunk": trunk_state}


register_model("film_attn_pt", init_film_attn, apply_film_attn,
               needs_video=True, needs_question=True, uses_stem=True)
