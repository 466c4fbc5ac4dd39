"""The int8 frozen stem (the port of videonavqa_tpu/stem/quant.py).

The frozen VGG-16 partial and ObjDetectCNN stem, with every conv in int8:

- weights per output channel, symmetric (``quantize_stem``, once per weights
  version);
- activations per tensor, symmetric: a static scale from a calibration pass,
  or, without one, the batch's own absmax at every call;
- the convs sum int8 x int8 in int32 (``ops/quant.py conv_i8``: an im2col and
  ``torch._int_mm``), dequantized by ``acc * (s_x * s_w[c])``, then the bias;
- the eval-mode BatchNorms as one affine per channel, from ``rsqrt``.

Two calibrations, as the JAX package's: ``calibrate_act_scales`` (each conv
input's absmax times 1.1) and ``calibrate_stem_quant`` (per-input-channel
equalization, the 99.99th percentile as the clip, and per-output-channel
bias correction, over at most 128 frames). Their f32 walks run with TF32 off
on the card, so the bias deltas carry no TF32 error.

The JAX package computes these convs with XLA, outside any Pallas kernel, so
the port runs them in plain PyTorch; no kernel is launched here (VGG block
1 is quantized too, so ``vgg_block1`` is not on this route). The arithmetic
follows JAX's op for op: ``round(x / scale)`` for a dynamic scale,
``round(h * m)`` for a static one, ``acc * (s_x * s_w)`` then ``+ bias``, all
in f32 and half to even. With JAX's ``qstem`` (``utils/checkpoint.py
qstem_from_jax``) the VGG stage is the same to the bit.
"""

from __future__ import annotations

import contextlib

import torch

from videonavqa_tpu_torch.ops.conv import conv2d, max_pool2d
from videonavqa_tpu_torch.ops.norm import EPS
from videonavqa_tpu_torch.ops.quant import (
    conv_i8, quantize_act_dynamic, quantize_weight_channelwise)
from videonavqa_tpu_torch.stem.vgg import VGG_PARTIAL_CFG

# frames of one pass of ``stem_features_int8`` where every layer has a static
# scale (a dynamic scale is the absmax of the whole batch, which chunks would
# change): bounds the f32 activations, 8.5 MB a frame after conv1_1
FRAME_CHUNK = 256


def _f32(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _quantize_weight(w):
    """OIHW kernel -> (int8 kernel, per-out-channel f32 scale)."""
    return quantize_weight_channelwise(w)


def _quantize_act(x):
    """f32 activations -> (int8, scalar scale), per-tensor dynamic symmetric."""
    return quantize_act_dynamic(x)


def _conv_int8(xq, wq, sx, sw):
    """int8 SAME conv -> f32 ``acc * (sx * sw)``, each int32 cast to f32 as it
    is multiplied."""
    return conv_i8(xq, wq) * (_f32(sx, sw.device) * sw)


def _bn_affine(state, params):
    """Eval-mode BN as (scale, shift) per channel."""
    inv = torch.rsqrt(state["var"].float() + EPS)
    scale = params["weight"].float() * inv
    shift = params["bias"].float() - state["mean"].float() * scale
    return scale, shift


#: conv layer names in forward order (10 conv inputs to calibrate)
_CONV_ORDER = tuple(item[0] for item in VGG_PARTIAL_CFG if item != "M") + tuple(
    f"conv{b}{i}" for b in range(1, 4) for i in (1, 2))


def _act_multiplier(s, e, device):
    """``1 / s``, or ``(1 / s) / e`` per input channel where equalized, in f32
    as JAX forms it (a true division, not torch's reciprocal-times of a
    scalar over a tensor)."""
    m = _f32(1.0 / s, device)
    return m if e is None else m / e


def quantize_stem(vgg_params, det_params, act_scales=None):
    """int8 weights and per-channel scales of both stem stages.

    ``act_scales``: None (dynamic activation scales), ``{conv_name: float}``
    from ``calibrate_act_scales``, or the rich dict of ``calibrate_stem_quant``
    (``scales``, ``eq``, ``bias_delta``). -> ``{"vgg": {name: layer}, "det":
    {name: layer}, "act_scales": scales}``, each layer ``{"wq": int8 OIHW,
    "sw": [O] f32, "bias": [O] f32}`` and, with static scales, ``"aq": {"m",
    "s"}`` (the activation multiplier, scalar or per input channel, and the
    dequantization scale), on the weights' device."""
    rich = act_scales is not None and "scales" in act_scales
    scales = act_scales["scales"] if rich else act_scales
    eq = act_scales.get("eq", {}) if rich else {}
    bias_delta = act_scales.get("bias_delta", {}) if rich else {}
    q = {"vgg": {}, "det": {}, "act_scales": scales}

    def build(stage, name, params):
        w, bias = params["weight"].float(), params["bias"].float()
        e = eq.get(name)
        if e is not None:
            w = w * e[None, :, None, None]
        wq, sw = _quantize_weight(w)
        layer = {"wq": wq, "sw": sw, "bias": bias}
        db = bias_delta.get(name)
        if db is not None:
            layer["bias"] = bias + db
        if scales is not None:
            s = scales[name]
            layer["aq"] = {"m": _act_multiplier(s, e, w.device), "s": _f32(s, w.device)}
        q[stage][name] = layer

    for item in VGG_PARTIAL_CFG:
        if item != "M":
            build("vgg", item[0], vgg_params[item[0]])
    for b in range(1, 4):
        for c in (f"conv{b}1", f"conv{b}2"):
            build("det", c, det_params[c])
    return q


@contextlib.contextmanager
def _exact_f32():
    """TF32 off for cuDNN and matmuls within, the settings restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _calib_walk(vgg_params, det_params, det_state, videos, hook):
    """Run the f32 stem over ``videos`` [B, T, H, W, 3], calling hook(name,
    params, x, out) at every conv (x = conv input, out = f32 conv output with
    its bias, pre-activation); the hook's return value replaces ``out``. The
    layer structure is ``stem_features_int8``'s."""
    B, T = videos.shape[:2]
    h = videos.reshape(B * T, *videos.shape[2:]).float()
    with torch.no_grad(), _exact_f32():
        for item in VGG_PARTIAL_CFG:
            if item == "M":
                h = max_pool2d(h)
                continue
            name = item[0]
            p = vgg_params[name]
            h = torch.relu(hook(name, p, h, conv2d(p, h, dtype=torch.float32)))
        scale, shift = _bn_affine(det_state["bn_input"], det_params["bn_input"])
        h = h * scale + shift
        for b in range(1, 4):
            for c in (f"conv{b}1", f"conv{b}2"):
                p = det_params[c]
                h = hook(c, p, h, conv2d(p, h, dtype=torch.float32))
            scale, shift = _bn_affine(det_state[f"bn{b}"], det_params[f"bn{b}"])
            h = torch.relu(h * scale + shift)
            if b < 3:
                h = max_pool2d(h)


# frames of one calibrate_act_scales walk: an absmax is the largest of its
# chunks' absmaxes, so chunking changes nothing and bounds the f32 walk
_ABSMAX_CHUNK = 128


def calibrate_act_scales(vgg_params, det_params, det_state, videos, margin=1.1):
    """Run the f32 stem over calibration videos, recording each conv input's
    absmax -> {conv_name: max(absmax * margin, 1e-6) / 127}. ``videos``:
    [B, T, 160, 208, 3] f32 (pixels /255)."""
    absmax = {}

    def record(name, params, x, out):
        a = float(torch.amax(torch.abs(x)))
        absmax[name] = max(absmax.get(name, 0.0), a)
        return out

    frames = videos.reshape(-1, *videos.shape[2:])
    for chunk in frames.split(_ABSMAX_CHUNK):
        _calib_walk(vgg_params, det_params, det_state, chunk[None], record)
    return {name: max(a * margin, 1e-6) / 127.0 for name, a in absmax.items()}


def percentile_linear(x, p):
    """``jnp.percentile(x, p)`` (its default 'linear' method) over all of x,
    in the f32 arithmetic XLA compiles it to: the position ``p * c``, with
    ``p / 100 * (n - 1)`` rewritten so and the constant ``c = (n - 1) *
    0.01`` folded in f32, then the values at its floor and ceiling in sorted
    order, weighted ``1 - frac`` and ``frac``.

    ``torch.quantile`` refuses more than 2**24 elements; here only the top
    ``n - floor`` values are selected (``topk``), few for a high percentile."""
    flat = x.reshape(-1)
    n = flat.numel()
    c = (_f32(float(n), flat.device) - 1) * _f32(0.01, flat.device)
    pos = _f32(p, flat.device) * c
    low, high = torch.floor(pos), torch.ceil(pos)
    high_weight = pos - low
    low_weight = 1 - high_weight
    lo = min(max(int(low), 0), n - 1)
    hi = min(max(int(high), 0), n - 1)
    if n - lo <= hi + 1:
        top = torch.topk(flat, n - lo).values           # descending: top[-1] = sorted[lo]
        low_value, high_value = top[-1], top[-1 - (hi - lo)]
    else:
        bottom = torch.topk(flat, hi + 1, largest=False).values   # ascending
        low_value, high_value = bottom[lo], bottom[hi]
    fused = high_value.double() * high_weight.double() + (low_value * low_weight).double()
    return fused.float()


def calibrate_stem_quant(vgg_params, det_params, det_state, videos, *,
                         percentile=99.99, equalize=True, bias_correct=True,
                         max_frames=128):
    """The improved static int8 calibration: per-input-channel equalization
    (x' = x / e, w' = w * e, e = sqrt(a_c / w_c) clipped to [2^-6, 2^6]),
    the ``percentile`` of |x'| as each per-tensor clip (0 or None: the
    max times 1.1), and per-output-channel bias correction (the mean of the
    f32 conv output minus its int8 simulation, folded into the bias). Over
    the first ``max_frames`` frames of the batch. -> the rich act_scales
    dict of ``quantize_stem``: ``{"scales", "eq", "bias_delta"}``."""
    B, T = videos.shape[:2]
    if B * T > max_frames:
        videos = videos.reshape(B * T, *videos.shape[2:])[:max_frames][None]

    scales, eq, bias_delta = {}, {}, {}

    def record(name, params, x, out):
        a = torch.amax(torch.abs(x), dim=tuple(range(x.ndim - 1)))
        if equalize:
            a = torch.maximum(a, 1e-5 * torch.max(a))
            w_in = torch.amax(torch.abs(params["weight"].float()), dim=(0, 2, 3))
            w_in = torch.maximum(w_in, 1e-5 * torch.max(w_in))
            e = torch.clamp(torch.sqrt(a / w_in), 2.0 ** -6, 2.0 ** 6)
            eq[name] = e
            if percentile:
                amax = percentile_linear(torch.abs(x / e), percentile)
            else:
                amax = torch.max(a / e) * 1.1
        else:
            amax = (percentile_linear(torch.abs(x), percentile) if percentile
                    else torch.max(a) * 1.1)
        scales[name] = max(float(amax), 1e-6) / 127.0
        return out

    _calib_walk(vgg_params, det_params, det_state, videos, record)

    if bias_correct:
        def correct(name, params, x, out):
            e = eq.get(name)
            w = params["weight"].float()
            if e is not None:
                w = w * e[None, :, None, None]
            wq, sw = _quantize_weight(w)
            s = scales[name]
            m = _act_multiplier(s, e, x.device)
            xq = torch.clamp(torch.round(x * m), -127, 127).to(torch.int8)
            sim = _conv_int8(xq, wq, s, sw) + params["bias"].float()
            # ``out`` already holds the bias (conv2d adds it)
            bias_delta[name] = torch.mean(out - sim, dim=tuple(range(out.ndim - 1)))
            return out

        _calib_walk(vgg_params, det_params, det_state, videos, correct)

    return {"scales": scales, "eq": eq, "bias_delta": bias_delta}


def _qact(h, layer):
    aq = layer.get("aq")
    if aq is not None:
        # m folds 1/scale and, where equalized, the per-input-channel divisor;
        # s is the matching dequantization scale
        return torch.clamp(torch.round(h * aq["m"]), -127, 127).to(torch.int8), aq["s"]
    return _quantize_act(h)


def _int8_conv_layer(h, layer):
    xq, sx = _qact(h, layer)
    return _conv_int8(xq, layer["wq"], sx, layer["sw"]) + layer["bias"]


def vgg_features_int8(qstem, frames):
    """The VGG stage in int8: frames [N, H, W, 3] f32 -> [N, H/4, W/4, 128]."""
    h = frames
    for item in VGG_PARTIAL_CFG:
        if item == "M":
            h = max_pool2d(h)
        else:
            h = torch.relu(_int8_conv_layer(h, qstem["vgg"][item[0]]))
    return h


def _stem_int8(qstem, det_params, det_state, frames):
    h = vgg_features_int8(qstem, frames)
    # the detector's input BN (eval)
    scale, shift = _bn_affine(det_state["bn_input"], det_params["bn_input"])
    h = h * scale + shift
    for b in range(1, 4):
        for c in (f"conv{b}1", f"conv{b}2"):
            h = _int8_conv_layer(h, qstem["det"][c])
        scale, shift = _bn_affine(det_state[f"bn{b}"], det_params[f"bn{b}"])
        h = torch.relu(h * scale + shift)
        if b < 3:
            h = max_pool2d(h)
    return h


def stem_features_int8(qstem, det_params, det_state, video, *, frame_chunk=FRAME_CHUNK):
    """The int8 counterpart of ``stem_features``: [B, T, 160, 208, 3] f32
    (pixels /255) -> f32 [B, T, 10, 13, num_filters], with no gradient.

    The layers are ``vgg_partial`` and ``obj_detector_features``'s (pools,
    back-to-back convs, BN and ReLU order); only the conv arithmetic is
    quantized. Where every layer has a static scale the frames run in chunks
    of ``frame_chunk``; with a dynamic one the whole batch runs at once."""
    B, T = video.shape[:2]
    frames = video.reshape(B * T, *video.shape[2:]).float()
    static = all("aq" in layer for stage in ("vgg", "det") for layer in qstem[stage].values())
    with torch.no_grad():
        if static and frame_chunk and frame_chunk < frames.shape[0]:
            h = torch.cat([_stem_int8(qstem, det_params, det_state, chunk)
                           for chunk in frames.split(frame_chunk)])
        else:
            h = _stem_int8(qstem, det_params, det_state, frames)
    return h.reshape(B, T, *h.shape[1:])
