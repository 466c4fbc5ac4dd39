"""Video-only C3D 3-D CNN (the port of models/v_only_cnn3d.py), and the trunk
concat3d shares.

BN3d -> conv3d(3->64) + pool(1,2,2) -> BN -> conv3d(64->128) + pool(4,4,4)
-> BN -> conv3d(128->128) + pool(4,4,4) -> BN -> FC 7680->2048 -> BN ->
FC 2048->128 -> BN -> FC 128->num_classes, each conv and FC followed by a
ReLU.

- The reference feeds the clip as [B, 3, 160, 208, 35], so torch's Conv3d
  takes (H=160, W=208, T=35) as its (D, H, W) volume: pool1 (1,2,2) halves
  the 208 axis and time. The volume is 160x208x35 -> 160x104x17 -> 40x26x4
  -> 10x6x1, 7,680 features in torch's [C, D, H, W] flatten order.
- ``v_len`` is ignored: padded frames are zeros and flow through the convs
  and BatchNorms.
- The 3-D convs keep torch's default init (the reference's weights_init
  matches only nn.Conv2d); the FCs get Xavier with zero bias.

A frame-bucket-trimmed batch (T < 35) gives the full zero-padded volume's
answer by one of three routes: the zero-run splice (``c3d_trunk_trimmed``,
train and eval), the splice from a precomputed zero-run
(``c3d_trunk_trimmed_cached``, eval, from ``state['c3d_zero']``), or padding
back to 35 frames. Which one runs only moves time: ``SPLICE_MAX_T`` and
``SPLICE_MAX_T_CACHED`` route it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from videonavqa_tpu_torch.models.base import DTYPES, register_model
from videonavqa_tpu_torch.ops import initializers as init
from videonavqa_tpu_torch.ops.conv import conv3d, max_pool3d
from videonavqa_tpu_torch.ops.linear import linear
from videonavqa_tpu_torch.ops.norm import batch_norm, batch_stats, normalize
from videonavqa_tpu_torch.ops.video import normalize_video
from videonavqa_tpu_torch.utils.device import tree_to

_W = 3  # the time axis of the [B, D=160, H=208, W=T, C] volume
_POOLS = ((1, 2, 2), (4, 4, 4), (4, 4, 4))
_STAGES = (("conv1", "bn1"), ("conv2", "bn2"), ("conv3a", "bn3"))

# The largest bucket the in-step zero-run splice takes, and the largest the
# precomputed one takes; longer trimmed batches pad back to 35 frames.
# Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit at batch 32,
# bf16, by chip_smoke.py's sweep_splice_gate (PERF.md, section 6): the full
# volume's forward took 55.0-55.7 ms at every width, the in-step splice 14.8
# ms at T 4 to 55.0 at T 24 and 58.7 at T 26, the cached one 12.4 to 54.0 at
# T 28 and 59.4 at T 30. (The JAX package's 12 and 16 were measured on a TPU
# v5e at batch 8.) At batch 1 the host sets the time and no route wins by
# much: the in-step splice loses at every width there.
SPLICE_MAX_T = 24
SPLICE_MAX_T_CACHED = 28


def init_c3d_trunk(gen, cfg):
    """The C3D trunk's (params, state): bn_input, conv1..conv3a with their
    BNs, fc6 and fc7 with theirs (shared with concat3d)."""
    params, state = {}, {}
    params["bn_input"], state["bn_input"] = init.init_bn(3)
    params["conv1"] = init.torch_default_conv3d(gen, 3, 3, 3, 3, 64)
    params["bn1"], state["bn1"] = init.init_bn(64)
    params["conv2"] = init.torch_default_conv3d(gen, 3, 3, 3, 64, 128)
    params["bn2"], state["bn2"] = init.init_bn(128)
    params["conv3a"] = init.torch_default_conv3d(gen, 3, 3, 3, 128, 128)
    params["bn3"], state["bn3"] = init.init_bn(128)
    params["fc6"] = init.reference_linear(gen, 2048, 7680)
    params["bn6"], state["bn6"] = init.init_bn(2048)
    params["fc7"] = init.reference_linear(gen, 128, 2048)
    params["bn7"], state["bn7"] = init.init_bn(128)
    return params, state


def _volume(video):
    """[B, T, 160, 208, 3] -> the reference's volume [B, 160, 208, T, 3]."""
    return video.permute(0, 2, 3, 1, 4).contiguous()


def c3d_trunk(params, state, video, cfg, *, train):
    """video [B, T, 160, 208, 3] in [0, 1] -> ([B, 128], new_state).

    T == cfg.max_num_frames runs the full volume. A shorter, bucket-trimmed
    batch still has the full zero-padded volume's answer: through the
    precomputed zero-run (eval, T <= SPLICE_MAX_T_CACHED, where the state
    holds ``c3d_zero['T<T>']``), the in-step splice (T <= SPLICE_MAX_T), or
    padded back to the full volume."""
    T = video.shape[1]
    if T < cfg.max_num_frames:
        zc = None
        if not train and T <= SPLICE_MAX_T_CACHED:
            zc = state.get("c3d_zero", {}).get(f"T{T}")
        if zc is not None:
            return c3d_trunk_trimmed_cached(params, state, video, cfg, zc)
        if T <= SPLICE_MAX_T:
            return c3d_trunk_trimmed(params, state, video, cfg, train=train)
        video = F.pad(video, (0, 0, 0, 0, 0, 0, 0, cfg.max_num_frames - T))
    dtype = DTYPES[cfg.compute_dtype]
    new_state = dict(state)
    h, new_state["bn_input"] = batch_norm(params["bn_input"], state["bn_input"], _volume(video),
                                          train=train)
    for (conv, bn), window in zip(_STAGES, _POOLS):
        h = max_pool3d(torch.relu(conv3d(params[conv], h, dtype=dtype)), window)
        h, new_state[bn] = batch_norm(params[bn], state[bn], h, train=train)
    return _c3d_head(params, state, new_state, h, train=train)


def _c3d_head(params, state, new_state, h, *, train):
    """The FC tail: [B, 10, 6, 1, 128] volume -> [B, 128]; torch's [C, D, H,
    W] flatten, so the reference's fc6 weights line up."""
    h = h.permute(0, 4, 1, 2, 3).reshape(h.shape[0], -1)
    h = torch.relu(linear(params["fc6"], h))
    h, new_state["bn6"] = batch_norm(params["bn6"], state["bn6"], h, train=train)
    h = torch.relu(linear(params["fc7"], h))
    h, new_state["bn7"] = batch_norm(params["bn7"], state["bn7"], h, train=train)
    return h, new_state


# --- the zero-run splice ----------------------------------------------------
#
# The reference runs the FULL zero-padded volume through conv3d and BN3d, so
# the padded tail contributes to the answer (conv bias and BN shifts make it
# nonzero). Every value of that tail is input-independent: position w of a
# layer equals what the layer gives on an all-zero video wherever w's
# receptive cone touches only zero frames. So one all-zero example (the
# zero-run) runs beside the batch, each conv runs only over the live prefix
# plus a 2-column zero-run margin, and the zero-run's columns stand in for
# positions >= live. Train-mode BN statistics are taken over the full volume
# materialized (the same reduction as batch_norm on the untrimmed tensor: a
# sum(prefix) + B * sum(tail) split drifts ~1e-5 in f32, which the head's
# batch-sized BNs amplify), and the tail's gradient flows through the
# broadcast zero-run.

def _w_take(xz, lo, hi, B):
    """Zero-run columns [lo, hi) broadcast to batch size B."""
    ext = xz[:, :, :, lo:hi]
    return ext.expand(B, *ext.shape[1:])


def _conv_spliced(p, xr, xz, live, dtype):
    """SAME conv over the live prefix (+2 zero-run margin columns) and over
    the full-width zero-run -> (y_real exact on [0, new_live), y_zero,
    new_live); full[w] == y_zero[w] for w >= new_live."""
    Wf = xz.shape[_W]
    xin = torch.cat([xr, _w_take(xz, live, min(live + 2, Wf), xr.shape[0])], dim=_W)
    keep = min(live + 1, Wf)
    yr = conv3d(p, xin, dtype=dtype)[:, :, :, :keep]
    return yr, conv3d(p, xz, dtype=dtype), keep


def _pool_spliced(xr, xz, live, window):
    """VALID max pool of both; the live prefix is padded with zero-run
    columns to a window multiple so its windows line up with the full
    volume's."""
    s = window[2]
    Wf = xz.shape[_W]
    # ceil for a partial prefix, at most the full pooled width (VALID pooling
    # drops the remainder window once live reaches Wf)
    pooled_live = min(-(-live // s), Wf // s)
    need = pooled_live * s
    if need > live:
        xr = torch.cat([xr, _w_take(xz, live, need, xr.shape[0])], dim=_W)
    return max_pool3d(xr, window), max_pool3d(xz, window), pooled_live


def _bn_spliced(params, state, xr, xz, live, *, train):
    """BatchNorm whose train-mode statistics are batch_norm's over the full
    volume concat(prefix, broadcast zero-run tail), applied to both tensors
    (the zero-run is normalized by the real batch's statistics)."""
    if not train:
        return (batch_norm(params, state, xr, train=False)[0],
                batch_norm(params, state, xz, train=False)[0], state)
    xr32, xz32 = xr.float(), xz.float()
    xfull = torch.cat([xr32, _w_take(xz32, live, xz32.shape[_W], xr.shape[0])], dim=_W)
    mean, var, new_state = batch_stats(state, xfull)
    return normalize(params, xr32, mean, var), normalize(params, xz32, mean, var), new_state


def c3d_trunk_trimmed(params, state, video, cfg, *, train):
    """The full zero-padded volume's trunk output from a trimmed batch
    [B, T, 160, 208, 3] (T < cfg.max_num_frames): conv work scales with T."""
    dtype = DTYPES[cfg.compute_dtype]
    B = video.shape[0]
    xr = _volume(video)
    xz = torch.zeros((1, *xr.shape[1:3], cfg.max_num_frames, xr.shape[4]), dtype=xr.dtype,
                     device=xr.device)
    live = xr.shape[_W]
    new_state = dict(state)
    xr, xz, new_state["bn_input"] = _bn_spliced(params["bn_input"], state["bn_input"], xr, xz,
                                                live, train=train)
    for (conv, bn), window in zip(_STAGES, _POOLS):
        xr, xz, live = _conv_spliced(params[conv], xr, xz, live, dtype)
        xr, xz, live = _pool_spliced(torch.relu(xr), torch.relu(xz), live, window)
        xr, xz, new_state[bn] = _bn_spliced(params[bn], state[bn], xr, xz, live, train=train)
    # the full-geometry volume for the fixed-size flatten
    if live < xz.shape[_W]:
        xr = torch.cat([xr, _w_take(xz, live, xz.shape[_W], B)], dim=_W)
    return _c3d_head(params, state, new_state, xr, train=train)


# --- the precomputed zero-run (serving) -------------------------------------
#
# In eval mode every zero-run value is a function of the weights and the
# stored BN statistics alone, so precompute_c3d_zero_slices runs the chain
# once per weights version and keeps, per bucket width, the columns the
# splice reads (a few MB): a cached step runs only the live prefix's convs.
# Train mode never reads it (its BN statistics depend on the batch, and the
# tail's gradient flows through the in-step zero-run).

def _splice_plan(T, Wf):
    """The column plan of bucket width T, stage by stage, as _conv_spliced and
    _pool_spliced take it: the conv's margin columns, its keep, the pool's
    pad columns -> (plan, the final live width, the final width)."""
    plan = []
    live, W = T, Wf
    for window in _POOLS:
        s = window[2]
        keep = min(live + 1, W)
        pooled_live = min(-(-keep // s), W // s)
        plan.append({"margin": (live, min(live + 2, W)), "keep": keep,
                     "pad": (keep, pooled_live * s)})
        live, W = pooled_live, W // s
    return plan, live, W


def precompute_c3d_zero_slices(params, state, cfg, widths):
    """The eval-mode zero-run's columns that c3d_trunk_trimmed_cached reads,
    for each bucket width T in ``widths`` (0 < T < max_num_frames):
    {"T<T>": {"m1", "p1", "m2", "p2", "m3", "p3", "tail"}}, each [1, ...].
    Kept under ``state['c3d_zero']``; new weights need new columns."""
    dtype = DTYPES[cfg.compute_dtype]
    Wf = cfg.max_num_frames
    dev = params["conv1"]["weight"].device
    with torch.no_grad():
        z = batch_norm(params["bn_input"], state["bn_input"],
                       torch.zeros((1, 160, 208, Wf, 3), device=dev), train=False)[0]
        stages = []   # per stage: (the conv's input, the pool's input)
        for (conv, bn), window in zip(_STAGES, _POOLS):
            zc = torch.relu(conv3d(params[conv], z, dtype=dtype))
            stages.append((z, zc))
            z = batch_norm(params[bn], state[bn], max_pool3d(zc, window), train=False)[0]
        out = {}
        for T in widths:
            if not 0 < T < Wf:
                continue
            plan, live, W = _splice_plan(T, Wf)
            cols = {}
            for k, (st, (z_in, z_pre)) in enumerate(zip(plan, stages), start=1):
                cols[f"m{k}"] = z_in[:, :, :, slice(*st["margin"])].clone()
                cols[f"p{k}"] = z_pre[:, :, :, slice(*st["pad"])].clone()
            cols["tail"] = z[:, :, :, live:W].clone()
            out[f"T{T}"] = cols
    return out


def c3d_trunk_trimmed_cached(params, state, video, cfg, zc):
    """Eval only: the splice with the zero-run's columns read from ``zc``
    (``precompute_c3d_zero_slices(...)['T<T>']``), no zero-run computed."""
    dtype = DTYPES[cfg.compute_dtype]
    B, T = video.shape[:2]
    plan, _, _ = _splice_plan(T, cfg.max_num_frames)

    def cat(x, cols):
        return torch.cat([x, cols.expand(B, *cols.shape[1:])], dim=_W) if cols.shape[_W] else x

    xr = batch_norm(params["bn_input"], state["bn_input"], _volume(video), train=False)[0]
    for k, (st, (conv, bn), window) in enumerate(zip(plan, _STAGES, _POOLS), start=1):
        xr = torch.relu(conv3d(params[conv], cat(xr, zc[f"m{k}"]), dtype=dtype))
        xr = max_pool3d(cat(xr[:, :, :, :st["keep"]], zc[f"p{k}"]), window)
        xr = batch_norm(params[bn], state[bn], xr, train=False)[0]
    return _c3d_head(params, state, dict(state), cat(xr, zc["tail"]), train=False)


def init_fn(gen, cfg, device):
    params, state = init_c3d_trunk(gen, cfg)
    params["fc8"] = init.reference_linear(gen, cfg.num_classes, 128)
    return tree_to(params, device), tree_to(state, device)


def apply_fn(params, state, batch, cfg, *, train=False, generator=None):
    h, new_state = c3d_trunk(params, state, normalize_video(batch["video"]), cfg, train=train)
    return linear(params["fc8"], h), new_state


register_model("v_only_cnn3d", init_fn, apply_fn,
               needs_video=True, needs_question=False, uses_stem=False)
