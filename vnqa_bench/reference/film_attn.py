"""film_attn_pt's eval forward, plain (VideoNavQA's FiLM model with the
attention tail; catalina17/VideoNavQA, eval.sh's film_attn_pt preset).

  question: Embedding -> LSTM re-encoded once per frame, (h, c) carried from
            frame to frame; each pass's last valid h -> Linear -> ReLU gives
            the FiLM (gamma, beta) of every block at that frame
  per frame: conv3x3(512 -> C) -> ReLU -> BN, then N blocks of
            res = ReLU(conv1x1(x)); y = conv3x3(res); x = ReLU(gamma*y + beta) + res
  tail:     per-frame Linear embedding (CHW flatten) and score; 35 steps of a
            masked softmax over frames feeding an LSTMCell; Linear over all
            35 hidden states -> logits

Served with a static int8 trunk: ``calibrate`` runs the trunk in float32 on a
calibration batch and records 1.25 x each conv's input absmax; ``forward``
then quantizes each conv's input with that absmax and its weight per output
channel, sums the integer products exactly, and stores the result in bf16
(``REQUANT_F32_MAX_ROWS`` says which value of the 1x1 conv's result the 3x3
conv quantizes).
The frame axis may be trimmed below 35 frames: the trimmed frames are
"phantom" frames with zero features, score and mask, which add to the
softmax normaliser only. Frames between a row's length and the batch's
longest video are masked; frames past the batch's longest are not (the
reference code's quirk).
"""

from __future__ import annotations

import torch

from vnqa_bench.reference.ops import (
    NEG_MASK, REF, batch_norm_eval, conv2d, exact_f32, int8_conv, linear, lstm_step, matmul)

MAX_FRAMES = 35
# The route rule of the served int8 trunk (the JAX package's, kept by the
# port): at or under this many folded rows (B x T x 130) the 3x3 conv's input
# is quantized from the 1x1 conv's float32 result, above it from the result
# as stored in bf16.
REQUANT_F32_MAX_ROWS = 9100


def shapes(cfg):
    """{leaf path: shape} of film_attn_pt's parameters in the layouts the
    measured package's checkpoints use, and of its state."""
    C, Cin, N = cfg["num_res_block_channels"], cfg["num_input_channels"], cfg["num_res_blocks"]
    E, H, A = cfg["embed_size"], cfg["hidden_size"], cfg["at_hidden_size"]
    lstm = lambda i, h: {"w_ih": (4 * h, i), "w_hh": (4 * h, h), "b_ih": (4 * h,),
                         "b_hh": (4 * h,)}
    lin = lambda o, i: {"weight": (o, i), "bias": (o,)}
    conv = lambda o, i, k: {"weight": (o, i, k, k), "bias": (o,)}
    trunk = {"conv_init": conv(C, Cin, 3), "bn_init": {"weight": (C,), "bias": (C,)}}
    for k in range(N):
        trunk[f"conv3x3_{k}"] = conv(C, C, 3)
        trunk[f"conv1x1_{k}"] = conv(C, C, 1)
    params = {"embed": {"weight": (cfg["vocab_size"], E)}, "encoder": lstm(E, H),
              "decoder": lin(2 * C * N, H), "trunk": trunk,
              "fc_embed_attn": lin(A, 130 * C), "fc_attn_1": lin(1, A),
              "fc_hidden_attn": lin(1, A), "lstm_attn": lstm(A, A),
              "out_linear": lin(cfg["num_classes"], MAX_FRAMES * A)}
    state = {"trunk": {"bn_init": {"mean": (C,), "var": (C,)}}}
    return params, state


def film_values(params, q, q_lens, frames, prec=REF):
    """[B, frames, 2*C*N] f32: the question re-encoded once per frame."""
    enc = params["encoder"]
    emb = params["embed"]["weight"].float()[q.long()]
    xw = matmul(emb, enc["w_ih"].t(), prec) + enc["b_ih"].float()
    steps = int(q_lens.max())
    h = c = torch.zeros((q.shape[0], enc["w_hh"].shape[1]), device=q.device)
    finals = []
    for _ in range(frames):
        last = torch.zeros_like(h)
        for t in range(steps):
            gates = xw[:, t] + matmul(h, enc["w_hh"].t(), prec) + enc["b_hh"].float()
            i, f, g, o = gates.chunk(4, dim=-1)
            c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h2 = torch.sigmoid(o) * torch.tanh(c2)
            live = (t < q_lens)[:, None]
            h, c = torch.where(live, h2, h), torch.where(live, c2, c)
            last = torch.where((t == q_lens - 1)[:, None], h2, last)
        finals.append(last)
    enc_out = torch.stack(finals, dim=1)
    return torch.relu(linear(params["decoder"], enc_out, prec))


def _blocks(cfg):
    return range(cfg["num_res_blocks"])


def calibrate(params, state, batch, cfg, prec=REF):
    """{conv name: 1.25 x its input's absmax} of the float32 trunk on ``batch``."""
    with exact_f32():
        feats = batch["v_features"]
        B, T = feats.shape[:2]
        p = params["trunk"]
        films = film_values(params, batch["question"], batch["q_len"], T, prec)
        fv = films.reshape(B * T, -1)
        C = cfg["num_res_block_channels"]
        absmax = {}
        x = feats.reshape(B * T, *feats.shape[2:]).float()
        absmax["conv_init"] = 1.25 * x.abs().amax()
        x = torch.relu(conv2d(p["conv_init"], x, torch.float32))
        x = batch_norm_eval(p["bn_init"], state["trunk"]["bn_init"], x)
        for k in _blocks(cfg):
            absmax[f"conv1x1_{k}"] = 1.25 * x.abs().amax()
            res = torch.relu(conv2d(p[f"conv1x1_{k}"], x, torch.float32))
            absmax[f"conv3x3_{k}"] = 1.25 * res.abs().amax()
            y = conv2d(p[f"conv3x3_{k}"], res, torch.float32)
            a = fv[:, 2 * k * C:2 * k * C + C][:, None, None, :]
            b = fv[:, 2 * k * C + C:2 * (k + 1) * C][:, None, None, :]
            x = torch.relu(a * y + b) + res
        return absmax


def forward(params, state, batch, absmax, cfg, prec=REF, dtype=torch.bfloat16):
    """logits [B, num_classes] of a padded batch through the static int8 trunk."""
    with exact_f32():
        feats, v_lens = batch["v_features"], batch["v_len"]
        B, T = feats.shape[:2]
        p = params["trunk"]
        C = cfg["num_res_block_channels"]
        levels = prec.trunk_levels
        fv = film_values(params, batch["question"], batch["q_len"], T, prec).reshape(B * T, -1)
        x = feats.reshape(B * T, *feats.shape[2:])
        x = torch.relu(int8_conv(p["conv_init"], x, absmax["conv_init"], dtype, levels))
        x = batch_norm_eval(p["bn_init"], state["trunk"]["bn_init"], x)
        # the 3x3 conv's codes come from the 1x1's result as stored, or, at
        # or under REQUANT_F32_MAX_ROWS folded rows, from its float32 value
        from_f32 = B * T * feats.shape[2] * feats.shape[3] <= REQUANT_F32_MAX_ROWS
        for k in _blocks(cfg):
            res32 = torch.relu(int8_conv(p[f"conv1x1_{k}"], x, absmax[f"conv1x1_{k}"],
                                         torch.float32, levels))
            res = res32.to(dtype)
            y = int8_conv(p[f"conv3x3_{k}"], res32 if from_f32 else res, absmax[f"conv3x3_{k}"],
                          dtype, levels)
            a = fv[:, 2 * k * C:2 * k * C + C].to(dtype)[:, None, None, :]
            b = fv[:, 2 * k * C + C:2 * (k + 1) * C].to(dtype)[:, None, None, :]
            x = torch.relu(a * y + b) + res
        x = x.reshape(B, T, *x.shape[1:])
        return tail(params, x, v_lens, prec)


def tail(params, x, v_lens, prec=REF):
    """The attention tail over trunk output x [B, T, 10, 13, C] -> logits."""
    B, T = x.shape[:2]
    t_idx = torch.arange(T, device=x.device)[None, :]
    valid = t_idx < v_lens[:, None]
    flat = x.float().permute(0, 1, 4, 2, 3).reshape(B, T, -1)        # CHW order
    feats = torch.where(valid[..., None], linear(params["fc_embed_attn"], flat, prec), 0.0)
    scores = torch.where(valid, linear(params["fc_attn_1"], feats, prec)[..., 0], 0.0)
    mask = torch.where((t_idx < v_lens.max()) & ~valid, NEG_MASK, 0.0)
    phantom = float(MAX_FRAMES - T)
    A = feats.shape[-1]
    h = c = torch.zeros((B, A), device=x.device)
    hs = []
    for _ in range(MAX_FRAMES):
        v = linear(params["fc_hidden_attn"], h, prec)                  # [B, 1]
        logits = v + scores + mask
        m = logits.amax(dim=1, keepdim=True)
        if phantom > 0:
            m = torch.maximum(m, v)
        e = torch.exp(logits - m)
        denom = e.sum(dim=1, keepdim=True)
        if phantom > 0:
            denom = denom + phantom * torch.exp(v - m)
        ctx = matmul((e / denom)[:, None, :], feats, prec)[:, 0]
        h, c = lstm_step(params["lstm_attn"], ctx, h, c, prec)
        hs.append(h)
    return linear(params["out_linear"], torch.stack(hs, dim=1).reshape(B, -1), prec)
