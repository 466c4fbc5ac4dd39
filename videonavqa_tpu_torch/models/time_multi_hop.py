"""Time multi-hop FiLM model (the port of models/time_multi_hop.py).

The FiLM trunk and global max-pool tail, with the FiLM values decoded per
res-block per frame by a multi-hop attention decoder over the question LSTM
states:

  per frame: re-encode the question (carried LSTM state) -> rnn_states
             [B, Tq, H]; LayerNorm of the last valid state -> context h
  per block: p = h * rnn_states; coefs = softmax(fc_hidden_attn(p));
             h = coefs^T p; film = LayerNorm(fc_attn_out(h))

The decoder needs only the question, so it runs for all frames first: one
LSTM pass per frame, the state carried from frame to frame, all frames
chained in one call (one kernel launch a forward with
``cfg.use_pallas_kernels``), then the hops, which carry nothing across
frames, once over the folded [T*B] rows.
The conv trunk then runs once over the folded [B*T] batch.

The train forward (``train=True``) runs the plain LSTM chain and the plain
trunk in ``compute_dtype`` through autograd, whatever
``cfg.use_pallas_kernels`` says, as the JAX package does: the LSTM kernel has
no backward pass. The trunk's frame BatchNorm then takes batch statistics
and returns the new running ones.

The softmax over words runs to the *batch's* max q_len: positions beyond an
example's own q_len have rnn_states = 0, so their logit is the
fc_hidden_attn bias; positions at t >= max(q_lens) are masked with -inf.
"""

from __future__ import annotations

import torch

from videonavqa_tpu_torch.kernels import lstm as lstm_kernels
from videonavqa_tpu_torch.models.base import DTYPES, register_model
from videonavqa_tpu_torch.models.film import film_trunk, init_film_trunk
from videonavqa_tpu_torch.ops import initializers as init
from videonavqa_tpu_torch.ops.conv import conv2d
from videonavqa_tpu_torch.ops.linear import embedding, linear, linear_chw
from videonavqa_tpu_torch.ops.lstm import last_valid
from videonavqa_tpu_torch.ops.masking import length_mask, mask_invalid, word_softmax_mask
from videonavqa_tpu_torch.ops.norm import init_layer_norm, layer_norm
from videonavqa_tpu_torch.utils import constants as C
from videonavqa_tpu_torch.utils.device import tree_to


def init_fn(gen, cfg, device):
    total_out = 2 * cfg.num_res_block_channels * cfg.num_res_blocks
    params = {
        "embed": {"weight": init.normal(gen, (cfg.vocab_size, cfg.embed_size))},
        "q_encoder": init.reference_lstm(gen, cfg.embed_size, cfg.hidden_size),
        "encoder_norm": init_layer_norm(cfg.hidden_size),
        "fc_hidden_attn": init.reference_linear(gen, 1, cfg.hidden_size),
        "fc_attn_out": init.reference_linear(gen, total_out, cfg.hidden_size),
        "decoder_norm": init_layer_norm(total_out),
        "c1x1_tail": init.reference_conv2d(
            gen, 1, 1, cfg.num_res_block_channels, cfg.num_tail_channels),
        "out_linear": init.reference_linear(
            gen, cfg.num_classes, C.STEM_OUT_POSITIONS * cfg.num_tail_channels),
    }
    params["trunk"], trunk_state = init_film_trunk(gen, cfg)
    return tree_to(params, device), tree_to({"trunk": trunk_state}, device)


def film_values_all_frames(params, q, q_lens, num_frames, cfg, *, use_kernel=False):
    """Per-frame FiLM values [B, T, 2*C*N]: block k's slice [2kC, 2(k+1)C) is
    taken from block k's own decode, the layout film_trunk slices. The LSTM
    chain over the frames is one kernel launch with ``use_kernel``, else the
    plain loop."""
    B, Tq = q.shape
    ch = cfg.num_res_block_channels
    emb = embedding(params["embed"], q, padding_idx=0)
    enc = params["q_encoder"]
    xw = linear({"weight": enc["w_ih"], "bias": enc["b_ih"]}, emb).transpose(0, 1).contiguous()
    w_hh, b_hh = enc["w_hh"].float().contiguous(), enc["b_hh"].float().contiguous()
    lens = q_lens.to(torch.int32)
    run = lstm_kernels.lstm_frames if use_kernel else lstm_kernels.lstm_frames_plain
    zeros = torch.zeros((B, cfg.hidden_size), dtype=torch.float32, device=q.device)
    states, _, _ = run(xw, w_hh, b_hh, lens, zeros, zeros, num_frames)   # [T, Tq, B, H]
    # frames folded into the rows: [T*B, Tq, H]
    rnn_states = states.transpose(1, 2).reshape(num_frames * B, Tq, -1)
    ctx = layer_norm(params["encoder_norm"], last_valid(rnn_states, q_lens.repeat(num_frames)))
    word_mask = word_softmax_mask(q_lens, Tq)
    values = []
    for k in range(cfg.num_res_blocks):
        p = ctx[:, None, :] * rnn_states
        logits = linear(params["fc_hidden_attn"], p)[..., 0] + word_mask
        ctx = torch.einsum("bt,bth->bh", torch.softmax(logits, dim=1), p)
        film = layer_norm(params["decoder_norm"], linear(params["fc_attn_out"], ctx))
        values.append(film[:, 2 * k * ch: 2 * (k + 1) * ch])
    return torch.cat(values, dim=-1).reshape(num_frames, B, -1).transpose(0, 1)


def apply_fn(params, state, batch, cfg, *, train=False, generator=None):
    feats, v_lens = batch["v_features"], batch["v_len"]
    B, T = feats.shape[:2]
    films = film_values_all_frames(params, batch["question"], batch["q_len"], T, cfg,
                                   use_kernel=cfg.use_pallas_kernels and not train)
    x, trunk_state = film_trunk(params["trunk"], state["trunk"], feats, films,
                                length_mask(v_lens, T), cfg, train=train)
    x = torch.relu(conv2d(params["c1x1_tail"], x.reshape(B * T, *x.shape[2:]),
                          dtype=DTYPES[cfg.compute_dtype]))
    # the temporal max commutes with the CHW flatten: pool channels-last and
    # let linear_chw re-lay the weight
    pooled = mask_invalid(x.reshape(B, T, *x.shape[1:]), v_lens).amax(dim=1)
    return linear_chw(params["out_linear"], pooled), {"trunk": trunk_state}


register_model("time_multi_hop", init_fn, apply_fn,
               needs_video=True, needs_question=True, uses_stem=True)
