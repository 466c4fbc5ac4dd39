"""Masked LSTM in plain PyTorch: packed-sequence semantics at fixed [B, T].

- the carried (h, c) freezes once t >= len, so the final carry is each
  sequence's own last state;
- per-step outputs are zero beyond each sequence's length;
- the input projection ``x @ W_ih^T + b_ih`` for all steps is one matmul.

Gate order is torch's (i, f, g, o); weights are ``[4H, in]`` / ``[4H, H]``.
These are the building blocks of the two recurrence kernels' plain versions
(kernels/film_reencode.py, kernels/attn_tail.py).
"""

from __future__ import annotations

import torch

from videonavqa_tpu_torch.ops.linear import linear


def _gates_to_state(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def lstm_cell(params, x, h, c):
    """One torch nn.LSTMCell step. x: [B, E]; h, c: [B, H]."""
    gates = (linear({"weight": params["w_ih"], "bias": params["b_ih"]}, x)
             + linear({"weight": params["w_hh"], "bias": params["b_hh"]}, h))
    return _gates_to_state(gates, c)


def lstm(params, x, lens, h0=None, c0=None, *, precomputed_xw=None):
    """Masked LSTM over x [B, T, E] with lengths [B].

    Returns (outputs [B, T, H] zero beyond lens, (h_final, c_final)).
    ``precomputed_xw`` ([B, T, 4H]) lets a caller that runs the same sequence
    again (the FiLM frame loop) hoist the input projection; x is then unused.
    """
    xw = precomputed_xw if precomputed_xw is not None else linear(
        {"weight": params["w_ih"], "bias": params["b_ih"]}, x)
    B, T = xw.shape[:2]
    H = params["w_hh"].shape[1]
    zeros = torch.zeros((B, H), dtype=torch.float32, device=xw.device)
    h = zeros if h0 is None else h0
    c = zeros if c0 is None else c0
    hh = {"weight": params["w_hh"], "bias": params["b_hh"]}
    outs = []
    for t in range(T):
        h_new, c_new = _gates_to_state(xw[:, t] + linear(hh, h), c)
        valid = (t < lens)[:, None]
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        outs.append(torch.where(valid, h_new, torch.zeros_like(h_new)))
    return torch.stack(outs, dim=1), (h, c)


def last_valid(y, lens):
    """Gather y[b, lens[b] - 1] (the reference's last-timestep gather)."""
    idx = torch.clamp(lens.long() - 1, 0, y.shape[1] - 1)
    return y[torch.arange(y.shape[0], device=y.device), idx]
