"""Masked LSTM: packed-sequence semantics at fixed [B, T].

- the carried (h, c) freezes once t >= len, so the final carry is each
  sequence's own last state;
- per-step outputs are zero beyond each sequence's length;
- the input projection ``x @ W_ih^T + b_ih`` for all steps is one matmul.

Gate order is torch's (i, f, g, o); weights are ``[4H, in]`` / ``[4H, H]``.
The recurrence itself is in kernels/lstm.py: its plain version, or, with
``use_kernel`` on CUDA tensors, the CUDA kernel.
"""

from __future__ import annotations

import torch

from videonavqa_tpu_torch.kernels import lstm as lstm_kernels
from videonavqa_tpu_torch.kernels.lstm import gates_to_state
from videonavqa_tpu_torch.ops.linear import linear
from videonavqa_tpu_torch.ops.masking import length_mask


def lstm_cell(params, x, h, c):
    """One torch nn.LSTMCell step. x: [B, E]; h, c: [B, H]."""
    gates = (linear({"weight": params["w_ih"], "bias": params["b_ih"]}, x)
             + linear({"weight": params["w_hh"], "bias": params["b_hh"]}, h))
    return gates_to_state(gates, c)


def lstm(params, x, lens, h0=None, c0=None, *, precomputed_xw=None, use_kernel=False):
    """Masked LSTM over x [B, T, E] with lengths [B].

    Returns (outputs [B, T, H] zero beyond lens, (h_final, c_final)).
    ``precomputed_xw`` ([B, T, 4H]) lets a caller that runs the same sequence
    again (the FiLM frame loop) hoist the input projection; x is then unused.
    ``use_kernel`` routes the recurrence to the CUDA kernel (serving only;
    models gate it on ``cfg.use_pallas_kernels``)."""
    xw = precomputed_xw if precomputed_xw is not None else linear(
        {"weight": params["w_ih"], "bias": params["b_ih"]}, x)
    B = xw.shape[0]
    H = params["w_hh"].shape[1]
    zeros = torch.zeros((B, H), dtype=torch.float32, device=xw.device)
    h0 = zeros if h0 is None else h0.float().contiguous()
    c0 = zeros if c0 is None else c0.float().contiguous()
    run = lstm_kernels.lstm if use_kernel else lstm_kernels.lstm_plain
    outs, h, c = run(xw.float().transpose(0, 1).contiguous(), params["w_hh"].float().contiguous(),
                     params["b_hh"].float().contiguous(), lens.to(torch.int32), h0, c0)
    return outs.transpose(0, 1), (h, c)


def reverse_padded(x, lens):
    """Reverse each row of x [B, T, ...] within its valid prefix; positions
    t >= len keep their values (callers mask them)."""
    B, T = x.shape[:2]
    t = torch.arange(T, device=x.device)[None, :]
    n = lens.long()[:, None]
    idx = torch.where(t < n, n - 1 - t, t).reshape(B, T, *([1] * (x.ndim - 2)))
    return torch.gather(x, 1, idx.expand_as(x))


def bilstm(fwd_params, bwd_params, x, lens, *, use_kernel=False):
    """Bidirectional masked LSTM (torch nn.LSTM(bidirectional=True) over packed
    input) -> (outputs [B, T, 2H] zero beyond lens, h_n [B, 2H])."""
    out_f, (h_f, _) = lstm(fwd_params, x, lens, use_kernel=use_kernel)
    out_b_rev, (h_b, _) = lstm(bwd_params, reverse_padded(x, lens), lens, use_kernel=use_kernel)
    out_b = reverse_padded(out_b_rev, lens)
    out_b = torch.where(length_mask(lens, x.shape[1])[..., None], out_b, 0.0)
    return torch.cat([out_f, out_b], dim=-1), torch.cat([h_f, h_b], dim=-1)


def last_valid(y, lens):
    """Gather y[b, lens[b] - 1] (the reference's last-timestep gather)."""
    idx = torch.clamp(lens.long() - 1, 0, y.shape[1] - 1)
    return y[torch.arange(y.shape[0], device=y.device), idx]
