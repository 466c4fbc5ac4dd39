"""film_attn attention tail: the kernel of csrc/attn_tail.cu and its plain version.

Replaces ``videonavqa_tpu/kernels/attn_tail_pallas.py`` (attn_tail_pallas):
``num_steps`` (35) steps of phantom-corrected masked softmax over frames,
context reduction and an LSTMCell update. The serial chain of 35 steps, not
bytes, bounds it on an H100; the source note in the .cu file says how the
design keeps each step on chip.
"""

from __future__ import annotations

import ctypes

import torch

from videonavqa_tpu_torch.kernels import _build
from videonavqa_tpu_torch.ops.linear import linear
from videonavqa_tpu_torch.ops.lstm import lstm_cell

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_void_p])


def attn_tail_plain(params, feats, scores, mask, num_steps, n_phantom):
    """feats [B, T, A], scores and mask [B, T] -> hs [B, num_steps, A] f32."""
    B, T, A = feats.shape
    feats = feats.float()
    sm = scores.float() + mask.float()
    h = c = torch.zeros((B, A), dtype=torch.float32, device=feats.device)
    hs = []
    for _ in range(num_steps):
        v = linear(params["fc_hidden_attn"], h)                    # [B, 1]
        logits = v + sm
        m = torch.maximum(logits.amax(dim=1, keepdim=True), v)
        e = torch.exp(logits - m)
        denom = e.sum(dim=1, keepdim=True) + n_phantom * torch.exp(v - m)
        ctxt = torch.einsum("bt,bta->ba", e / denom, feats)
        h, c = lstm_cell(params["lstm_attn"], ctxt, h, c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _interleave_gates(w):
    """[4A, K] gate-major rows (i, f, g, o) -> [K, 4A] with column 4u + g =
    row g*A + u: the layout in which neighbouring kernel threads read
    neighbouring addresses."""
    G, K = w.shape
    return w.float().reshape(4, G // 4, K).permute(2, 1, 0).reshape(K, G).contiguous()


def attn_tail(params, all_features, scores, mask, num_steps, n_phantom):
    """all_features [B, T, A], scores and mask [B, T] -> hs [B, num_steps, A] f32.

    params: fc_hidden_attn {'weight' [1, A], 'bias' [1]} and lstm_attn
    {'w_ih' [4A, A], 'w_hh' [4A, A], 'b_ih', 'b_hh' [4A]}. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    global launches
    if all_features.device.type == "cpu":
        return attn_tail_plain(params, all_features, scores, mask, num_steps, n_phantom)
    B, T, A = all_features.shape
    if A != 128 or not 1 <= T <= 64:
        raise ValueError(f"attn_tail kernel needs A == 128 and 1 <= T <= 64, got A={A}, T={T}")
    dev = all_features.device
    cell = params["lstm_attn"]
    feats = all_features.float().contiguous()
    scores = scores.float().contiguous()
    mask = mask.float().contiguous()
    w_hid = params["fc_hidden_attn"]["weight"].float().reshape(A).contiguous()
    b_hid = params["fc_hidden_attn"]["bias"].float().reshape(1).contiguous()
    w_ih_t = _interleave_gates(cell["w_ih"])
    w_hh_t = _interleave_gates(cell["w_hh"])
    bias = (cell["b_ih"].float() + cell["b_hh"].float()).reshape(4, A).t().reshape(-1).contiguous()
    for name, t, shape in (("feats", feats, (B, T, A)), ("scores", scores, (B, T)),
                           ("mask", mask, (B, T)), ("w_hid", w_hid, (A,)),
                           ("b_hid", b_hid, (1,)), ("w_ih", w_ih_t, (A, 4 * A)),
                           ("w_hh", w_hh_t, (A, 4 * A)), ("bias", bias, (4 * A,))):
        _build.require(t, name, torch.float32, shape, dev)
    hs = torch.empty((B, num_steps, A), dtype=torch.float32, device=dev)
    fn = _build.function("attn_tail", "attn_tail", _ARGTYPES)
    err = fn(feats.data_ptr(), scores.data_ptr(), mask.data_ptr(), w_hid.data_ptr(),
             b_hid.data_ptr(), w_ih_t.data_ptr(), w_hh_t.data_ptr(), bias.data_ptr(),
             hs.data_ptr(), B, T, int(num_steps), A, float(n_phantom), _build.stream_ptr(dev))
    _build.check(err, "attn_tail launch")
    launches += 1
    return hs
