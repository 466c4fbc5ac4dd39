"""The reference's weight-init scheme, drawn from a ``torch.Generator``.

Xavier-uniform weights with zero bias for Linear/Conv; Xavier ih, orthogonal
hh and forget-gate bias 1 for LSTMs; and torch's own defaults
(``torch_default_*``, ``kaiming_uniform``) for the layers the reference never
re-initializes (MAC's LSTMs, lstm_proj and third conv). These let the port build full-width
weights with no JAX. They do not give the JAX package's numbers (another
generator): parity tests bridge the JAX weights instead.

Layouts: Linear ``[out, in]``; Conv2D ``OIHW``; Conv3D ``OIDHW``; LSTM ``w_ih [4H, in]``,
``w_hh [4H, H]`` with gate order (i, f, g, o). Tensors are made on the CPU
(so a seed gives the same weights on every device); callers move them.
"""

from __future__ import annotations

import math

import torch


def _fans(shape, layout: str) -> tuple[int, int]:
    """(fan_in, fan_out) as torch.nn.init._calculate_fan_in_and_fan_out."""
    if layout == "oi":
        return shape[1], shape[0]
    if layout in ("oihw", "oidhw"):
        rf = math.prod(shape[2:])
        return shape[1] * rf, shape[0] * rf
    raise ValueError(f"unknown layout {layout!r}")


def uniform(gen, shape, low: float, high: float):
    return torch.rand(shape, generator=gen) * (high - low) + low


def xavier_uniform(gen, shape, layout: str = "oi", gain: float = 1.0):
    fan_in, fan_out = _fans(shape, layout)
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return uniform(gen, shape, -bound, bound)


def kaiming_uniform(gen, shape, layout: str = "oi", a: float = 0.0):
    """torch.nn.init.kaiming_uniform_ with mode='fan_in', leaky_relu."""
    fan_in, _ = _fans(shape, layout)
    bound = math.sqrt(3.0) * math.sqrt(2.0 / (1.0 + a * a)) / math.sqrt(fan_in)
    return uniform(gen, shape, -bound, bound)


def torch_default_linear(gen, out_features: int, in_features: int):
    """torch's default nn.Linear init: kaiming_uniform(a=sqrt(5)) weight and
    uniform(+-1/sqrt(fan_in)) bias."""
    bound = 1.0 / math.sqrt(in_features)
    return {"weight": kaiming_uniform(gen, (out_features, in_features), "oi", a=math.sqrt(5.0)),
            "bias": uniform(gen, (out_features,), -bound, bound)}


def torch_default_conv2d(gen, kh: int, kw: int, cin: int, cout: int):
    """torch's default nn.Conv2d init (kaiming_uniform(a=sqrt(5)) + uniform bias)."""
    bound = 1.0 / math.sqrt(cin * kh * kw)
    return {"weight": kaiming_uniform(gen, (cout, cin, kh, kw), "oihw", a=math.sqrt(5.0)),
            "bias": uniform(gen, (cout,), -bound, bound)}


def torch_default_conv3d(gen, kd: int, kh: int, kw: int, cin: int, cout: int):
    """torch's default nn.Conv3d init, which the reference's C3D convs keep
    (its weights_init matches only nn.Conv2d)."""
    bound = 1.0 / math.sqrt(cin * kd * kh * kw)
    return {"weight": kaiming_uniform(gen, (cout, cin, kd, kh, kw), "oidhw", a=math.sqrt(5.0)),
            "bias": uniform(gen, (cout,), -bound, bound)}


def torch_default_lstm(gen, input_size: int, hidden_size: int):
    """torch's default nn.LSTM init: every weight and bias uniform(+-1/sqrt(H))."""
    bound = 1.0 / math.sqrt(hidden_size)
    return {"w_ih": uniform(gen, (4 * hidden_size, input_size), -bound, bound),
            "w_hh": uniform(gen, (4 * hidden_size, hidden_size), -bound, bound),
            "b_ih": uniform(gen, (4 * hidden_size,), -bound, bound),
            "b_hh": uniform(gen, (4 * hidden_size,), -bound, bound)}


def orthogonal(gen, shape):
    """torch.nn.init.orthogonal_: rows or columns orthonormal."""
    n_rows, n_cols = shape
    a = torch.randn((max(n_rows, n_cols), min(n_rows, n_cols)), generator=gen)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if n_rows < n_cols:
        q = q.T
    return q[:n_rows, :n_cols].contiguous()


def normal(gen, shape, std: float = 1.0):
    return std * torch.randn(shape, generator=gen)


def reference_linear(gen, out_features: int, in_features: int):
    return {"weight": xavier_uniform(gen, (out_features, in_features), "oi"),
            "bias": torch.zeros(out_features)}


def reference_conv2d(gen, kh: int, kw: int, cin: int, cout: int):
    return {"weight": xavier_uniform(gen, (cout, cin, kh, kw), "oihw"),
            "bias": torch.zeros(cout)}


def reference_conv3d(gen, kd: int, kh: int, kw: int, cin: int, cout: int):
    return {"weight": xavier_uniform(gen, (cout, cin, kd, kh, kw), "oidhw"),
            "bias": torch.zeros(cout)}


def reference_lstm(gen, input_size: int, hidden_size: int):
    """Xavier w_ih, orthogonal w_hh over the full [4H, H] matrix, b_ih = 0,
    b_hh = 0 except the forget-gate block = 1."""
    b_hh = torch.zeros(4 * hidden_size)
    b_hh[hidden_size:2 * hidden_size] = 1.0
    return {
        "w_ih": xavier_uniform(gen, (4 * hidden_size, input_size), "oi"),
        "w_hh": orthogonal(gen, (4 * hidden_size, hidden_size)),
        "b_ih": torch.zeros(4 * hidden_size),
        "b_hh": b_hh,
    }


def init_bn(c: int):
    """BatchNorm parameters (affine) and state (running stats), torch defaults."""
    return ({"weight": torch.ones(c), "bias": torch.zeros(c)},
            {"mean": torch.zeros(c), "var": torch.ones(c)})
