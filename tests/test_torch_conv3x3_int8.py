"""The calibrated int8 trunk's 3x3 conv kernel (``kernels/conv3x3_int8.py``).

On the CPU: the plain twin is the im2col route the trunk ran before the
kernel (``conv2d_int8_preq_act`` / ``conv2d_int8_prequant``, then the eager
ReLU or FiLM tail), bit for bit; the wrapper runs it for CPU tensors and
counts no launch; the trunk sends a conv to the kernel only where
``takes`` says so (CUDA, a 3x3 kernel, C and O multiples of 16, bf16) and
only on its calibrated route with the fused int8 1x1, and that route, run
through the wrapper, gives the im2col route's logits bit for bit;
``trace_drain`` carries the launch counter; the module imports without nvcc.

On the card (marked ``card``; skipped without CUDA or nvcc): the kernel
against its plain twin, bit for bit, at the served shapes and at edge
shapes, a calibrated film_attn_pt forward through both routes, and a width
the kernel does not take, refused. Run them there with
``python -m pytest tests/test_torch_conv3x3_int8.py -q -m card``.

This file imports no JAX: the kernel replaces no Pallas kernel, and its
reference is the port's own im2col route.
"""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from videonavqa_tpu_torch.kernels import _build
from videonavqa_tpu_torch.kernels import conv3x3_int8 as conv_mod
from videonavqa_tpu_torch.models import ModelConfig, get_model
from videonavqa_tpu_torch.models import film as film_mod
from videonavqa_tpu_torch.ops.quant import (
    act_scale, conv2d_int8_preq_act, conv2d_int8_prequant, quantize_act,
    quantize_weight_channelwise)
from videonavqa_tpu_torch.utils import logging as tlog

SMALL = dict(model="film_attn_pt", num_classes=7, vocab_size=19, embed_size=8, hidden_size=8,
             at_hidden_size=8, num_res_blocks=2, num_res_block_channels=16,
             num_input_channels=16, max_num_frames=5, max_q_len=9, compute_dtype="bfloat16")


def _conv_inputs(N, H, W, C, O, seed, device="cpu"):
    """(wq, w_scale, bias, x, xq, absmax) of one int8 conv, drawn on the CPU."""
    g = torch.Generator().manual_seed(seed)
    wq, w_scale = quantize_weight_channelwise(torch.randn(O, C, 3, 3, generator=g) * 0.1)
    bias = torch.randn(O, generator=g) * 0.1
    x = torch.relu(torch.randn(N, H, W, C, generator=g)).to(torch.bfloat16)
    absmax = 1.25 * x.float().abs().amax()
    xq = quantize_act(x, act_scale(absmax))
    return tuple(t.to(device) for t in (wq, w_scale, bias, x, xq, absmax))


def _film_inputs(N, H, W, O, seed, device="cpu"):
    """(a, b, res) of a FiLM block: a and b one bf16 row a frame."""
    g = torch.Generator().manual_seed(seed)
    a = (1.5 * torch.randn(N, O, generator=g)).to(torch.bfloat16)
    b = (0.5 * torch.randn(N, O, generator=g)).to(torch.bfloat16)
    res = torch.relu(torch.randn(N, H, W, O, generator=g)).to(torch.bfloat16)
    return tuple(t.to(device) for t in (a, b, res))


def _batch(B, T, cin, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return {"v_features": torch.relu(torch.randn(B, T, 10, 13, cin, generator=g)).to(device),
            "question": torch.randint(1, 19, (B, 9), generator=g).to(device),
            "v_len": torch.tensor([T, max(1, T - 2)][:B]).to(device),
            "q_len": torch.tensor([9, 4][:B]).to(device)}


def _calibrated(device="cpu", **extra):
    """(spec, cfg, params, state, batch) of film_attn_pt at SMALL widths, its
    int8 trunk calibrated on the batch."""
    cfg = ModelConfig(**{**SMALL, **extra})
    spec = get_model("film_attn_pt")
    params, state = spec.init(torch.Generator().manual_seed(0), cfg, torch.device(device))
    batch = _batch(2, cfg.max_num_frames, cfg.num_input_channels, device=device)
    with torch.no_grad():
        _, state = spec.apply(params, state, batch,
                              dataclasses.replace(cfg, int8_trunk_calibrate=True))
    cfg = dataclasses.replace(cfg, use_int8_trunk=True, use_pallas_kernels=True)
    return spec, cfg, params, state, batch


def _logits(spec, cfg, params, state, batch):
    with torch.no_grad():
        return spec.apply(params, state, batch, cfg)[0]


# --- on the CPU ------------------------------------------------------------------

@pytest.mark.parametrize("form", ["relu", "film", "none", "film_no_bias"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_plain_twin_is_the_im2col_route(form, out_dtype):
    """conv3x3_int8_plain repeats what the trunk ran before the kernel, bit
    for bit: conv_init's relu(conv2d_int8_prequant(x)) from the int8 x, and a
    block's conv2d_int8_preq_act followed by the eager FiLM tail."""
    wq, w_scale, bias, x, xq, absmax = _conv_inputs(3, 10, 13, 32, 48, seed=1)
    if form == "film_no_bias":
        bias = None
    if form == "relu":
        want = torch.relu(conv2d_int8_prequant(wq, w_scale, bias, x, absmax,
                                               out_dtype=out_dtype))
        got = conv_mod.conv3x3_int8_plain(wq, w_scale, bias, xq, absmax, relu=True,
                                          out_dtype=out_dtype)
    elif form == "none":
        want = conv2d_int8_prequant(wq, w_scale, bias, x, absmax, out_dtype=out_dtype)
        got = conv_mod.conv3x3_int8_plain(wq, w_scale, bias, xq, absmax, out_dtype=out_dtype)
    else:
        a, b, res = _film_inputs(3, 10, 13, 48, seed=2)
        a, b, res = a.to(out_dtype), b.to(out_dtype), res.to(out_dtype)
        y = conv2d_int8_preq_act(wq, w_scale, bias, xq, absmax, out_dtype=out_dtype)
        want = torch.relu(a[:, None, None, :] * y + b[:, None, None, :]) + res
        got = conv_mod.conv3x3_int8_plain(wq, w_scale, bias, xq, absmax, film=(a, b, res),
                                          out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (3, 10, 13, 48)
    assert torch.equal(got, want)


@pytest.mark.parametrize("film", [False, True])
def test_wrapper_takes_the_plain_twin_on_the_cpu(film):
    wq, w_scale, bias, _, xq, absmax = _conv_inputs(2, 10, 13, 16, 32, seed=3)
    fm = _film_inputs(2, 10, 13, 32, seed=4) if film else None
    before = conv_mod.launches
    got = conv_mod.conv3x3_int8(wq, w_scale, bias, xq, absmax, relu=not film, film=fm)
    want = conv_mod.conv3x3_int8_plain(wq, w_scale, bias, xq, absmax, relu=not film, film=fm)
    assert conv_mod.launches == before == 0
    assert torch.equal(got, want)


def _meta_wq(O, C, k=3):
    return torch.empty((O, C, k, k), dtype=torch.int8, device="meta")


@pytest.mark.parametrize("device, O, C, k, out_dtype, taken", [
    ("cuda", 1024, 1024, 3, torch.bfloat16, True),
    ("cuda", 1024, 512, 3, torch.bfloat16, True),
    ("cuda:1", 16, 48, 3, torch.bfloat16, True),
    ("cpu", 1024, 1024, 3, torch.bfloat16, False),
    ("meta", 1024, 1024, 3, torch.bfloat16, False),
    ("cuda", 1024, 1024, 1, torch.bfloat16, False),
    ("cuda", 1024, 12, 3, torch.bfloat16, False),
    ("cuda", 24, 1024, 3, torch.bfloat16, False),
    ("cuda", 1024, 1024, 3, torch.float32, False),
])
def test_takes_only_cuda_3x3_convs_of_widths_multiple_of_16(device, O, C, k, out_dtype, taken):
    assert conv_mod.takes(torch.device(device), _meta_wq(O, C, k), out_dtype) is taken


@pytest.mark.parametrize("O, C, k, x_shape", [
    (24, 16, 3, (1, 10, 13, 16)), (16, 12, 3, (1, 10, 13, 12)), (16, 16, 1, (1, 10, 13, 16)),
    (16, 16, 3, (1, 10, 13, 32)), (16, 16, 3, (0, 10, 13, 16))])
def test_check_shape_refuses_what_the_kernel_does_not_take(O, C, k, x_shape):
    xq = torch.empty(x_shape, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="conv3x3_int8 kernel needs"):
        conv_mod.check_shape(_meta_wq(O, C, k), xq)


def test_wrapper_refuses_a_tensor_off_the_cpu_that_is_not_on_cuda():
    """Off the CPU the wrapper launches or raises (no fallback): on the meta
    device it gets as far as the device check."""
    m = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv_mod.conv3x3_int8(_meta_wq(16, 16), m(16), None, m(1, 10, 13, 16, dtype=torch.int8),
                              m())


def _spy(monkeypatch, taken):
    """Force ``takes`` to ``taken`` in the trunk and count the wrapper's calls."""
    calls = []
    real = film_mod.conv3x3_int8

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(film_mod, "conv3x3_takes", lambda device, wq, dtype: taken)
    monkeypatch.setattr(film_mod, "conv3x3_int8", spy)
    return calls


def test_kernel_route_gives_the_im2col_routes_logits_on_the_cpu(monkeypatch):
    """The trunk's kernel route, forced on the CPU (where the wrapper runs the
    plain twin): conv_init with its ReLU and every block's 3x3 conv with the
    FiLM tail go through the wrapper, and the logits are the im2col route's
    bit for bit."""
    spec, cfg, params, state, batch = _calibrated()
    want = _logits(spec, cfg, params, state, batch)
    calls = _spy(monkeypatch, True)
    got = _logits(spec, cfg, params, state, batch)
    assert [(kw.get("film") is not None, kw.get("relu", False)) for kw in calls] == \
        [(False, True)] + [(True, False)] * cfg.num_res_blocks
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["dynamic", "static", "train", "calibrate", "no_kernels",
                                  "over_the_row_gate"])
def test_other_routes_keep_the_im2col_conv(mode, monkeypatch):
    """Even where ``takes`` says yes, only the calibrated route with the
    fused int8 1x1 sends a conv to the kernel: the dynamic and static int8
    modes, training, the calibration pass, the kernels off and a batch over
    the fused kernel's row gate keep the im2col route."""
    spec, cfg, params, state, batch = _calibrated()
    trunk = dict(state["trunk"])
    if mode == "dynamic":
        del trunk["int8_scales"], trunk["int8_wq"]
    elif mode == "static":
        del trunk["int8_wq"]
    elif mode == "calibrate":
        cfg = dataclasses.replace(cfg, int8_trunk_calibrate=True)
    elif mode == "no_kernels":
        cfg = dataclasses.replace(cfg, use_pallas_kernels=False)
    elif mode == "over_the_row_gate":
        monkeypatch.setattr(film_mod, "INT8_FUSED_MAX_ROWS", 2 * cfg.max_num_frames * 130 - 1)
    calls = _spy(monkeypatch, True)
    with torch.no_grad():
        spec.apply(params, {"trunk": trunk}, batch, cfg, train=mode == "train")
    assert calls == []


@pytest.mark.parametrize("compute_dtype, calls", [("bfloat16", 1), ("float32", 0)])
def test_trunk_sends_only_bf16_convs_on_cuda_to_the_kernel(compute_dtype, calls, monkeypatch):
    """With ``takes`` as it is, the calibrated route of a trunk whose tensors
    lie on the card sends conv_init to the kernel at bf16 and keeps it on the
    im2col route at f32 (here on CPU tensors, where the wrapper runs the
    plain twin)."""
    spec, cfg, params, state, batch = _calibrated()
    got = _spy(monkeypatch, True)
    monkeypatch.setattr(film_mod, "conv3x3_takes", conv_mod.takes)
    cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    conv, block = film_mod._trunk_convs(params["trunk"], state["trunk"], cfg, 1300, {},
                                        device=torch.device("cuda"))
    assert block is not None
    x = batch["v_features"].reshape(-1, 10, 13, cfg.num_input_channels)
    y = conv(params["trunk"]["conv_init"], x, "conv_init", relu=True)
    assert y.dtype == getattr(torch, compute_dtype) and len(got) == calls


def test_trunk_asks_takes_with_its_device_weights_and_dtype(monkeypatch):
    """The route depends only on what the trunk observes: the tensors'
    device, each conv's int8 weight and the compute dtype."""
    spec, cfg, params, state, batch = _calibrated()
    asked = []
    monkeypatch.setattr(film_mod, "conv3x3_takes",
                        lambda device, wq, dtype: asked.append((device, tuple(wq.shape), dtype)))
    _logits(spec, cfg, params, state, batch)
    C, Cin = cfg.num_res_block_channels, cfg.num_input_channels
    want = {(torch.device("cpu"), (C, Cin, 3, 3), torch.bfloat16)}
    want |= {(torch.device("cpu"), (C, C, k, k), torch.bfloat16) for k in (1, 3)}
    assert set(asked) == want and len(asked) == 1 + 2 * cfg.num_res_blocks


def test_trace_drain_carries_the_launch_counter(monkeypatch):
    """``conv3x3_int8.launches``, the growth since ``trace_on()`` or the last
    drain: 0 on the CPU (the kernel route forced, the wrapper runs the plain
    twin), and what the counter grew by where it grew."""
    spec, cfg, params, state, batch = _calibrated()
    _spy(monkeypatch, True)
    tlog.trace_on()
    try:
        _logits(spec, cfg, params, state, batch)
        assert tlog.trace_drain()["counters"]["conv3x3_int8.launches"] == 0
        monkeypatch.setattr(conv_mod, "launches", conv_mod.launches + 6)
        assert tlog.trace_drain()["counters"]["conv3x3_int8.launches"] == 6
        assert tlog.trace_drain()["counters"]["conv3x3_int8.launches"] == 0
    finally:
        tlog.trace_off()
        tlog.trace_drain()


def test_module_imports_without_nvcc(tmp_path):
    """Nothing builds at import: the module loads with no nvcc on the PATH
    and a CUDA_HOME without one."""
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    code = ("import videonavqa_tpu_torch.kernels.conv3x3_int8 as m, "
            "videonavqa_tpu_torch.kernels._build as b\n"
            "print(m.launches, 'conv3x3_int8' in b.SOURCES)\n"
            "try:\n    b._nvcc()\nexcept RuntimeError:\n    print('no nvcc')\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["0 True", "no nvcc"]


# --- on the card -----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel runs only on the card")
    try:
        _build._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the CUDA kernel")
    return torch.device("cuda")


def _against_the_twin(dev, N, C, O, film, seed, H=10, W=13):
    wq, w_scale, bias, _, xq, absmax = _conv_inputs(N, H, W, C, O, seed, dev)
    fm = _film_inputs(N, H, W, O, seed + 1, dev) if film else None
    before = conv_mod.launches
    got = conv_mod.conv3x3_int8(wq, w_scale, bias, xq, absmax, relu=not film, film=fm)
    assert conv_mod.launches == before + 1
    want = conv_mod.conv3x3_int8_plain(wq, w_scale, bias, xq, absmax, relu=not film, film=fm)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (N, H, W, O)
    assert torch.equal(got, want), f"{int((got != want).sum())} elements differ"


@pytest.mark.card
@pytest.mark.parametrize("C, film", [(1024, True), (1024, False), (512, False), (512, True)])
def test_kernel_bit_equal_at_the_served_shape(card, C, film):
    """Batch 32 x 35 frames (145,600 rows) into 1,024 channels: a block's conv
    (C 1,024, the FiLM form) and conv_init (C 512, ReLU), each in both forms."""
    _against_the_twin(card, 32 * 35, C, 1024, film, seed=10)


@pytest.mark.card
@pytest.mark.parametrize("N, C, O", [(1, 1024, 1024), (3, 1024, 1024), (32 * 20, 1024, 1024),
                                     (3, 16, 16), (3, 48, 48), (1, 16, 48), (5, 48, 16)])
@pytest.mark.parametrize("film", [False, True])
def test_kernel_bit_equal_at_edge_shapes(card, N, C, O, film):
    """One frame, three (390 rows: no whole row tile of 128 past the first
    three), batch 32 at a trimmed 20 frames, and widths far under the
    kernel's tiles (16, 48: zeros past C and outputs past O dropped)."""
    _against_the_twin(card, N, C, O, film, seed=N + C + O)


@pytest.mark.card
def test_calibrated_forward_gives_the_im2col_routes_logits(card, monkeypatch):
    """film_attn_pt at SMALL widths (16 channels), batch 2, 5 frames, the
    int8 trunk calibrated: the logits through the kernel (one launch for
    conv_init, one a block) and through the im2col route are identical."""
    spec, cfg, params, state, batch = _calibrated(card)
    before = conv_mod.launches
    got = _logits(spec, cfg, params, state, batch)
    assert conv_mod.launches == before + 1 + cfg.num_res_blocks
    monkeypatch.setattr(film_mod, "conv3x3_takes", lambda device, wq, dtype: False)
    want = _logits(spec, cfg, params, state, batch)
    assert conv_mod.launches == before + 1 + cfg.num_res_blocks
    assert torch.equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("C, O", [(12, 16), (16, 24)])
def test_kernel_refuses_a_width_it_does_not_take(card, C, O):
    wq = torch.zeros((O, C, 3, 3), dtype=torch.int8, device=card)
    xq = torch.zeros((1, 10, 13, C), dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="multiples of 16"):
        conv_mod.conv3x3_int8(wq, torch.ones(O, device=card), None, xq,
                              torch.tensor(1.0, device=card))
