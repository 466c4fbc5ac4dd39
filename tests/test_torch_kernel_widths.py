"""The port's kernels at every width a ModelConfig can carry, on the CPU.

On the card the four width-bound kernels take any width: the re-encode and
the attention tail zero-pad a small hidden size up to their cluster kernel's
128 (or 256), the wide LSTM chain pads to a multiple of 4, and the fused
int8 1x1 pads its weights to multiples of 128 (x's columns are padded as it
quantizes them). A padded unit's weights, biases and inputs are zero, so its
c and h stay exactly 0 and the real units' sums gain only exact zeros; a
padded int8 column quantizes to 0 and adds nothing to an int32 sum.

Here: each padding helper's plain version on the padded problem against the
unpadded one, bit for bit in f32; the width checks, which refuse only what
the card cannot hold; and film_attn_pt and the question-only lstm at widths
no served preset uses, the port's kernel route (the wrappers' plain versions
on the CPU) against the JAX package with its Pallas kernels in interpret
mode. On the CPU a row of 12 and a row of 128 take other vector paths
(BLAS sums in other orders; sigmoid's vectorized and scalar lanes round
differently), so the f32 plain version itself moves by ~1e-7 with the width:
the re-encode's padding check runs both problems in f64 on f32 inputs and
compares them rounded to f32, bit for bit (a last-bit f64 difference, which
the rounding absorbs); the tail's plain version casts to f32 inside, and its
real units are held to 2e-7 (its padded ones to exactly 0).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import videonavqa_tpu.kernels.attn_tail_pallas  # noqa: F401  (for _force_interpret)
import videonavqa_tpu.kernels.film_reencode_pallas  # noqa: F401
import videonavqa_tpu.kernels.int8_matmul_pallas  # noqa: F401
import videonavqa_tpu.kernels.lstm_pallas  # noqa: F401
from videonavqa_tpu.models import get_model as jax_get_model
from test_kernels import _force_interpret
from test_torch_film_attn import INT8_LOGIT_ATOL, _batch, _jax, _jax_apply, _setup, _torch
from test_torch_lstm_models import LOGIT_ATOL
from test_torch_lstm_models import _batch as _lstm_batch
from test_torch_lstm_models import _jax_apply as _lstm_jax_apply
from test_torch_lstm_models import _setup as _lstm_setup
from videonavqa_tpu_torch.kernels import attn_tail as attn_mod
from videonavqa_tpu_torch.kernels import film_reencode as reenc_mod
from videonavqa_tpu_torch.kernels import int8_matmul as int8_mod
from videonavqa_tpu_torch.kernels import lstm as lstm_mod
from videonavqa_tpu_torch.models import film as film_mod
from videonavqa_tpu_torch.models import get_model, q_only_lstm
from videonavqa_tpu_torch.ops import lstm as ops_lstm
from videonavqa_tpu_torch.ops.quant import act_scale, quantize_weight_channelwise

# Widths the served presets do not use, and the widest flags.
WIDTHS = (6, 10, 12, 20, 48, 100, 200, 300, 1600, 2048)


def _rand(r, *shape, scale=1.0):
    return torch.from_numpy((scale * r.standard_normal(shape)).astype(np.float32))


def _f64(r, *shape, scale=1.0):
    """f32 values, held in f64 (see the module note)."""
    return _rand(r, *shape, scale=scale).double()


def _linear_f64(p, x):
    return x @ p["weight"].t() + p["bias"]


@pytest.mark.parametrize("H", [6, 10])
def test_lstm_padding_is_exact(H):
    """pad_units to the wide chain's multiple of 4: the plain version on the
    padded problem gives the unpadded outs, h and c bit for bit, and the
    padded units stay exactly 0."""
    r = np.random.default_rng(H)
    T, B = 7, 3
    xw, w_hh, b_hh = _rand(r, T, B, 4 * H), _rand(r, 4 * H, H, scale=0.3), _rand(r, 4 * H)
    h0, c0 = _rand(r, B, H), _rand(r, B, H)
    lens = torch.tensor([7, 3, 1], dtype=torch.int32)
    Hp = lstm_mod.padded_hidden(H)
    assert Hp % 4 == 0 and Hp - H < 4
    xw_p, w_p, b_p, h0_p, c0_p = lstm_mod.pad_units(Hp, xw, w_hh, b_hh, h0, c0)
    assert xw_p.shape == (T, B, 4 * Hp) and w_p.shape == (4 * Hp, Hp)
    want = lstm_mod.lstm_plain(xw, w_hh, b_hh, lens, h0, c0)
    got = lstm_mod.lstm_plain(xw_p, w_p, b_p, lens, h0_p, c0_p)
    for g, w in zip(got, want):
        assert torch.equal(g[..., :H], w)
        assert float(g[..., H:].abs().max()) == 0.0


def _lstm_f64(params, x, lens, h0=None, c0=None, *, precomputed_xw):
    """ops/lstm.py lstm without its casts to f32 (the re-encode's plain
    version calls it on precomputed inputs), its recurrent product in f64."""
    B, H = precomputed_xw.shape[0], params["w_hh"].shape[1]
    zeros = torch.zeros((B, H), dtype=torch.float64)
    outs, h, c = lstm_mod.lstm_plain(precomputed_xw.transpose(0, 1), params["w_hh"],
                                     params["b_hh"], lens, zeros if h0 is None else h0,
                                     zeros if c0 is None else c0)
    return outs.transpose(0, 1), (h, c)


def test_film_reencode_padding_is_exact(monkeypatch):
    """Hidden 12 padded to the cluster chain's 128: the plain re-encode on the
    padded problem gives every pass's final h bit for bit (in f64 through
    _lstm_f64, rounded to f32)."""
    monkeypatch.setattr(reenc_mod, "lstm", _lstm_f64)
    monkeypatch.setattr(lstm_mod, "linear", _linear_f64)
    r = np.random.default_rng(12)
    H, Tq, B, n_frames = 12, 9, 3, 4
    xw, w_hh, b_hh = _f64(r, Tq, B, 4 * H), _f64(r, 4 * H, H, scale=0.3), _f64(r, 4 * H)
    lens = torch.tensor([9, 4, 1], dtype=torch.int32)
    Hp = reenc_mod.padded_hidden(H)
    assert Hp == reenc_mod.CHAIN_HIDDEN
    want = reenc_mod.film_reencode_plain(xw, w_hh, b_hh, lens, n_frames)
    got = reenc_mod.film_reencode_plain(*lstm_mod.pad_units(Hp, xw, w_hh, b_hh), lens, n_frames)
    assert got.shape == (n_frames, B, Hp)
    assert torch.equal(got[..., :H].float(), want.float())
    assert float(got[..., H:].abs().max()) == 0.0


def test_attn_tail_padding_is_exact():
    """Attention 20 padded to 128 (pad_inputs, which folds b_ih + b_hh into
    one bias): the plain tail on the padded problem, against the unpadded
    tail given the same folded bias, keeps the padded units at exactly 0 and
    the real ones within 2e-7 (the CPU's width-dependent f32 rounding)."""
    r = np.random.default_rng(20)
    A, B, T, S = 20, 3, 6, 5
    params = {"fc_hidden_attn": {"weight": _rand(r, 1, A), "bias": _rand(r, 1)},
              "lstm_attn": {"w_ih": _rand(r, 4 * A, A, scale=0.3),
                            "w_hh": _rand(r, 4 * A, A, scale=0.3),
                            "b_ih": _rand(r, 4 * A), "b_hh": _rand(r, 4 * A)}}
    feats, scores = _rand(r, B, T, A), _rand(r, B, T)
    mask = torch.zeros((B, T))
    mask[1, 4:] = -2.0 ** 31
    ap = attn_mod.padded_size(A)
    assert ap == 128
    w_ih, w_hh, bias, feats_p = attn_mod.pad_inputs(params, feats, ap)
    folded = {"fc_hidden_attn": params["fc_hidden_attn"],
              "lstm_attn": {**params["lstm_attn"],
                            "b_ih": params["lstm_attn"]["b_ih"] + params["lstm_attn"]["b_hh"],
                            "b_hh": torch.zeros(4 * A)}}
    w_hid = F.pad(params["fc_hidden_attn"]["weight"], (0, ap - A))
    padded = {"fc_hidden_attn": {"weight": w_hid, "bias": params["fc_hidden_attn"]["bias"]},
              "lstm_attn": {"w_ih": w_ih, "w_hh": w_hh, "b_ih": bias,
                            "b_hh": torch.zeros(4 * ap)}}
    want = attn_mod.attn_tail_plain(folded, feats, scores, mask, S, 2.0)
    got = attn_mod.attn_tail_plain(padded, feats_p, scores, mask, S, 2.0)
    np.testing.assert_allclose(got[..., :A].numpy(), want.numpy(), rtol=0, atol=2e-7)
    assert float(got[..., A:].abs().max()) == 0.0


@pytest.mark.parametrize("stored", [False, True])
@pytest.mark.parametrize("C", [48, 200])
def test_int8_padding_is_exact(C, stored):
    """N = K = C padded to multiples of 128 (pad_weights; x's columns as the
    streamed route's quantize kernel writes them, zeros): y and yq of the
    plain version bit-equal to the unpadded ones, on both requant sources,
    and the padded outputs 0."""
    r = np.random.default_rng(C)
    M = 300
    wq, w_scale = quantize_weight_channelwise(_rand(r, C, C, 1, 1))
    wq = wq[:, :, 0, 0].contiguous()
    x = torch.relu(_rand(r, M, C)).to(torch.bfloat16)
    sx = act_scale(1.25 * x.float().abs().amax())
    comb, bias = (sx * w_scale).contiguous(), _rand(r, C, scale=0.1)
    nx = act_scale(torch.tensor(4.0))
    want = int8_mod.int8_matmul_plain(x, wq, comb, bias, sx, nx, relu=True,
                                      out_dtype=torch.bfloat16, requant_stored=stored)
    wq_p, comb_p, bias_p = int8_mod.pad_weights(wq, comb, bias)
    Cp = int8_mod.padded(C)
    assert wq_p.shape == (Cp, Cp) and comb_p.shape == bias_p.shape == (Cp,)
    x_p = F.pad(x, (0, Cp - C))
    got = int8_mod.int8_matmul_plain(x_p, wq_p, comb_p, bias_p, sx, nx, relu=True,
                                     out_dtype=torch.bfloat16, requant_stored=stored)
    for g, w in zip(got, want):
        assert torch.equal(g[:, :C], w)
        assert int(g[:, C:].float().abs().max()) == 0


@pytest.mark.parametrize("W", WIDTHS)
def test_width_checks_refuse_no_width_a_config_carries(W):
    """Every kernel's width check takes W; on meta tensors each wrapper then
    reaches its input checks, which raise only for the device (no plain
    fallback, no shape refusal)."""
    lstm_mod.check_hidden(W)
    reenc_mod.check_shape(32, W)
    int8_mod.check_shape(4550, W, W)
    assert attn_mod.padded_size(W) >= W and reenc_mod.padded_hidden(W) >= W
    m = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    B = 33
    with pytest.raises(ValueError, match="CUDA"):
        lstm_mod.lstm(m(5, B, 4 * W), m(4 * W, W), m(4 * W), m(B, dtype=torch.int32), m(B, W),
                      m(B, W))
    with pytest.raises(ValueError, match="CUDA"):
        reenc_mod.film_reencode(m(5, B, 4 * W), m(4 * W, W), m(4 * W),
                                m(B, dtype=torch.int32), 3)
    params = {"fc_hidden_attn": {"weight": m(1, W), "bias": m(1)},
              "lstm_attn": {"w_ih": m(4 * W, W), "w_hh": m(4 * W, W), "b_ih": m(4 * W),
                            "b_hh": m(4 * W)}}
    with pytest.raises(ValueError, match="CUDA"):
        attn_mod.attn_tail(params, m(2, 35, W), m(2, 35), m(2, 35), 35, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        int8_mod.int8_matmul_2d(m(4, W, dtype=torch.bfloat16), m(W, W, dtype=torch.int8),
                                m(W), m(W), m())


WIDE_FILM = dict(hidden_size=12, at_hidden_size=20, num_res_block_channels=48)


@pytest.fixture
def jax_pallas_interpreted():
    patches = [_force_interpret(f"videonavqa_tpu.kernels.{mod}", name) for mod, name in (
        ("attn_tail_pallas", "attn_tail_pallas"), ("film_reencode_pallas", "film_reencode_pallas"),
        ("int8_matmul_pallas", "matmul_int8_fused_pallas"), ("lstm_pallas", "lstm_pallas"))]
    yield
    for mod, name, orig in patches:
        setattr(mod, name, orig)


def _spy(monkeypatch, mod, name):
    calls = []
    fn = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


@pytest.mark.parametrize("int8", [False, True])
def test_film_attn_at_odd_widths_matches_jax_pallas(int8, jax_pallas_interpreted, monkeypatch):
    """film_attn_pt at hidden 12, attention 20 and 48 trunk channels (each
    padded on the card), eval, the kernels on in both packages: the port's
    route through the re-encode, tail and (int8) fused 1x1 wrappers against
    the JAX package's Pallas kernels in interpret mode. f32 logits to 1e-5;
    the calibrated int8 trunk (calibrated by each package) to 2e-3 with
    equal argmax."""
    jcfg, _, jp, js, cfg, params, state = _setup(**WIDE_FILM, use_int8_trunk=int8)
    if int8:
        cal = _batch(4)
        _, js = _jax_apply(dataclasses.replace(jcfg, int8_trunk_calibrate=True))(
            jp, js, _jax(cal))
        _, state = get_model("film_attn_pt").apply(
            params, state, _torch(cal), dataclasses.replace(cfg, int8_trunk_calibrate=True))
    jcfg = dataclasses.replace(jcfg, use_pallas_kernels=True)
    cfg = dataclasses.replace(cfg, use_pallas_kernels=True)
    b = _batch(4, seed=1)
    reenc = _spy(monkeypatch, film_mod, "film_reencode")
    tail = _spy(monkeypatch, film_mod, "attn_tail")
    fused = _spy(monkeypatch, film_mod, "matmul_int8_fused")
    want, _ = jax.jit(lambda p, s, bb: jax_get_model("film_attn_pt").apply(
        p, s, bb, jcfg, train=False, rng=jax.random.PRNGKey(1)))(jp, js, _jax(b))
    got, _ = get_model("film_attn_pt").apply(params, state, _torch(b), cfg)
    assert (len(reenc), len(tail), len(fused)) == (1, 1, 2 if int8 else 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=INT8_LOGIT_ATOL if int8 else 1e-5)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))


def test_q_only_lstm_at_hidden_10_matches_jax_pallas(jax_pallas_interpreted, monkeypatch):
    """The question-only lstm at hidden 10 (the wide chain pads it to 12 on
    the card), the kernels on: the port's route through the LSTM wrapper
    against the JAX model with lstm_pallas in interpret mode, from the
    (h0, c0) JAX draws, to 1e-4."""
    jcfg, jspec, jp, js, cfg, params, _ = _lstm_setup("lstm", (("hidden_size", 10),))
    b = _lstm_batch(get_model("lstm"), 6)
    want, _ = _lstm_jax_apply(jspec, jcfg, jp, js, b, rng=7)
    k_h, k_c = jax.random.split(jax.random.PRNGKey(7))
    h0, c0 = (torch.from_numpy(np.array(jax.random.normal(k, (3, 10)))) for k in (k_h, k_c))
    calls = _spy(monkeypatch, ops_lstm.lstm_kernels, "lstm")
    got = q_only_lstm.apply_with_state(params, _torch(b), cfg, h0, c0)
    assert cfg.use_pallas_kernels and len(calls) == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))
