"""The port's int8 frozen stem (stem/quant.py) against the JAX package's, on
the CPU, at small frames (48x64, 2 videos x 2 frames) and 32 detector
filters; the weights are made with numpy (tests/test_torch_stem.py's
helpers: non-zero biases, randomized BatchNorm statistics) and given to
both packages.

Bounds:

- ``quantize_stem`` on JAX's scales: the int8 weights, the weight scales,
  the biases and the activation quantizers equal;
- calibration, both kinds: the scales within SCALE_RTOL (1e-6) of JAX's;
  the equalization divisors and the bias deltas within EQ_RTOL and
  BIAS_DELTA_ATOL given JAX's f32 convs and BN affines, and within the OWN_*
  bounds with the port's own (summed in another order; measured beside each);
- ``stem_features_int8`` on JAX's own ``qstem`` (``qstem_from_jax``): the VGG
  stage bit-equal to JAX run op by op; the whole stem within
  STEM_FEATURE_ATOL of the largest feature: past the detector's input BN,
  whose ``rsqrt`` sits an ulp from XLA's for about a third of the inputs,
  an int8 code may flip (the features moved by more than 1e-5 are counted
  and bounded too);
- the percentile equal to ``jnp.percentile``'s to the bit, over more than
  2**24 elements (where ``torch.quantile`` refuses) and at low and high
  percentiles;
- the K-padded im2col of a 3-channel conv equal to the unpadded product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_stem import _bn, _conv

from videonavqa_tpu.ops.conv import conv2d as jax_conv2d
from videonavqa_tpu.ops.conv import max_pool2d as jax_max_pool2d
from videonavqa_tpu.stem import quant as jq
from videonavqa_tpu.stem.vgg import VGG_PARTIAL_CFG
from videonavqa_tpu_torch.ops.quant import conv_i8
from videonavqa_tpu_torch.stem import quant as tq
from videonavqa_tpu_torch.utils.checkpoint import qstem_from_jax, stem_from_jax

NUM_FILTERS = 32
# Measured with JAX's f32 convs and BN affines in the port's walk: scales
# equal, eq 6.0e-8, bias deltas 2.1e-9 (the largest |bias delta| is 2.5e-3).
# With the port's own: scales 4.9e-7 (conv2_2; absmax 4.0e-7), eq 6.3e-6,
# bias deltas 1.08e-4 (conv2_2: an eq 6e-6 apart moves a weight's int8 code
# across a rounding edge, which shifts that channel's simulated output).
SCALE_RTOL = 1e-6
EQ_RTOL = 1e-6
BIAS_DELTA_ATOL = 1e-7
OWN_EQ_RTOL = 5e-5
OWN_BIAS_DELTA_ATOL = 5e-4
STEM_FEATURE_ATOL = 1e-5  # of the largest feature; measured at most 1.05e-7
MAX_FLIP_SHARE = 1e-3     # of the features more than 1e-5 apart; measured 0
CALIBRATIONS = ("absmax", "improved")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def stem():
    """(JAX trees as jnp, the port's trees, the video as numpy)."""
    r = np.random.default_rng(15)
    vgg = {"conv1_1": _conv(r, 3, 64, 0.1), "conv1_2": _conv(r, 64, 64, 0.1),
           "conv2_1": _conv(r, 64, 128, 0.1), "conv2_2": _conv(r, 128, 128, 0.1)}
    det, det_state = {}, {}
    det["bn_input"], det_state["bn_input"] = _bn(r, 128)
    cin = 128
    for b in range(1, 4):
        det[f"conv{b}1"] = _conv(r, cin, NUM_FILTERS, 0.1)
        det[f"conv{b}2"] = _conv(r, NUM_FILTERS, NUM_FILTERS, 0.1)
        det[f"bn{b}"], det_state[f"bn{b}"] = _bn(r, NUM_FILTERS)
        cin = NUM_FILTERS
    video = r.random((2, 2, 48, 64, 3), dtype=np.float32)
    port = stem_from_jax(vgg, det, det_state, torch.device("cpu"))
    return jax.tree.map(jnp.asarray, (vgg, det, det_state)), port, video


def _calibrate(pkg, mode, trees, video):
    fn = pkg.calibrate_stem_quant if mode == "improved" else pkg.calibrate_act_scales
    return fn(*trees, video)


def _jax_f32_conv(params, x, *, dtype=None):
    """The port's conv2d computed by JAX's (OIHW -> HWIO), as f32 torch."""
    p = {"weight": jnp.asarray(params["weight"].permute(2, 3, 1, 0).numpy()),
         "bias": jnp.asarray(params["bias"].numpy())}
    return torch.from_numpy(np.array(jax_conv2d(p, jnp.asarray(x.numpy()), dtype=jnp.float32)))


def _jax_bn_affine(state, params):
    """The port's _bn_affine by JAX's (its rsqrt may sit an ulp from torch's)."""
    scale, shift = jq._bn_affine(*(jax.tree.map(lambda t: jnp.asarray(t.numpy()), d)
                                   for d in (state, params)))
    return torch.from_numpy(np.array(scale)), torch.from_numpy(np.array(shift))


@pytest.fixture(scope="module")
def calibrations(stem):
    """{mode: (JAX act_scales, the port's, the port's with JAX's f32 convs
    and BatchNorm affines)}."""
    jtrees, ttrees, video = stem
    out = {}
    for mode in CALIBRATIONS:
        want = _calibrate(jq, mode, jtrees, jnp.asarray(video))
        own = _calibrate(tq, mode, ttrees, torch.from_numpy(video))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tq, "conv2d", _jax_f32_conv)
            mp.setattr(tq, "_bn_affine", _jax_bn_affine)
            same = _calibrate(tq, mode, ttrees, torch.from_numpy(video))
        out[mode] = (want, own, same)
    return out


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _jax_qstem_np(jtrees, act_scales):
    q = jq.quantize_stem(jtrees[0], jtrees[1], act_scales=act_scales)
    return jax.tree.map(lambda v: np.asarray(v) if isinstance(v, jax.Array) else v, q)


def _check_scales(got, want, *, scale_rtol, eq_rtol, bias_delta_atol):
    if "scales" in want:
        assert set(got) == {"scales", "eq", "bias_delta"}
        for name in jq._CONV_ORDER:
            np.testing.assert_allclose(_np(got["eq"][name]), _np(want["eq"][name]),
                                       rtol=eq_rtol, err_msg=name)
            np.testing.assert_allclose(_np(got["bias_delta"][name]),
                                       _np(want["bias_delta"][name]),
                                       rtol=0, atol=bias_delta_atol, err_msg=name)
        got, want = got["scales"], want["scales"]
    assert list(got) == list(tq._CONV_ORDER) == list(jq._CONV_ORDER)
    for name in jq._CONV_ORDER:
        assert isinstance(got[name], float)
        np.testing.assert_allclose(got[name], want[name], rtol=scale_rtol, err_msg=name)


@pytest.mark.parametrize("mode", CALIBRATIONS)
def test_calibration_matches_jax_given_the_same_f32_convs(calibrations, mode):
    """The calibration's own arithmetic (absmax, equalization, the
    percentile, the int8 simulation and the bias deltas), with the f32 walk's
    convs and BatchNorm affines computed by JAX's in both."""
    want, _, got = calibrations[mode]
    _check_scales(got, want, scale_rtol=SCALE_RTOL, eq_rtol=EQ_RTOL,
                  bias_delta_atol=BIAS_DELTA_ATOL)


@pytest.mark.parametrize("mode", CALIBRATIONS)
def test_calibration_with_the_ports_convs_stays_near_jax(calibrations, mode):
    """With the port's own f32 convs (summed in another order than XLA's)
    the scales stay within SCALE_RTOL; equalization divides each channel by
    its absmax, so a channel of small values, whose conv outputs carry the
    largest relative float error, passes that error to its divisor and, by
    way of the weights' int8 codes, to the bias deltas (OWN_* bounds)."""
    want, got, _ = calibrations[mode]
    _check_scales(got, want, scale_rtol=SCALE_RTOL, eq_rtol=OWN_EQ_RTOL,
                  bias_delta_atol=OWN_BIAS_DELTA_ATOL)


@pytest.mark.parametrize("mode", CALIBRATIONS + ("dynamic",))
def test_quantize_stem_on_jax_scales_matches_jax(stem, calibrations, mode):
    """The same act_scales dict (JAX's, carried over) -> the same int8 stem."""
    jtrees, ttrees, _ = stem
    jscales = None if mode == "dynamic" else calibrations[mode][0]
    want = _jax_qstem_np(jtrees, jscales)
    tscales = None
    if jscales is not None:
        tscales = jax.tree.map(lambda v: torch.from_numpy(np.asarray(v))
                               if isinstance(v, jax.Array) else v, jscales)
    got = tq.quantize_stem(ttrees[0], ttrees[1], act_scales=tscales)
    assert got["act_scales"] == want["act_scales"] if mode == "absmax" else True
    for stage in ("vgg", "det"):
        assert list(got[stage]) == list(want[stage])
        for name, lay in want[stage].items():
            g = got[stage][name]
            np.testing.assert_array_equal(g["wq"].permute(2, 3, 1, 0).numpy(), lay["wq"])
            assert g["wq"].dtype == torch.int8
            np.testing.assert_array_equal(g["sw"].numpy(), lay["sw"])
            np.testing.assert_array_equal(g["bias"].numpy(), lay["bias"])
            assert ("aq" in g) == ("aq" in lay)
            if "aq" in lay:
                for k in ("m", "s"):
                    np.testing.assert_array_equal(g["aq"][k].numpy(),
                                                  np.asarray(lay["aq"][k], np.float32))


def _jax_vgg_int8(qstem, video):
    """JAX's stem_features_int8 up to the VGG stage's output, op by op: the
    same lines of videonavqa_tpu/stem/quant.py."""
    B, T = video.shape[:2]
    h = video.reshape(B * T, *video.shape[2:])
    for item in VGG_PARTIAL_CFG:
        if item == "M":
            h = jax_max_pool2d(h)
            continue
        layer = qstem["vgg"][item[0]]
        xq, sx = jq._qact(h, layer)
        h = jax.nn.relu(jq._conv_int8(xq, layer["wq"], sx, layer["sw"]) + layer["bias"])
    return h


@pytest.mark.parametrize("mode", CALIBRATIONS + ("dynamic",))
def test_int8_stem_on_jax_qstem_matches_jax(stem, calibrations, mode):
    jtrees, ttrees, video = stem
    jscales = None if mode == "dynamic" else calibrations[mode][0]
    jqstem = jq.quantize_stem(jtrees[0], jtrees[1], act_scales=jscales)
    qstem = qstem_from_jax(_jax_qstem_np(jtrees, jscales), torch.device("cpu"))
    x = torch.from_numpy(video)
    np.testing.assert_array_equal(
        tq.vgg_features_int8(qstem, x.reshape(-1, *x.shape[2:])).numpy(),
        np.asarray(_jax_vgg_int8(jqstem, jnp.asarray(video))))
    want = np.asarray(jq.stem_features_int8(jqstem, jtrees[1], jtrees[2], jnp.asarray(video)))
    got = tq.stem_features_int8(qstem, ttrees[1], ttrees[2], x).numpy()
    assert got.shape == want.shape == (2, 2, 3, 4, NUM_FILTERS)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=STEM_FEATURE_ATOL * scale)
    assert np.mean(np.abs(got - want) > 1e-5) <= MAX_FLIP_SHARE


@pytest.mark.parametrize("mode", CALIBRATIONS)
def test_int8_stem_of_the_port_calibration_stays_near_f32(stem, calibrations, mode):
    """End to end in the port: its own calibration, then the int8 stem, near
    the f32 stem (JAX's test bounds of the feature error, 0.06 and 0.03
    improved, hold on these uniform frames too)."""
    from videonavqa_tpu_torch.stem import stem_features

    _, ttrees, video = stem
    x = torch.from_numpy(video)
    q = tq.quantize_stem(ttrees[0], ttrees[1], act_scales=calibrations[mode][1])
    got = tq.stem_features_int8(q, ttrees[1], ttrees[2], x)
    want = stem_features(*ttrees, x, dtype=torch.float32)
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    assert rel < (0.03 if mode == "improved" else 0.06)


def test_static_stem_chunks_frames_without_changing_them(stem, calibrations):
    _, ttrees, video = stem
    q = tq.quantize_stem(ttrees[0], ttrees[1], act_scales=calibrations["improved"][1])
    x = torch.from_numpy(video)
    whole = tq.stem_features_int8(q, ttrees[1], ttrees[2], x, frame_chunk=None)
    assert torch.equal(tq.stem_features_int8(q, ttrees[1], ttrees[2], x, frame_chunk=1), whole)


def test_dynamic_stem_takes_one_scale_over_the_whole_batch(stem, monkeypatch):
    """Without static scales no chunking: each conv quantizes the batch at once."""
    _, ttrees, video = stem
    q = tq.quantize_stem(ttrees[0], ttrees[1])
    seen = []
    real = tq._quantize_act

    def spy(h):
        seen.append(h.shape[0])
        return real(h)

    monkeypatch.setattr(tq, "_quantize_act", spy)
    tq.stem_features_int8(q, ttrees[1], ttrees[2], torch.from_numpy(video), frame_chunk=1)
    assert seen == [4] * len(tq._CONV_ORDER)


def test_int8_stem_is_frozen(stem):
    _, ttrees, video = stem
    x = torch.from_numpy(video).requires_grad_(True)
    q = tq.quantize_stem(ttrees[0], ttrees[1])
    out = tq.stem_features_int8(q, ttrees[1], ttrees[2], x)
    assert not out.requires_grad and out.grad_fn is None


@pytest.mark.parametrize("cin", [3, 4, 8])
def test_conv_i8_pads_the_contraction_to_a_multiple_of_8(cin):
    """A 3x3 conv over 3 channels (K = 27) and over 4 (K = 36, the int32
    view's case) runs padded; every sum is the unpadded product's."""
    r = np.random.default_rng(cin)
    x = r.integers(-127, 128, (2, 9, 11, cin)).astype(np.int8)
    w = r.integers(-127, 128, (16, cin, 3, 3)).astype(np.int8)
    got = conv_i8(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    cols = np.stack([xp[:, i:i + 9, j:j + 11] for i in range(3) for j in range(3)], axis=3)
    w2 = w.astype(np.int64).transpose(0, 2, 3, 1).reshape(16, -1)
    want = cols.reshape(2, 9, 11, 9 * cin) @ w2.T
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n, q", [(2 ** 24 + 4099, 99.99), (123457, 99.99), (1536, 99.9),
                                  (1000, 0.5), (999, 50.0), (7, 100.0), (7, 0.0)])
def test_percentile_matches_jnp_bit_for_bit(n, q):
    """Over |x| as the calibration takes it, more than 2**24 elements too."""
    x = np.abs(np.random.default_rng(n).standard_normal(n)).astype(np.float32)
    got = tq.percentile_linear(torch.from_numpy(x), q).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.percentile(jnp.asarray(x), q)))


def test_torch_quantile_refuses_what_the_percentile_takes():
    x = torch.zeros(2 ** 24 + 1)
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(x, 0.9999)
    assert float(tq.percentile_linear(x, 99.99)) == 0.0
