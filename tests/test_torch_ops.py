"""The PyTorch port's ops against the JAX package's, on the CPU at small width.

Inputs are made with numpy from a seed and handed to both sides. Float ops
agree to atol 1e-5 (f32, sums in another order), the ops without a long sum
(the norms, pooling, video normalization, the reversal) to atol 1e-6; the
int8 quantizers and the int8 convs' integer parts agree bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videonavqa_tpu.models.base import ModelConfig as JaxModelConfig
from videonavqa_tpu.ops import conv as jconv
from videonavqa_tpu.ops import initializers as jinit
from videonavqa_tpu.ops import linear as jlinear
from videonavqa_tpu.ops import lstm as jlstm
from videonavqa_tpu.ops import masking as jmasking
from videonavqa_tpu.ops import norm as jnorm
from videonavqa_tpu.ops import quant as jquant
from videonavqa_tpu.ops import video as jvideo
from videonavqa_tpu.models import concat2d as jconcat2d
from videonavqa_tpu.models import v_only_cnn2d_lstm as jv_only
from videonavqa_tpu.utils.checkpoint import flatten_tree
from videonavqa_tpu.utils import constants as jconstants
from videonavqa_tpu_torch.models.base import ModelConfig
from videonavqa_tpu_torch.models import concat2d, v_only_cnn2d_lstm
from videonavqa_tpu_torch.ops import (
    conv, initializers, linear, lstm, masking, norm, quant, video)
from videonavqa_tpu_torch.utils import constants
from videonavqa_tpu_torch.utils.checkpoint import params_from_jax
from videonavqa_tpu_torch.utils.device import tree_to

TIGHT_ATOL = 1e-6

ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(tree):
    """numpy (nested dict) -> torch."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _hwio_to_oihw(w):
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def test_model_config_fields_match_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(ModelConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(JaxModelConfig)])


def test_constants_match_jax():
    for name in dir(jconstants):
        if name.isupper():
            assert getattr(constants, name) == getattr(jconstants, name), name
    # constants the models copy
    assert v_only_cnn2d_lstm.VGG11_CFG == jv_only.VGG11_CFG
    assert v_only_cnn2d_lstm.FRAME_FEAT_DIM == jv_only.FRAME_FEAT_DIM
    assert concat2d.HIDDEN_SIZE == jconcat2d.HIDDEN_SIZE
    assert norm.EPS == jnorm.EPS


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    r = _rng(1)
    p = {"weight": r.standard_normal((5, 7)).astype(np.float32)}
    if bias:
        p["bias"] = r.standard_normal(5).astype(np.float32)
    x = r.standard_normal((3, 4, 7)).astype(np.float32)
    want = np.asarray(jlinear.linear(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    np.testing.assert_allclose(linear.linear(_t(p), _t(x)).numpy(), want, atol=ATOL)


def test_linear_chw():
    r = _rng(2)
    p = {"weight": r.standard_normal((6, 4 * 10 * 13)).astype(np.float32),
         "bias": r.standard_normal(6).astype(np.float32)}
    x = r.standard_normal((2, 3, 10, 13, 4)).astype(np.float32)
    want = np.asarray(jlinear.linear_chw(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    np.testing.assert_allclose(linear.linear_chw(_t(p), _t(x)).numpy(), want, atol=ATOL)


def test_embedding():
    """film_attn's embedding: no padding_idx, so pad tokens read the live row 0."""
    r = _rng(3)
    w = r.standard_normal((11, 4)).astype(np.float32)
    tok = r.integers(0, 11, (3, 9)).astype(np.int32)
    tok[:, -2:] = 0
    want = np.asarray(jlinear.embedding({"weight": jnp.asarray(w)}, jnp.asarray(tok),
                                        padding_idx=None))
    np.testing.assert_array_equal(linear.embedding({"weight": _t(w)}, _t(tok)).numpy(), want)


def test_masks():
    lens = np.array([4, 1, 2], np.int32)  # batch max 4 < T: frames 4, 5 unmasked
    T = 6
    np.testing.assert_array_equal(masking.length_mask(_t(lens), T).numpy(),
                                  np.asarray(jmasking.length_mask(jnp.asarray(lens), T)))
    got = masking.attn_frame_mask(_t(lens), T)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jmasking.attn_frame_mask(jnp.asarray(lens), T)))
    x = _rng(4).standard_normal((3, T, 2, 5)).astype(np.float32)
    np.testing.assert_array_equal(masking.mask_invalid(_t(x), _t(lens)).numpy(),
                                  np.asarray(jmasking.mask_invalid(jnp.asarray(x),
                                                                   jnp.asarray(lens))))


def _lstm_params(r, E, H):
    return {"w_ih": r.standard_normal((4 * H, E)).astype(np.float32) * 0.3,
            "w_hh": r.standard_normal((4 * H, H)).astype(np.float32) * 0.3,
            "b_ih": r.standard_normal(4 * H).astype(np.float32) * 0.1,
            "b_hh": r.standard_normal(4 * H).astype(np.float32) * 0.1}


def test_lstm_cell():
    r = _rng(5)
    p = _lstm_params(r, 6, 8)
    x, h, c = (r.standard_normal((3, n)).astype(np.float32) for n in (6, 8, 8))
    jh, jc = jlstm.lstm_cell(jax.tree.map(jnp.asarray, p), *map(jnp.asarray, (x, h, c)))
    th, tc = lstm.lstm_cell(_t(p), _t(x), _t(h), _t(c))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)


@pytest.mark.parametrize("carry", [False, True])
def test_masked_lstm_and_last_valid(carry):
    r = _rng(6)
    B, T, E, H = 4, 9, 6, 8
    p = _lstm_params(r, E, H)
    x = r.standard_normal((B, T, E)).astype(np.float32)
    lens = np.array([9, 4, 1, 7], np.int32)
    h0 = c0 = None
    if carry:
        h0, c0 = (r.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    jp = jax.tree.map(jnp.asarray, p)
    jout, (jh, jc) = jlstm.lstm(jp, jnp.asarray(x), jnp.asarray(lens),
                               None if h0 is None else jnp.asarray(h0),
                               None if c0 is None else jnp.asarray(c0))
    tout, (th, tc) = lstm.lstm(_t(p), _t(x), _t(lens), None if h0 is None else _t(h0),
                               None if c0 is None else _t(c0))
    for got, want in ((tout, jout), (th, jh), (tc, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(lstm.last_valid(tout, _t(lens)).numpy(),
                               np.asarray(jlstm.last_valid(jout, jnp.asarray(lens))), atol=ATOL)


def test_frame_batch_norm_eval():
    r = _rng(7)
    C = 5
    params = {"weight": r.standard_normal(C).astype(np.float32),
              "bias": r.standard_normal(C).astype(np.float32)}
    state = {"mean": r.standard_normal(C).astype(np.float32),
             "var": r.uniform(0.5, 2.0, C).astype(np.float32)}
    x = r.standard_normal((2, 3, 4, 5, C)).astype(np.float32)
    fm = np.ones((2, 3), bool)
    want, _ = jnorm.frame_batch_norm(jax.tree.map(jnp.asarray, params),
                                     jax.tree.map(jnp.asarray, state), jnp.asarray(x),
                                     jnp.asarray(fm), train=False)
    got, _ = norm.frame_batch_norm(_t(params), _t(state), _t(x).to(torch.bfloat16).float(),
                                   _t(fm), train=False)
    want_bf, _ = jnorm.frame_batch_norm(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(fm), train=False)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want_bf), atol=ATOL)
    got32, _ = norm.frame_batch_norm(_t(params), _t(state), _t(x), _t(fm), train=False)
    np.testing.assert_allclose(got32.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("k", [1, 3])
def test_conv2d(k):
    r = _rng(8 + k)
    w = r.standard_normal((k, k, 6, 4)).astype(np.float32) * 0.3
    b = r.standard_normal(4).astype(np.float32)
    x = r.standard_normal((2, 10, 13, 6)).astype(np.float32)
    want = np.asarray(jconv.conv2d({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                                   jnp.asarray(x), dtype=jnp.float32))
    got = conv.conv2d({"weight": _t(_hwio_to_oihw(w)), "bias": _t(b)}, _t(x),
                      dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_quantize_weight_channelwise_bitwise():
    w = (_rng(10).standard_normal((3, 3, 6, 4)) * 0.3).astype(np.float32)
    jq, js = jquant.quantize_weight_channelwise(jnp.asarray(w))
    tq, ts = quant.quantize_weight_channelwise(_t(_hwio_to_oihw(w)))
    np.testing.assert_array_equal(tq.numpy(), _hwio_to_oihw(np.asarray(jq)))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("cin", [16, 6])  # the im2col copies 4-byte words only when cin % 4 == 0
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("preq_act", [False, True])
def test_int8_convs(k, preq_act, cin):
    """The int8 convs: int8 product exact, f32 dequant to round-off."""
    r = _rng(11 + k)
    w = (r.standard_normal((k, k, cin, 8)) * 0.3).astype(np.float32)
    b = r.standard_normal(8).astype(np.float32)
    x = r.standard_normal((2, 10, 13, cin)).astype(np.float32)
    absmax = np.float32(1.25 * np.abs(x).max())
    jq, js = jquant.quantize_weight_channelwise(jnp.asarray(w))
    tq, ts = quant.quantize_weight_channelwise(_t(_hwio_to_oihw(w)))
    if preq_act:
        xq = np.clip(np.round(x / (absmax / np.float32(127.0))), -127, 127).astype(np.int8)
        want = jquant.conv2d_int8_preq_act(jq, js, jnp.asarray(b), jnp.asarray(xq),
                                           jnp.asarray(absmax))
        got = quant.conv2d_int8_preq_act(tq, ts, _t(b), _t(xq), torch.tensor(absmax))
    else:
        want = jquant.conv2d_int8_prequant(jq, js, jnp.asarray(b), jnp.asarray(x),
                                           jnp.asarray(absmax))
        got = quant.conv2d_int8_prequant(tq, ts, _t(b), _t(x), torch.tensor(absmax))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # the integer part alone: bitwise
    xq_t = quant.quantize_act(_t(x), quant.act_scale(torch.tensor(absmax)))
    want_acc = jquant._conv_i8(jnp.asarray(xq_t.numpy()), jq, (1, 1), "SAME")
    np.testing.assert_array_equal(quant.conv_i8(xq_t, tq).numpy(), np.asarray(want_acc))


def test_initializers_follow_the_reference_scheme():
    g = torch.Generator().manual_seed(0)
    cell = initializers.reference_lstm(g, 6, 8)
    assert cell["w_ih"].shape == (32, 6) and cell["w_hh"].shape == (32, 8)
    np.testing.assert_array_equal(cell["b_hh"].numpy()[8:16], 1.0)
    assert float(cell["b_ih"].abs().sum()) == 0.0
    # orthogonal w_hh: columns orthonormal, as torch.nn.init.orthogonal_
    np.testing.assert_allclose((cell["w_hh"].t() @ cell["w_hh"]).numpy(), np.eye(8),
                               atol=1e-5)
    w = initializers.reference_conv2d(g, 3, 3, 64, 32)["weight"]
    jw = jinit.reference_conv2d(jax.random.PRNGKey(0), 3, 3, 64, 32)["weight"]
    assert w.shape == (32, 64, 3, 3)
    bound = np.sqrt(6.0 / (64 * 9 + 32 * 9))
    assert float(w.abs().max()) <= bound and float(np.abs(np.asarray(jw)).max()) <= bound
    assert abs(float(w.std()) - float(np.asarray(jw).std())) < 0.05 * bound
    lin = initializers.reference_linear(g, 5, 7)
    assert lin["weight"].shape == (5, 7) and float(lin["bias"].abs().sum()) == 0.0


@pytest.mark.parametrize("padding_idx", [None, 0])
def test_embedding_padding_idx(padding_idx):
    r = _rng(20)
    w = r.standard_normal((11, 4)).astype(np.float32)
    tok = r.integers(0, 11, (3, 6)).astype(np.int32)
    tok[0, 4:] = 0
    want = jlinear.embedding({"weight": jnp.asarray(w)}, jnp.asarray(tok),
                             padding_idx=padding_idx)
    got = linear.embedding({"weight": _t(w)}, _t(tok), padding_idx=padding_idx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reverse_padded():
    r = _rng(21)
    x = r.standard_normal((4, 9, 3)).astype(np.float32)
    lens = np.array([9, 4, 1, 7], np.int32)
    want = jlstm.reverse_padded(jnp.asarray(x), jnp.asarray(lens))
    got = lstm.reverse_padded(_t(x), _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TIGHT_ATOL)
    np.testing.assert_array_equal(got.numpy()[1, :4], x[1, 3::-1])


def test_bilstm():
    r = _rng(22)
    B, T, E, H = 4, 9, 6, 8
    pf, pb = _lstm_params(r, E, H), _lstm_params(r, E, H)
    x = r.standard_normal((B, T, E)).astype(np.float32)
    lens = np.array([9, 4, 1, 7], np.int32)
    jout, jh = jlstm.bilstm(jax.tree.map(jnp.asarray, pf), jax.tree.map(jnp.asarray, pb),
                            jnp.asarray(x), jnp.asarray(lens))
    tout, th = lstm.bilstm(_t(pf), _t(pb), _t(x), _t(lens), use_kernel=True)
    assert tout.shape == (B, T, 2 * H) and th.shape == (B, 2 * H)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    assert float(tout[1, 4:].abs().max()) == 0.0   # both directions zero beyond len


def test_batch_norm_eval():
    r = _rng(23)
    C = 3
    p = {"weight": r.standard_normal(C).astype(np.float32),
         "bias": r.standard_normal(C).astype(np.float32)}
    st = {"mean": r.standard_normal(C).astype(np.float32),
          "var": (r.random(C) + 0.5).astype(np.float32)}
    x = r.standard_normal((2, 3, 4, 5, C)).astype(np.float32)
    want, _ = jnorm.batch_norm(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, st),
                               jnp.asarray(x), train=False)
    got, st2 = norm.batch_norm(_t(p), _t(st), _t(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TIGHT_ATOL)
    np.testing.assert_array_equal(st2["mean"].numpy(), st["mean"])


def test_layer_norm():
    r = _rng(24)
    C = 12
    p = {"weight": r.standard_normal(C).astype(np.float32),
         "bias": r.standard_normal(C).astype(np.float32)}
    x = r.standard_normal((3, 5, C)).astype(np.float32)
    want = jnorm.layer_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    np.testing.assert_allclose(norm.layer_norm(_t(p), _t(x)).numpy(), np.asarray(want),
                               atol=TIGHT_ATOL)
    fresh = norm.init_layer_norm(C)
    jfresh = jnorm.init_layer_norm(C)
    for k in ("weight", "bias"):
        np.testing.assert_array_equal(fresh[k].numpy(), np.asarray(jfresh[k]))


@pytest.mark.parametrize("hw", [(10, 13), (4, 6), (5, 5)])
def test_max_pool2d(hw):
    x = _rng(25).standard_normal((2, 3, *hw, 4)).astype(np.float32)
    want = jconv.max_pool2d(jnp.asarray(x))
    got = conv.max_pool2d(_t(x))
    assert got.shape == (2, 3, hw[0] // 2, hw[1] // 2, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TIGHT_ATOL)


def test_five_pools_of_a_frame():
    x = torch.zeros((1, constants.VID_HEIGHT, constants.VID_WIDTH, 1))
    for _ in range(5):
        x = conv.max_pool2d(x)
    assert x.shape == (1, 5, 6, 1)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_normalize_video(dtype):
    r = _rng(26)
    x = (r.integers(0, 256, (2, 3, 4, 5, 3)).astype(dtype) if dtype == np.uint8
         else r.random((2, 3, 4, 5, 3)).astype(dtype))
    want = jvideo.normalize_video(jnp.asarray(x))
    got = video.normalize_video(_t(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TIGHT_ATOL)


def test_torch_default_initializers_shapes_and_bounds():
    """Only shapes, bounds and dtypes: the two generators cannot agree."""
    g = torch.Generator().manual_seed(1)
    cell = initializers.torch_default_lstm(g, 6, 16)
    jcell = jinit.torch_default_lstm(jax.random.PRNGKey(1), 6, 16)
    for k, v in cell.items():
        assert v.shape == jcell[k].shape and v.dtype == torch.float32
        assert float(v.abs().max()) <= 0.25
    lin = initializers.torch_default_linear(g, 5, 16)
    assert lin["weight"].shape == (5, 16) and lin["bias"].shape == (5,)
    assert float(lin["weight"].abs().max()) <= 0.25 and float(lin["bias"].abs().max()) <= 0.25
    cv = initializers.torch_default_conv2d(g, 3, 3, 4, 8)
    jw, jb = jinit.torch_default_conv2d(jax.random.PRNGKey(1), 3, 3, 4, 8)
    assert cv["weight"].shape == (8, 4, 3, 3) == _hwio_to_oihw(jw).shape
    assert cv["bias"].shape == jb.shape
    bound = 1.0 / np.sqrt(4 * 9)
    assert float(cv["weight"].abs().max()) <= bound and float(cv["bias"].abs().max()) <= bound
    k = initializers.kaiming_uniform(g, (8, 4, 3, 3), "oihw")
    assert float(k.abs().max()) <= np.sqrt(6.0 / 36)
    assert float(k.abs().max()) > bound   # wider than the default init's bound
    assert initializers.kaiming_uniform(g, (5, 7), "oi").shape == (5, 7)


def test_saved_lists_come_back_as_lists():
    """A list in the JAX pytree (MAC's position_aware) is saved under the keys
    0, 1, ...; the bridge gives the model a list again, at any depth."""
    tree = {"mac": {"position_aware": [{"weight": jnp.full((2, 3), float(i))}
                                       for i in range(11)],
                    "mem_0": jnp.zeros((1, 2))}}
    params, _ = params_from_jax(flatten_tree(tree, "params/"))
    pa = params["mac"]["position_aware"]
    assert isinstance(pa, list) and len(pa) == 11
    assert [float(p["weight"][0, 0]) for p in pa] == [float(i) for i in range(11)]
    moved = tree_to(params, torch.device("cpu"))
    assert isinstance(moved["mac"]["position_aware"], list)


def test_word_softmax_mask_runs_to_the_batch_max():
    m = masking.word_softmax_mask(torch.tensor([3, 5, 1]), 7)
    assert m.shape == (1, 7) and m.dtype == torch.float32
    np.testing.assert_array_equal(m.numpy()[0], [0, 0, 0, 0, 0, -np.inf, -np.inf])
