"""The port's frozen stem against the JAX package, on the CPU.

Frames are made with numpy from a seed, at the real 160x208 (the fused block-1
kernel and the model's 10x13 planes need it), at most 4 frames per JAX call;
the JAX stem's weights cross over through ``stem_from_jax``. The Pallas
block-1 kernel runs in interpret mode on its ``relay_w2d_block1`` weights, as
its own test runs it. Tolerances:

- f32: rtol 2e-5, atol 2e-6, the JAX block-1 kernel test's own (sums taken
  in another order), through VGG; rtol and atol 1e-5 through the detector's
  six more convs, whose BatchNorms rescale by up to ~2;
- bf16: one bf16 ulp of the largest output for block 1, two for the whole
  VGG stem. Each conv rounds its output to bf16 after sums taken in another
  order, so a value can sit one ulp away and move a small output downstream
  by more than that output's own ulp. Three for the detector and the whole
  stem, whose eval BatchNorms rescale such a flip by up to ~2.1 (weight
  <= 1.5, var >= 0.5); and there, against JAX run op by op (each op rounds
  to bf16 where its code says; inside one jitted graph XLA's simplifier may
  drop bf16 round trips), at least BF16_EQUAL_SHARE of the outputs
  bit-equal: a bf16 rounding put in or left out (BN in bf16, convs in f32,
  the output rounded to bf16) leaves under half of them equal;
- the video-served model: f32 probabilities to atol 1e-6, as the engine's
  feature-served test.

Torch runs on at most 2 CPU threads while this file runs (restored after),
so it does not crowd the JAX tests that run beside it.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videonavqa_tpu.kernels.vgg_block1_pallas import vgg_block1_pallas, vgg_partial_w2d_pallas
from videonavqa_tpu.models import ModelConfig as JaxConfig
from videonavqa_tpu.models import get_model as jax_get_model
from videonavqa_tpu.stem import init_obj_detector as jax_init_obj_detector
from videonavqa_tpu.stem import init_vgg_partial as jax_init_vgg_partial
from videonavqa_tpu.stem import obj_detector_features as jax_obj_detector_features
from videonavqa_tpu.stem import stem_features as jax_stem_features
from videonavqa_tpu.stem import vgg_partial as jax_vgg_partial
from videonavqa_tpu.stem.vgg import relay_w2d_block1
from videonavqa_tpu.utils.checkpoint import save_checkpoint
from videonavqa_tpu_torch.kernels import vgg_block1 as block1_mod
from videonavqa_tpu_torch.models import ModelConfig
from videonavqa_tpu_torch.serve.engine import InferenceEngine
from videonavqa_tpu_torch.stem import (
    init_obj_detector, init_vgg_partial, obj_detector_features, stem_features, vgg_partial,
    vgg_partial_block1_kernel,
)
from videonavqa_tpu_torch.utils.checkpoint import stem_from_jax

F32_TOL = dict(rtol=2e-5, atol=2e-6)
DEEP_F32_TOL = dict(rtol=1e-5, atol=1e-5)
DEEP_BF16_ULPS = 3
BF16_EQUAL_SHARE = 0.6
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
NUM_FILTERS = 32


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _conv(r, cin, cout, bias_scale=0.0):
    """An HWIO conv as the JAX stem holds it: Xavier-uniform weight."""
    bound = np.sqrt(6.0 / (9 * (cin + cout)))
    return {"weight": r.uniform(-bound, bound, (3, 3, cin, cout)).astype(np.float32),
            "bias": (bias_scale * r.standard_normal(cout)).astype(np.float32)}


def _bn(r, c):
    return ({"weight": r.uniform(0.5, 1.5, c).astype(np.float32),
             "bias": (0.1 * r.standard_normal(c)).astype(np.float32)},
            {"mean": (0.1 * r.standard_normal(c)).astype(np.float32),
             "var": r.uniform(0.5, 2.0, c).astype(np.float32)})


@pytest.fixture(scope="module")
def jax_stem():
    """JAX-layout stem weights made with numpy (the trees of
    ``init_vgg_partial`` and ``init_obj_detector(num_filters=32)``), with
    block-1 biases non-zero, so relu(b1) != 0 and the frame-edge zeros
    matter, and BatchNorm statistics randomized; and the port's copy."""
    r = np.random.default_rng(7)
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
    port = stem_from_jax(vgg, det, det_state, torch.device("cpu"))
    jstem = jax.tree.map(jnp.asarray, (vgg, det, det_state))
    return jstem, port


def test_stem_init_trees_match_jax():
    """The port's init gives the JAX init's trees, conv kernels as OIHW."""
    tvgg = init_vgg_partial(torch.Generator().manual_seed(0))
    tdet, tdet_state = init_obj_detector(torch.Generator().manual_seed(0),
                                         num_filters=NUM_FILTERS)
    jvgg = jax.eval_shape(jax_init_vgg_partial, jax.random.PRNGKey(0))
    jdet, jdet_state = jax.eval_shape(
        functools.partial(jax_init_obj_detector, num_filters=NUM_FILTERS), jax.random.PRNGKey(0))

    def shapes(tree, hwio):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {jax.tree_util.keystr(k): tuple(np.array(v.shape)[[3, 2, 0, 1]])
                if hwio and len(v.shape) == 4 else tuple(v.shape) for k, v in flat}

    for port, ref in ((tvgg, jvgg), (tdet, jdet), (tdet_state, jdet_state)):
        assert shapes(port, False) == shapes(ref, True)
    assert all(float(t["bias"].abs().max()) == 0.0 for t in tvgg.values())


def _frames(n, seed=0):
    return np.random.default_rng(seed).random((n, 160, 208, 3), dtype=np.float32)


def _bf16_ulp(v):
    """One bf16 unit in the last place at |v| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(abs(float(v)), 2.0 ** -126))) - 7)


def _close(got, want, dtype, ulps):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=ulps * _bf16_ulp(np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block1_plain_matches_pallas(jax_stem, dtype):
    (vgg, _, _), (tvgg, _, _) = jax_stem
    jdt, tdt = DTYPES[dtype]
    x = _frames(1)
    want = vgg_block1_pallas(relay_w2d_block1(vgg), jnp.asarray(x), dtype=jdt, interpret=True)
    got = block1_mod.vgg_block1_plain(tvgg, torch.from_numpy(x), dtype=tdt)
    assert got.dtype == tdt
    _close(got.float(), np.asarray(want.astype(jnp.float32)), dtype, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["plain", "block1_kernel"])
def test_vgg_partial_matches_jax(jax_stem, route, dtype):
    (vgg, _, _), (tvgg, _, _) = jax_stem
    jdt, tdt = DTYPES[dtype]
    x = _frames(1, seed=1)
    if route == "plain":
        want = jax.jit(functools.partial(jax_vgg_partial, dtype=jdt))(vgg, jnp.asarray(x))
        got = vgg_partial(tvgg, torch.from_numpy(x), dtype=tdt)
    else:
        want = vgg_partial_w2d_pallas(relay_w2d_block1(vgg), vgg, jnp.asarray(x), dtype=jdt,
                                      interpret=True)
        before = block1_mod.launches
        got = vgg_partial_block1_kernel(tvgg, torch.from_numpy(x), dtype=tdt)
        assert block1_mod.launches == before  # the CPU runs the plain version
    assert got.shape == (1, 40, 52, 128)
    _close(got.float(), np.asarray(want.astype(jnp.float32)), dtype, 2)


def test_obj_detector_features_matches_jax(jax_stem):
    (_, det, det_state), (_, tdet, tdet_state) = jax_stem
    x = np.maximum(np.random.default_rng(2).standard_normal((2, 40, 52, 128)), 0).astype(np.float32)
    want = jax.jit(functools.partial(jax_obj_detector_features, dtype=jnp.float32))(
        det, det_state, jnp.asarray(x))
    got = obj_detector_features(tdet, tdet_state, torch.from_numpy(x), dtype=torch.float32)
    assert got.shape == (2, 10, 13, NUM_FILTERS) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DEEP_F32_TOL)


def _close_deep_bf16(got, want, *, equal_share):
    """Within DEEP_BF16_ULPS of the largest output, and at least
    ``equal_share`` of the outputs bit-equal."""
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=DEEP_BF16_ULPS * _bf16_ulp(np.abs(want).max()))
    assert float((got == want).mean()) >= equal_share


def test_obj_detector_features_bf16_matches_jax(jax_stem):
    """The detector in bf16, as the served stem runs it, against JAX op by op."""
    (_, det, det_state), (_, tdet, tdet_state) = jax_stem
    x = np.maximum(np.random.default_rng(2).standard_normal((3, 40, 52, 128)), 0).astype(np.float32)
    want = jax_obj_detector_features(det, det_state, jnp.asarray(x), dtype=jnp.bfloat16)
    got = obj_detector_features(tdet, tdet_state, torch.from_numpy(x), dtype=torch.bfloat16)
    _close_deep_bf16(got, want, equal_share=BF16_EQUAL_SHARE)


@pytest.mark.parametrize("frame_chunk", [None, 2])
def test_stem_features_bf16_matches_jax(jax_stem, frame_chunk):
    """The whole stem in bf16 with block 1 on the kernel's route, as the
    served stem runs it. With ``frame_chunk`` JAX's ``lax.map`` traces the
    chunk into one graph, so only the ulp bound applies there."""
    jstem, tstem = jax_stem
    video = _frames(3, seed=3).reshape(1, 3, 160, 208, 3)
    want = jax_stem_features(*jstem, jnp.asarray(video), dtype=jnp.bfloat16,
                             frame_chunk=frame_chunk)
    got = stem_features(*tstem, torch.from_numpy(video), dtype=torch.bfloat16,
                        frame_chunk=frame_chunk, use_kernel=True)
    assert got.shape == (1, 3, 10, 13, NUM_FILTERS)
    _close_deep_bf16(got, want, equal_share=BF16_EQUAL_SHARE if frame_chunk is None else 0.0)


@pytest.mark.parametrize("frame_chunk", [None, 2])
def test_stem_features_matches_jax(jax_stem, frame_chunk):
    """Three frames; chunk 2 pads them to four and trims the padding away."""
    jstem, tstem = jax_stem
    video = _frames(3, seed=3).reshape(1, 3, 160, 208, 3)
    want = jax.jit(functools.partial(jax_stem_features, dtype=jnp.float32,
                                     frame_chunk=frame_chunk))(*jstem, jnp.asarray(video))
    got = stem_features(*tstem, torch.from_numpy(video), dtype=torch.float32,
                        frame_chunk=frame_chunk, use_kernel=True)
    assert got.shape == (1, 3, 10, 13, NUM_FILTERS) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DEEP_F32_TOL)


SMALL = dict(num_classes=7, vocab_size=19, embed_size=8, hidden_size=8, at_hidden_size=8,
             num_res_blocks=1, num_res_block_channels=32, num_input_channels=NUM_FILTERS,
             max_num_frames=4, max_q_len=9, compute_dtype="float32")


@pytest.mark.parametrize("kernels", [False, True])
def test_video_served_film_attn_matches_jax(jax_stem, tmp_path, monkeypatch, kernels):
    """The slice end to end: uint8 frames through the engine's video mode
    (stem, then film_attn_pt) against JAX stem_features -> apply -> softmax on
    the same padded batch (2 rows, frame bucket 2)."""
    jstem, tstem = jax_stem
    if kernels:
        for mod_name, name in (("attn_tail_pallas", "attn_tail_pallas"),
                               ("film_reencode_pallas", "film_reencode_pallas")):
            mod = importlib.import_module(f"videonavqa_tpu.kernels.{mod_name}")
            monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))
    jcfg = JaxConfig(**SMALL, use_pallas_kernels=kernels)
    jspec = jax_get_model("film_attn_pt")
    jp, js = jax.jit(jspec.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    save_checkpoint(str(tmp_path / "w.npz"), params=jp, state=js, meta={})
    eng = InferenceEngine(ModelConfig(**SMALL, use_pallas_kernels=kernels),
                          checkpoint_path=str(tmp_path / "w.npz"), max_batch=2,
                          frame_buckets=(2, 4), device="cpu", from_video=True, stem=tstem)
    assert eng.visual_key == "video"
    r = np.random.default_rng(4)
    video = r.integers(0, 256, (2, 3, 160, 208, 3), dtype=np.uint8)
    items = [(video[0], 2, [3, 1, 4, 1, 5]), (video[1], 1, [9, 2, 6])]
    before = block1_mod.launches
    got = eng.run_batch(items)
    assert block1_mod.launches == before

    q = np.zeros((2, 56), np.int32)
    for i, (_, _, tok) in enumerate(items):
        q[i, :len(tok)] = tok
    batch = {"question": jnp.asarray(q), "v_len": jnp.asarray([2, 1], jnp.int32),
             "q_len": jnp.asarray([5, 3], jnp.int32)}

    def probs(p, s, video, b):
        feats = jax_stem_features(*jstem, video.astype(jnp.float32) / 255.0, dtype=jnp.float32)
        logits, _ = jspec.apply(p, s, dict(b, v_features=feats), jcfg, train=False,
                                rng=jax.random.PRNGKey(0))
        return jax.nn.softmax(logits, axis=-1)

    want = jax.jit(probs)(jp, js, jnp.asarray(video[:, :2]), batch)
    assert got.shape == (2, 7)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


def test_engine_video_mode_follows_compute_dtype_and_kernels(monkeypatch):
    """Video mode runs the stem in cfg.compute_dtype with use_kernel =
    cfg.use_pallas_kernels, and the calibration forward (int8 trunk) sees the
    stem's output; feature mode never calls the stem."""
    calls = []

    def fake_stem(vgg, det, det_state, video, *, dtype, use_kernel):
        calls.append((video.dtype, dtype, use_kernel))
        B, T = video.shape[:2]
        return torch.ones((B, T, 10, 13, 12))

    import videonavqa_tpu_torch.serve.engine as engine_mod
    monkeypatch.setattr(engine_mod, "stem_features", fake_stem)
    small = dict(num_classes=7, vocab_size=19, embed_size=8, hidden_size=8, at_hidden_size=8,
                 num_res_blocks=1, num_res_block_channels=16, num_input_channels=12,
                 max_num_frames=4)
    cfg = ModelConfig(**small, compute_dtype="bfloat16", use_pallas_kernels=True,
                      use_int8_trunk=True)
    eng = InferenceEngine(cfg, max_batch=2, frame_buckets=(4,), device="cpu", from_video=True)
    assert eng.stem[1]["conv11"]["weight"].shape == (12, 128, 3, 3)
    frames = np.zeros((4, 160, 208, 3), np.uint8)
    eng.run_batch([(frames, 4, [1, 2])])
    assert not eng.needs_int8_calibration
    eng.run_batch([(frames, 3, [1])])
    assert calls == [(torch.float32, torch.bfloat16, True)] * 2
    feat_eng = InferenceEngine(dataclasses.replace(cfg, use_int8_trunk=False), max_batch=1,
                               device="cpu")
    assert feat_eng.stem is None and feat_eng.visual_key == "v_features"
    feat_eng.run_batch([(np.ones((4, 10, 13, 12), np.float32), 4, [1])])
    assert len(calls) == 2
