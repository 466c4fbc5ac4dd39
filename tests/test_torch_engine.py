"""The port's serving engine and weight bridge against the JAX package, on the CPU.

``InferenceEngine.run_batch`` is held against the JAX ``apply_film_attn`` plus
softmax on the same padded batch (max_batch rows, padding rows with
v_len = q_len = 1, the frame axis trimmed to its bucket): f32 probabilities
to atol 1e-6. With the int8 trunk the first micro-batch calibrates, exactly
as the JAX daemon does; later batches agree to atol 1e-4 in probability
(one int8 step at a rounding boundary, see test_torch_film_attn.py).
"""

import dataclasses
import functools
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videonavqa_tpu.models import ModelConfig as JaxConfig
from videonavqa_tpu.models import get_model as jax_get_model
from videonavqa_tpu.utils.checkpoint import save_checkpoint
from videonavqa_tpu_torch.models import ModelConfig, get_model
from videonavqa_tpu_torch.serve.engine import InferenceEngine
from videonavqa_tpu_torch.utils import device as device_mod
from videonavqa_tpu_torch.utils.checkpoint import load_jax_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_classes=7, vocab_size=19, embed_size=8, hidden_size=8, at_hidden_size=8,
             num_res_blocks=2, num_res_block_channels=16, num_input_channels=12,
             num_tail_channels=4, max_num_frames=6, max_q_len=9, compute_dtype="float32")
BUCKETS = (2, 4, 6)
MAX_Q_LEN = 56


def _jax_init(jcfg):
    return jax.jit(jax_get_model("film_attn_pt").init, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)


def _jax_weights(path, **extra):
    jcfg = JaxConfig(**{**SMALL, **extra})
    jspec = jax_get_model("film_attn_pt")
    jp, js = _jax_init(jcfg)
    save_checkpoint(str(path), params=jp, state=js, meta={"epoch": 3})
    return jcfg, jspec, jp, js


def _items(seed, n, v_lens):
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        feats = np.maximum(r.standard_normal((6, 10, 13, 12)), 0).astype(np.float32)
        tokens = r.integers(1, 19, r.integers(1, 10)).tolist()
        out.append((feats, v_lens[i], tokens))
    return out


def _padded(items, B):
    """The JAX daemon's padding of one micro-batch (cli/serve.py dispatch_batch)."""
    t_b = min(t for t in BUCKETS if t >= max(max(v, 1) for _, v, _ in items))
    video = np.zeros((B, t_b, 10, 13, 12), np.float32)
    question = np.zeros((B, MAX_Q_LEN), np.int32)
    v_len = np.ones(B, np.int32)
    q_len = np.ones(B, np.int32)
    for i, (f, v, tok) in enumerate(items):
        video[i] = f[:t_b]
        question[i, :len(tok)] = tok
        v_len[i] = max(v, 1)
        q_len[i] = max(len(tok), 1)
    return {"v_features": jnp.asarray(video), "question": jnp.asarray(question),
            "v_len": jnp.asarray(v_len), "q_len": jnp.asarray(q_len)}


def _jax_probs(jspec, jp, js, items, jcfg, B):
    """JAX apply + softmax on the padded batch (jitted: cheaper on the CPU)."""
    logits, state = jax.jit(lambda p, s, b: jspec.apply(p, s, b, jcfg, train=False,
                                                        rng=jax.random.PRNGKey(0)))(
        jp, js, _padded(items, B))
    return np.asarray(jax.nn.softmax(logits, axis=-1))[:len(items)], state


def _engine(path, B, **extra):
    return InferenceEngine(ModelConfig(**{**SMALL, **extra}), checkpoint_path=str(path),
                           max_batch=B, frame_buckets=BUCKETS, device="cpu")


@pytest.mark.parametrize("v_lens", [(3, 1, 4), (6, 2, 5)])
def test_run_batch_matches_jax_apply_softmax(tmp_path, v_lens):
    jcfg, jspec, jp, js = _jax_weights(tmp_path / "w.npz")
    eng = _engine(tmp_path / "w.npz", 4, use_pallas_kernels=True)
    items = _items(0, 3, v_lens)
    got = eng.run_batch(items)
    want, _ = _jax_probs(jspec, jp, js, items, jcfg, 4)
    assert got.shape == (3, 7)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_int8_engine_calibrates_on_first_batch(tmp_path, monkeypatch):
    jcfg, jspec, jp, js = _jax_weights(tmp_path / "w.npz", use_int8_trunk=True,
                                       use_pallas_kernels=True)
    for mod_name, name in (("attn_tail_pallas", "attn_tail_pallas"),
                           ("film_reencode_pallas", "film_reencode_pallas"),
                           ("int8_matmul_pallas", "matmul_int8_fused_pallas")):
        mod = importlib.import_module(f"videonavqa_tpu.kernels.{mod_name}")
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))
    eng = _engine(tmp_path / "w.npz", 2, use_int8_trunk=True, use_pallas_kernels=True)
    first = _items(1, 1, (4,))  # padded to 2 rows; the padding row enters the absmax
    assert eng.needs_int8_calibration
    got = eng.run_batch(first)
    assert not eng.needs_int8_calibration
    want, jstate = _jax_probs(jspec, jp, js, first,
                              dataclasses.replace(jcfg, int8_trunk_calibrate=True), 2)
    np.testing.assert_allclose(got, want, atol=1e-6)
    for name, s in jstate["trunk"]["int8_scales"].items():
        np.testing.assert_allclose(float(eng.state["trunk"]["int8_scales"][name]), float(s),
                                   rtol=1e-5)
    second = _items(2, 2, (4, 3))
    got2 = eng.run_batch(second)
    want2, _ = _jax_probs(jspec, jp, jstate, second, jcfg, 2)
    np.testing.assert_allclose(got2, want2, atol=1e-4)
    np.testing.assert_array_equal(got2.argmax(-1), want2.argmax(-1))


@pytest.mark.parametrize("calibrated", [False, True])
def test_jax_checkpoint_through_the_bridge(tmp_path, calibrated):
    """A JAX save_checkpoint npz, read by the port's own reader, gives the same
    logits; conv kernels arrive OIHW, calibrated int8 state included."""
    extra = {"use_int8_trunk": True} if calibrated else {}
    jcfg = JaxConfig(**{**SMALL, **extra})
    jspec = jax_get_model("film_attn_pt")
    jp, js = _jax_init(jcfg)
    r = np.random.default_rng(3)
    b = {"v_features": np.maximum(r.standard_normal((2, 4, 10, 13, 12)), 0).astype(np.float32),
         "question": r.integers(1, 19, (2, 9)).astype(np.int32),
         "v_len": np.array([4, 2], np.int32), "q_len": np.array([9, 3], np.int32)}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    apply = lambda c: jax.jit(lambda p, s, b: jspec.apply(p, s, b, c, train=False,
                                                          rng=jax.random.PRNGKey(0)))
    if calibrated:
        _, js = apply(dataclasses.replace(jcfg, int8_trunk_calibrate=True))(jp, js, jb)
    save_checkpoint(str(tmp_path / "c.npz"), params=jp, state=js, meta={"epoch": 7})
    params, state, meta = load_jax_checkpoint(str(tmp_path / "c.npz"), torch.device("cpu"))
    assert meta == {"epoch": 7}
    w = np.asarray(jp["trunk"]["conv3x3_0"]["weight"])
    np.testing.assert_array_equal(params["trunk"]["conv3x3_0"]["weight"].numpy(),
                                  w.transpose(3, 2, 0, 1))
    if calibrated:
        wq = np.asarray(js["trunk"]["int8_wq"]["conv1x1_1"]["wq"])
        np.testing.assert_array_equal(state["trunk"]["int8_wq"]["conv1x1_1"]["wq"].numpy(),
                                      wq.transpose(3, 2, 0, 1))
    want, _ = apply(jcfg)(jp, js, jb)
    got, _ = get_model("film_attn_pt").apply(
        params, state, {k: torch.from_numpy(v) for k, v in b.items()},
        ModelConfig(**{**SMALL, **extra}))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_bucket_for():
    eng = InferenceEngine(ModelConfig(**SMALL), max_batch=2, device="cpu")
    assert [eng.bucket_for(v) for v in (0, 1, 8, 9, 34, 35)] == [8, 8, 8, 12, 35, 35]
    eng.frame_buckets = (4, 8)
    assert [eng.bucket_for(v) for v in (3, 8, 9)] == [4, 8, 35]
    with pytest.raises(ValueError):
        eng.run_batch(_items(0, 3, (1, 2, 3)))  # more items than max_batch


@pytest.mark.parametrize("model,from_video,key", [
    ("film_attn_pt", False, "v_features"), ("film_attn_pt", True, "video"),
    ("v_only_cnn2d_lstm", False, "video"), ("v_only_cnn2d_lstm", True, "video"),
    ("lstm", False, None)])
def test_what_an_item_carries(model, from_video, key):
    """Today's callers keep today's items; video mode adds the stem for a stem
    model only (a model that takes frames itself gets them as before)."""
    eng = InferenceEngine(ModelConfig(**{**SMALL, "model": model}), max_batch=1, device="cpu",
                          from_video=from_video)
    assert eng.visual_key == key
    assert (eng.stem is not None) == (model == "film_attn_pt" and from_video)


def test_video_mode_refuses_a_model_without_video():
    with pytest.raises(ValueError, match="takes no video"):
        InferenceEngine(ModelConfig(**{**SMALL, "model": "lstm"}), max_batch=1, device="cpu",
                        from_video=True)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(ModelConfig(**SMALL))
    with pytest.raises(RuntimeError, match="CUDA"):
        device_mod.resolve_device("cuda:0")
    assert device_mod.resolve_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = """
import pkgutil, importlib, sys
import videonavqa_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(videonavqa_tpu_torch.__path__, 'videonavqa_tpu_torch.')]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'
             or m == 'videonavqa_tpu' or m.startswith('videonavqa_tpu.'))
print(len(mods), bad)
assert not bad, bad
# the card's machine may lack these: nothing imports them at import time
absent = sorted(m for m in ('cv2', 'ml_dtypes', 'zstandard', 'optax') if m in sys.modules)
assert not absent, absent
for want in ('kernels.lstm', 'models.q_only_lstm', 'models.time_multi_hop',
             'models.v_only_cnn2d_lstm', 'models.concat2d', 'models.mac', 'ops.video',
             'stem', 'stem.vgg', 'stem.obj_detector', 'kernels.vgg_block1', 'cli.common',
             'data.pipeline', 'data.vnr', 'data.prefetch', 'utils.logging',
             'cli.q_and_v_eval', 'cli.v_only_eval', 'cli.q_only_eval',
             'cli.extract_features', 'cli.serve', 'cli.predict', 'serve.engine',
             'serve.batcher', 'serve.http', 'datagen.encode', 'datagen.ontology',
             'models.v_only_cnn3d', 'models.concat3d', 'models.q_only_bow',
             'cli.q_and_v_test', 'cli.q_only_test', 'cli.v_only_test',
             'cli.results_analysis', 'stem.quant', 'cli.train_obj_detector',
             'utils.zoo_import', 'utils.zoo_export', 'cli.export_checkpoint'):
    assert 'videonavqa_tpu_torch.' + want in mods, want
assert len(mods) >= 73, len(mods)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
