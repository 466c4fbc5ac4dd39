"""The port's feature cache (cli/extract_features.py, --feature_cache) and the
FiLM trunk's static and dynamic int8 forms, against the JAX package on the CPU.

- Extraction of a tiny packed dataset (2 videos of 8 real 160x208 frames, the
  port's seeded stem in bf16) equals the port's ``stem_features`` of those
  frames bit for bit, and JAX's ``VNRBatchLoader`` reads the port's ``.fnr``
  back with the same features, tokens, labels, q_ids and lengths.
- The stem fingerprint: stable; changed by the weight files, the dtype and the
  backend; never JAX's for the same files.
- fp8: the stored bits are torch's and ml_dtypes' rounding of the same f32
  features, and a forward from them gives JAX's logits (atol 1e-5).
- One epoch of both harnesses with ``--feature_cache true`` from one JAX
  checkpoint, each over a ``.fnr`` holding the same feature bits under its own
  package's fingerprint (a cheap stand-in stem wrote them; neither run loads a
  stem): epoch losses rtol 1e-5, hits and predictions equal. A port run with
  fp8 and ``--int8_trunk true`` extracts once, then reuses its cache.
- ``conv2d_int8_static`` / ``conv2d_int8_dynamic`` against JAX's, and
  film_attn_pt's static and dynamic int8 trunk: logits atol 2e-3, argmax equal.
"""

import argparse
import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from videonavqa_tpu.cli import common as jcommon
from videonavqa_tpu.cli import extract_features as jef
from videonavqa_tpu.cli import q_and_v_eval as jq_and_v
from videonavqa_tpu.data import vnr as jvnr
from videonavqa_tpu.models import ModelConfig as JaxConfig
from videonavqa_tpu.models import get_model as jax_get_model
from videonavqa_tpu.ops import quant as jquant
from videonavqa_tpu.train import step as jstep
from videonavqa_tpu.utils import checkpoint as jckpt
from videonavqa_tpu_torch.cli import common as tcommon
from videonavqa_tpu_torch.cli import extract_features as ef
from videonavqa_tpu_torch.cli import q_and_v_eval
from videonavqa_tpu_torch.data import vnr
from videonavqa_tpu_torch.data.pipeline import DataPaths, load_json
from videonavqa_tpu_torch.data.synthetic import generate_synthetic_dataset
from videonavqa_tpu_torch.models import ModelConfig, get_model
from videonavqa_tpu_torch.models import film as film_mod
from videonavqa_tpu_torch.ops import quant
from videonavqa_tpu_torch.ops.video import normalize_video
from videonavqa_tpu_torch.train.step import forward
from videonavqa_tpu_torch.utils import checkpoint as tckpt
from videonavqa_tpu_torch.utils.checkpoint import load_jax_checkpoint

LOSS_RTOL = 1e-5
INT8_ATOL = 2e-3
FP8_ATOL = 1e-5
# A stand-in stem with the real stem's output geometry (10 x 13 x 512): a
# 16 x 16 average pool, a seeded 3 -> 512 projection and a ReLU, in jnp and torch.
STEM_W = (np.random.default_rng(77).standard_normal((3, 512)) * 0.5).astype(np.float32)
FNR_FINGERPRINT_OFFSET = 20   # data/vnr.py RecordWriter.close: header v2


def jax_stand_in(video):
    B, T = video.shape[:2]
    x = video.reshape(B, T, 10, 16, 13, 16, 3).mean(axis=(3, 5))
    return jax.nn.relu(x @ jnp.asarray(STEM_W))


def torch_stand_in(video):
    B, T = video.shape[:2]
    x = video.reshape(B, T, 10, 16, 13, 16, 3).mean(dim=(3, 5))
    return torch.relu(x @ torch.from_numpy(STEM_W))


@pytest.fixture(autouse=True)
def _two_threads():
    """Torch on 2 CPU threads, so the JAX tests beside it are not starved."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nest(flat, prefix):
    tree = {}
    for key, a in flat.items():
        if key.startswith(prefix):
            *parents, leaf = key[len(prefix):].split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(a)
    return tree


def jax_weights(path, cfg, *, seed=0, l_rate=None):
    """Writes a JAX-package checkpoint at ``path`` holding the port's seeded
    init of ``cfg`` (with a fresh optax Adam state at ``l_rate``, epoch -1,
    where given) -> its (params, state) as JAX trees. (The JAX package's own
    init takes 5-8 s a call on the CPU at 512 input channels; the weights'
    values do not matter here, only that both packages start from them.)"""
    params, state = get_model(cfg.model).init(torch.Generator().manual_seed(seed), cfg,
                                              torch.device("cpu"))
    tckpt.save_checkpoint(path, params=params, state=state)
    flat, _ = tckpt.read_npz(path)
    jp, js = _nest(flat, "params/"), _nest(flat, "state/")
    if l_rate is not None:
        jckpt.save_checkpoint(path, params=jp, state=js,
                              opt_state=jstep.make_optimizer(l_rate).init(jp), meta={"epoch": -1})
    return jp, js


def extract_args(data_dir, **kw):
    return argparse.Namespace(**{**dict(data_dir=data_dir, device="cpu",
                                        compute_dtype="float32", feature_dtype="bfloat16",
                                        frcnn_pretrained_path=None, chunk=128,
                                        compress="zstd"), **kw})


def write_features(data_dir, splits, feature_dtype="bfloat16"):
    """The splits' feature files, written by the port's extraction through the
    torch stand-in stem under the port's fingerprint (f32 stem, the CPU)."""
    vnr.ensure_built()
    args = extract_args(data_dir, feature_dtype=feature_dtype)
    split_map = load_json(DataPaths(data_dir).split_file)
    return {s: ef.extract_split(args, torch_stand_in, s, split_map[s]) for s in splits}


def jax_copy(data_dir, out_dir, jax_args, feature_dtype="bfloat16"):
    """A copy of ``data_dir`` whose feature files carry the JAX package's
    fingerprint for ``jax_args`` (the feature bits unchanged)."""
    shutil.copytree(data_dir, out_dir)
    want = jef.stem_fingerprint(jax_args, jcommon.DataPaths(out_dir))
    for name in os.listdir(out_dir):
        if name.startswith("features_") and name.endswith(".fnr"):
            with open(os.path.join(out_dir, name), "r+b") as f:
                f.seek(FNR_FINGERPRINT_OFFSET)
                f.write(want)
    return out_dir


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """2 train, 2 val and 2 test videos of 8 raw frames (one chunk of 8)."""
    out = str(tmp_path_factory.mktemp("fcache_tiny"))
    generate_synthetic_dataset(out, num_houses=3, trajs_per_house=2, seed=11,
                               video_format="npy", min_frames=8, max_frames=8)
    return out


@pytest.fixture(scope="module")
def extracted(tiny):
    """The train split extracted with the port's seeded stem in bf16."""
    vnr.ensure_built()
    args = extract_args(tiny, compute_dtype="bfloat16")
    paths = DataPaths(tiny)
    stem_fn = tcommon.load_stem(args, paths, torch.device("cpu"))
    ids = sorted(load_json(paths.split_file)["train"])
    return ef.extract_split(args, stem_fn, "train", ids), stem_fn, ids


def test_extraction_equals_the_stem_bit_for_bit(extracted, tiny):
    path, stem_fn, ids = extracted
    assert path == os.path.join(tiny, "features_train.fnr") and len(ids) == 2
    loader = vnr.VNRBatchLoader(path, 1, shuffle=False, mode="test")
    assert loader.torch_dtype == torch.bfloat16 and loader.frame_shape == (10, 13, 512)
    for i, ex in enumerate(ids):
        frames = np.load(os.path.join(tiny, "videos", ex + ".npy"))
        assert frames.shape == (8, 160, 208, 3)
        want = stem_fn(normalize_video(torch.from_numpy(frames)[None]))[0]
        got = torch.from_numpy(loader.example_frames(i)).view(torch.bfloat16)
        assert torch.equal(got.view(torch.int16), want.to(torch.bfloat16).view(torch.int16))
    loader.close()


def test_jax_loader_reads_the_port_cache(extracted, tiny):
    path, _, ids = extracted
    jl = jvnr.VNRBatchLoader(path, 2, shuffle=False, mode="test")
    tl = vnr.VNRBatchLoader(path, 2, shuffle=False, mode="test")
    assert jl.n == tl.n == len(ids) and jl.frame_shape == (10, 13, 512)
    np.testing.assert_array_equal(jl.lengths, tl.lengths)
    np.testing.assert_array_equal(jl.lengths, [2, 2])   # ceil(8 / 4)
    labels = load_json(os.path.join(tiny, "labels.json"))
    q_ids = load_json(os.path.join(tiny, "q_ids.json"))
    for i, ex in enumerate(ids):
        np.testing.assert_array_equal(jl.example_frames(i).view(np.uint16),
                                      tl.example_frames(i))
        tokens, label, q_id = jl.example_meta(i)
        np.testing.assert_array_equal(
            tokens, np.load(os.path.join(tiny, "encoded_questions", ex + ".npy")))
        assert (label, q_id) == (labels[ex], q_ids[ex])
    jb, tb = next(iter(jl.epoch(0))), next(iter(tl.epoch(0)))
    np.testing.assert_array_equal(jb["v_features"].view(np.uint16), tb["v_features"])
    for k in ("v_len", "question", "q_len", "label", "q_id"):
        np.testing.assert_array_equal(jb[k], tb[k])
    assert jvnr.read_fingerprint(path) == ef.stem_fingerprint(
        extract_args(tiny, compute_dtype="bfloat16"), DataPaths(tiny))
    jl.close()
    tl.close()


def test_stem_fingerprint(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    paths = DataPaths(str(data))
    args = extract_args(str(data))
    base = ef.stem_fingerprint(args, paths)
    assert len(base) == 16 and ef.stem_fingerprint(args, paths) == base
    ef._FINGERPRINT_CACHE.clear()
    assert ef.stem_fingerprint(args, paths) == base   # stable, not only memoized
    changed = {
        "dtype": ef.stem_fingerprint(extract_args(str(data), compute_dtype="bfloat16"), paths),
        "backend": ef.stem_fingerprint(extract_args(str(data), device="cuda"), paths),
    }
    vgg = tmp_path / "vgg16_caffe.pth"
    vgg.write_bytes(b"vgg weights")
    changed["vgg file"] = ef.stem_fingerprint(
        extract_args(str(data), frcnn_pretrained_path=str(vgg)), paths)
    vgg.write_bytes(b"other vgg weights")
    changed["vgg contents"] = ef.stem_fingerprint(
        extract_args(str(data), frcnn_pretrained_path=str(vgg)), paths)
    (data / "obj_detect.pt").write_bytes(b"detector")
    changed["detector file"] = ef.stem_fingerprint(args, paths)
    assert len({base, *changed.values()}) == 1 + len(changed), changed
    # JAX's fingerprint of the same files and dtype is never the port's
    (data / "obj_detect.pt").unlink()
    for kw in ({}, {"compute_dtype": "bfloat16"}, {"frcnn_pretrained_path": str(vgg)}):
        a = extract_args(str(data), **kw)
        assert jef.stem_fingerprint(a, jcommon.DataPaths(str(data))) != \
            ef.stem_fingerprint(a, paths)


FP8_CFG = dict(num_classes=7, vocab_size=134, embed_size=8, hidden_size=8, at_hidden_size=8,
               num_res_blocks=1, num_res_block_channels=16, num_input_channels=512,
               max_num_frames=6, compute_dtype="float32")


def test_fp8_round_trip_and_forward(tiny, tmp_path):
    data = str(tmp_path / "d")
    shutil.copytree(tiny, data)
    path = write_features(data, ["val"], "float8_e4m3")["val"]
    assert path.endswith("features_val_fp8.fnr")
    ids = sorted(load_json(os.path.join(data, "split.json"))["val"])
    tl = vnr.VNRBatchLoader(path, 2, shuffle=False, mode="val", deterministic=True)
    jl = jvnr.VNRBatchLoader(path, 2, shuffle=False, mode="val", deterministic=True)
    assert tl.torch_dtype == torch.float8_e4m3fn
    for i, ex in enumerate(ids):
        f32 = torch_stand_in(normalize_video(torch.from_numpy(
            np.load(os.path.join(data, "videos", ex + ".npy")))[None]))[0]
        bits = tl.example_frames(i)
        assert torch.equal(torch.from_numpy(bits), f32.to(torch.float8_e4m3fn).view(torch.uint8))
        np.testing.assert_array_equal(bits, f32.numpy().astype(ml_dtypes.float8_e4m3fn)
                                      .view(np.uint8))
    # one batch through both forwards (its 6 first frames), fp8 widened in the forward
    tb, jb = next(iter(tl.epoch(0))), next(iter(jl.epoch(0)))
    tb["v_features"], jb["v_features"] = tb["v_features"][:, :6], jb["v_features"][:, :6]
    batch, _ = tcommon.prepare_batch(dict(tb))
    assert batch["v_features"].dtype == torch.float8_e4m3fn
    jcfg = JaxConfig(model="film_attn_pt", **FP8_CFG)
    jspec = jax_get_model("film_attn_pt")
    jp, js = jax_weights(str(tmp_path / "w.npz"), ModelConfig(model="film_attn_pt", **FP8_CFG))
    jbatch = {k: jnp.asarray(jb[k]) for k in ("v_features", "question", "v_len", "q_len")}
    want, _ = jax.jit(lambda p, s, b: jstep._forward(jspec, jcfg, p, s, b, jax.random.PRNGKey(0),
                                                     train=False))(jp, js, jbatch)
    params, state, _ = load_jax_checkpoint(str(tmp_path / "w.npz"), torch.device("cpu"))
    got, _ = forward(get_model("film_attn_pt"), ModelConfig(model="film_attn_pt", **FP8_CFG),
                     params, state, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP8_ATOL)
    tl.close()
    jl.close()


# --- the harness from the cache ---------------------------------------------

HARNESS_ARGS = ["--model", "film_attn_pt", "--num_res_blocks", "1",
                "--num_res_block_channels", "16", "--embed_size", "8", "--hidden_size", "8",
                "--at_hidden_size", "8", "--num_input_channels", "512",
                "--compute_dtype", "float32", "--batch_size", "4", "--loss_reduction", "sum",
                "--clip_value", "1.0", "--l_rate", "1e-3", "--stats_after_every", "1",
                "--bucket_frames", "true", "--feature_cache", "true"]


@pytest.fixture(scope="module")
def harness_dir(tmp_path_factory):
    """8 train and 8 val examples of at most 32 frames (frame bucket 8), their
    train and val feature files written by the port."""
    out = str(tmp_path_factory.mktemp("fcache_harness"))
    generate_synthetic_dataset(out, num_houses=3, trajs_per_house=8, seed=5,
                               video_format="npy", max_frames=32)
    write_features(out, ["train", "val"])
    return out


def _no_stem(*a, **k):
    raise AssertionError("a current feature cache must not load the stem")


def _spy_epochs(monkeypatch, cls, summary_index):
    seen = []
    orig = cls.run_epoch

    def spy(self, *a, **k):
        out = orig(self, *a, **k)
        seen.append(out[summary_index])
        return out

    monkeypatch.setattr(cls, "run_epoch", spy)
    return seen


def test_one_epoch_from_the_cache_matches_the_jax_harness(harness_dir, tmp_path, monkeypatch):
    jargs = jcommon.build_q_and_v_parser().parse_args(HARNESS_ARGS + ["--data_dir", harness_dir])
    jdir = jax_copy(harness_dir, str(tmp_path / "jax_data"), jargs)
    monkeypatch.setattr(jcommon, "load_stem", _no_stem)
    monkeypatch.setattr(tcommon, "load_stem", _no_stem)
    start = str(tmp_path / "start.npz")
    cfg = tcommon.cfg_from_args(tcommon.build_q_and_v_parser().parse_args(HARNESS_ARGS),
                                "film_attn_pt")
    jp, js = jax_weights(start, cfg, seed=7, l_rate=1e-3)
    # every leaf of the init is read over from the start checkpoint
    monkeypatch.setattr(jcommon.Harness, "init_model", lambda self: (jp, js))
    runs = {}
    for side, main, cls, idx, data, extra in (
            ("jax", jq_and_v.main, jcommon.Harness, 3, jdir, []),
            ("port", q_and_v_eval.main, tcommon.Harness, 1, harness_dir, ["--device", "cpu"])):
        ckpt = str(tmp_path / f"{side}.npz")
        shutil.copy(start, ckpt)
        seen = _spy_epochs(monkeypatch, cls, idx)
        main(HARNESS_ARGS + extra + ["--data_dir", data, "--checkpoint_path", ckpt])
        runs[side] = seen
    assert len(runs["port"]) == len(runs["jax"]) == 2   # one train epoch, one validation
    for t, j in zip(runs["port"], runs["jax"]):
        assert t["num_examples"] == j["num_examples"] == 8
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=LOSS_RTOL)
        assert t["hit"] == j["hit"]
        np.testing.assert_array_equal(t["y_pred"], j["y_pred"])
        np.testing.assert_array_equal(t["y_target"], j["y_target"])


def test_fp8_int8_harness_extracts_once(harness_dir, tmp_path, monkeypatch):
    """--feature_dtype float8_e4m3 with --int8_trunk true: the first run finds
    no fp8 cache, loads the stem once and extracts; the second reuses the
    cache. Validation runs the trunk's dynamic int8 convs."""
    data = str(tmp_path / "d")
    shutil.copytree(harness_dir, data)
    loads, dynamic = [], []
    monkeypatch.setattr(tcommon, "load_stem",
                        lambda *a, **k: loads.append(1) or torch_stand_in)
    real = film_mod.conv2d_int8_dynamic
    monkeypatch.setattr(film_mod, "conv2d_int8_dynamic",
                        lambda *a, **k: dynamic.append(1) or real(*a, **k))
    seen = _spy_epochs(monkeypatch, tcommon.Harness, 1)
    argv = HARNESS_ARGS + ["--device", "cpu", "--data_dir", data, "--feature_dtype",
                           "float8_e4m3", "--int8_trunk", "true"]
    q_and_v_eval.main(argv)
    assert loads == [1] and os.path.exists(os.path.join(data, "features_val_fp8.fnr"))
    assert dynamic and len(dynamic) % 3 == 0   # conv_init, conv1x1_0, conv3x3_0 a batch
    q_and_v_eval.main(argv)
    assert loads == [1]
    assert len(seen) == 4 and all(np.isfinite(s["loss"]) for s in seen)
    assert seen[0]["loss"] == seen[2]["loss"]   # the same run from the same cache


def test_feature_cache_with_int8_stem_exits(tmp_path):
    with pytest.raises(SystemExit, match="mutually exclusive"):
        q_and_v_eval.main(["--model", "film_attn_pt", "--device", "cpu", "--feature_cache",
                           "true", "--int8_stem", "true", "--data_dir", str(tmp_path)])


# --- the static and dynamic int8 trunk ----------------------------------------

def test_int8_convs_match_jax():
    r = np.random.default_rng(4)
    x = np.maximum(r.standard_normal((3, 10, 13, 24)), 0).astype(np.float32)
    for k in (1, 3):
        w = (r.standard_normal((k, k, 24, 16)) * 0.1).astype(np.float32)   # HWIO
        b = r.standard_normal(16).astype(np.float32)
        jp = {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}
        tp = {"weight": torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
              "bias": torch.from_numpy(b)}
        absmax = np.float32(1.25 * x.max())
        want_s = jax.jit(jquant.conv2d_int8_static)(jp, jnp.asarray(x), jnp.asarray(absmax))
        got_s = quant.conv2d_int8_static(tp, torch.from_numpy(x), torch.tensor(absmax))
        want_d = jax.jit(jquant.conv2d_int8_dynamic)(jp, jnp.asarray(x))
        got_d = quant.conv2d_int8_dynamic(tp, torch.from_numpy(x))
        for got, want in ((got_s, want_s), (got_d, want_d)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    xq, sx = quant.quantize_act_dynamic(torch.from_numpy(x))
    jq, js = jax.jit(jquant.quantize_act_dynamic)(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    assert float(sx) == float(js)


INT8_SMALL = dict(num_classes=7, vocab_size=19, embed_size=8, hidden_size=8, at_hidden_size=8,
                  num_res_blocks=2, num_res_block_channels=16, num_input_channels=12,
                  num_tail_channels=4, max_num_frames=6, max_q_len=9, compute_dtype="float32",
                  use_int8_trunk=True)


@pytest.mark.parametrize("form", ["static", "dynamic"])
def test_film_int8_trunk_forms_match_jax(form, tmp_path):
    """static: the state holds the calibrated absmax but no int8 weights;
    dynamic: it holds neither (the harness's eval step)."""
    jcfg = JaxConfig(**INT8_SMALL)
    jspec = jax_get_model("film_attn_pt")
    jp, js = jax_weights(str(tmp_path / "w.npz"), ModelConfig(model="film_attn_pt", **INT8_SMALL))
    r = np.random.default_rng(3)
    b = {"v_features": np.maximum(r.standard_normal((3, 6, 10, 13, 12)), 0).astype(np.float32),
         "question": r.integers(1, 19, (3, 9)).astype(np.int32),
         "v_len": np.array([6, 2, 4], np.int32), "q_len": np.array([9, 3, 5], np.int32)}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    apply = lambda c: jax.jit(lambda p, s, b: jspec.apply(p, s, b, c, train=False,
                                                          rng=jax.random.PRNGKey(0)))
    if form == "static":
        import dataclasses

        _, js = apply(dataclasses.replace(jcfg, int8_trunk_calibrate=True))(jp, js, jb)
        js = {**js, "trunk": {k: v for k, v in js["trunk"].items() if k != "int8_wq"}}
        assert "int8_scales" in js["trunk"]
    jckpt.save_checkpoint(str(tmp_path / "w.npz"), params=jp, state=js)
    want, _ = apply(jcfg)(jp, js, jb)
    params, state, _ = load_jax_checkpoint(str(tmp_path / "w.npz"), torch.device("cpu"))
    assert ("int8_scales" in state["trunk"]) == (form == "static")
    assert "int8_wq" not in state["trunk"]
    got, _ = get_model("film_attn_pt").apply(
        params, state, {k: torch.from_numpy(v) for k, v in b.items()},
        ModelConfig(model="film_attn_pt", **INT8_SMALL))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=INT8_ATOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))
