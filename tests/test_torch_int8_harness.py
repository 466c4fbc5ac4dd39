"""``--int8_stem true`` through the port's entry points against the JAX
package's, on the CPU, on the datasets of tests/test_torch_harness.py (its
``data_dir``) and tests/test_torch_serve.py (its ``data``).

Both packages read the same real, narrow stem from files: a VGG-16 partial at
8, 8, 16 and 128 channels (``--frcnn_pretrained_path``) and an ObjDetectCNN
at 8 filters (``obj_detect.pt`` in a linked copy of the dataset), made with
numpy, so the int8 stem runs at the real 160x208 frames in seconds and feeds
the small film_attn_pt of the harness tests (8 input channels). Each side
calibrates on its own, on the same first batch (or stored video), with its
own f32 convs, so its scales sit within 1e-6 of JAX's and the bias deltas
within the bounds of tests/test_torch_int8_stem.py. The JAX harness runs
its int8 stem inside the jitted step, where XLA fuses the dequantization
(multiply-adds) and so moves a few int8 codes: on the narrow stem, jitted
against eager, up to 0.66% of the largest feature with the improved
calibration. The port matches the eager form (its VGG stage to the bit), so
the bounds below are of that gap (measured beside each):

- ``q_and_v_eval``, one epoch from one JAX checkpoint, both calibrations:
  the losses within LOSS_RTOL, hits and predictions equal;
- ``q_and_v_test`` from one checkpoint: the loss within LOSS_RTOL, the
  ``t_``/``p_``/``q_`` dumps equal;
- the daemon's engine in video mode, with and without
  ``--int8_stem_calibration_video``: the probabilities of the same stored
  videos (the same frame picks, after the calibration video's) within
  PROB_ATOL of JAX's engine, the argmax equal;
- ``predict`` with ``--int8_stem true`` gives the answer of the stem in
  ``--compute_dtype`` bit for bit (no calibration batch there, as in JAX).
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from videonavqa_tpu.cli import common as jcommon
from videonavqa_tpu.cli import q_and_v_eval as jq_and_v
from videonavqa_tpu.cli import q_and_v_test as jq_and_v_test
from videonavqa_tpu.cli import serve as jserve
from videonavqa_tpu.models import get_model as jax_get_model
from videonavqa_tpu.utils import checkpoint as jckpt
from videonavqa_tpu.utils import torch_import as jti
from videonavqa_tpu_torch.cli import common as tcommon
from videonavqa_tpu_torch.cli import predict, q_and_v_eval, q_and_v_test, serve

from test_torch_feature_cache import jax_weights
from test_torch_harness import FILM_ARGS, _jax_templates, _spy_epochs, tiny_dir  # noqa: F401
from test_torch_obj_detector import _narrow_vgg_pth
from test_torch_serve import data  # noqa: F401
from test_torch_stem import _bn, _conv

NUM_FILTERS = 8          # FILM_ARGS' --num_input_channels
LOSS_RTOL = 1e-3         # measured: 1.3e-4 (absmax, the train epoch), others under 5.5e-6
PROB_ATOL = 1e-5         # measured: 2.8e-7
# FILM_ARGS at batch 2: the harness's one-batch calibration then takes 16
# frames (bucket 8) in q_and_v_eval and 70 (the test split's 35-frame
# container) in q_and_v_test
ARGS = FILM_ARGS[:FILM_ARGS.index("--batch_size")] + ["--batch_size", "2"] + \
    FILM_ARGS[FILM_ARGS.index("--batch_size") + 2:]
MODEL = ["--model", "film_attn_pt", "--num_res_blocks", "1", "--num_res_block_channels", "16",
         "--embed_size", "8", "--hidden_size", "8", "--at_hidden_size", "8",
         "--num_input_channels", str(NUM_FILTERS), "--vocab_size", "19",
         "--compute_dtype", "float32"]


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _with_stem(src, dst):
    """``dst``: links to every entry of the dataset ``src``, and the narrow
    ``obj_detect.pt`` (written by JAX's exporter) -> the VGG file's path."""
    os.makedirs(dst)
    for name in os.listdir(src):
        os.symlink(os.path.join(src, name), os.path.join(dst, name))
    r = np.random.default_rng(61)
    p, s = {}, {}
    p["bn_input"], s["bn_input"] = _bn(r, 128)
    cin = 128
    for b in range(1, 4):
        p[f"conv{b}1"] = _conv(r, cin, NUM_FILTERS, 0.1)
        p[f"conv{b}2"] = _conv(r, NUM_FILTERS, NUM_FILTERS, 0.1)
        p[f"bn{b}"], s[f"bn{b}"] = _bn(r, NUM_FILTERS)
        cin = NUM_FILTERS
    p["fc_tail1"] = {"weight": np.zeros((4, NUM_FILTERS * 30), np.float32),
                     "bias": np.zeros(4, np.float32)}
    p["bn_tail1"], s["bn_tail1"] = _bn(r, 4)
    p["fc_tail2"] = {"weight": np.zeros((3, 4), np.float32), "bias": np.zeros(3, np.float32)}
    jti.export_obj_detector_pt(p, s, os.path.join(dst, "obj_detect.pt"))
    vgg = os.path.join(dst, "vgg.pth")
    _narrow_vgg_pth(vgg)
    return vgg


@pytest.fixture(scope="module")
def harness_data(tiny_dir, tmp_path_factory):  # noqa: F811
    out = str(tmp_path_factory.mktemp("int8_harness") / "d")
    return out, _with_stem(tiny_dir, out)


@pytest.mark.parametrize("mode", ["improved", "absmax"])
def test_q_and_v_eval_with_the_int8_stem_matches_jax(harness_data, tmp_path, monkeypatch,
                                                      capsys, mode):
    d, vgg = harness_data
    jp, js, jopt = _jax_templates()
    start = str(tmp_path / "start.npz")
    jckpt.save_checkpoint(start, params=jp, state=js, opt_state=jopt, meta={"epoch": -1})
    built = []
    real = tcommon.load_stem

    def spy(*a, **k):
        built.append(k.get("calibration_video") is not None)
        return real(*a, **k)

    monkeypatch.setattr(tcommon, "load_stem", spy)
    args = ARGS + ["--data_dir", d, "--int8_stem", "true", "--int8_stem_calibration", mode,
                   "--frcnn_pretrained_path", vgg]
    runs = {}
    for side, main, cls, idx, extra in (("jax", jq_and_v.main, jcommon.Harness, 3, []),
                                        ("port", q_and_v_eval.main, tcommon.Harness, 1,
                                         ["--device", "cpu"])):
        shutil.copy(start, tmp_path / f"{side}.npz")
        seen = _spy_epochs(monkeypatch, cls, idx)
        main(args + extra + ["--checkpoint_path", str(tmp_path / f"{side}.npz")])
        runs[side] = (seen, capsys.readouterr().out)
    assert built == [True]   # calibrated once, before the model's init
    (jsum, jout), (tsum, tout) = runs["jax"], runs["port"]
    for out in (jout, tout):
        assert f"=> Calibrating int8 stem on one batch ({mode})" in out
    assert len(tsum) == len(jsum) == 2
    for t, j in zip(tsum, jsum):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=LOSS_RTOL)
        assert (t["hit"], t["num_examples"]) == (j["hit"], j["num_examples"])
        np.testing.assert_array_equal(t["y_pred"], j["y_pred"])


def test_q_and_v_test_with_the_int8_stem_matches_jax(harness_data, tmp_path, capsys):
    d, vgg = harness_data
    jp, js, _ = _jax_templates()
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        jckpt.save_checkpoint(str(tmp_path / side / "m.npz"), params=jp, state=js,
                              meta={"epoch": 0})
    args = ARGS + ["--data_dir", d, "--int8_stem", "true", "--int8_stem_calibration", "absmax",
                   "--frcnn_pretrained_path", vgg]
    want = jq_and_v_test.main(args + ["--checkpoint_path", str(tmp_path / "jax" / "m.npz")])
    jout = capsys.readouterr().out
    got = q_and_v_test.main(args + ["--device", "cpu",
                                    "--checkpoint_path", str(tmp_path / "port" / "m.npz")])
    tout = capsys.readouterr().out
    for out in (jout, tout):
        assert "=> Calibrating int8 stem on one batch (absmax)" in out
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert got["hit"] == want["hit"] and got["num_examples"] == want["num_examples"] == 4
    for prefix in ("t_", "p_", "q_"):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / f"{prefix}m.npz.npy"),
                                      np.load(tmp_path / "jax" / f"{prefix}m.npz.npy"))


@pytest.fixture(scope="module")
def serve_data(data, tmp_path_factory):  # noqa: F811
    """(the serve dataset with the narrow stem, the VGG file, a checkpoint of
    the small model at 8 input channels, its JAX trees)."""
    base = tmp_path_factory.mktemp("int8_serve")
    d = str(base / "d")
    vgg = _with_stem(data[0], d)
    ckpt = str(base / "w.npz")
    cfg = tcommon.cfg_from_args(tcommon.build_q_and_v_parser().parse_args(MODEL), "film_attn_pt")
    return d, vgg, ckpt, jax_weights(ckpt, cfg, seed=5)


@pytest.mark.parametrize("calibration_video", [None, "last"])
def test_engine_video_mode_with_the_int8_stem_matches_jax(serve_data, monkeypatch, capsys,
                                                          calibration_video):
    d, vgg, ckpt, (jp, js) = serve_data
    videos = sorted(os.listdir(os.path.join(d, "videos")))
    argv = MODEL + ["--data_dir", d, "--checkpoint_path", ckpt, "--int8_stem", "true",
                    "--frcnn_pretrained_path", vgg, "--bucket_frames", "true"]
    if calibration_video:
        argv += ["--int8_stem_calibration_video", videos[-1]]
    spec = jax_get_model("film_attn_pt")
    monkeypatch.setattr(jserve, "get_model",
                        lambda name: dataclasses.replace(spec, init=lambda key, cfg: (jp, js)))
    jparser = jserve.build_q_and_v_parser()
    jparser.add_argument("--max_batch", type=int, default=4)
    jparser.add_argument("--int8_stem_calibration_video", type=str, default=None)
    jeng = jserve.InferenceEngine(jparser.parse_args(argv))
    jout = capsys.readouterr().out
    engine = serve.InferenceEngine.from_args(serve.build_parser().parse_args(
        argv + ["--device", "cpu", "--max_batch", "4"]))
    tout = capsys.readouterr().out
    assert engine.stem_is_int8 and jeng.stem_is_int8
    name = videos[-1] if calibration_video else videos[0]
    line = [x for x in jout.splitlines() if x.startswith("=> int8 stem: calibrating on")]
    assert line == [x for x in tout.splitlines() if x.startswith("=> int8 stem: calibrating on")]
    assert line[0].startswith(f"=> int8 stem: calibrating on {name} (")

    items = {}
    for side, eng in (("jax", jeng), ("port", engine)):
        items[side] = [(*eng.load_video(v), [1 + i, 2, 3]) for i, v in enumerate(videos[:3])]
    for (tf, tv, _), (jf, jv, _) in zip(items["port"], items["jax"]):
        assert tv == jv and np.array_equal(tf, jf)   # the same picks after calibration
    got, want = engine.run_batch(items["port"]), np.asarray(jeng.run_batch(items["jax"]))
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_engine_int8_stem_without_a_stored_video_exits(serve_data, tmp_path):
    d, vgg, ckpt, _ = serve_data
    empty = tmp_path / "empty"
    empty.mkdir()
    for name in os.listdir(d):
        if name != "videos":
            os.symlink(os.path.join(d, name), empty / name)
    with pytest.raises(SystemExit, match="none were found"):
        serve.InferenceEngine.from_args(serve.build_parser().parse_args(
            MODEL + ["--data_dir", str(empty), "--checkpoint_path", ckpt, "--int8_stem", "true",
                     "--device", "cpu"]))


def test_engine_reload_keeps_the_int8_stem(serve_data, tmp_path):
    d, vgg, ckpt, _ = serve_data
    engine = serve.InferenceEngine.from_args(serve.build_parser().parse_args(
        MODEL + ["--data_dir", d, "--checkpoint_path", ckpt, "--int8_stem", "true",
                 "--frcnn_pretrained_path", vgg, "--device", "cpu"]))
    stem = engine.stem
    engine.reload(ckpt)
    assert engine.stem is stem and engine.stem_is_int8


def test_predict_with_the_int8_stem_answers_as_the_plain_stem(serve_data, capsys):
    d, vgg, ckpt, _ = serve_data
    video = os.path.join(d, "videos", sorted(os.listdir(os.path.join(d, "videos")))[0])
    argv = MODEL + ["--data_dir", d, "--checkpoint_path", ckpt, "--video", video,
                    "--question", "w3 w5 w7", "--frcnn_pretrained_path", vgg, "--device", "cpu"]
    want = predict.main(argv)
    want_out = capsys.readouterr().out
    got = predict.main(argv + ["--int8_stem", "true"])
    assert np.array_equal(got, want) and capsys.readouterr().out == want_out
