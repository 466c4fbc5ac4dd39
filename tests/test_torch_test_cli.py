"""The port's test-split entry points and its v_only_cnn3d daemon against the
JAX package's, on the CPU.

- q_and_v_test (film_gp_pt at small widths, 1 block x 16 channels, from the
  epoch checkpoint of one small JAX q_and_v_eval epoch), q_only_test (bow,
  from one JAX q_only_eval epoch's checkpoint) and v_only_test (cnn3d, the
  JAX weights of tests/test_torch_cnn3d.py, a test split of one video at
  batch 2: its batch padded) run in both packages from copies of one JAX
  checkpoint: the summary's loss rtol 1e-5, its hits, predictions and F1
  equal, the printed lines alike (numbers rtol 1e-5), and the t_/p_/q_ dumps
  byte-equal; results_analysis prints the same lines over both packages'
  dumps. Both load_stems take tests/test_torch_harness.py's stand-in stem.
- The daemon (cli/serve.py build_server, --bucket_frames true) serves
  v_only_cnn3d from raw frames through the precomputed zero-run, its
  probabilities within 1e-5 of JAX's engine on the same items; a /reload
  swaps in other weights with the zero-run computed from them, and the
  answers follow JAX's engine reloaded alike.
"""

import dataclasses
import os
import shutil
import threading

import jax
import numpy as np
import pytest
import torch

from videonavqa_tpu.cli import common as jcommon
from videonavqa_tpu.cli import q_and_v_eval as jq_and_v_eval
from videonavqa_tpu.cli import q_and_v_test as jq_and_v_test
from videonavqa_tpu.cli import q_only_eval as jq_only_eval
from videonavqa_tpu.cli import q_only_test as jq_only_test
from videonavqa_tpu.cli import results_analysis as jresults
from videonavqa_tpu.cli import serve as jserve
from videonavqa_tpu.cli import v_only_test as jv_only_test
from videonavqa_tpu.data.synthetic import generate_synthetic_dataset
from videonavqa_tpu.models import get_model as jax_get_model
from videonavqa_tpu.utils import checkpoint as jckpt
from videonavqa_tpu_torch.cli import common as tcommon
from videonavqa_tpu_torch.cli import q_and_v_test, q_only_test, results_analysis, serve
from videonavqa_tpu_torch.cli import v_only_test
from videonavqa_tpu_torch.models import v_only_cnn3d as c3d
from videonavqa_tpu_torch.serve import loadgen
from videonavqa_tpu_torch.utils import checkpoint as tckpt

import test_torch_cnn3d as c3d_tests
from test_torch_harness import _assert_same_lines, _jax_stem, _torch_stem

LOSS_RTOL = 1e-5
PROB_ATOL = 1e-5
GP_ARGS = ["--model", "film_gp_pt", "--num_res_blocks", "1", "--num_res_block_channels", "16",
           "--embed_size", "8", "--hidden_size", "8", "--num_input_channels", "8",
           "--num_tail_channels", "4", "--compute_dtype", "float32", "--batch_size", "3",
           "--loss_reduction", "sum", "--l_rate", "1e-3", "--stats_after_every", "1",
           "--num_workers", "2"]
BOW_ARGS = ["--model", "bow", "--embed_size", "8", "--batch_size", "3", "--num_epochs", "1",
            "--stats_after_every", "1", "--l_rate", "1e-3", "--num_workers", "2"]
CNN3D_ARGS = ["--model", "cnn3d", "--compute_dtype", "float32", "--batch_size", "2",
              "--num_workers", "1"]


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def stand_in_stems(monkeypatch):
    monkeypatch.setattr(jcommon, "load_stem", lambda *a, **k: _jax_stem)
    monkeypatch.setattr(tcommon, "load_stem", lambda *a, **k: _torch_stem)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """4 train, 4 val and 4 test examples of at most 32 frames."""
    out = str(tmp_path_factory.mktemp("test_cli_data"))
    generate_synthetic_dataset(out, num_houses=3, trajs_per_house=4, seed=8,
                               video_format="npy", max_frames=32)
    return out


@pytest.fixture(scope="module")
def one_dir(tmp_path_factory):
    """One example in each split, of at most 12 frames."""
    out = str(tmp_path_factory.mktemp("test_cli_one"))
    generate_synthetic_dataset(out, num_houses=3, trajs_per_house=1, seed=9,
                               video_format="npy", max_frames=12)
    return out


def with_init(spec, jp, js):
    """A JAX model spec whose init gives (jp, js)."""
    return dataclasses.replace(spec, init=lambda key, cfg: (jp, js))


def run_both(tmp_path, capsys, monkeypatch, jmod, tmod, argv, ckpt_path):
    """Both packages' test entry point (the modules' ``main``) from copies of
    ``ckpt_path`` -> {side: (run_test's summary, stdout, dump directory,
    checkpoint name)}."""
    out = {}
    name = os.path.basename(ckpt_path)
    for side, mod, extra in (("jax", jmod, []), ("port", tmod, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        shutil.copy(ckpt_path, d / name)
        seen = []
        real = mod.run_test
        monkeypatch.setattr(mod, "run_test", lambda *a, **k: seen.append(real(*a, **k)))
        mod.main(argv + extra + ["--checkpoint_path", str(d / name)])
        out[side] = (seen[0], capsys.readouterr().out.replace(str(d), "DIR"), d, name)
    return out


def assert_same_tests(runs, capsys, n):
    (js, jout, jd, name), (ts, tout, td, _) = runs["jax"], runs["port"]
    np.testing.assert_allclose(ts["loss"], js["loss"], rtol=LOSS_RTOL)
    assert (ts["hit"], ts["num_examples"]) == (js["hit"], js["num_examples"]) == \
        (ts["hit"], n)
    np.testing.assert_array_equal(ts["y_pred"], js["y_pred"])
    assert (ts["f1_w"], ts["f1_micro"]) == (js["f1_w"], js["f1_micro"])
    assert "Testing:" in tout
    _assert_same_lines(tout, jout)
    for prefix in ("t_", "p_", "q_"):
        with open(td / f"{prefix}{name}.npy", "rb") as f, \
                open(jd / f"{prefix}{name}.npy", "rb") as g:
            assert f.read() == g.read(), prefix
    jresults.main(["--checkpoint_path", str(jd / name)])
    want = capsys.readouterr().out
    results_analysis.main(["--checkpoint_path", str(td / name)])
    got = capsys.readouterr().out
    assert got == want and ">>> Stats for" in got


def test_q_and_v_test_film_gp_matches_jax(data_dir, tmp_path, capsys, monkeypatch,
                                          stand_in_stems):
    jq_and_v_eval.main(GP_ARGS + ["--data_dir", data_dir,
                                  "--checkpoint_path", str(tmp_path / "gp.npz")])
    capsys.readouterr()
    runs = run_both(tmp_path, capsys, monkeypatch, jq_and_v_test, q_and_v_test,
                    GP_ARGS + ["--data_dir", data_dir], str(tmp_path / "e0_gp.npz"))
    assert_same_tests(runs, capsys, 4)


def test_q_only_test_bow_matches_jax(data_dir, tmp_path, capsys, monkeypatch):
    jq_only_eval.main(BOW_ARGS + ["--data_dir", data_dir,
                                  "--checkpoint_path", str(tmp_path / "bow.npz")])
    capsys.readouterr()
    runs = run_both(tmp_path, capsys, monkeypatch, jq_only_test, q_only_test,
                    BOW_ARGS + ["--data_dir", data_dir], str(tmp_path / "bow.npz"))
    assert "val acc" in runs["port"][1]
    assert_same_tests(runs, capsys, 4)


def test_v_only_test_cnn3d_matches_jax(one_dir, tmp_path, capsys, monkeypatch):
    """One test video at batch 2 (one padding row) through the full 35-frame
    container, from the JAX weights of tests/test_torch_cnn3d.py with a
    seeded fc8 over the dataset's 70 classes."""
    _, jp, js, _, _, _ = c3d_tests.setup()
    r = np.random.default_rng(11)
    jp = dict(jp, fc8={"weight": (0.1 * r.standard_normal((70, 128))).astype(np.float32),
                       "bias": np.zeros(70, np.float32)})
    path = str(tmp_path / "c3d.npz")
    jckpt.save_checkpoint(path, params=jp, state=js, meta={"epoch": 0})
    # the JAX harness's own init takes seconds eagerly; the checkpoint
    # overwrites every leaf
    spec = jax_get_model("v_only_cnn3d")
    monkeypatch.setattr(jcommon, "get_model", lambda name: with_init(spec, jp, js))
    runs = run_both(tmp_path, capsys, monkeypatch, jv_only_test, v_only_test,
                    CNN3D_ARGS + ["--data_dir", one_dir], path)
    assert_same_tests(runs, capsys, 1)


def test_run_test_requires_a_checkpoint(data_dir, tmp_path, stand_in_stems):
    with pytest.raises(SystemExit, match="Checkpoint required"):
        q_and_v_test.main(GP_ARGS + ["--device", "cpu", "--data_dir", data_dir,
                                     "--checkpoint_path", str(tmp_path / "absent.npz")])


# --- the daemon ------------------------------------------------------------------

def _items():
    b = c3d_tests.video_batch()
    return [(b["video"][i], int(b["v_len"][i]), [1, 2]) for i in range(2)]


def test_v_only_cnn3d_daemon_matches_jax_and_reload_recomputes_the_zero_run(
        one_dir, tmp_path, monkeypatch):
    _, jp, js, _, _, _ = c3d_tests.setup()
    first = str(tmp_path / "first.npz")
    jckpt.save_checkpoint(first, params=jp, state=js, meta={"epoch": 1})
    argv = ["--model", "v_only_cnn3d", "--num_classes", "7", "--vocab_size", "19",
            "--data_dir", one_dir, "--compute_dtype", "float32",
            "--bucket_frames", "true", "--max_batch", "2", "--checkpoint_path", first]
    spec = jax_get_model("v_only_cnn3d")
    monkeypatch.setattr(jserve, "get_model", lambda name: with_init(spec, jp, js))
    jparser = jserve.build_q_and_v_parser()
    jparser.add_argument("--max_batch", type=int, default=2)
    jeng = jserve.InferenceEngine(jparser.parse_args(argv))

    engine, batcher, server = serve.build_server(serve.build_parser().parse_args(
        argv + ["--device", "cpu", "--port", "0"]))
    threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    port = server.server_address[1]
    try:
        widths = [t for t in engine.frame_buckets if t <= c3d.SPLICE_MAX_T_CACHED]
        zero = engine.state["c3d_zero"]
        assert widths and sorted(zero) == sorted(f"T{t}" for t in widths)
        assert engine.bucket_for(7) in widths   # the items take the cached splice
        np.testing.assert_allclose(engine.run_batch(_items()), jeng.run_batch(_items()),
                                   atol=PROB_ATOL)

        other = str(tmp_path / "other.npz")
        new_p, new_s = spec.init(jax.random.PRNGKey(5), jeng.cfg)
        jckpt.save_checkpoint(other, params=new_p, state=new_s, meta={"epoch": 2})
        version = engine.weights_version
        assert loadgen.request(port, "/reload", {"checkpoint_path": other}, timeout=300) == \
            (200, {"ok": True, "epoch": 2})
        assert engine.weights_version == version + 1
        new_zero = engine.state["c3d_zero"]
        want = c3d.precompute_c3d_zero_slices(
            engine.params, {k: v for k, v in engine.state.items() if k != "c3d_zero"},
            engine.cfg, widths)
        assert sorted(new_zero) == sorted(want)
        for T in want:
            for k, w in want[T].items():
                assert torch.equal(new_zero[T][k], w), (T, k)
        assert not torch.equal(new_zero["T8"]["m2"], zero["T8"]["m2"])
        monkeypatch.setattr(jserve, "get_model", lambda name: with_init(spec, new_p, new_s))
        jeng.reload(other)
        np.testing.assert_allclose(engine.run_batch(_items()), jeng.run_batch(_items()),
                                   atol=PROB_ATOL)
        # the checkpoint the engine writes from its weights holds no zero-run
        tckpt.save_checkpoint(str(tmp_path / "w.npz"), params=engine.params,
                              state=engine.state)
        assert not any("c3d_zero" in k for k in tckpt.read_npz(str(tmp_path / "w.npz"))[0])
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
    assert engine.epoch == 2
