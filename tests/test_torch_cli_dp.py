"""The port's entry points on a mesh, on the CPU (the counterpart of
tests/test_cli_dp.py and tests/test_multiprocess.py).

The runs train film_gp_pt (1 block x 16 channels, f32, batch 4, the
harness's defaults: mean loss, lr 1e-4, as tests/test_cli_dp.py) for one
epoch from the feature cache of a cheap stand-in stem (rank 0 would extract
it, the other ranks waiting for the file; the module's fixture has), all
from one JAX-package checkpoint (the port's seeded init, a fresh Adam
state, epoch -1), the JAX harness too. Two meshes serve the file, each
started once: data 2 as two processes launched with --distributed (this
one process 0, a second as a user would start it; run_training, then
q_only_eval), and data 1 x model 2 with the second rank spawned
(cli/common.py on_mesh; train, train on from its checkpoint, q_and_v_test).
Bounds: the params within 3e-3 and the BN state within 1e-4 of JAX's
single-device run (tests/test_cli_dp.py's); against the port's own run
without a mesh, the params within 2e-5, a fifth of one Adam step; a
'model'-sharded checkpoint's round trip exact.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from videonavqa_tpu.cli import common as jcommon
from videonavqa_tpu.data.synthetic import generate_synthetic_dataset
from videonavqa_tpu_torch.cli import common as tcommon
from videonavqa_tpu_torch.cli import q_and_v_test, q_only_eval
from videonavqa_tpu_torch.cli.extract_features import ensure_features
from videonavqa_tpu_torch.parallel import launch, multihost
from videonavqa_tpu_torch.train.step import tree_items
from videonavqa_tpu_torch.utils import checkpoint as ckpt

from test_torch_feature_cache import jax_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--model", "film_gp_pt", "--num_res_blocks", "1", "--num_res_block_channels", "16",
        "--num_tail_channels", "4", "--embed_size", "8", "--hidden_size", "8",
        "--num_input_channels", "512", "--compute_dtype", "float32", "--batch_size", "4",
        "--num_epochs", "1",
        "--feature_cache", "true", "--num_workers", "1"]
Q_ONLY = ["--device", "cpu", "--model", "bow", "--batch_size", "4", "--num_epochs", "2",
          "--stats_after_every", "1", "--l_rate", "1e-3", "--compute_dtype", "float32",
          "--num_workers", "1"]
PARAM_ATOL = 3e-3
STATE_ATOL = 1e-4
MESH_PARAM_ATOL = 2e-5
# the stand-in stem: a 16x16 average pool, a seeded 3 -> 512 projection, a ReLU
STEM_W = (np.random.default_rng(78).standard_normal((3, 512)) * 0.5).astype(np.float32)


def _jax_stem(video):
    B, T = video.shape[:2]
    x = video.reshape(B, T, 10, 16, 13, 16, 3).mean(axis=(3, 5))
    return jax.nn.relu(x @ jax.numpy.asarray(STEM_W))


def _torch_stem(video):
    B, T = video.shape[:2]
    x = video.reshape(B, T, 10, 16, 13, 16, 3).mean(dim=(3, 5))
    return torch.relu(x @ torch.from_numpy(STEM_W))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(the port's data dir, the JAX harness's copy, the start checkpoint):
    8 train, 8 val and 8 test examples; the port's feature cache extracted
    here by the stand-in stem."""
    base = tmp_path_factory.mktemp("cli_dp")
    port, jax_dir = str(base / "port"), str(base / "jax")
    generate_synthetic_dataset(port, num_houses=3, trajs_per_house=8, seed=5,
                               video_format="npy", max_frames=32)
    shutil.copytree(port, jax_dir)
    args = tcommon.build_q_and_v_parser().parse_args(ARGS + ["--device", "cpu",
                                                            "--data_dir", port])
    start = str(base / "start.npz")
    jax_weights(start, tcommon.cfg_from_args(args, "film_gp_pt"), seed=7, l_rate=1e-4)
    ensure_features(args, _torch_stem, ("train", "val", "test"),
                    tcommon.load_json(os.path.join(port, "split.json")))
    return port, jax_dir, start


def _from(start, tmp_path, name):
    path = str(tmp_path / name)
    shutil.copy(start, path)
    return path


def _argv(data, ckpt_path, extra=()):
    return ARGS + ["--device", "cpu", "--data_dir", data[0], "--checkpoint_path", ckpt_path,
                   *extra]


def _train(data, ckpt_path, extra=()):
    return ranks.run_calls(None, [("train", _argv(data, ckpt_path, extra))])[0]


def _close(got, want, atol):
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def single(data, tmp_path_factory):
    """The single-device run's (params, state)."""
    return _train(data, _from(data[2], tmp_path_factory.mktemp("single"), "m.npz"))


def _distributed(pid, port):
    return ["--mesh_devices", "2", "--distributed", "true", "--coordinator_address",
            f"127.0.0.1:{port}", "--num_processes", "2", "--process_id", str(pid)]


@pytest.fixture(scope="module")
def dp_world(data, tmp_path_factory):
    """--mesh_devices 2 --distributed: this process is process 0, a second
    is launched as a user would; both run run_training, then q_only_eval,
    each at a coordinator port of its own -> {'train': process 0's (params,
    state), 'q_only': ((params, state), its standard output), 'peer':
    (exit code, standard error, its params file)}."""
    base = tmp_path_factory.mktemp("dp")
    ports = [launch.free_port(), launch.free_port()]

    def calls(pid):
        return [("train", _argv(data, _from(data[2], base, f"m{pid}.npz"),
                                _distributed(pid, ports[0]))),
                ("q_only", Q_ONLY + ["--data_dir", data[0]] + _distributed(pid, ports[1]))]

    out = str(base / "peer.npz")
    code = ("import json, sys\n"
            "sys.path.insert(0, 'tests')\n"
            "import _torch_mesh_ranks\n"
            "_torch_mesh_ranks.run_calls(None, json.loads(sys.argv[1]), sys.argv[2])\n")
    peer = subprocess.Popen([sys.executable, "-c", code, json.dumps(calls(1)), out], cwd=REPO,
                            env=dict(os.environ, OMP_NUM_THREADS="2"),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        mine = calls(0)
        train = ranks.run_calls(None, mine[:1])[0]
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            q_only = ranks.run_calls(None, mine[1:])[0]
        _, err = peer.communicate(timeout=180)
    finally:
        if peer.poll() is None:
            peer.kill()
    return {"train": train, "q_only": (q_only, printed.getvalue()),
            "peer": (peer.returncode, err, out)}


@pytest.fixture(scope="module")
def mp_world(data, tmp_path_factory):
    """--mesh_devices 2 --model_parallel 2, the second rank spawned: train
    from the start checkpoint, train on from its e0_ checkpoint, then
    q_and_v_test from that -> (the directory, [the results])."""
    base = tmp_path_factory.mktemp("mp")
    mesh = ["--mesh_devices", "2", "--model_parallel", "2"]
    first = str(base / "e0_m.npz")
    calls = [("train", _argv(data, _from(data[2], base, "m.npz"), mesh)),
             ("train", _argv(data, first, mesh)),
             ("test", _argv(data, first, mesh))]
    args = tcommon.build_q_and_v_parser().parse_args(calls[0][1])
    return base, tcommon.on_mesh(ranks.run_calls, args, calls)


def test_cli_dp_matches_single_device_and_jax(data, single, dp_world, tmp_path, monkeypatch):
    """--mesh_devices 2 (2 rows a rank) against the run without a mesh and
    against the JAX harness's single-device run_training."""
    p, s = dp_world["train"]
    _close(p, single[0], MESH_PARAM_ATOL)
    _close(s, single[1], STATE_ATOL)

    monkeypatch.setattr(jcommon, "load_stem", lambda *a, **k: _jax_stem)
    jargs = jcommon.build_q_and_v_parser().parse_args(
        ARGS + ["--data_dir", data[1], "--checkpoint_path", _from(data[2], tmp_path, "j.npz")])
    jp, js = jcommon.run_training(jargs, "film_gp_pt")
    want = {k: (v.transpose(3, 2, 0, 1) if v.ndim == 4 else v)
            for k, v in ((k, np.asarray(v)) for k, v in tree_items(jp))}
    _close(p, want, PARAM_ATOL)
    _close(s, {k: np.asarray(v) for k, v in tree_items(js)}, STATE_ATOL)


def test_model_parallel_checkpoint_cycle_and_test(data, single, mp_world, tmp_path):
    """--mesh_devices 2 --model_parallel 2: train (decoder and out_linear rows
    split over 'model'), save (the sharded leaves gathered, rank 0 writes),
    restore and train on; the file holds exactly the params the run
    returned; both runs against the same cycle without a mesh; then
    q_and_v_test from the file on the mesh against it without one: the
    summary and the dumps equal."""
    base, ((p0, _), (p1, s1), got) = mp_world
    first = str(base / "e0_m.npz")
    flat, meta = ckpt.read_npz(first)
    assert meta["epoch"] == 0
    for k, v in p0.items():
        f = flat["params/" + k]
        np.testing.assert_array_equal(f.transpose(3, 2, 0, 1) if f.ndim == 4 else f, v,
                                      err_msg=k)
    _close(p0, single[0], MESH_PARAM_ATOL)
    plain = _from(first, tmp_path, "e0_m.npz")
    q1, r1 = _train(data, plain)
    _close(p1, q1, MESH_PARAM_ATOL)
    _close(s1, r1, STATE_ATOL)

    want = q_and_v_test.main(ARGS + ["--device", "cpu", "--data_dir", data[0],
                                     "--checkpoint_path", plain])
    assert (got["hit"], got["num_examples"]) == (want["hit"], want["num_examples"]) == \
        (got["hit"], 8)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for prefix in ("t_", "p_", "q_"):
        np.testing.assert_array_equal(np.load(str(base / f"{prefix}e0_m.npz.npy")),
                                      np.load(str(tmp_path / f"{prefix}e0_m.npz.npy")))


def test_q_only_eval_on_a_mesh(data, dp_world, capsys):
    """question-only BoW, its own loop: 2 epochs on the mesh against the same
    without one (its validation lines equal)."""
    with launch.cpu_threads():
        want_p, _ = q_only_eval.main(Q_ONLY + ["--data_dir", data[0]])
    want = capsys.readouterr().out
    (got_p, _), got = dp_world["q_only"]
    lines = lambda out: [ln for ln in out.splitlines() if ln.startswith("Validation")]
    assert len(lines(got)) == 2 and lines(got) == lines(want)
    _close(got_p, {k: v.detach().numpy() for k, v in tree_items(want_p)}, MESH_PARAM_ATOL)


def test_cli_batch_not_divisible_errors(data):
    with pytest.raises(SystemExit, match="divide"):
        _train(data, "unused.npz", ["--mesh_devices", "2", "--batch_size", "3"])


def test_distributed_two_processes_match_one(single, dp_world):
    """--distributed: the launched second process ran both entry points to
    the end, its params are process 0's, bit for bit, and process 0's are
    the single-device run's."""
    rc, err, out = dp_world["peer"]
    assert rc == 0, err[-3000:]
    p, s = dp_world["train"]
    _close(p, single[0], MESH_PARAM_ATOL)
    _close(s, single[1], STATE_ATOL)
    peer = np.load(out)
    assert sorted(peer.files) == sorted(f"0/{k}" for k in p)
    for k, v in p.items():
        np.testing.assert_array_equal(peer[f"0/{k}"], v, err_msg=k)


def test_expect_multiprocess_fails_fast_on_silent_degradation(monkeypatch):
    """--distributed that resolves to one process raises; one asked for runs."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    try:
        multihost.initialize(None, 1, None, expect_multiprocess=True)
        assert torch.distributed.get_world_size() == 1
    finally:
        multihost.shutdown()
    with pytest.raises(RuntimeError, match="train alone"):
        multihost.initialize(None, None, None, expect_multiprocess=True)
    assert not torch.distributed.is_initialized()
