"""The port's training harness against the JAX package's, on the CPU.

The slice as a whole: both packages' ``q_and_v_eval.main`` train the small
film_attn_pt (1 block x 16 channels, embed/hidden/attention 8, 8 input
channels, f32, batch 4, sum loss, clip 1.0, Adam 1e-3) for one epoch with
``--bucket_frames true`` on an npy fixture, both resumed from copies of one
JAX checkpoint (the JAX init, a fresh optax state, epoch -1). Both
``load_stem``s are replaced by the same cheap stand-in stem (a 16x16 average
pool, then a seeded 3->8 projection and a ReLU), written once in jnp and
once in torch; tests/test_torch_stem.py holds the real stem.

Bounds: the epoch losses rtol 1e-5 and the hits, predictions and F1 equal;
the printed lines alike with their numbers within rtol 1e-5 (examples/s
aside); the JSONL events with the same keys and numbers within rtol 1e-5
(times aside); the port's ``e0_`` checkpoint loads in JAX's ``load_checkpoint``,
its params and Adam moments within the train goldens' bounds of JAX's
(GOLDEN_ATOL, GOLDEN_TIGHT_ATOL off NOISE_LEAVES; tests/test_torch_train.py;
elements whose gradient was float noise at a step: SUB_NOISE_ATOL, see
NOISE_GRAD) and its count equal. Also: a save -> load round trip is bit-exact; a JAX
checkpoint with a mid-run Adam state passes through the port bit for bit,
at the checkpoint's lr, and the port steps on from it; MAC's lr schedule;
every refused flag; the device default; the question-only and video-only
entry points; the stem importers; the step timer and the profiler trace.
"""

import json
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videonavqa_tpu.cli import common as jcommon
from videonavqa_tpu.cli import q_and_v_eval as jq_and_v
from videonavqa_tpu.data.synthetic import generate_synthetic_dataset
from videonavqa_tpu.models import ModelConfig as JaxConfig
from videonavqa_tpu.models import get_model as jax_get_model
from videonavqa_tpu.train import step as jstep
from videonavqa_tpu.utils import checkpoint as jckpt
from videonavqa_tpu.utils import torch_import as jti
from videonavqa_tpu_torch.cli import common as tcommon
from videonavqa_tpu_torch.cli import q_and_v_eval, q_and_v_test, q_only_eval, q_only_test
from videonavqa_tpu_torch.cli import v_only_eval, v_only_test
from videonavqa_tpu_torch.models import ModelConfig, get_model
from videonavqa_tpu_torch.stem import stem_features
from videonavqa_tpu_torch.train import step
from videonavqa_tpu_torch.utils import checkpoint as ckpt
from videonavqa_tpu_torch.utils import torch_import as ti
from videonavqa_tpu_torch.utils.logging import MetricsLogger, StepTimer, maybe_profile

from test_torch_train import (
    GOLDEN_ATOL, GOLDEN_TIGHT_ATOL, NOISE_LEAVES, SMALL, _batch, _max_diff, _t,
)

FILM_ARGS = ["--model", "film_attn_pt", "--num_res_blocks", "1",
             "--num_res_block_channels", "16", "--embed_size", "8", "--hidden_size", "8",
             "--at_hidden_size", "8", "--num_input_channels", "8",
             "--compute_dtype", "float32", "--batch_size", "4", "--loss_reduction", "sum",
             "--clip_value", "1.0", "--l_rate", "1e-3", "--stats_after_every", "1",
             "--bucket_frames", "true", "--num_workers", "2"]
JAX_FILM_CFG = JaxConfig(model="film_attn_pt", num_res_blocks=1, num_res_block_channels=16,
                         embed_size=8, hidden_size=8, at_hidden_size=8, num_input_channels=8,
                         compute_dtype="float32")
LOSS_RTOL = 1e-5
# An element whose clipped gradient is this small at some step is float noise
# there: its exact value is a sum of cancelling terms of ~1e-2 (the train-mode
# BN's backward), and Adam's normalized step g / (|g| + 1e-8) turns its sign
# and size into a step of up to the lr, on either side. Such elements are held
# to two steps of the lr each way, and the running statistics of a channel
# behind one of them too; every other element to GOLDEN_TIGHT_ATOL. (On a
# fixture of 40-frame videos, conv_init/bias[12] took such a step: step 1's
# gradient 1.7e-8 in JAX and -0.9e-8 in the port, 1.09e-3 apart after two
# steps at lr 1e-3, bn_init's statistics 4.5e-4. On this test's 32-frame
# fixture every element lies within the goldens' bounds: the noise leaf
# fc_hidden_attn/bias 7.0e-5, the rest at most 1.1e-5, lstm_attn/w_ih.)
NOISE_GRAD = 1e-7
SMALL_CHANNELS = 16   # --num_res_block_channels
SUB_NOISE_ATOL = 2 * 2 * 1e-3
STEM_W = (np.random.default_rng(77).standard_normal((3, 8)) * 0.5).astype(np.float32)


def _jax_stem(video):
    B, T = video.shape[:2]
    x = video.reshape(B, T, 10, 16, 13, 16, 3).mean(axis=(3, 5))
    return jax.nn.relu(x @ jnp.asarray(STEM_W))


def _torch_stem(video):
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


@pytest.fixture
def stand_in_stems(monkeypatch):
    monkeypatch.setattr(jcommon, "load_stem", lambda *a, **k: _jax_stem)
    monkeypatch.setattr(tcommon, "load_stem", lambda *a, **k: _torch_stem)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """8 train, 8 val and 8 test examples of at most 32 frames (v_len <= 8:
    frame bucket 8)."""
    out = str(tmp_path_factory.mktemp("harness_data"))
    generate_synthetic_dataset(out, num_houses=3, trajs_per_house=8, seed=5,
                               video_format="npy", max_frames=32)
    return out


def _tiny(tmp_path_factory, n):
    out = str(tmp_path_factory.mktemp(f"harness_tiny{n}"))
    generate_synthetic_dataset(out, num_houses=3, trajs_per_house=n, seed=6,
                               video_format="npy", max_frames=12)
    return out


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    """4 train and 4 val examples of at most 12 frames: one batch of 4 each."""
    return _tiny(tmp_path_factory, 4)


@pytest.fixture(scope="module")
def one_dir(tmp_path_factory):
    """1 train and 1 val example: the video-only model's 160x208 trunk runs
    its whole 35-frame container (its harness has no frame buckets)."""
    return _tiny(tmp_path_factory, 1)


_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _numbered_lines(text):
    """[(line with each number as '#', [numbers])] of the non-empty lines."""
    return [(_NUM.sub("#", line), [float(x) for x in _NUM.findall(line)])
            for line in text.splitlines() if line.strip()]


def _assert_same_lines(got, want, skip_last_number_of=()):
    got, want = _numbered_lines(got), _numbered_lines(want)
    assert [g for g, _ in got] == [w for w, _ in want]
    for (line, g), (_, w) in zip(got, want):
        if line.startswith(skip_last_number_of):
            g, w = g[:-1], w[:-1]
        np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, atol=1e-6, err_msg=line)


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _spy_epochs(monkeypatch, cls, summary_index):
    """Record each run_epoch's summary."""
    seen = []
    orig = cls.run_epoch

    def spy(self, *a, **k):
        out = orig(self, *a, **k)
        seen.append(out[summary_index])
        return out

    monkeypatch.setattr(cls, "run_epoch", spy)
    return seen


def _spy_noise_gradients(monkeypatch):
    """{leaf path: bool mask in the JAX layout} of the elements whose clipped
    gradient (``p.grad`` after a step) lay under NOISE_GRAD at some step of
    the port's harness."""
    masks = {}
    real = tcommon.make_train_step

    def make(*a, **k):
        inner = real(*a, **k)

        def train(params, state, batch, generator=None):
            out = inner(params, state, batch, generator)
            for path, p in step.tree_items(params):
                m = (p.grad.abs() < NOISE_GRAD).numpy()
                m = m.transpose(2, 3, 1, 0) if m.ndim == 4 else m
                masks[path] = masks[path] | m if path in masks else m
            return out

        return train

    monkeypatch.setattr(tcommon, "make_train_step", make)
    return masks


def _assert_held(got, want, sub_noise):
    """Params: NOISE_LEAVES within GOLDEN_ATOL, the elements of
    ``sub_noise`` within SUB_NOISE_ATOL, every other element within
    GOLDEN_TIGHT_ATOL."""
    want = dict(step.tree_items(want))
    for k, v in step.tree_items(got):
        d = np.abs(np.asarray(v) - np.asarray(want[k]))
        if k in NOISE_LEAVES:
            assert d.max() <= GOLDEN_ATOL, k
            continue
        sub = sub_noise[k]
        assert d[~sub].max(initial=0.0) <= GOLDEN_TIGHT_ATOL, k
        assert d[sub].max(initial=0.0) <= SUB_NOISE_ATOL, k


def _assert_bn_held(got, want, sub_noise):
    """bn_init's running statistics within GOLDEN_TIGHT_ATOL, but for the
    channels behind a sub-noise element of conv_init (whose output it
    normalizes): SUB_NOISE_ATOL there."""
    noisy = sub_noise["trunk/conv_init/bias"] | \
        sub_noise["trunk/conv_init/weight"].reshape(-1, SMALL_CHANNELS).any(axis=0)
    for k in ("mean", "var"):
        d = np.abs(np.asarray(got["trunk"]["bn_init"][k]) -
                   np.asarray(want["trunk"]["bn_init"][k]))
        assert d[~noisy].max(initial=0.0) <= GOLDEN_TIGHT_ATOL, k
        assert d[noisy].max(initial=0.0) <= SUB_NOISE_ATOL, k


def _jax_templates():
    jp, js = jax.jit(jax_get_model("film_attn_pt").init, static_argnums=1)(
        jax.random.PRNGKey(7), JAX_FILM_CFG)
    return jp, js, jstep.make_optimizer(1e-3).init(jp)


def test_run_training_matches_the_jax_harness(data_dir, tmp_path, monkeypatch, capsys,
                                              stand_in_stems):
    jp, js, jopt = _jax_templates()
    start = str(tmp_path / "start.npz")
    jckpt.save_checkpoint(start, params=jp, state=js, opt_state=jopt, meta={"epoch": -1})
    sub_noise = _spy_noise_gradients(monkeypatch)
    runs = {}
    for side, main, cls, idx, extra in (("jax", jq_and_v.main, jcommon.Harness, 3, []),
                                        ("port", q_and_v_eval.main, tcommon.Harness, 1,
                                         ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        shutil.copy(start, d / "m.npz")
        seen = _spy_epochs(monkeypatch, cls, idx)
        main(FILM_ARGS + extra + ["--data_dir", data_dir, "--checkpoint_path", str(d / "m.npz"),
                                  "--metrics_file", str(d / "m.jsonl")])
        runs[side] = (seen, capsys.readouterr().out, _read_jsonl(d / "m.jsonl"), d / "e0_m.npz")

    (jsum, jout, jlog, jfile), (tsum, tout, tlog, tfile) = runs["jax"], runs["port"]
    assert len(tsum) == len(jsum) == 2   # one train epoch, one validation
    for t, j in zip(tsum, jsum):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=LOSS_RTOL)
        assert (t["hit"], t["num_examples"]) == (j["hit"], j["num_examples"]) and t["hit"] >= 0
        np.testing.assert_array_equal(t["y_pred"], j["y_pred"])
        np.testing.assert_array_equal(t["y_target"], j["y_target"])
        assert (t["f1_w"], t["f1_micro"]) == (j["f1_w"], j["f1_micro"])
    assert tsum[0]["num_examples"] == tsum[1]["num_examples"] == 8
    assert "Restoring from checkpoint" in tout and "Average loss after 2 iterations" in tout
    _assert_same_lines(tout.replace(str(tmp_path / "port"), "DIR"),
                       jout.replace(str(tmp_path / "jax"), "DIR"),
                       skip_last_number_of=("Train Epoch",))

    assert [r["event"] for r in tlog] == [r["event"] for r in jlog] == [
        "run_start", "train_progress", "train_progress", "train_epoch", "eval_epoch"]
    for t, j in zip(tlog, jlog):
        assert sorted(t) == sorted(j)
        for k, v in j.items():
            if k == "args":
                assert sorted(set(t[k]) - {"device"}) == sorted(v)
            elif k not in ("time", "examples_per_sec") and isinstance(v, (int, float)):
                np.testing.assert_allclose(t[k], v, rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
            elif k not in ("time", "examples_per_sec"):
                assert t[k] == v, k

    # the port's e0_ checkpoint in JAX's loader, against JAX's own
    jp, js, jopt = _jax_templates()
    got = jckpt.load_checkpoint(str(tfile), params_template=jp, state_template=js,
                                opt_template=jopt)
    want = jckpt.load_checkpoint(str(jfile), params_template=jp, state_template=js,
                                 opt_template=jopt)
    assert got[3] == {**want[3], "train_f1w": got[3]["train_f1w"],
                      "train_f1micro": got[3]["train_f1micro"]} and got[3]["epoch"] == 0
    _assert_held(got[0], want[0], sub_noise)
    _assert_bn_held(got[1], want[1], sub_noise)
    for moment in ("mu", "nu"):
        g, w = getattr(got[2].inner_state[0], moment), getattr(want[2].inner_state[0], moment)
        assert _max_diff(g, w) <= GOLDEN_ATOL
        assert _max_diff(g, w, skip=NOISE_LEAVES) <= GOLDEN_TIGHT_ATOL
    assert int(got[2].count) == int(got[2].inner_state[0].count) == int(want[2].count) == 2
    np.testing.assert_array_equal(got[2].hyperparams["learning_rate"],
                                  want[2].hyperparams["learning_rate"])


def _small(model):
    return ModelConfig(**{**SMALL, "model": model})


def _trained_port(model, seed, lr, steps=1):
    """Port params, state and Adam after ``steps`` train steps from features."""
    cfg = _small(model)
    spec = get_model(model)
    params, state = spec.init(torch.Generator().manual_seed(seed), cfg, torch.device("cpu"))
    opt = step.make_optimizer(params, lr)
    train = step.make_train_step(spec, cfg, opt, reduction="sum", clip_value=1.0)
    for it in range(steps):
        state, _ = train(params, state, _t(_batch(it)), torch.Generator().manual_seed(it))
    return params, state, opt


@pytest.mark.parametrize("model", ["film_attn_pt", "mac"])
def test_save_load_round_trip_is_bit_exact(model, tmp_path):
    params, state, opt = _trained_port(model, 0, 1e-3, steps=2)
    path = str(tmp_path / "c.npz")
    ckpt.save_checkpoint(path, params=params, state=state, optimizer=opt, meta={"epoch": 4})
    p2, s2, opt2 = _trained_port(model, 1, 0.25, steps=0)
    assert ckpt.load_checkpoint(path, params=p2, state=s2, optimizer=opt2) == {"epoch": 4}
    for a, b in ((params, p2), (state, s2)):
        assert [k for k, _ in step.tree_items(a)] == [k for k, _ in step.tree_items(b)]
        for (k, x), (_, y) in zip(step.tree_items(a), step.tree_items(b)):
            assert torch.equal(x, y), k
    # the file keeps the lr in f32, as optax's state does
    assert {k: v for k, v in opt2.param_groups[0].items() if k != "params"} == \
        {k: v for k, v in opt.param_groups[0].items() if k != "params"} | {
            "lr": float(np.float32(1e-3))}
    for (k, x), (_, y) in zip(step.tree_items(params), step.tree_items(p2)):
        sx, sy = opt.state[x], opt2.state[y]
        assert float(sy["step"]) == float(sx["step"]) == 2.0 and sy["step"].dtype == torch.float32
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sx[key], sy[key]), (k, key)


def test_a_jax_checkpoint_with_adam_state_survives_the_port_bit_for_bit(tmp_path):
    """A JAX checkpoint whose optax state is mid-run (count 5, seeded
    moments, lr 3e-4): the port restores it over other weights and another
    lr (0.5), writes it back with the same bytes in every leaf, and steps on
    from it (step 6)."""
    jp, js, jopt = _jax_templates()
    r = np.random.default_rng(12)
    rand = lambda a: (r.standard_normal(np.shape(a)) * 1e-3).astype(np.float32)
    inner = jopt.inner_state[0]._replace(count=jnp.int32(5), mu=jax.tree.map(rand, jp),
                                         nu=jax.tree.map(lambda a: rand(a) ** 2, jp))
    jopt = jopt._replace(count=jnp.int32(5), inner_state=(inner, *jopt.inner_state[1:]))
    jopt.hyperparams["learning_rate"] = jnp.float32(3e-4)
    jp, js = jax.tree.map(rand, jp), jax.tree.map(lambda a: rand(a) + 1.0, js)
    src, out = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_checkpoint(src, params=jp, state=js, opt_state=jopt, meta={"epoch": 3})

    cfg = tcommon.cfg_from_args(tcommon.build_q_and_v_parser().parse_args(
        FILM_ARGS + ["--device", "cpu"]), "film_attn_pt")
    spec = get_model("film_attn_pt")
    params, state = spec.init(torch.Generator().manual_seed(1), cfg, torch.device("cpu"))
    opt = step.make_optimizer(params, 0.5)
    assert ckpt.load_checkpoint(src, params=params, state=state, optimizer=opt) == {"epoch": 3}
    assert opt.param_groups[0]["lr"] == float(np.float32(3e-4))
    ckpt.save_checkpoint(out, params=params, state=state, optimizer=opt, meta={"epoch": 3})
    want, got = ckpt.read_npz(src)[0], ckpt.read_npz(out)[0]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k

    B, T = 2, 8
    rb = np.random.default_rng(13)
    batch = {"v_features": torch.from_numpy(rb.random((B, T, 10, 13, 8), dtype=np.float32)),
             "question": torch.from_numpy(rb.integers(1, 134, (B, 56)).astype(np.int32)),
             "v_len": torch.tensor([8, 3], dtype=torch.int32),
             "q_len": torch.tensor([5, 9], dtype=torch.int32),
             "label": torch.tensor([1, 4], dtype=torch.int32)}
    before = params["out_linear"]["weight"].clone()
    step.make_train_step(spec, cfg, opt, reduction="sum", clip_value=1.0)(params, state, batch)
    assert all(float(s["step"]) == 6.0 for s in opt.state.values())
    assert not torch.equal(before, params["out_linear"]["weight"])


def test_mac_learning_rate_schedule_through_run_training(tiny_dir, monkeypatch,
                                                         stand_in_stems):
    seen = []
    real = tcommon.set_learning_rate

    def spy(optimizer, lr):
        seen.append(lr)
        real(optimizer, lr)

    monkeypatch.setattr(tcommon, "set_learning_rate", spy)
    q_and_v_eval.main(["--device", "cpu", "--model", "mac", "--data_dir", tiny_dir,
                       "--mac_dim", "8", "--mac_max_step", "2", "--embed_size", "8",
                       "--num_input_channels", "8", "--compute_dtype", "float32",
                       "--batch_size", "4", "--num_epochs", "3", "--num_workers", "1"])
    assert seen == [1e-4, 1e-5, 1e-4]


# The mesh flags run (tests/test_torch_cli_dp.py); these cases are the
# combinations that cannot (the batch or the devices do not split) or would
# be silently ignored (a process training alone), each refused before any
# data is read.
_MESH_REFUSALS = {
    "divide_data": "must divide by the 'data' mesh axis",
    "divide_mp": "does not divide by --model_parallel",
    "divide_procs": "does not divide by --num_processes",
    "no_mesh_mp": "--model_parallel 2 needs --mesh_devices",
    "no_mesh_dist": "--distributed true needs --mesh_devices",
    "no_dist": "read only with --distributed",
}


@pytest.mark.parametrize("main, argv, item", [
    (q_and_v_eval.main, ["--model", "film_attn_pt", "--feature_cache", "true",
                         "--int8_stem", "true"], "mutually exclusive"),
    (q_and_v_test.main, ["--model", "concat3d", "--mesh_devices", "3"], "divide_data"),
    (q_and_v_eval.main, ["--model", "film_attn_pt", "--int8_trunk", "true",
                         "--mesh_devices", "2", "--batch_size", "3"], "divide_data"),
    (q_and_v_eval.main, ["--model", "film_attn_pt", "--mesh_devices", "2",
                         "--model_parallel", "3"], "divide_mp"),
    (q_and_v_eval.main, ["--model", "film_attn_pt", "--model_parallel", "2"], "no_mesh_mp"),
    (q_and_v_eval.main, ["--model", "film_attn_pt", "--distributed", "true"], "no_mesh_dist"),
    (q_and_v_eval.main, ["--model", "film_attn_pt", "--num_processes", "2"], "no_dist"),
    (q_and_v_eval.main, ["--model", "film_gp_pt", "--distributed", "true", "--mesh_devices",
                         "2", "--num_processes", "4"], "divide_procs"),
    (v_only_test.main, ["--model", "cnn3d", "--model_parallel", "2"], "no_mesh_mp"),
    (q_only_test.main, ["--model", "bow", "--process_id", "1"], "no_dist"),
    (q_only_eval.main, ["--model", "lstm", "--mesh_devices", "3"], "divide_data"),
    (q_and_v_eval.main, ["--model", "film_attn_pt", "--jax_cache_dir", "/tmp/x"], "XLA"),
], ids=lambda v: "A8" if isinstance(v, str) and v in _MESH_REFUSALS else None)   # the ids the cases had as item A8
def test_refused_flags_exit(main, argv, item, tmp_path):
    item = re.escape(_MESH_REFUSALS[item]) if item in _MESH_REFUSALS else item
    with pytest.raises(SystemExit, match=item):
        main(argv + ["--device", "cpu", "--data_dir", str(tmp_path / "absent")])


def test_device_defaults_to_cuda_and_raises_without_it(tiny_dir, monkeypatch):
    assert tcommon.build_q_and_v_parser().parse_args([]).device == "cuda"
    assert v_only_eval.build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, model in ((q_and_v_eval.main, "film_attn_pt"), (q_only_eval.main, "lstm"),
                        (v_only_eval.main, "cnn2d_lstm")):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--model", model, "--data_dir", tiny_dir])


# The JAX harnesses' line formats (videonavqa_tpu/cli/common.py run_epoch and
# run_training, videonavqa_tpu/cli/q_only_eval.py main).
_AVG = r"Average loss after 1 iterations in epoch {}: \d+\.\d{{6}}"
_Q_ONLY_LINES = [
    r"4 train examples, 4 validation examples",
    r"Using class weights \[(1\. ?)+",
    r" ?(1\. ?)+",
    r" ?(1\. ?)+\]",
    _AVG.format(1),
    r"Train Epoch: 1\tAverage loss: \d+\.\d{6}\tF1: w\d\.\d{4}, micro\d\.\d{4}",
    r"Validation:\tAverage loss: \d+\.\d{6}, F1: w\d\.\d{4}, micro\d\.\d{4}",
    _AVG.format(2),
    r"Train Epoch: 2\tAverage loss: \d+\.\d{6}\tF1: w\d\.\d{4}, micro\d\.\d{4}",
    r"Validation:\tAverage loss: \d+\.\d{6}, F1: w\d\.\d{4}, micro\d\.\d{4}",
]


def _assert_lines(out, patterns):
    lines = [line for line in out.splitlines() if line.strip()]
    assert len(lines) == len(patterns), lines
    for line, pattern in zip(lines, patterns):
        assert re.fullmatch(pattern, line), line


def test_q_only_eval_runs_and_prints_the_jax_lines(tiny_dir, tmp_path, capsys):
    q_only_eval.main(["--device", "cpu", "--model", "lstm", "--data_dir", tiny_dir,
                      "--batch_size", "4", "--num_epochs", "2", "--stats_after_every", "1",
                      "--embed_size", "8", "--hidden_size", "8", "--num_workers", "1",
                      "--checkpoint_path", str(tmp_path / "q.npz")])
    _assert_lines(capsys.readouterr().out, _Q_ONLY_LINES)
    # the best validation's checkpoint, in JAX's loader
    jp, js = jax.jit(jax_get_model("lstm").init, static_argnums=1)(
        jax.random.PRNGKey(0), JaxConfig(model="lstm", embed_size=8, hidden_size=8))
    meta = jckpt.load_checkpoint(str(tmp_path / "q.npz"), params_template=jp,
                                 state_template=js,
                                 opt_template=jstep.make_optimizer(1e-5).init(jp))[3]
    assert meta["model"] == "lstm" and meta["epoch"] in (0, 1)


_V_ONLY_LINES = [
    r"1 train examples, 1 validation examples",
    r"=> No checkpoint existent - will save the model here",
    _AVG.format(1),
    r"Train Epoch: 0\tAverage loss: \d+\.\d{6}\tAccuracy: \d/1\tF1: w\d\.\d{4}, "
    r"micro\d\.\d{4}\t\(\d+\.\d{2} ex/s\)",
    r"\{.*\}",
    r"Validation:\tAverage loss: \d+\.\d{6}, Accuracy: \d/1, F1: w\d\.\d{4}, micro\d\.\d{4}",
]


def test_v_only_eval_runs_and_prints_the_jax_lines(one_dir, tmp_path, capsys):
    v_only_eval.main(["--device", "cpu", "--model", "cnn2d_lstm", "--data_dir", one_dir,
                      "--batch_size", "1", "--hidden_size", "8", "--compute_dtype", "float32",
                      "--stats_after_every", "1", "--num_workers", "1",
                      "--checkpoint_path", str(tmp_path / "v.npz")])
    _assert_lines(capsys.readouterr().out, _V_ONLY_LINES)
    flat, meta = ckpt.read_npz(str(tmp_path / "e0_v.npz"))
    assert meta["model"] == "v_only_cnn2d_lstm" and int(flat[ckpt.OPT_COUNT]) == 1


def _torch_stem_state_dicts(tmp_path):
    """A VGG-16 file (under a module prefix, with layers the stem skips) and
    an obj_detect.pt, seeded, written with torch."""
    g = torch.Generator().manual_seed(3)
    vgg = {}
    for idx, (cin, cout) in {0: (3, 64), 2: (64, 64), 5: (64, 128), 7: (128, 128),
                             10: (128, 256)}.items():
        vgg[f"RCNN_base.features.{idx}.weight"] = torch.randn(cout, cin, 3, 3, generator=g)
        vgg[f"RCNN_base.features.{idx}.bias"] = torch.randn(cout, generator=g)
    det = {}

    def bn(name, n):
        det[f"{name}.weight"] = torch.rand(n, generator=g) + 0.5
        det[f"{name}.bias"] = torch.randn(n, generator=g)
        det[f"{name}.running_mean"] = torch.randn(n, generator=g)
        det[f"{name}.running_var"] = torch.rand(n, generator=g) + 0.5
        det[f"{name}.num_batches_tracked"] = torch.tensor(7)

    bn("bn_input", 128)
    cin = 128
    for b in range(1, 4):
        for j, c in ((1, cin), (2, 16)):
            det[f"conv{b}{j}.weight"] = torch.randn(16, c, 3, 3, generator=g) * 0.1
            det[f"conv{b}{j}.bias"] = torch.randn(16, generator=g)
        bn(f"bn{b}", 16)
        cin = 16
    det["fc_tail1.weight"] = torch.randn(6, 16 * 30, generator=g)
    det["fc_tail1.bias"] = torch.randn(6, generator=g)
    bn("bn_tail1", 6)
    det["fc_tail2.weight"] = torch.randn(27, 6, generator=g)
    det["fc_tail2.bias"] = torch.randn(27, generator=g)
    vgg_path, det_dir = tmp_path / "vgg16_caffe.pth", tmp_path / "data"
    det_dir.mkdir()
    torch.save(vgg, vgg_path)
    torch.save({"state_dict": det}, det_dir / "obj_detect.pt")
    return str(vgg_path), str(det_dir)


def test_stem_importers_give_stem_from_jax_tensors(tmp_path, capsys):
    vgg_path, det_dir = _torch_stem_state_dicts(tmp_path)
    det_path = os.path.join(det_dir, "obj_detect.pt")
    want = ckpt.stem_from_jax(
        jti.import_vgg_partial(jti.load_torch_state_dict(vgg_path, key=None)),
        *jti.import_obj_detector(jti.load_torch_state_dict(det_path)), torch.device("cpu"))
    got = (ti.import_vgg_partial(ti.load_torch_state_dict(vgg_path, key=None)),
           *ti.import_obj_detector(ti.load_torch_state_dict(det_path)))
    for g, w in zip(got, want):
        assert [k for k, _ in step.tree_items(g)] == [k for k, _ in step.tree_items(w)]
        for (k, x), (_, y) in zip(step.tree_items(g), step.tree_items(w)):
            assert x.dtype == y.dtype and torch.equal(x, y), k

    # load_stem imports both files where they exist, and runs on the plain route
    args = tcommon.build_q_and_v_parser().parse_args(
        ["--frcnn_pretrained_path", vgg_path, "--compute_dtype", "float32"])
    stem_fn = tcommon.load_stem(args, tcommon.DataPaths(det_dir), torch.device("cpu"))
    assert "random" not in capsys.readouterr().out
    video = torch.rand(1, 2, 32, 48, 3, generator=torch.Generator().manual_seed(4))
    expected = stem_features(*want, video, dtype=torch.float32)
    assert torch.equal(stem_fn(video), expected)


def test_a_torch_save_checkpoint_is_refused(tmp_path):
    """A torch.save file goes through the reference importer (see
    tests/test_torch_zoo_interchange.py); one that does not hold the model's
    layers is refused, naming the first missing one, and loads nothing."""
    path = str(tmp_path / "ref.pt")
    torch.save({"epoch": 3, "state_dict": {"w": torch.zeros(2)}}, path)
    params, state, opt = _trained_port("film_attn_pt", 0, 1e-3, steps=0)
    before = [t.clone() for _, t in step.tree_items(params)]
    with pytest.raises(KeyError, match="embed.weight"):
        ckpt.load_any_checkpoint(path, model_name="film_attn_pt", cfg=_small("film_attn_pt"),
                                 params=params, state=state, optimizer=opt)
    assert all(torch.equal(t, b) for (_, t), b in zip(step.tree_items(params), before))
    assert not opt.state


def test_checkpoint_refuses_a_leaf_of_another_shape(tmp_path):
    params, state, opt = _trained_port("film_attn_pt", 0, 1e-3, steps=1)
    path = str(tmp_path / "c.npz")
    ckpt.save_checkpoint(path, params=params, state=state, optimizer=opt)
    other, other_state, _ = _trained_port("film_attn_pt", 0, 1e-3, steps=0)
    other["out_linear"]["bias"] = torch.zeros(3)
    with pytest.raises(ValueError, match="out_linear/bias"):
        ckpt.load_checkpoint(path, params=other, state=other_state)
    other, _, _ = _trained_port("film_attn_pt", 0, 1e-3, steps=0)
    other["fc_attn_2"] = {"bias": torch.zeros(1)}
    with pytest.raises(KeyError, match="fc_attn_2"):
        ckpt.load_checkpoint(path, params=other)


def test_step_timer_and_profile_trace(tmp_path):
    timer = StepTimer(skip=1)
    for _ in range(3):
        timer.start()
        assert timer.stop("cpu") >= 0.0
    assert timer.count == 3 and timer.mean_ms >= 0.0
    with maybe_profile(str(tmp_path / "trace")):
        torch.ones(4).sum()
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1 and traces[0].endswith(".json")
    with maybe_profile(None):   # no directory: no trace
        pass
    assert MetricsLogger(None).path is None
