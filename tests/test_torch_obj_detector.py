"""The detector's classification mode, its export and its trainer in the port
against the JAX package's, on the CPU.

Weights and inputs are made with numpy from a seed (tests/test_torch_stem.py's
helpers, the tail's Linears and BatchNorms too) and given to both packages
through ``stem_from_jax``; the convs run in f32. Bounds: logits atol 1e-5
(LOGIT_ATOL), the new BatchNorm state atol 1e-6 (STATE_ATOL), train mode
given the dropout mask JAX draws; the exported ``obj_detect.pt`` equal key
for key, in order. ``train_obj_detector --data`` (8 filters, tail 16, 16
frames of 160x208, batch 4, 2 epochs, dropout 0, both packages' convs in
f32 (each trainer's VGG and detector functions monkeypatched), the JAX init
carried over, a narrow VGG from a ``--frcnn_pretrained_path``
file, so the test takes seconds): the same printed lines, numbers rtol 1e-5;
the checkpoint read by JAX's ``load_checkpoint``, its parameters and state
within TRAINED_ATOL of JAX's (NOISE_ATOL for the biases whose gradient is
float noise). ``--synthetic 8`` in the same set-up: the rendered frames and
targets bit-equal to JAX's (``make_synthetic_detector_data``, two seeds),
the epoch lines within LINE_RTOL. Measured values stand beside each bound.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_stem import _bn, _conv

from videonavqa_tpu.cli import train_obj_detector as jtod
from videonavqa_tpu.stem import init_obj_detector as jax_init_obj_detector
from videonavqa_tpu.stem import obj_detector as jax_obj_detector
from videonavqa_tpu.stem import vgg_partial as jax_vgg_partial
from videonavqa_tpu.utils import checkpoint as jckpt
from videonavqa_tpu.utils import torch_import as jti
from videonavqa_tpu_torch.cli import train_obj_detector as tod
from videonavqa_tpu_torch.stem import obj_detector
from videonavqa_tpu_torch.utils import torch_import as ti
from videonavqa_tpu_torch.utils.checkpoint import stem_from_jax

NUM_FILTERS = 8
HIDDEN = 16
CLASSES = 5
LOGIT_ATOL = 1e-5      # measured: 4.2e-7 eval, 6.4e-6 train (batch statistics of 4 frames)
STATE_ATOL = 1e-6      # measured: 1.7e-7
TRAINED_ATOL = 2e-5    # after 8 Adam steps at lr 1e-4; measured 2.1e-6 (bn_tail1/var)
LINE_RTOL = 1e-5
SYNTHETIC_FRAMES, SYNTHETIC_CLASSES = 8, 27   # --synthetic: DEFAULT_DETECTOR_CLASSES
# The biases right before a train-mode BatchNorm have a zero gradient in exact
# arithmetic (the batch mean takes them out), so Adam turns their float noise
# into steps of up to the lr either way, as the noise leaves of
# tests/test_torch_train.py; they, and the running means of the BatchNorms
# behind them, are held to two such steps a step: 2 x 8 x 1e-4.
NOISE_LEAVES = ("conv12/bias", "conv22/bias", "conv32/bias", "fc_tail1/bias",
                "bn1/mean", "bn2/mean", "bn3/mean", "bn_tail1/mean")
NOISE_ATOL = 2 * 8 * 1e-4   # measured 9.2e-4 (conv12/bias)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _linear(r, out, inp):
    bound = 1.0 / np.sqrt(inp)
    return {"weight": r.uniform(-bound, bound, (out, inp)).astype(np.float32),
            "bias": r.uniform(-bound, bound, out).astype(np.float32)}


@pytest.fixture(scope="module")
def detector():
    """(JAX params, JAX state) as numpy, with the tail."""
    r = np.random.default_rng(21)
    p, s = {}, {}
    p["bn_input"], s["bn_input"] = _bn(r, 128)
    cin = 128
    for b in range(1, 4):
        p[f"conv{b}1"] = _conv(r, cin, NUM_FILTERS, 0.1)
        p[f"conv{b}2"] = _conv(r, NUM_FILTERS, NUM_FILTERS, 0.1)
        p[f"bn{b}"], s[f"bn{b}"] = _bn(r, NUM_FILTERS)
        cin = NUM_FILTERS
    p["fc_tail1"] = _linear(r, HIDDEN, NUM_FILTERS * 5 * 6)
    p["bn_tail1"], s["bn_tail1"] = _bn(r, HIDDEN)
    p["fc_tail2"] = _linear(r, CLASSES, HIDDEN)
    return p, s


def _feats(n=3, seed=4):
    return np.random.default_rng(seed).standard_normal((n, 40, 52, 128)).astype(np.float32)


def _port(detector):
    _, tp, ts = stem_from_jax({}, *detector, torch.device("cpu"))
    return tp, ts


def test_stem_from_jax_carries_the_detector_tail(detector):
    tp, ts = _port(detector)
    for name in ("fc_tail1", "fc_tail2"):
        for k in ("weight", "bias"):   # Linears keep [out, in] in both packages
            np.testing.assert_array_equal(tp[name][k].numpy(), detector[0][name][k])
    assert set(ts["bn_tail1"]) == {"mean", "var"}
    assert tuple(tp["conv11"]["weight"].shape) == (NUM_FILTERS, 128, 3, 3)


@pytest.mark.parametrize("logits", [True, False])
def test_obj_detector_eval_matches_jax(detector, logits):
    jp, js = jax.tree.map(jnp.asarray, detector)
    x = _feats()
    want, want_state = jax_obj_detector(jp, js, jnp.asarray(x), train=False, logits=logits,
                                        dtype=jnp.float32)
    tp, ts = _port(detector)
    with torch.no_grad():
        got, got_state = obj_detector(tp, ts, torch.from_numpy(x), train=False, logits=logits,
                                      dtype=torch.float32)
    assert got.shape == (3, CLASSES) and got_state is not None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_ATOL)


def _jax_mask(key, p, n):
    return np.array(jax.random.bernoulli(key, 1.0 - p, (n, HIDDEN)))


@pytest.mark.parametrize("p", [0.0, 0.5])
def test_obj_detector_train_matches_jax_given_its_dropout_mask(detector, p):
    jp, js = jax.tree.map(jnp.asarray, detector)
    x = _feats(4, 5)
    key = jax.random.PRNGKey(3)
    want, want_state = jax_obj_detector(jp, js, jnp.asarray(x), train=True, dropout_rng=key,
                                        tail_dropout_p=p, dtype=jnp.float32)
    tp, ts = _port(detector)
    mask = torch.from_numpy(_jax_mask(key, p, 4)) if p else None
    with torch.no_grad():
        got, got_state = obj_detector(tp, ts, torch.from_numpy(x), train=True,
                                      tail_dropout_p=p, dropout_mask=mask, dtype=torch.float32)
    if p:
        assert 0 < int((~mask).sum()) < mask.numel()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_ATOL)
    assert set(got_state) == set(want_state)
    for name, st in want_state.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(got_state[name][k].numpy(), np.asarray(st[k]),
                                       rtol=0, atol=STATE_ATOL, err_msg=f"{name}/{k}")


def test_obj_detector_dropout_draws_from_its_generator(detector):
    tp, ts = _port(detector)
    x = torch.from_numpy(_feats(6, 6))

    def run(seed, train=True):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return obj_detector(tp, ts, x, train=train, generator=g, tail_dropout_p=0.5,
                                dtype=torch.float32)[0]

    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    # no generator and no mask, or eval: nothing drops (JAX's forward without an rng)
    assert torch.equal(run(None), obj_detector(tp, ts, x, train=True, dtype=torch.float32)[0])
    assert torch.equal(run(1, train=False), run(None, train=False))


def test_export_obj_detector_pt_matches_jax(detector, tmp_path):
    jp, js = jax.tree.map(jnp.asarray, detector)
    jti.export_obj_detector_pt(jp, js, str(tmp_path / "j.pt"))
    ti.export_obj_detector_pt(*_port(detector), str(tmp_path / "t.pt"))
    want = torch.load(tmp_path / "j.pt", weights_only=False)["state_dict"]
    got = torch.load(tmp_path / "t.pt", weights_only=False)["state_dict"]
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k
    # and it reads back into the same trees
    tp, ts = ti.import_obj_detector(ti.load_torch_state_dict(str(tmp_path / "t.pt")))
    for name, leaf in tp.items():
        for k, v in leaf.items():
            assert torch.equal(v, _port(detector)[0][name][k])


def _narrow_vgg_pth(path):
    """A VGG-16 state_dict with the partial stem's four convs at 8, 8, 16 and
    128 channels (the detector's input BN fixes the last at 128)."""
    r = np.random.default_rng(31)
    sd = {}
    for idx, (cin, cout) in zip((0, 2, 5, 7), ((3, 8), (8, 8), (8, 16), (16, 128))):
        c = _conv(r, cin, cout, 0.1)
        sd[f"features.{idx}.weight"] = torch.from_numpy(c["weight"].transpose(3, 2, 0, 1).copy())
        sd[f"features.{idx}.bias"] = torch.from_numpy(c["bias"])
    torch.save(sd, path)


_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _lines(text):
    return [(_NUM.sub("#", line), [float(x) for x in _NUM.findall(line)])
            for line in text.splitlines() if line.strip()]


def _train_both(tmp_path, monkeypatch, capsys, source, classes):
    """train_obj_detector in both packages on ``source`` (8 filters, tail 16,
    batch 4, 2 epochs, dropout 0, f32, JAX's init carried over, the narrow
    VGG) -> (JAX's init trees, the port's printed lines, JAX's)."""
    _narrow_vgg_pth(tmp_path / "vgg.pth")
    common = source + ["--num_filters", str(NUM_FILTERS), "--tail_hidden_dim",
                       str(HIDDEN), "--tail_dropout_p", "0.0", "--batch_size", "4",
                       "--num_epochs", "2", "--frcnn_pretrained_path", str(tmp_path / "vgg.pth")]

    # both in f32; the port starts from JAX's init (the generators differ)
    monkeypatch.setattr(jtod, "vgg_partial", functools.partial(jax_vgg_partial,
                                                               dtype=jnp.float32))
    monkeypatch.setattr(jtod, "obj_detector", functools.partial(jax_obj_detector,
                                                                dtype=jnp.float32))
    monkeypatch.setattr(tod, "vgg_partial", functools.partial(tod.vgg_partial,
                                                              dtype=torch.float32))
    monkeypatch.setattr(tod, "obj_detector", functools.partial(tod.obj_detector,
                                                               dtype=torch.float32))
    jinit = jax_init_obj_detector(jax.random.PRNGKey(0), nb_classes=classes,
                                  num_filters=NUM_FILTERS, tail_hidden_dim=HIDDEN)
    jinit_np = jax.tree.map(np.asarray, jinit)
    monkeypatch.setattr(tod, "init_obj_detector",
                        lambda gen, **kw: stem_from_jax({}, *jinit_np, torch.device("cpu"))[1:])

    jtod.main(common + ["--checkpoint_path", str(tmp_path / "j.npz")])
    want_out = capsys.readouterr().out
    tod.main(common + ["--checkpoint_path", str(tmp_path / "t.npz"), "--device", "cpu",
                       "--export_pt", str(tmp_path / "t.pt")])
    got_out = capsys.readouterr().out
    assert got_out.splitlines()[-1] == f"exported {tmp_path / 't.pt'}"
    got, want = _lines(got_out)[:-1], _lines(want_out)
    assert [g for g, _ in got] == [w for w, _ in want]
    assert sum(line.startswith("Epoch") for line, _ in got) == 2
    for (line, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=LINE_RTOL, atol=1e-6, err_msg=line)
    return jinit


def test_train_obj_detector_matches_jax(tmp_path, monkeypatch, capsys):
    r = np.random.default_rng(41)
    data = tmp_path / "frames.npz"
    np.savez(data, images=r.integers(0, 256, (16, 160, 208, 3), dtype=np.uint8),
             targets=(r.random((16, CLASSES)) < 0.3).astype(np.float32))
    jinit = _train_both(tmp_path, monkeypatch, capsys, ["--data", str(data)], CLASSES)

    # the port's checkpoint in JAX's loader, next to JAX's own
    jp, js, _, jmeta = jckpt.load_checkpoint(str(tmp_path / "j.npz"), params_template=jinit[0],
                                             state_template=jinit[1])
    tp, tstate, _, tmeta = jckpt.load_checkpoint(str(tmp_path / "t.npz"),
                                                 params_template=jinit[0],
                                                 state_template=jinit[1])
    assert tmeta == jmeta == {"model": "obj_detector", "nb_classes": CLASSES}
    for a, b in ((tp, jp), (tstate, js)):
        for (path, x), (_, y) in zip(jax.tree_util.tree_flatten_with_path(a)[0],
                                     jax.tree_util.tree_flatten_with_path(b)[0]):
            name = "/".join(str(k.key) for k in path)
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0,
                                       atol=NOISE_ATOL if name in NOISE_LEAVES else TRAINED_ATOL,
                                       err_msg=name)
    assert list(torch.load(tmp_path / "t.pt", weights_only=False)["state_dict"])[:2] == \
        ["bn_input.weight", "bn_input.bias"]


@pytest.mark.parametrize("seed", [0, 5])
def test_make_synthetic_detector_data_matches_jax(seed):
    assert tod.DEFAULT_DETECTOR_CLASSES == jtod.DEFAULT_DETECTOR_CLASSES
    assert len(tod.DEFAULT_DETECTOR_CLASSES) == SYNTHETIC_CLASSES
    frames, targets = tod.make_synthetic_detector_data(SYNTHETIC_FRAMES, seed)
    want_frames, want_targets = jtod.make_synthetic_detector_data(SYNTHETIC_FRAMES, seed)
    assert frames.dtype == want_frames.dtype == np.uint8
    assert frames.shape == (SYNTHETIC_FRAMES, 160, 208, 3)
    assert targets.dtype == want_targets.dtype == np.float32
    assert np.array_equal(frames, want_frames) and np.array_equal(targets, want_targets)
    assert 0 < targets.mean() < 1


def test_train_obj_detector_synthetic_matches_jax(tmp_path, monkeypatch, capsys):
    """--synthetic 8: the same rendered frames and targets, then the same
    epoch lines as JAX's trainer (the --data test's set-up)."""
    jinit = _train_both(tmp_path, monkeypatch, capsys, ["--synthetic", str(SYNTHETIC_FRAMES)],
                        SYNTHETIC_CLASSES)
    _, _, _, meta = jckpt.load_checkpoint(str(tmp_path / "t.npz"), params_template=jinit[0],
                                          state_template=jinit[1])
    assert meta == {"model": "obj_detector", "nb_classes": SYNTHETIC_CLASSES}


@pytest.mark.parametrize("argv, match", [
    pytest.param([], "need --data", id="argv1-need --data"),
])
def test_train_obj_detector_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        tod.main(argv + ["--device", "cpu"])
