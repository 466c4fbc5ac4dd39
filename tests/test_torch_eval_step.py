"""The port's eval step, its validation metrics and the harness settings of the
models it trains, against the JAX package's, on the CPU.

``make_eval_step`` returns JAX's four outputs: the loss over the rows of the
batch's ``valid`` mask (class-weighted or not, mean or sum), the hits over
every row, the predictions and the logits. It is held to JAX's
``make_eval_step`` on the same weights and numpy-seeded batches at the small
widths of tests/test_torch_train.py (the two per-frame video models at the
real 160x208 frames, two frames a video), the question-only LSTM given the
(h0, c0) JAX draws from the step's rng. Bounds: logits atol 1e-5 and the loss
rtol 1e-5 (measured values beside them), hits and predictions equal.
``train/metrics.py`` is a copy of the JAX module and must give the same
numbers.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import SMALL, _batch, _bridge, _j, _jax_init, _t
from test_torch_train_frame_models import video_batch
from test_torch_train_zoo import jax_initial_state

from videonavqa_tpu.cli import common as jax_common
from videonavqa_tpu.cli import q_only_eval as jax_q_only_eval
from videonavqa_tpu.cli import v_only_eval as jax_v_only_eval
from videonavqa_tpu.models import ModelConfig as JaxConfig
from videonavqa_tpu.models import get_model as jax_get_model
from videonavqa_tpu.train import metrics as jax_metrics
from videonavqa_tpu.train import step as jstep
from videonavqa_tpu_torch.cli.common import PRESET_L_RATE, TRAIN_STEP_OPTIONS
from videonavqa_tpu_torch.models import ModelConfig, get_model
from videonavqa_tpu_torch.models import q_only_lstm
from videonavqa_tpu_torch.train import metrics, step

LOGIT_ATOL = 1e-5  # measured: at most 8.2e-8 (film_attn_pt)
LOSS_RTOL = 1e-5   # measured: at most 1.3e-7 (mac)
MODELS = ("film_attn_pt", "mac", "v_only_cnn2d_lstm", "concat2d", "lstm")
# (reduction, class weights, valid mask)
LOSS_FORMS = (("mean", False, False), ("mean", True, True), ("sum", True, True))


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _eval_batch(model, seed):
    """Three rows (the video models: two frames each), with ``valid``
    dropping the last row as the harness pads a last batch."""
    spec = get_model(model)
    b = video_batch(seed, B=3, T=2) if spec.needs_video and not spec.uses_stem else _batch(seed)
    return dict(b, valid=np.array([True, True, False]))


@pytest.mark.parametrize("reduction, weighted, valid", LOSS_FORMS)
@pytest.mark.parametrize("model", MODELS)
def test_eval_step_matches_jax(monkeypatch, model, reduction, weighted, valid):
    _, jp, js = _jax_init(model)
    params, state = _bridge(jp, js)
    jcfg = JaxConfig(**{**SMALL, "model": model})
    weights = ((np.random.default_rng(21).random(SMALL["num_classes"]) + 0.25).astype(np.float32)
               if weighted else None)
    b = _eval_batch(model, 30)
    if not valid:
        del b["valid"]
    key = jax.random.PRNGKey(7)
    want = jstep.make_eval_step(jax_get_model(model), jcfg, reduction=reduction,
                                class_weights=None if weights is None else jnp.asarray(weights))(
        jp, js, _j(b), key)
    monkeypatch.setattr(q_only_lstm, "initial_state", lambda generator, shape, device:
                        jax_initial_state(key, *shape))
    got = step.make_eval_step(get_model(model), ModelConfig(**{**SMALL, "model": model}),
                              reduction=reduction,
                              class_weights=None if weights is None else torch.from_numpy(weights))(
        params, state, _t(b))
    assert sorted(got) == sorted(want) == ["hits", "logits", "loss", "preds"]
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=LOGIT_ATOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_array_equal(got["preds"].numpy(), np.asarray(want["preds"]))
    assert int(got["hits"]) == int(want["hits"])
    assert got["loss"].dtype == torch.float32 and got["loss"].shape == ()


def test_eval_step_loss_drops_invalid_rows_and_hits_count_every_row():
    """``valid`` leaves a padding row out of the loss, not out of the hits
    (the harness slices predictions to the valid rows itself)."""
    _, jp, js = _jax_init("mac")
    params, state = _bridge(jp, js)
    cfg = ModelConfig(**{**SMALL, "model": "mac"})
    b = _t(_eval_batch("mac", 31))
    eval_step = step.make_eval_step(get_model("mac"), cfg, reduction="sum")
    full = eval_step(params, state, {k: v for k, v in b.items() if k != "valid"})
    b["label"] = full["preds"].clone()           # every row a hit
    b["label"][2] = (b["label"][2] + 1) % SMALL["num_classes"]   # but the padding row
    masked = eval_step(params, state, b)
    two = eval_step(params, state, {k: v[:2] for k, v in b.items() if k != "valid"})
    assert int(masked["hits"]) == 2 and torch.equal(masked["logits"], full["logits"])
    np.testing.assert_allclose(float(masked["loss"]), float(two["loss"]), rtol=1e-6)


def test_eval_step_runs_raw_video_through_its_stem():
    """With ``stem_fn``, a batch of raw uint8 video gives what the batch of the
    stem's features gives; the stem sees frames /255 under inference mode."""
    _, jp, js = _jax_init("film_attn_pt")
    params, state = _bridge(jp, js)
    cfg = ModelConfig(**SMALL)
    b = _batch(32)
    video = np.random.default_rng(33).integers(0, 256, (3, 6, 4, 5, 3)).astype(np.uint8)
    seen = []

    def stem_fn(frames):
        seen.append((frames.dtype, float(frames.max()), torch.is_inference_mode_enabled()))
        return torch.from_numpy(b["v_features"])

    want = step.make_eval_step(get_model("film_attn_pt"), cfg)(params, state, _t(b))
    raw = _t({k: v for k, v in b.items() if k != "v_features"} | {"video": video})
    got = step.make_eval_step(get_model("film_attn_pt"), cfg, stem_fn=stem_fn)(params, state, raw)
    assert seen == [(torch.float32, float(video.max()) / 255.0, True)]
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_eval_step_leaves_the_state_and_takes_no_gradient():
    _, jp, js = _jax_init("v_only_cnn2d_lstm")
    params, state = _bridge(jp, js)
    for p in step.tree_leaves(params):
        p.requires_grad_(True)
    before = [t.clone() for t in step.tree_leaves(state)]
    out = step.make_eval_step(get_model("v_only_cnn2d_lstm"),
                              ModelConfig(**{**SMALL, "model": "v_only_cnn2d_lstm"}))(
        params, state, _t(video_batch(34, B=3, T=2)))
    assert all(torch.equal(a, b) for a, b in zip(before, step.tree_leaves(state)))
    assert not out["loss"].requires_grad and out["loss"].is_inference()


@pytest.mark.parametrize("num_classes", [None, 9])
@pytest.mark.parametrize("average", ["weighted", "micro", "macro"])
def test_f1_score_matches_jax(average, num_classes):
    r = np.random.default_rng(40)
    target = r.integers(0, 7, 200)
    pred = np.where(r.random(200) < 0.6, target, r.integers(0, 8, 200))
    assert metrics.f1_score(target, pred, average, num_classes) == jax_metrics.f1_score(
        target, pred, average, num_classes)


def test_f1_score_of_no_rows_and_an_unknown_average():
    for average in ("weighted", "micro", "macro"):
        assert metrics.f1_score([], [], average) == jax_metrics.f1_score([], [], average) == 0.0
    with pytest.raises(ValueError, match="unknown average"):
        metrics.f1_score([1], [1], "samples")


def test_per_class_accuracies_match_jax():
    r = np.random.default_rng(41)
    target = r.integers(0, 6, 150)   # classes 6..9 absent: 0.0
    pred = np.where(r.random(150) < 0.5, target, r.integers(0, 10, 150))
    got = metrics.per_class_accuracies(target, pred, 10)
    np.testing.assert_array_equal(got, jax_metrics.per_class_accuracies(target, pred, 10))
    assert got.dtype == np.float64 and not got[6:].any() and got[:6].all()


@functools.lru_cache(maxsize=None)
def _jax_harness_settings(model):
    """(reduction, clip_value, l_rate) that the JAX entry point gives
    ``model`` at its parser's defaults."""
    if model in ("v_only_cnn2d_lstm", "v_only_cnn3d"):
        args = jax_v_only_eval.build_parser().parse_args(["--model", model[len("v_only_"):]])
    elif model in ("lstm", "bow"):
        args = jax_q_only_eval.build_parser().parse_args(["--model", model])
        # the question-only harness takes no --clip_value and passes none, and
        # sums nothing: make_train_step(..., reduction="mean")
        source = inspect.getsource(jax_q_only_eval.main)
        assert "clip_value" not in source and 'reduction="mean"' in source
        assert args.use_class_weights
        return "mean", None, args.l_rate
    else:
        args = jax_common.build_q_and_v_parser().parse_args(["--model", model])
    return args.loss_reduction, args.clip_value, args.l_rate


@pytest.mark.parametrize("model", ["v_only_cnn2d_lstm", "concat2d", "lstm", "v_only_cnn3d",
                                   "concat3d", "bow"])
def test_train_step_options_are_the_jax_harness_settings(model):
    reduction, clip_value, l_rate = _jax_harness_settings(model)
    want = {"reduction": reduction}
    if clip_value is not None:
        want["clip_value"] = clip_value
    assert TRAIN_STEP_OPTIONS[model] == want
    assert PRESET_L_RATE[model] == l_rate
