"""The plain reference against the measured package's plain path, at small
widths on the CPU: the weights' layout, the stem, and whole runs of each kind
of cell, whose compared numbers are then at rounding level."""

import pytest
import torch

from conftest import SMALL
from vnqa_bench import harness, inputs
from vnqa_bench.reference import film_attn as ref_film
from vnqa_bench.reference import mac as ref_mac
from vnqa_bench.reference import stem as ref_stem

CPU = torch.device("cpu")
SEED = 2**31 + 77


def shapes_of(tree):
    if isinstance(tree, dict):
        return {k: shapes_of(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [shapes_of(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("config", ["film_attn_pt", "mac"])
def test_weights_have_the_layout_of_the_package(config):
    from videonavqa_tpu_torch.models import get_model
    from videonavqa_tpu_torch.models.base import ModelConfig

    cfg = {**harness.config_spec(config)["model"], **SMALL}
    params, state = get_model(config).init(torch.Generator().manual_seed(0),
                                           ModelConfig(**cfg), CPU)
    ref = ref_film if config == "film_attn_pt" else ref_mac
    want_p, want_s = ref.shapes(cfg)
    assert shapes_of(params) == want_p
    assert shapes_of(state) == want_s


def test_stem_layout_and_features():
    from videonavqa_tpu_torch.stem import init_obj_detector, init_vgg_partial, stem_features

    gen = torch.Generator().manual_seed(0)
    vgg = init_vgg_partial(gen)
    det, det_state = init_obj_detector(gen, num_filters=8)
    assert shapes_of(vgg) == ref_stem.vgg_shapes()
    want_p, want_s = ref_stem.detector_shapes(8)
    assert {k: shapes_of(det[k]) for k in want_p} == want_p
    assert shapes_of(det_state) == {**want_s, "bn_tail1": {"mean": (1024,), "var": (1024,)}}

    stem = (inputs.make_weights(ref_stem.vgg_shapes(), SEED, 12, CPU),
            inputs.make_weights(want_p, SEED, 13, CPU), inputs.make_weights(want_s, SEED, 14, CPU))
    video = inputs.videos(1, SEED, CPU)[:, :2]
    got = stem_features(*stem, video.float() / 255.0, dtype=torch.bfloat16, use_kernel=True)
    want = ref_stem.video_features(stem, video)
    scale = want.abs().max()
    assert scale > 0
    assert ((got - want).abs().max() / scale) < 2e-2
    assert ((got - want).abs().mean() / want.abs().mean()) < 2e-3


def run(cell, overrides, **options):
    return harness.run_cell(cell, SEED, 1.0, False, CPU, 0.0, model_overrides=SMALL,
                            cell_overrides=overrides, **options)


@pytest.mark.parametrize("cell,overrides", [
    ("film_attn_pt.bulk_fcache", {"batch": 4, "pool": 16, "check_batches": 2}),
    ("film_attn_pt.online_fcache", {"batch": 4, "pool": 16, "check_batches": 3, "rate": 10,
                                    "senders": 8}),
])
def test_served_features_match_the_reference(cell, overrides):
    result = run(cell, overrides)
    assert result["correct"] and result["failed"] == 0
    # at these widths one int8 code that a float32 rounding flips moves a
    # log-probability by ~1e-4; the int4 control moves them by ~5e-2
    assert result["compared"]["logprob_gap"][0] < 1e-3


def test_training_matches_the_reference():
    result = run("mac.train_video", {"batch": 2, "pool": 2})
    got = {k: v for k, (v, _) in result["compared"].items()}
    assert result["correct"]
    assert max(got[f"loss{k}_gap"] for k in (1, 2, 3)) < 1e-5
    assert got["grad_gap"] < 1e-2 and got["change_gap"] < 1e-2
