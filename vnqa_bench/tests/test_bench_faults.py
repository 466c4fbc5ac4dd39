"""The check that decides ``correct`` against its control and against faults
planted under the timed path: the rest of a run as it is, at small widths on
the CPU (the look for a card is skipped by calling the harness directly).

- each cell's control, the reference in the next lower precision, reads far
  above the program at these widths;
- an answer altered where it is produced, half of a training batch left out
  of the mean, and a step that leaves the state unchanged each turn
  ``correct`` false.
"""

import pytest
import torch

from conftest import SMALL
from vnqa_bench import faults, harness

CPU = torch.device("cpu")
SEED = 2**31 + 1234
SERVE = {
    "film_attn_pt.bulk_fcache": {"batch": 4, "pool": 16, "check_batches": 2},
    "film_attn_pt.online_fcache": {"batch": 4, "pool": 16, "check_batches": 3, "rate": 10,
                                   "senders": 8},
}
TRAIN = {"batch": 2, "pool": 2}


def run(cell, overrides, model=SMALL, **options):
    return harness.run_cell(cell, SEED, 1.0, False, CPU, 0.0, model_overrides=model,
                            cell_overrides=overrides, **options)


@pytest.mark.parametrize("cell", list(SERVE))
def test_serving_control_reads_far_above_the_program(cell):
    result = run(cell, SERVE[cell], control=True)
    program = result["compared"]["logprob_gap"][0]
    assert result["control"]["int4_trunk"]["logprob_gap"] > 10 * max(program, 1e-4)


def test_video_control_reads_far_above_the_program():
    result = run("film_attn_pt.bulk_video", {"batch": 2, "pool": 2, "check_batches": 1},
                 control=True)
    program = result["compared"]
    assert result["control"]["fp8_stem"]["feature_gap"] > 100 * max(program["feature_gap"][0],
                                                                    1e-6)
    assert result["control"]["int4_trunk"]["logprob_gap"] > 10 * program["logprob_gap"][0]


def test_training_controls_read_above_the_program():
    # MAC at mac_dim 128: at 16 the float32 roundings of two orders of the
    # same sums move a log-probability about as far as TF32 does
    result = run("mac.train_video", TRAIN, dict(SMALL, mac_dim=128), control=True)
    program = result["compared"]["logprob1_gap"][0]
    assert result["control"]["fp8_convs"]["logprob1_gap"] > 10 * program
    assert result["control"]["tf32"]["logprob1_gap"] > 3 * program


@pytest.mark.parametrize("cell", list(SERVE))
def test_an_altered_answer_is_caught(cell):
    with faults.altered_answer():
        assert run(cell, SERVE[cell])["correct"] is False


def test_half_a_batch_left_out_is_caught():
    with faults.half_batch():
        result = run("mac.train_video", TRAIN)
    assert result["correct"] is False
    assert result["compared"]["loss1_gap"][0] > result["compared"]["loss1_gap"][1]


def test_a_step_that_leaves_the_state_unchanged_is_caught():
    with faults.unchanged_state():
        result = run("mac.train_video", TRAIN)
    assert result["correct"] is False
    assert result["compared"]["change_gap"][0] == pytest.approx(1.0)
