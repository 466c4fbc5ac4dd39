"""The traffic made from the seed: the same work for every seed, the open-loop
schedule and the tail over a window."""

import numpy as np
import pytest

from vnqa_bench import harness, inputs
from vnqa_bench.traffic.open_loop import arrivals, percentile

MIX = harness.load_json(harness.BENCH / "workloads" / "film_attn_pt.bulk_fcache.json")["mix"]


def test_frames_after_the_pick():
    raw = np.array([1, 4, 5, 10, 139, 140, 141, 400])
    assert frames_list(raw) == [1, 1, 2, 3, 35, 35, 35, 35]


def frames_list(raw):
    return inputs.frames_after_pick(raw).tolist()


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_every_seed_gets_the_same_sizes(seed):
    v0, q0 = inputs.lengths(256, 1, MIX)
    v, q = inputs.lengths(256, seed, MIX)
    assert sorted(v) == sorted(v0) and sorted(q) == sorted(q0)
    assert v.min() == 3 and v.max() == 35
    assert 5 <= q.min() and q.max() <= 26
    assert np.median(q) == 10


def test_questions_are_zero_past_their_length():
    q_len = np.array([1, 5, 56])
    tok = inputs.questions(3, q_len, 2**31 + 5, 134)
    for row, n in zip(tok, q_len):
        assert (row[:n] >= 1).all() and (row[:n] <= 133).all() and (row[n:] == 0).all()


def test_the_same_seed_gives_the_same_inputs():
    a = inputs.lengths(64, 2**33 + 1, MIX), inputs.questions(4, np.array([3, 4, 5, 6]), 9, 134)
    b = inputs.lengths(64, 2**33 + 1, MIX), inputs.questions(4, np.array([3, 4, 5, 6]), 9, 134)
    assert all((x == y).all() for x, y in zip(a[0], b[0])) and (a[1] == b[1]).all()


def test_open_loop_schedule():
    rate, seconds = 400.0, 20.0
    due = arrivals(rate, seconds, 2**31 + 99)
    assert len(due) == 8000
    assert due[0] == 0 and (np.diff(due) > 0).all()
    assert due[-1] == pytest.approx(seconds, rel=0.01)
    # the same gaps for every seed, in another order (less the first, which
    # the schedule starts from)
    other = arrivals(rate, seconds, 3)
    assert not np.array_equal(due, other)
    assert abs(due[-1] - other[-1]) < 2 * np.log(2 * len(due)) / rate
    # exponential gaps: mean 1/rate, as many gaps over the mean as e^-1 predicts
    assert np.diff(due).mean() == pytest.approx(1 / rate, rel=0.01)
    assert (np.diff(due) > 1 / rate).mean() == pytest.approx(np.exp(-1), abs=0.01)


def test_p95_of_a_window():
    lat = np.arange(1, 101, dtype=float)          # 1..100 ms
    assert percentile(lat, 95) == 95.0
    assert percentile(lat, 50) == 50.0
    assert percentile(np.r_[lat, 1e6], 95) == 96.0  # one far request moves a rank, not the value
    assert percentile([7.0], 95) == 7.0


def test_weights_are_made_from_the_seed():
    import torch

    shapes = {"a": {"weight": (4, 3), "bias": (4,)}, "l": {"w_hh": (8, 2), "b_hh": (8,)},
              "bn": {"weight": (3,), "mean": (3,), "var": (3,)}}
    w1 = inputs.make_weights(shapes, 2**31 + 1, 10, torch.device("cpu"))
    w2 = inputs.make_weights(shapes, 2**31 + 1, 10, torch.device("cpu"))
    w3 = inputs.make_weights(shapes, 2**31 + 2, 10, torch.device("cpu"))
    assert torch.equal(w1["a"]["weight"], w2["a"]["weight"])
    assert not torch.equal(w1["a"]["weight"], w3["a"]["weight"])
    assert w1["a"]["weight"].abs().max() <= (6 / 7) ** 0.5
    assert (w1["l"]["b_hh"][2:4] > 0.9).all()             # the forget-gate block near 1
    assert (w1["bn"]["var"] > 0.5).all() and (w1["bn"]["weight"] > 0.5).all()
