"""The benchmark itself on the card: each cell once, over a short window, from
its command line; the result line holds what the contract asks, and the
output is correct. Skips without a CUDA card."""

import json
import subprocess
import sys

import pytest

from vnqa_bench import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_correct(cell, traced, card):
    out = subprocess.run(
        [sys.executable, "vnqa_bench/run.py", "--workload", cell, "--seed", str(2**31 + 31),
         "--seconds", "3", "--trace", str(traced)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    bench = harness.manifest()
    key = "per_layer" if traced else "end_to_end"
    assert set(result["metrics"]) <= {m["name"] for m in harness.cell_metrics(bench, cell, key)}
    if traced:
        assert result["device"]["busy_s"] > 0
        for name, m in result["metrics"].items():
            if name.startswith("roofline_pct.") or "mfu" in name:
                assert 0 < m["value"] <= 100


def test_no_card_means_no_result(tmp_path):
    """Without a card (here), or in a checkout without the measured package,
    the command exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "vnqa_bench/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
