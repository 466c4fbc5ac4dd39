"""The benchmark's own tests: the yardstick's arithmetic, the traffic, the
trace reduction, the manifest, the reference against the measured package's
plain path, the controls and the planted faults, all on the CPU at small
sizes. Tests marked ``card`` run the benchmark itself and skip without a
CUDA card:

    python3 -m pytest vnqa_bench/tests -q
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# small widths of both configurations for the CPU
SMALL = dict(num_res_block_channels=16, num_input_channels=8, hidden_size=8, at_hidden_size=8,
             embed_size=8, mac_dim=16)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card")
    return torch.device("cuda", 0)
