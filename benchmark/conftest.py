"""pytest settings of the benchmark's own tests (``benchmark/tests``),
which the repository's test command does not collect.

``@pytest.mark.card``: the test needs CUDA cards; the ``card`` fixture
skips it with a reason where there are none. The decision is made inside
the fixture, never while a module is imported.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs CUDA cards; skipped where there are none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs on the chip only")
    return torch.device("cuda", 0)
