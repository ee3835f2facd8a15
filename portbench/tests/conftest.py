"""Settings of the benchmark's own tests.

Run them from the repository's root: ``python -m pytest portbench/tests -q``.
Tests marked ``card`` need a CUDA card and skip without one (the ``card``
fixture decides, never the import); run them on the card with
``python -m pytest portbench/tests -q -m card``.
"""

import sys

import pytest

from portbench.tests.tiny import REPO

if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here; this test runs on the card")
    return torch.device("cuda")
