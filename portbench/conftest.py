"""pytest settings of the benchmark's own tests (``portbench/tests``):
the ``card`` marker of tests that need a CUDA card, which skip elsewhere.

    python -m pytest portbench/tests -q              # CPU: card tests skip
    python -m pytest portbench/tests -q -m card      # on a card machine
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    """Skip the test where there is no CUDA card (decided here, when the
    test runs, never when a module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs only on one")
