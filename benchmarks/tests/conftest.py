"""Tests of the benchmark harness. Run from the root of the checkout:

    python -m pytest benchmarks/tests -q

Tests marked ``card`` need the NVIDIA card and skip without it; on the
card machine ``python -m pytest benchmarks/tests -q -m card`` runs them.
Whether a card is there is decided in the ``card`` fixture, never while a
module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs the NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the NVIDIA card (CUDA is not available here)")
    return torch.cuda.get_device_name(0)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Few intra-op threads: the runtime's workers share the cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
