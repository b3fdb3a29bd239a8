"""pytest settings of the benchmark's own tests (`benchmark/tests/`).

Tests that need a CUDA card carry the `card` marker and skip without one;
the `card` fixture decides, never an import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
