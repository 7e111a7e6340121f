"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

Tests marked ``card`` need an NVIDIA card and skip elsewhere (the fixture
decides, at run time, never at import): on the card
``python -m pytest benchmark/tests -q -m card``."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda", 0)
