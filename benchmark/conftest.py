"""The benchmark's own tests (``python -m pytest benchmark -q`` from the
repository's root).  Tests that need a CUDA card carry the ``cuda``
marker and decide inside a fixture whether to skip."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.cuda.get_device_name(0)
