"""The benchmark's tests. Those marked cuda need an NVIDIA GPU; each decides
in a fixture whether there is one, and skips where there is none."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skipped where there "
        "is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
