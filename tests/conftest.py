"""Shared fixtures. NOTE: no XLA_FLAGS here — tests see the real single CPU
device; multi-device distribution tests spawn subprocesses with the flag."""
import jax
import pytest


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skipped where there "
        "is none (run on the GPU host: python -m pytest -m cuda tests/)")
