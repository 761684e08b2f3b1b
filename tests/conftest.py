import sys

import numpy as np
import pytest

try:  # pragma: no cover - exercised only when hypothesis is installed
    import hypothesis  # noqa: F401
except ImportError:
    # Seed containers ship without hypothesis; register the deterministic
    # fallback sampler so property-test modules still collect and run.
    import importlib.util
    import pathlib

    _spec = importlib.util.spec_from_file_location(
        "_hypothesis_fallback",
        pathlib.Path(__file__).parent / "_hypothesis_fallback.py")
    _hypothesis_fallback = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_hypothesis_fallback)
    sys.modules["hypothesis"] = _hypothesis_fallback
    sys.modules["hypothesis.strategies"] = _hypothesis_fallback.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "requires_cuda: needs an NVIDIA GPU and nvcc; the test "
        "skips itself elsewhere")


@pytest.fixture(scope="session")
def small_dataset():
    from repro.logstore.datasets import generate_dataset
    return generate_dataset("test", n_lines=2000, n_sources=12, seed=7)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
