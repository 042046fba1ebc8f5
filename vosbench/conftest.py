"""pytest settings of the benchmark's own tests (python -m pytest vosbench/tests).

Tests marked `card` need a CUDA device: they take the `card` fixture, which
skips them where torch sees none (decided when the test runs, never at
import, so every worker collects the same tests)."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run the benchmark's tests on the card)")
    return torch.device("cuda")
