"""pytest settings of the benchmark's tests (``python -m pytest portbench/tests``)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided when the
    test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card with "
                    "`python -m pytest portbench/tests -m card`")
    return torch.device("cuda")
