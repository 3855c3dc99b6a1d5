"""CPU tests of the benchmark (run with ``python -m pytest gpubench/tests``;
the repository's own suite, ``tests/``, does not collect them).  Tests that
need the card carry the ``card`` marker and take the ``card`` fixture,
which skips them where no CUDA card is present (decided inside the
fixture, never while a module is imported)."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (the chip); skips elsewhere")
    import torch

    torch.set_num_threads(2)  # several workers share the host's cores


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
