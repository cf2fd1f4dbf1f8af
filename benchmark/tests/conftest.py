"""The benchmark's CPU tests (``python -m pytest benchmark/tests``); not
collected by ``pytest tests/``.  Tests that need the card carry the
``cuda`` marker and skip here inside the ``card`` fixture."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent
for p in (str(REPO), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def tree(tmp_path_factory):
    """A checkout with the tiny cells ``tiny.chain`` and ``tiny.train``."""
    import tiny

    return tiny.make_tree(tmp_path_factory.mktemp("bench"))
