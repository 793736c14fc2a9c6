import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def cuda():
    """Skip the test unless a CUDA device is present (decided when the test
    runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
