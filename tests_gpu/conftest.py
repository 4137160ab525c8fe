"""GPU test tier of refraction_tpu_torch: each CUDA kernel against its plain
PyTorch version on the card.

Run on a machine with a CUDA GPU and nvcc:

    python -m pytest tests_gpu/ -q

Every test here carries the ``cuda`` marker and asks for the ``cuda``
fixture, which skips the test when no GPU is present; the decision is
made when the test runs, never at import or collection.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402
import torch  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU (the kernels have no CPU mode)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)
