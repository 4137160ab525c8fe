"""GPU test tier of refraction_tpu_torch: each CUDA kernel against its plain
PyTorch version on the card.

Run on a machine with a CUDA GPU and nvcc:

    python -m pytest tests_gpu/ -q

Every test here carries the ``cuda`` marker and asks for the ``cuda``
fixture, which skips the test when no GPU is present; tests marked
``two_cards`` ask for the ``two_cards`` fixture, which skips them on
fewer than two GPUs. The decision is made when the test runs, never at
import or collection.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402
import torch  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU (the kernels have no CPU mode)")
    config.addinivalue_line(
        "markers", "two_cards: needs two CUDA GPUs (the two_cards fixture "
        "skips with fewer)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs: one card cannot show a launch on "
                    "a device other than the thread's current one")
    return torch.device("cuda", 0), torch.device("cuda", 1)
