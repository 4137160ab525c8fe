"""Tests of the benchmark (rtbench/), on the CPU at tiny sizes:

    python -m pytest rtbench/tests -q

Tests marked ``cuda`` run a cell on the card and skip without one: the
``cuda`` fixture decides when the test runs, never at import.
"""

import copy

import pytest
import torch

from rtbench import check, spec

torch.set_num_threads(1)

# A cell shrunk to a size the plain versions render in a few tens of ms.
TINY_RENDER = {"width": 12, "height": 8}
TINY_MESH = {
    "nested_shell": {"kind": "nested_shell", "outer_subdiv": 1,
                     "outer_radius": 1.2, "inner_subdiv": 0,
                     "inner_radius": 0.9},
    "icosphere": {"kind": "icosphere", "subdiv": 1, "radius": 1.2},
}
TINY_TRAFFIC = {"warmup_frames": 2}
TINY_CHECK = {"PIXELS": 24, "PIXEL_SETS": 3, "CHECK_FRAMES": 6}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the frame kernel has no CPU "
        "mode); the cuda fixture skips without one")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port's "
                    "CUDA frame kernel")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny(monkeypatch):
    """`tiny_cell`, with the check's sizes shrunk to match."""
    for name, value in TINY_CHECK.items():
        monkeypatch.setattr(check, name, value)
    return tiny_cell


def tiny_cell(name: str) -> spec.Cell:
    """The cell ``name`` of BENCHMARK.json with its limits, at a tiny
    image, mesh and map (the check's sizes: the ``tiny`` fixture)."""
    cell = spec.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["render"].update(TINY_RENDER)
    cfg["mesh"] = dict(TINY_MESH[cfg["mesh"]["kind"]])
    cfg["env"] = {"height": 16, "width": 32}
    cell.config = cfg
    cell.traffic = {**cell.traffic, **TINY_TRAFFIC}
    return cell
