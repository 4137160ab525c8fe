"""The control, the reference computed in bfloat16 in the program's place,
fails the limits of every cell at a test size, while the program passes
them on the same frames and pixels (rtbench.control, whose chip runs set
the limits)."""

import pytest
import torch

from rtbench import check, control


@pytest.mark.parametrize("name", ["ref_demo.orbit", "config5.orbit",
                                  "config5.accumulate"])
def test_control_fails_the_limits(tiny, name):
    cell = tiny(name)
    seeds = [2 ** 31 + 1, 9]
    rows, summary = control.readings(cell, seeds, set(seeds), 0.2,
                                     torch.device("cpu"), lambda m: None)
    for row in rows:
        assert check.verdict(row["program"], cell.limits)[0], row
        assert not check.verdict(row["control"], cell.limits)[0], row
    assert set(summary["program_max"]) == set(summary["control_min"])
