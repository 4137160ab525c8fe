"""How ``correct`` is decided: what the window delivered against the
reference, number by number, each against its limit.

Two kinds of check, as the traffic mix names it (``"check"``):

- ``u8``: the display images the window brought to the host. Every frame
  keeps the pixels of one of the seed's pixel sets as the host received
  them; after the window a sample of frames drawn from the seed (the
  first and the last always among them) is traced again by the reference
  at each frame's angle and put through the reference's display
  transform. Numbers: ``u8_mean_abs``, the mean gap in 8-bit levels over
  every sampled channel, and ``u8_off2_share``, the share of sampled pixels
  with a channel two or more levels off.
- ``accumulate``: the accumulator the window folded into. At the seed's
  pixel set the float64 sum is held against the reference's float64 sum
  of every folded frame, each at its own angle. Numbers:
  ``acc_count_gap``, frames folded less the accumulator's count (exact:
  limit 0); ``acc_mean_abs`` and ``acc_max_abs``, the mean and the largest
  gap of a sampled channel's sum, divided by the frames folded.

The sizes of the check (`PIXELS`, `PIXEL_SETS`, `CHECK_FRAMES`) are
fixed here for every cell, and not in the traffic mixes, so that no cell
can make its own check weaker through data. The limits come from
``rtbench/limits/<config>.<check>.json``; each was set between the
program's readings over a dozen seeds and the control's, the reference
computed in bfloat16 (PERF.md).
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench.reference import tracer

# Pixels a frame keeps for the check, drawn from the seed: one set for the
# accumulator, and for the u8 check one of PIXEL_SETS sets a frame, in
# turns; frames of a u8 window traced again by the reference.
PIXELS = 128
PIXEL_SETS = 16
CHECK_FRAMES = 256


def u8_numbers(produced: np.ndarray, expected: torch.Tensor) -> dict:
    """``produced`` and ``expected`` (V, K, 3) 8-bit images (arrays or
    tensors) at the same pixels."""
    gap = (torch.as_tensor(produced).cpu().to(torch.int32)
           - expected.cpu().to(torch.int32)).abs()
    return {"u8_mean_abs": float(gap.double().mean()),
            "u8_off2_share": float((gap.amax(dim=-1) >= 2).double().mean())}


def acc_numbers(produced_sum: np.ndarray, count: int, folded: int,
                expected_sum: torch.Tensor) -> dict:
    """``produced_sum`` and ``expected_sum`` (K, 3) float64 sums at the
    same pixels; ``count`` the accumulator's, ``folded`` the frames the
    window handed to it."""
    gap = (torch.as_tensor(produced_sum).cpu().double()
           - expected_sum.cpu().double()).abs() / max(folded, 1)
    return {"acc_count_gap": float(abs(folded - count)),
            "acc_mean_abs": float(gap.mean()),
            "acc_max_abs": float(gap.max())}


def reference_u8(sc: tracer.Scene, render: dict, angles, pixels):
    """The reference's 8-bit images (V, K, 3) of the pixel ids ``pixels``
    (V, K) at ``angles`` (V)."""
    rad, _ = tracer.render_views(sc, render, angles, pixels)
    return tracer.display_u8(rad)


def reference_sum(sc: tracer.Scene, render: dict, angles, pixels):
    """The reference's float64 sum (K, 3) over ``angles`` of the pixel ids
    ``pixels`` (K,)."""
    ids = torch.as_tensor(pixels)[None].expand(len(angles), -1)
    rad, _ = tracer.render_views(sc, render, list(angles), ids)
    return rad.sum(dim=0)


def verdict(numbers: dict, limits: dict) -> tuple[bool, list[str]]:
    """(every number within its limit, one ``name value limit`` line a
    number). A number with no limit fails."""
    ok, lines = True, []
    for name, value in numbers.items():
        limit = limits.get(name)
        good = limit is not None and value <= limit
        ok &= good
        lines.append(f"check {name} {value!r} limit {limit!r} "
                     f"{'ok' if good else 'FAIL'}")
    return ok, lines
